// Multi-scale deformable attention forward, in three entries.
//
// 1. The fused entry (inference), `vnext_msda_fwd` (K1). Replaces the TPU kernel
//    `_v9_kernel` in vnext_tpu/ops/ms_deform_attn_pallas_v9.py as reached through
//    `ms_deform_attn_pallas_v9_cm_fused` (attn_is_logits=True): raw sampling
//    offsets, reference points and raw attention logits go in; the kernel forms
//    the pixel locations in f32, softmaxes the logits over L*P in f32, samples
//    every level bilinearly (align_corners=False, zero padding) and accumulates
//    in f32. It has no backward, as the TPU entry has none.
// 2. The standard entry (training), `vnext_msda_fwd_loc` (K4). Replaces
//    `_v9_kernel` as reached through `_forward_v9` (ms_deform_attn_pallas_v9.py:472),
//    the forward of `ms_deform_attn_pallas_v9`: precomputed normalized f32
//    locations [B, Q, M, L, P, 2] and softmaxed weights [B, Q, M, L, P] go in, so
//    the location and softmax prologue drops out. Its backward is
//    ms_deform_attn_bwd.cu. The same kernel is the forward of the implementation
//    selector's v6 / v7 / v8 routes (cfg.TPU.MSDA_IMPL "pallas", "pallas_v7",
//    "pallas_v8"): those TPU generations compute this function in this layout and
//    differ only in their VMEM / MXU schedules.
// 3. The channel-major entry (inference), `vnext_msda_fwd_loc_cm` (K4b).
//    Replaces `_v9_kernel` as reached through `ms_deform_attn_pallas_v9_cm`
//    (ms_deform_attn_pallas_v9.py:652): locations [B, M, L, P, 2, Q] and
//    weights [B, M, L, P, Q] with the query axis minor, output [B, M*D, Q]. The
//    value comes token-major [B, S, M, D] (one transpose in the wrapper), so the
//    sampling loop is K4's; the warps of a block take consecutive queries of one
//    head. A simple first form: its stores are not coalesced within a warp.
//
// What bounds them on the card: gathered bytes and the instructions that fetch
// them. At IDOL-R50 serving shapes (B=10, S=Q=8617, M=8, L=P=4, D=32) one
// encoder layer reads ~11 M samples x 4 corners x 512 B of bf16 value rows
// (all 8 heads), ~2.8 GB, almost all of it L2 hits (one frame's value is 4.4
// MB); the arithmetic is a few FLOPs per byte. Device memory alone would take
// 0.047 ms.
//
// K1's design: one warp per (batch, query) covering all 8 heads, 4 lanes per
// head and 8 channels (16 bytes) per lane, so one warp instruction fetches a
// corner of all 8 heads (8 x 64 B): 64 load instructions per query where one
// lane per channel needs 512. The prologue is per lane group: a lane loads the
// raw offsets of its 4 samples in one 16-byte load and their logits in one
// 8-byte load, a head's softmax is a reduction over its 4 lanes, and the range
// test is a predicate (weight 0, address clamped in range), not a branch. The
// four lanes of a head take a batch of 4 samples by shuffles and issue all 16
// corner loads before they use any. A block takes 8 consecutive queries of one
// frame (the batch is outermost in the grid), so neighbouring encoder queries
// meet overlapping value rows in L1, and each warp writes its query's 512-byte
// output row in one coalesced store. The locations are rounded as
// `pixel_locations` rounds them (explicit __fmul_rn / __fadd_rn), so samples on
// pixel centres pick the same corners as the plain version.
//
// K4 / K4b: one warp per (batch, query, head) and one lane per channel (D=32),
// the sampling loop `sample_levels` of msda_common.cuh; each corner read is one
// 64-byte row segment. The TPU machinery (tent-selector matmuls, row schedules,
// query padding, channel-major layout) is carried over by none of them: a GPU
// gathers directly.

#include "msda_common.cuh"

namespace {

constexpr int kQWarps = 8;   // K1: queries (one warp each) per block

// K1: one warp per (batch, query, group of 8 heads); lane = 4 * head + c, and
// lane c of a head owns channels 8c..8c+7 (16 bytes of the value row) and
// samples 4c..4c+3 of the head's L*P.
template <int REF_DIM>
__global__ void __launch_bounds__(kQWarps * 32, 2)
msda_fwd_kernel(const __nv_bfloat16* __restrict__ value,    // [B, S, M, D]
                const __nv_bfloat16* __restrict__ offsets,  // [B, Q, M, L, P, 2]
                const float* __restrict__ ref,              // [B, Q, L, REF_DIM]
                const __nv_bfloat16* __restrict__ logits,   // [B, Q, M, L*P]
                const int* __restrict__ levels,             // [L, 3]: h, w, start
                __nv_bfloat16* __restrict__ out,            // [B, Q, M*D]
                int Q, int S, int M, int L, int P) {
  __shared__ int s_lv[3 * kMaxLevels];
  load_levels(s_lv, levels, L);

  const int lane = threadIdx.x & 31;
  const int groups = (M + 7) / 8;
  const long long wq = (long long)blockIdx.x * kQWarps + (threadIdx.x >> 5);
  if (wq >= (long long)Q * groups) return;
  const int b = blockIdx.y;                     // the batch is outermost in the grid
  const int q = (int)(wq / groups), grp = (int)(wq % groups);
  const int head = 8 * grp + (lane >> 2), c = lane & 3;
  const bool active = head < M;
  const int LP = L * P;
  const long long bq = (long long)b * Q + q;
  const long long hrow = bq * M + (active ? head : 0);   // (b, q, head)

  // prologue: this lane's samples s = 4c + i, their raw offsets and logits
  float ox[4], oy[4], lg[4];
  if (LP == 16) {   // the model's shape: one 16-byte and one 8-byte load
    const uint4 o = __ldg(reinterpret_cast<const uint4*>(offsets + hrow * 32 + 8 * c));
    const uint2 e = __ldg(reinterpret_cast<const uint2*>(logits + hrow * 16 + 4 * c));
    const unsigned ow[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ox[i] = bf16_lo(ow[i]);
      oy[i] = bf16_hi(ow[i]);
    }
    lg[0] = bf16_lo(e.x); lg[1] = bf16_hi(e.x); lg[2] = bf16_lo(e.y); lg[3] = bf16_hi(e.y);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * c + i;
      const bool has = s < LP;
      ox[i] = has ? __bfloat162float(offsets[(hrow * LP + s) * 2]) : 0.f;
      oy[i] = has ? __bfloat162float(offsets[(hrow * LP + s) * 2 + 1]) : 0.f;
      lg[i] = has ? __bfloat162float(logits[hrow * LP + s]) : -INFINITY;
    }
  }

  // the head's softmax over L*P: a reduction over its 4 lanes
  float mx = fmaxf(fmaxf(lg[0], lg[1]), fmaxf(lg[2], lg[3]));
  mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
  float ex[4], sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ex[i] = 4 * c + i < LP ? expf(lg[i] - mx) : 0.f;
    sum += ex[i];
  }
  sum += __shfl_xor_sync(kFull, sum, 1);
  sum += __shfl_xor_sync(kFull, sum, 2);

  // pixel locations, rounded in pixel_locations' order (no fused multiply-add);
  // a sample outside (-1, w) x (-1, h), NaN or past L*P gets weight 0 at (0, 0)
  float px[4], py[4], at[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = 4 * c + i;
    const int l = s < LP ? s / P : 0;
    const float hl = (float)s_lv[3 * l], wl = (float)s_lv[3 * l + 1];
    const float* rf = ref + (bq * L + l) * REF_DIM;
    float x, y;
    if (REF_DIM == 2) {   // point reference: x = ref_x * w - 0.5 + off_x
      x = __fadd_rn(__fsub_rn(__fmul_rn(rf[0], wl), 0.5f), ox[i]);
      y = __fadd_rn(__fsub_rn(__fmul_rn(rf[1], hl), 0.5f), oy[i]);
    } else {              // box reference: x = (ref_x + off_x / P * ref_w * 0.5) * w - 0.5
      x = __fsub_rn(__fmul_rn(__fadd_rn(rf[0], __fmul_rn(__fmul_rn(__fdiv_rn(ox[i], (float)P), rf[2]), 0.5f)), wl), 0.5f);
      y = __fsub_rn(__fmul_rn(__fadd_rn(rf[1], __fmul_rn(__fmul_rn(__fdiv_rn(oy[i], (float)P), rf[3]), 0.5f)), hl), 0.5f);
    }
    const bool inside = s < LP && x > -1.f && x < wl && y > -1.f && y < hl;
    px[i] = inside ? x : 0.f;
    py[i] = inside ? y : 0.f;
    at[i] = inside ? ex[i] / sum : 0.f;
  }

  // sampling: batch j holds samples 4j..4j+3, owned by lane j of each head; the
  // four lanes of a head take them by shuffles and issue all 16 corner loads
  // (16 bytes each, clamped in range, weight 0 where outside) before using any
  const __nv_bfloat16* vb = value + (long long)b * S * M * kD + 256 * grp + 8 * lane;
  const long long row = (long long)M * kD;
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  const int batches = (LP + 3) / 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= batches) break;
    const int src = (lane & ~3) | j;
    float cw[16];
    int tok[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = __shfl_sync(kFull, px[i], src);
      const float y = __shfl_sync(kFull, py[i], src);
      const float a = __shfl_sync(kFull, at[i], src);
      const int s = 4 * j + i;
      const int l = s < LP ? s / P : 0;
      const int h = s_lv[3 * l], w = s_lv[3 * l + 1], start = s_lv[3 * l + 2];
      const float x0f = floorf(x), y0f = floorf(y);
      const float tx = x - x0f, ty = y - y0f;
      const int x0 = (int)x0f, y0 = (int)y0f;
      const bool vx0 = x0 >= 0, vx1 = x0 + 1 < w, vy0 = y0 >= 0, vy1 = y0 + 1 < h;
      const int xa = vx0 ? x0 : 0, xb = vx1 ? x0 + 1 : w - 1;
      const int ya = vy0 ? y0 : 0, yb = vy1 ? y0 + 1 : h - 1;
      cw[4 * i + 0] = vx0 && vy0 ? (1.f - tx) * (1.f - ty) * a : 0.f;
      cw[4 * i + 1] = vx1 && vy0 ? tx * (1.f - ty) * a : 0.f;
      cw[4 * i + 2] = vx0 && vy1 ? (1.f - tx) * ty * a : 0.f;
      cw[4 * i + 3] = vx1 && vy1 ? tx * ty * a : 0.f;
      tok[4 * i + 0] = start + ya * w + xa;
      tok[4 * i + 1] = start + ya * w + xb;
      tok[4 * i + 2] = start + yb * w + xa;
      tok[4 * i + 3] = start + yb * w + xb;
    }
    uint4 v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      v[k] = active ? __ldg(reinterpret_cast<const uint4*>(vb + (long long)tok[k] * row))
                    : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const unsigned vw[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[2 * u] = fmaf(cw[k], bf16_lo(vw[u]), acc[2 * u]);
        acc[2 * u + 1] = fmaf(cw[k], bf16_hi(vw[u]), acc[2 * u + 1]);
      }
    }
  }

  if (active) {   // the warp's 8 x 64 bytes of the query's output row, one coalesced store
    uint4 o;
    unsigned* ow = reinterpret_cast<unsigned*>(&o);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const __nv_bfloat162 pr = __floats2bfloat162_rn(acc[2 * u], acc[2 * u + 1]);
      ow[u] = *reinterpret_cast<const unsigned*>(&pr);
    }
    *reinterpret_cast<uint4*>(out + bq * M * kD + 256 * grp + 8 * lane) = o;
  }
}

template <bool CM>
__global__ void __launch_bounds__(kWarps * 32)
msda_fwd_loc_kernel(const __nv_bfloat16* __restrict__ value,  // [B, S, M, D]
                    const float* __restrict__ loc,            // [B, Q, M, L, P, 2] | CM [B, M, L, P, 2, Q]
                    const __nv_bfloat16* __restrict__ attn,   // [B, Q, M, L, P]    | CM [B, M, L, P, Q]
                    const int* __restrict__ levels,           // [L, 3]: h, w, start
                    __nv_bfloat16* __restrict__ out,          // [B, Q, M*D]        | CM [B, M*D, Q]
                    int B, int Q, int S, int M, int L, int P) {
  __shared__ int s_lv[3 * kMaxLevels];
  load_levels(s_lv, levels, L);

  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (long long)B * Q * M) return;
  const int LP = L * P;
  int b, m;
  float px, py, a;
  if (CM) {                           // warp = (b * M + m) * Q + q
    const long long bm = warp / Q;
    const long long q = warp % Q;
    m = (int)(bm % M);
    b = (int)(bm / M);
    pixel_location(loc + bm * 2 * LP * Q + q, Q, s_lv, lane, LP, P, px, py);
    a = lane < LP ? __bfloat162float(attn[(bm * LP + lane) * Q + q]) : 0.f;
  } else {                            // warp = (b * Q + q) * M + m
    m = (int)(warp % M);
    b = (int)(warp / M / Q);
    pixel_location(loc + warp * 2 * LP, 1, s_lv, lane, LP, P, px, py);
    a = lane < LP ? __bfloat162float(attn[warp * LP + lane]) : 0.f;
  }

  const __nv_bfloat16* vb = value + ((long long)b * S * M + m) * kD + lane;
  const float acc = sample_levels(vb, (long long)M * kD, s_lv, LP, P, px, py, a);
  if (CM) {
    out[((warp / Q) * kD + lane) * Q + warp % Q] = __float2bfloat16(acc);
  } else {
    out[warp * kD + lane] = __float2bfloat16(acc);   // [B, Q, M*D]: (b*Q + q)*M*D + m*D
  }
}

unsigned grid_for(int B, int Q, int M) {
  const long long warps = (long long)B * Q * M;
  return (unsigned)((warps + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" int vnext_msda_fwd(const void* value, const void* offsets, const void* ref,
                              const void* logits, const void* levels, void* out, int B,
                              int Q, int S, int M, int L, int P, int ref_dim,
                              void* stream) {
  const long long warps = (long long)Q * ((M + 7) / 8);
  const dim3 grid((unsigned)((warps + kQWarps - 1) / kQWarps), (unsigned)B);
  if (grid.x == 0 || grid.y == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<const __nv_bfloat16*>(value);
  auto* o = static_cast<const __nv_bfloat16*>(offsets);
  auto* r = static_cast<const float*>(ref);
  auto* lg = static_cast<const __nv_bfloat16*>(logits);
  auto* lv = static_cast<const int*>(levels);
  auto* y = static_cast<__nv_bfloat16*>(out);
  if (ref_dim == 2) {
    msda_fwd_kernel<2><<<grid, kQWarps * 32, 0, st>>>(v, o, r, lg, lv, y, Q, S, M, L, P);
  } else if (ref_dim == 4) {
    msda_fwd_kernel<4><<<grid, kQWarps * 32, 0, st>>>(v, o, r, lg, lv, y, Q, S, M, L, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool CM>
int launch_fwd_loc(const void* value, const void* loc, const void* attn, const void* levels,
                   void* out, int B, int Q, int S, int M, int L, int P, void* stream) {
  msda_fwd_loc_kernel<CM><<<grid_for(B, Q, M), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(loc),
      static_cast<const __nv_bfloat16*>(attn), static_cast<const int*>(levels),
      static_cast<__nv_bfloat16*>(out), B, Q, S, M, L, P);
  return (int)cudaGetLastError();
}

extern "C" int vnext_msda_fwd_loc(const void* value, const void* loc, const void* attn,
                                  const void* levels, void* out, int B, int Q, int S, int M,
                                  int L, int P, void* stream) {
  return launch_fwd_loc<false>(value, loc, attn, levels, out, B, Q, S, M, L, P, stream);
}

extern "C" int vnext_msda_fwd_loc_cm(const void* value, const void* loc, const void* attn,
                                     const void* levels, void* out, int B, int Q, int S, int M,
                                     int L, int P, void* stream) {
  return launch_fwd_loc<true>(value, loc, attn, levels, out, B, Q, S, M, L, P, stream);
}
