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
//    value comes token-major [B, S, M, D] (one transpose in the wrapper).
//
// What bounds them on the card: gathered bytes and the instructions that fetch
// them. At IDOL-R50 serving shapes (B=10, S=Q=8617, M=8, L=P=4, D=32) one
// encoder layer reads ~11 M samples x 4 corners x 512 B of bf16 value rows
// (all 8 heads), ~2.8 GB, almost all of it L2 hits (one frame's value is 4.4
// MB); the arithmetic is a few FLOPs per byte. Device memory alone would take
// 0.047 ms.
//
// One mapping for all three: one warp per (batch, query, group of 8 heads), 4
// lanes per head and 8 channels (16 bytes) per lane, so one warp instruction
// fetches a corner of all 8 heads (8 x 64 B): 64 load instructions per query
// where one lane per channel needs 512. The sampling loop is shared
// (`sample_heads` in msda_common.cuh): the four lanes of a head take a batch of
// 4 samples by shuffles and issue all 16 corner loads before they use any, and
// the range test is a predicate (weight 0, address clamped in range), not a
// branch. The batch is outermost in the grid, so the warps of a block take
// consecutive queries of one frame and neighbouring encoder queries meet
// overlapping value rows in L1.
// - K1's prologue is per lane group: a lane loads the raw offsets of its 4
//   samples in one 16-byte load and their logits in one 8-byte load, a head's
//   softmax is a reduction over its 4 lanes, and the locations are rounded as
//   `pixel_locations` rounds them (explicit __fmul_rn / __fadd_rn), so samples
//   on pixel centres pick the same corners as the plain version. Each warp
//   writes its query's 512-byte output row in one coalesced store.
// - K4's prologue is K5's (`load_locations`, `pixel_coords`): two 16-byte loads
//   of f32 locations and one 8-byte load of weights per lane where L*P = 16,
//   x = loc_x * w - 0.5 without a fused multiply-add. Its output row leaves as
//   K1's does.
// - K4b: a block takes 32 consecutive queries of one (batch, group of 8 heads).
//   Its warps first stage the tile's locations and weights in shared memory,
//   each global read a run of 32 queries along Q; each warp then reads its
//   queries' samples back (the rows padded so that neither side conflicts on
//   banks), runs K4's loop and leaves its output in shared memory, and the
//   block writes the [256 channels x 32 queries] tile so that each channel's
//   row is one run of 64 bytes along Q.
//
// The TPU machinery (tent-selector matmuls, row schedules, query padding,
// channel-major layout) is carried over by none of them: a GPU gathers
// directly.

#include "msda_common.cuh"

namespace {

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

  // pixel locations, rounded in pixel_locations' order (no fused multiply-add)
  float px[4], py[4], at[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = 4 * c + i;
    const int l = s < LP ? s / P : 0;
    const float hl = (float)s_lv[3 * l], wl = (float)s_lv[3 * l + 1];
    const float* rf = ref + (bq * L + l) * REF_DIM;
    if (REF_DIM == 2) {   // point reference: x = ref_x * w - 0.5 + off_x
      px[i] = __fadd_rn(__fsub_rn(__fmul_rn(rf[0], wl), 0.5f), ox[i]);
      py[i] = __fadd_rn(__fsub_rn(__fmul_rn(rf[1], hl), 0.5f), oy[i]);
    } else {              // box reference: x = (ref_x + off_x / P * ref_w * 0.5) * w - 0.5
      px[i] = __fsub_rn(__fmul_rn(__fadd_rn(rf[0], __fmul_rn(__fmul_rn(__fdiv_rn(ox[i], (float)P), rf[2]), 0.5f)), wl), 0.5f);
      py[i] = __fsub_rn(__fmul_rn(__fadd_rn(rf[1], __fmul_rn(__fmul_rn(__fdiv_rn(oy[i], (float)P), rf[3]), 0.5f)), hl), 0.5f);
    }
    at[i] = ex[i] / sum;
    keep_inside(s < LP, wl, hl, px[i], py[i], at[i]);
  }

  float acc[8];
  sample_heads(value + (long long)b * S * M * kD + 256 * grp + 8 * lane, (long long)M * kD, s_lv, LP, P,
               lane, active, px, py, at, acc);
  // the warp's 8 x 64 bytes of the query's output row, one coalesced store
  if (active) store_row8(out + bq * M * kD + 256 * grp + 8 * lane, acc);
}

// K4: one warp per (batch, query, group of 8 heads), lanes as K1's
__global__ void __launch_bounds__(kQWarps * 32, 2)
msda_fwd_loc_kernel(const __nv_bfloat16* __restrict__ value,  // [B, S, M, D]
                    const float* __restrict__ loc,            // [B, Q, M, L, P, 2]
                    const __nv_bfloat16* __restrict__ attn,   // [B, Q, M, L, P]
                    const int* __restrict__ levels,           // [L, 3]: h, w, start
                    __nv_bfloat16* __restrict__ out,          // [B, Q, M*D]
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

  float lx[4], ly[4], at[4], px[4], py[4], wl[4], hl[4], acc[8];
  load_locations(loc, attn, hrow, c, LP, lx, ly, at);
  pixel_coords(s_lv, c, LP, P, lx, ly, px, py, wl, hl);
#pragma unroll
  for (int i = 0; i < 4; ++i) keep_inside(4 * c + i < LP, wl[i], hl[i], px[i], py[i], at[i]);
  sample_heads(value + (long long)b * S * M * kD + 256 * grp + 8 * lane, (long long)M * kD, s_lv, LP, P,
               lane, active, px, py, at, acc);
  if (active) store_row8(out + bq * M * kD + 256 * grp + 8 * lane, acc);
}

// K4b's tile: kCmTile queries of one (batch, group of 8 heads). Shared memory
// holds one row of kCmRow words per query: 8 x 32 f32 location words (word k of
// lane t at k * 32 + t: lane t = 4 * head + c holds x, y of its samples 4c + i
// as words 2i, 2i + 1), 2 x 32 words of bf16 weight pairs (word u of lane t at
// 256 + u * 32 + t: samples 4c + 2u, 4c + 2u + 1) and one word of padding, so
// that 32 consecutive queries of one staged row, and the 32 lanes of one query,
// each fall on 32 banks. After a warp has read its query's samples it leaves
// the query's output there too (word u of lane t at u * 32 + t: channels
// 8t + 2u, 8t + 2u + 1).
constexpr int kCmTile = 32;
constexpr int kCmRow = 8 * 32 + 2 * 32 + 1;

__global__ void __launch_bounds__(kQWarps * 32, 2)
msda_fwd_loc_cm_kernel(const __nv_bfloat16* __restrict__ value,  // [B, S, M, D]
                       const float* __restrict__ loc,            // [B, M, L, P, 2, Q]
                       const __nv_bfloat16* __restrict__ attn,   // [B, M, L, P, Q]
                       const int* __restrict__ levels,           // [L, 3]: h, w, start
                       __nv_bfloat16* __restrict__ out,          // [B, M*D, Q]
                       int Q, int S, int M, int L, int P) {
  __shared__ int s_lv[3 * kMaxLevels];
  __shared__ unsigned s_tile[kCmTile * kCmRow];
  const int groups = (M + 7) / 8;
  const int grp = blockIdx.x % groups;
  const int q0 = (blockIdx.x / groups) * kCmTile;
  const int b = blockIdx.y;
  const int LP = L * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // staging: a warp takes one row (head, component) at a time, lane = query,
  // so each global read is a run of 32 queries along Q
  {
    const int q = q0 + lane;
    unsigned* row_q = s_tile + lane * kCmRow;
    for (int r = warp; r < 8 * 2 * LP; r += kQWarps) {
      const int hh = r / (2 * LP), j = r % (2 * LP), head = 8 * grp + hh;
      const int s = j >> 1;
      const float v = head < M && q < Q ? loc[((long long)(b * M + head) * 2 * LP + j) * Q + q] : 0.f;
      row_q[(2 * (s & 3) + (j & 1)) * 32 + 4 * hh + (s >> 2)] = __float_as_uint(v);
    }
    __nv_bfloat16* at_q = reinterpret_cast<__nv_bfloat16*>(row_q + 256);
    for (int r = warp; r < 8 * LP; r += kQWarps) {
      const int hh = r / LP, s = r % LP, head = 8 * grp + hh;
      const __nv_bfloat16 v = head < M && q < Q ? attn[((long long)(b * M + head) * LP + s) * Q + q]
                                                : __float2bfloat16(0.f);
      at_q[2 * (((s & 3) >> 1) * 32 + 4 * hh + (s >> 2)) + (s & 1)] = v;
    }
  }
  load_levels(s_lv, levels, L);   // its __syncthreads also ends the staging

  const int head = 8 * grp + (lane >> 2), c = lane & 3;
  const bool active = head < M;
  const __nv_bfloat16* vb = value + (long long)b * S * M * kD + 256 * grp + 8 * lane;
  for (int qq = warp; qq < kCmTile && q0 + qq < Q; qq += kQWarps) {
    unsigned* row_q = s_tile + qq * kCmRow;
    float lx[4], ly[4], at[4], px[4], py[4], wl[4], hl[4], acc[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lx[i] = __uint_as_float(row_q[2 * i * 32 + lane]);
      ly[i] = __uint_as_float(row_q[(2 * i + 1) * 32 + lane]);
    }
    const unsigned a01 = row_q[256 + lane], a23 = row_q[256 + 32 + lane];
    at[0] = bf16_lo(a01); at[1] = bf16_hi(a01); at[2] = bf16_lo(a23); at[3] = bf16_hi(a23);
    pixel_coords(s_lv, c, LP, P, lx, ly, px, py, wl, hl);
#pragma unroll
    for (int i = 0; i < 4; ++i) keep_inside(4 * c + i < LP, wl[i], hl[i], px[i], py[i], at[i]);
    sample_heads(vb, (long long)M * kD, s_lv, LP, P, lane, active, px, py, at, acc);
    // words this lane read above and no other lane reads: no barrier needed
#pragma unroll
    for (int u = 0; u < 4; ++u) row_q[u * 32 + lane] = pack_bf16(acc[2 * u], acc[2 * u + 1]);
  }
  __syncthreads();

  // the [256 channels x 32 queries] tile: a warp takes one pair of channels at a
  // time, lane = query, so each channel's row leaves as one run along Q
  const int q = q0 + lane;
  if (q >= Q) return;
  for (int cp = warp; cp < 128; cp += kQWarps) {   // channels 2 cp, 2 cp + 1 of the group
    if (8 * grp + cp / 16 >= M) break;
    const unsigned w = s_tile[lane * kCmRow + (cp & 3) * 32 + (cp >> 2)];
    __nv_bfloat16* o = out + ((long long)b * M * kD + 256 * grp + 2 * cp) * Q + q;
    o[0] = __ushort_as_bfloat16((unsigned short)(w & 0xffffu));
    o[Q] = __ushort_as_bfloat16((unsigned short)(w >> 16));
  }
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

extern "C" int vnext_msda_fwd_loc(const void* value, const void* loc, const void* attn,
                                  const void* levels, void* out, int B, int Q, int S, int M,
                                  int L, int P, void* stream) {
  const long long warps = (long long)Q * ((M + 7) / 8);
  const dim3 grid((unsigned)((warps + kQWarps - 1) / kQWarps), (unsigned)B);
  if (grid.x == 0 || grid.y == 0) return 0;
  msda_fwd_loc_kernel<<<grid, kQWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(loc),
      static_cast<const __nv_bfloat16*>(attn), static_cast<const int*>(levels),
      static_cast<__nv_bfloat16*>(out), Q, S, M, L, P);
  return (int)cudaGetLastError();
}

extern "C" int vnext_msda_fwd_loc_cm(const void* value, const void* loc, const void* attn,
                                     const void* levels, void* out, int B, int Q, int S, int M,
                                     int L, int P, void* stream) {
  const long long tiles = (long long)(Q + kCmTile - 1) / kCmTile * ((M + 7) / 8);
  const dim3 grid((unsigned)tiles, (unsigned)B);
  if (grid.x == 0 || grid.y == 0) return 0;
  msda_fwd_loc_cm_kernel<<<grid, kQWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(loc),
      static_cast<const __nv_bfloat16*>(attn), static_cast<const int*>(levels),
      static_cast<__nv_bfloat16*>(out), Q, S, M, L, P);
  return (int)cudaGetLastError();
}
