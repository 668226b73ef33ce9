// Multi-scale deformable attention forward, in two entries.
//
// 1. The fused entry (inference), `vnext_msda_fwd`. Replaces the TPU kernel
//    `_v9_kernel` in vnext_tpu/ops/ms_deform_attn_pallas_v9.py as reached through
//    `ms_deform_attn_pallas_v9_cm_fused` (attn_is_logits=True): raw sampling
//    offsets, reference points and raw attention logits go in; the kernel forms
//    the pixel locations in f32, softmaxes the logits over L*P in f32, samples
//    every level bilinearly (align_corners=False, zero padding) and accumulates
//    in f32. It has no backward, as the TPU entry has none.
// 2. The standard entry (training), `vnext_msda_fwd_loc`. Replaces `_v9_kernel`
//    as reached through `_forward_v9` (ms_deform_attn_pallas_v9.py:472), the
//    forward of `ms_deform_attn_pallas_v9`: precomputed normalized f32 locations
//    [B, Q, M, L, P, 2] and softmaxed weights [B, Q, M, L, P] go in, so the
//    location and softmax prologue drops out. Its backward is
//    ms_deform_attn_bwd.cu. The same kernel is the forward of the
//    implementation selector's v6 / v7 / v8 routes (cfg.TPU.MSDA_IMPL
//    "pallas", "pallas_v7", "pallas_v8"): those TPU generations compute this
//    function in this layout and differ only in their VMEM / MXU schedules.
// 3. The channel-major entry (inference), `vnext_msda_fwd_loc_cm` (K4b).
//    Replaces `_v9_kernel` as reached through `ms_deform_attn_pallas_v9_cm`
//    (ms_deform_attn_pallas_v9.py:652): locations [B, M, L, P, 2, Q] and
//    weights [B, M, L, P, Q] with the query axis minor, output [B, M*D, Q]. The
//    value comes token-major [B, S, M, D] (one transpose in the wrapper), so
//    the sampling loop and its 64-byte corner rows are K4's; the warps of a
//    block take consecutive queries of one head, so the strided reads of the
//    locations and weights and the strided output stores of a block fall in
//    neighbouring 2- and 4-byte words that L2 merges. A simple first form:
//    its stores are not coalesced within a warp.
//
// What bounds them on the card: gathered bytes. At IDOL-R50 eval shapes (B=10,
// S=Q=8617, M=8, L=P=4, D=32) one encoder layer reads ~11 M samples x 4 corners
// x 64 B of bf16 value rows, ~2.8 GB, almost all of it L2 hits (the value
// tensor is 44 MB, inside the 50 MB L2); the arithmetic is a few FLOPs per byte.
// Design: one warp per (batch, query, head) and one lane per channel (D=32), so
// each corner read is one 64-byte contiguous row segment, and the 8 heads of a
// query sit in one block and read neighbouring 64-byte segments of the same
// 512-byte value row. The per-warp setup is one coalesced load per lane plus warp
// shuffles: 32 offsets and 16 logits (fused entry) or 32 f32 locations, one
// 128-byte load, and 16 weights (standard entry). The TPU machinery
// (tent-selector matmuls, row schedules, query padding, channel-major layout) is
// not carried over: a GPU gathers directly.

#include "msda_common.cuh"

namespace {

template <int REF_DIM>
__global__ void __launch_bounds__(kWarps * 32)
msda_fwd_kernel(const __nv_bfloat16* __restrict__ value,    // [B, S, M, D]
                const __nv_bfloat16* __restrict__ offsets,  // [B, Q, M, L, P, 2]
                const float* __restrict__ ref,              // [B, Q, L, REF_DIM]
                const __nv_bfloat16* __restrict__ logits,   // [B, Q, M, L*P]
                const int* __restrict__ levels,             // [L, 3]: h, w, start
                __nv_bfloat16* __restrict__ out,            // [B, Q, M*D]
                int B, int Q, int S, int M, int L, int P) {
  __shared__ int s_lv[3 * kMaxLevels];
  load_levels(s_lv, levels, L);

  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (long long)B * Q * M) return;
  const int m = (int)(warp % M);
  const long long bq = warp / M;  // b * Q + q
  const int b = (int)(bq / Q);
  const int LP = L * P;

  // softmax of the raw logits over (L, P): lane j holds logit j
  float lg = lane < LP ? __bfloat162float(logits[warp * LP + lane]) : -INFINITY;
  float mx = lg;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  const float e = lane < LP ? expf(lg - mx) : 0.f;
  const float attn = e / warp_sum(e);

  // raw offsets (lane j holds component j of the 2*L*P) and the reference
  const float off = lane < 2 * LP ? __bfloat162float(offsets[warp * 2 * LP + lane]) : 0.f;
  const float rf = lane < L * REF_DIM ? ref[bq * L * REF_DIM + lane] : 0.f;

  // lane j < LP forms the pixel location of sample j = (l, p)
  const int j = lane < LP ? lane : 0;
  const int lj = j / P;
  const float ox = __shfl_sync(kFull, off, 2 * j);
  const float oy = __shfl_sync(kFull, off, 2 * j + 1);
  const float rx = __shfl_sync(kFull, rf, lj * REF_DIM);
  const float ry = __shfl_sync(kFull, rf, lj * REF_DIM + 1);
  const float wl = (float)s_lv[3 * lj + 1];
  const float hl = (float)s_lv[3 * lj];
  float px, py;
  if (REF_DIM == 2) {
    // point reference: x = ref_x * w - 0.5 + off_x (offsets in level pixels)
    px = rx * wl - 0.5f + ox;
    py = ry * hl - 0.5f + oy;
  } else {
    // box reference: x = (ref_x + off_x / P * ref_w * 0.5) * w - 0.5
    const float rw = __shfl_sync(kFull, rf, lj * REF_DIM + 2);
    const float rh = __shfl_sync(kFull, rf, lj * REF_DIM + 3);
    px = (rx + ox / (float)P * rw * 0.5f) * wl - 0.5f;
    py = (ry + oy / (float)P * rh * 0.5f) * hl - 0.5f;
  }

  const __nv_bfloat16* vb = value + ((long long)b * S * M + m) * kD + lane;
  const float acc = sample_levels(vb, (long long)M * kD, s_lv, LP, P, px, py, attn);
  out[bq * M * kD + m * kD + lane] = __float2bfloat16(acc);
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
  const unsigned blocks = grid_for(B, Q, M);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<const __nv_bfloat16*>(value);
  auto* o = static_cast<const __nv_bfloat16*>(offsets);
  auto* r = static_cast<const float*>(ref);
  auto* lg = static_cast<const __nv_bfloat16*>(logits);
  auto* lv = static_cast<const int*>(levels);
  auto* y = static_cast<__nv_bfloat16*>(out);
  if (ref_dim == 2) {
    msda_fwd_kernel<2><<<blocks, kWarps * 32, 0, st>>>(v, o, r, lg, lv, y, B, Q, S, M, L, P);
  } else if (ref_dim == 4) {
    msda_fwd_kernel<4><<<blocks, kWarps * 32, 0, st>>>(v, o, r, lg, lv, y, B, Q, S, M, L, P);
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
