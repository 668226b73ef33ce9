// Multi-scale deformable attention forward, fused entry (inference).
//
// Replaces the TPU kernel `_v9_kernel` in vnext_tpu/ops/ms_deform_attn_pallas_v9.py
// as reached through `ms_deform_attn_pallas_v9_cm_fused` (attn_is_logits=True):
// raw sampling offsets, reference points and raw attention logits go in; the
// kernel forms the pixel locations in f32, softmaxes the logits over L*P in f32,
// samples every level bilinearly (align_corners=False, zero padding) and
// accumulates in f32.
//
// What bounds it on the card: gathered bytes. At IDOL-R50 eval shapes (B=10,
// S=Q=8617, M=8, L=P=4, D=32) one encoder layer reads ~11 M samples x 4 corners
// x 64 B of bf16 value rows, ~2.8 GB, almost all of it L2 hits (the value
// tensor is 44 MB, inside the 50 MB L2); the arithmetic is a few FLOPs per byte.
// Design: one warp per (batch, query, head) and one lane per channel (D=32), so
// each corner read is one 64-byte contiguous row segment, and the 8 heads of a
// query sit in one block and read neighbouring 64-byte segments of the same
// 512-byte value row. The per-warp setup (32 offsets, 16 logits, the reference
// point) is one coalesced load per lane plus warp shuffles. The TPU machinery
// (tent-selector matmuls, row schedules, query padding, channel-major layout) is
// not carried over: a GPU gathers directly.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kD = 32;          // channels per head == lanes per warp
constexpr int kWarps = 8;       // warps (queries x heads) per block
constexpr int kMaxLevels = 8;
constexpr unsigned kFull = 0xffffffffu;

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
  if (threadIdx.x < 3 * L) s_lv[threadIdx.x] = levels[threadIdx.x];
  __syncthreads();

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
  float e = lane < LP ? expf(lg - mx) : 0.f;
  float sum = e;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  const float attn = e / sum;

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
  const long long row = (long long)M * kD;  // elements between neighbouring tokens
  float acc = 0.f;
#pragma unroll 4
  for (int s = 0; s < LP; ++s) {
    const float x = __shfl_sync(kFull, px, s);
    const float y = __shfl_sync(kFull, py, s);
    const float a = __shfl_sync(kFull, attn, s);
    const int l = s / P;
    const int h = s_lv[3 * l], w = s_lv[3 * l + 1], start = s_lv[3 * l + 2];
    // outside (-1, w) x (-1, h) every corner is padding (and NaN skips too)
    if (!(x > -1.f && x < (float)w && y > -1.f && y < (float)h)) continue;
    const float x0f = floorf(x), y0f = floorf(y);
    const float tx = x - x0f, ty = y - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;
    const __nv_bfloat16* vl = vb + (long long)start * row;
    float v = 0.f;
    if (y0 >= 0) {
      if (x0 >= 0) v += (1.f - tx) * (1.f - ty) * __bfloat162float(vl[(long long)(y0 * w + x0) * row]);
      if (x0 + 1 < w) v += tx * (1.f - ty) * __bfloat162float(vl[(long long)(y0 * w + x0 + 1) * row]);
    }
    if (y0 + 1 < h) {
      if (x0 >= 0) v += (1.f - tx) * ty * __bfloat162float(vl[(long long)((y0 + 1) * w + x0) * row]);
      if (x0 + 1 < w) v += tx * ty * __bfloat162float(vl[(long long)((y0 + 1) * w + x0 + 1) * row]);
    }
    acc += a * v;
  }
  out[bq * M * kD + m * kD + lane] = __float2bfloat16(acc);
}

}  // namespace

extern "C" int vnext_msda_fwd(const void* value, const void* offsets, const void* ref,
                              const void* logits, const void* levels, void* out, int B,
                              int Q, int S, int M, int L, int P, int ref_dim,
                              void* stream) {
  const long long warps = (long long)B * Q * M;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
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
