// Pieces shared by the multi-scale deformable attention kernels
// (ms_deform_attn_fwd.cu, ms_deform_attn_bwd.cu).
//
// Every MSDA kernel here maps one warp to one (batch, query, head) and one lane
// to one channel (D = 32), with the 8 heads of a query in one block. Lane j < L*P
// carries sample j = (l, p): its pixel location and its attention weight, which
// the sampling loops broadcast to the whole warp with shuffles.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kD = 32;          // channels per head == lanes per warp
constexpr int kWarps = 8;       // warps (queries x heads) per block
constexpr int kMaxLevels = 8;
constexpr unsigned kFull = 0xffffffffu;

// levels [L, 3] (h, w, start) into shared memory; every thread of the block calls it
__device__ __forceinline__ void load_levels(int* s_lv, const int* levels, int L) {
  if (threadIdx.x < 3 * L) s_lv[threadIdx.x] = levels[threadIdx.x];
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Precomputed normalized locations [.., L, P, 2] f32 -> pixel coordinates of this
// lane's sample (lane j < L*P), x = loc_x * w - 0.5 as grid_sample with
// align_corners=False. The product and the difference are rounded separately
// (no fused multiply-add), as PyTorch and XLA round them, so a sample that lands
// exactly on a pixel centre lands there here too: the backward's derivative is
// taken corner by corner and jumps at integer pixels.
__device__ __forceinline__ void pixel_location(const float* loc_row, const int* s_lv,
                                               int lane, int LP, int P, float& px,
                                               float& py) {
  const float lv = lane < 2 * LP ? loc_row[lane] : 0.f;   // one 128-byte load per warp
  const int j = lane < LP ? lane : 0;
  const int lj = j / P;
  const float lx = __shfl_sync(kFull, lv, 2 * j);
  const float ly = __shfl_sync(kFull, lv, 2 * j + 1);
  px = __fsub_rn(__fmul_rn(lx, (float)s_lv[3 * lj + 1]), 0.5f);
  py = __fsub_rn(__fmul_rn(ly, (float)s_lv[3 * lj]), 0.5f);
}

// The forward's sampling loop, shared by every entry: lane s < L*P holds sample
// s's pixel location (px, py) and weight a; returns this lane's channel of
// sum_s a_s * bilinear(V_l(s), x_s, y_s). A corner outside the level adds zero;
// a sample outside (-1, w) x (-1, h) has no corner inside and is skipped whole
// (NaN skips too), which also keeps the int casts in range.
__device__ __forceinline__ float sample_levels(const __nv_bfloat16* vb, long long row,
                                               const int* s_lv, int LP, int P, float px,
                                               float py, float a) {
  float acc = 0.f;
#pragma unroll 4
  for (int s = 0; s < LP; ++s) {
    const float x = __shfl_sync(kFull, px, s);
    const float y = __shfl_sync(kFull, py, s);
    const float as = __shfl_sync(kFull, a, s);
    const int l = s / P;
    const int h = s_lv[3 * l], w = s_lv[3 * l + 1], start = s_lv[3 * l + 2];
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
    acc += as * v;
  }
  return acc;
}

}  // namespace
