// Pieces shared by the multi-scale deformable attention kernels
// (ms_deform_attn_fwd.cu, ms_deform_attn_bwd.cu).
//
// Every MSDA kernel maps one warp to one (batch, query, group of 8 heads): lane
// = 4 * head + c, and lane c of a head owns channels 8c..8c+7 (16 bytes of the
// head's 64-byte value row) and samples 4c..4c+3 of the head's L*P. Which
// kernel uses which piece:
//   load_levels, the bf16 helpers, kD, kQWarps       K1, K4, K4b, K5
//   load_locations (standard-layout prologue)        K4, K5
//   pixel_coords (locations -> pixel coordinates)     K4, K4b, K5
//   keep_inside (the forward's range test)            K1, K4, K4b
//   sample_heads (the forward's sampling loop)        K1, K4, K4b
//   store_row8 (8 channels, one 16-byte store)        K1, K4
// K1 forms its pixel coordinates from raw offsets and reference points and
// softmaxes its logits itself; K4b stages its channel-major locations and
// weights through shared memory; K5 has its own loop (the three sums and the
// value gradient's reductions).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kD = 32;          // channels per head
constexpr int kQWarps = 8;      // warps (queries) per block
constexpr int kMaxLevels = 8;
constexpr unsigned kFull = 0xffffffffu;

// levels [L, 3] (h, w, start) into shared memory; every thread of the block calls it
__device__ __forceinline__ void load_levels(int* s_lv, const int* levels, int L) {
  if (threadIdx.x < 3 * L) s_lv[threadIdx.x] = levels[threadIdx.x];
  __syncthreads();
}

// the two bf16 halves of a 32-bit word as f32, and two f32 rounded into one
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The standard layout's prologue: lane c of head row `hrow` = (b, q, head)
// loads the normalized f32 locations [.., L*P, 2] and bf16 weights [.., L*P]
// of its samples s = 4c + i. Where L*P = 16 (the model's shape) that is two
// 16-byte loads and one 8-byte load; a sample past L*P gets 0.
__device__ __forceinline__ void load_locations(const float* __restrict__ loc,
                                               const __nv_bfloat16* __restrict__ attn,
                                               long long hrow, int c, int LP, float lx[4],
                                               float ly[4], float at[4]) {
  if (LP == 16) {
    const float4 l0 = __ldg(reinterpret_cast<const float4*>(loc + hrow * 32 + 8 * c));
    const float4 l1 = __ldg(reinterpret_cast<const float4*>(loc + hrow * 32 + 8 * c + 4));
    const uint2 e = __ldg(reinterpret_cast<const uint2*>(attn + hrow * 16 + 4 * c));
    lx[0] = l0.x; ly[0] = l0.y; lx[1] = l0.z; ly[1] = l0.w;
    lx[2] = l1.x; ly[2] = l1.y; lx[3] = l1.z; ly[3] = l1.w;
    at[0] = bf16_lo(e.x); at[1] = bf16_hi(e.x); at[2] = bf16_lo(e.y); at[3] = bf16_hi(e.y);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * c + i;
      const bool has = s < LP;
      lx[i] = has ? loc[(hrow * LP + s) * 2] : 0.f;
      ly[i] = has ? loc[(hrow * LP + s) * 2 + 1] : 0.f;
      at[i] = has ? __bfloat162float(attn[hrow * LP + s]) : 0.f;
    }
  }
}

// Pixel coordinates of lane c's samples, x = loc_x * w_l - 0.5 as grid_sample
// with align_corners=False, and their levels' extents (wl, hl). The product and
// the difference are rounded separately (no fused multiply-add), as PyTorch and
// XLA round them, so a sample that lands exactly on a pixel centre lands there
// here too: the backward's derivative is taken corner by corner and jumps at
// integer pixels. A sample past L*P goes to -inf, which every range test rejects.
__device__ __forceinline__ void pixel_coords(const int* s_lv, int c, int LP, int P,
                                             const float lx[4], const float ly[4], float px[4],
                                             float py[4], float wl[4], float hl[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = 4 * c + i;
    const int l = s < LP ? s / P : 0;
    hl[i] = (float)s_lv[3 * l];
    wl[i] = (float)s_lv[3 * l + 1];
    px[i] = s < LP ? __fsub_rn(__fmul_rn(lx[i], wl[i]), 0.5f) : -INFINITY;
    py[i] = s < LP ? __fsub_rn(__fmul_rn(ly[i], hl[i]), 0.5f) : -INFINITY;
  }
}

// The forward's range test on one sample of a level w x h, as a predicate: a
// sample outside (-1, w) x (-1, h) (NaN fails it, and so does one that does
// not exist, `has` false) has no corner inside its level; it gets weight 0 at
// (0, 0), so it adds exactly nothing and its loads stay inside the level.
__device__ __forceinline__ void keep_inside(bool has, float w, float h, float& x, float& y, float& a) {
  const bool inside = has && x > -1.f && x < w && y > -1.f && y < h;
  x = inside ? x : 0.f;
  y = inside ? y : 0.f;
  a = inside ? a : 0.f;
}

// The forward's sampling loop: acc[k] += sum_s at_s * bilinear(V_l(s), x_s, y_s)
// for this lane's channels 8c + k. `vb` points at the lane's 8 channels of the
// batch's first value row ([S, M, D] rows of `row` elements). Batch j holds
// samples 4j..4j+3, owned by lane j of each head; the four lanes of a head take
// them by shuffles and issue all 16 corner loads (16 bytes each, clamped inside
// the level, weight 0 where the corner is outside) before using any. Lanes of
// heads past M (`active` false) load nothing.
__device__ __forceinline__ void sample_heads(const __nv_bfloat16* __restrict__ vb, long long row,
                                             const int* s_lv, int LP, int P, int lane, bool active,
                                             const float px[4], const float py[4],
                                             const float at[4], float acc[8]) {
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
}

// 8 f32 rounded to bf16 and stored as one 16-byte vector
__device__ __forceinline__ void store_row8(__nv_bfloat16* dst, const float acc[8]) {
  uint4 o;
  o.x = pack_bf16(acc[0], acc[1]);
  o.y = pack_bf16(acc[2], acc[3]);
  o.z = pack_bf16(acc[4], acc[5]);
  o.w = pack_bf16(acc[6], acc[7]);
  *reinterpret_cast<uint4*>(dst) = o;
}

}  // namespace
