// Multi-scale deformable attention backward of the standard entry (training).
//
// Replaces the TPU kernel `_v9_bwd_kernel` in
// vnext_tpu/ops/ms_deform_attn_pallas_v9_bwd.py (called by `_backward_v9`, the
// custom VJP of `ms_deform_attn_pallas_v9`): given the forward's inputs (value
// [B, S, M, D] bf16, normalized f32 locations [B, Q, M, L, P, 2], softmaxed bf16
// weights [B, Q, M, L, P]) and the cotangent g [B, Q, M*D] bf16, it computes in
// one pass what jax.grad of `ms_deform_attn_core_jnp` computes:
//
//   dattn[l,p]  = sum_d g_d * bilinear_d(V_l, x, y)
//   dloc_x[l,p] = attn * w_l * sum_d g_d * [(1-ty)(v01-v00) + ty(v11-v10)]
//   dloc_y[l,p] = attn * h_l * sum_d g_d * [(1-tx)(v10-v00) + tx(v11-v01)]
//   dvalue[c]  += attn * w_c * g          for each corner c inside the level
//
// with x = loc_x * w_l - 0.5 and v_c = 0 for a corner outside the level. The
// derivative is taken corner by corner at integer pixels (d tx / dx = 1 with
// floor constant), not by the tent's sign: at init the encoder's samples land
// exactly on pixel centres, where the two differ.
//
// What bounds it on the card: the gathered corner reads, as in the forward, plus
// one 128-byte f32 reduction into the value gradient per corner inside a level
// (the atomics land in L2). Design: the forward's mapping, one warp per (batch,
// query, head) and one lane per channel, with this lane's cotangent channel in a
// register. Per sample, the three sums over channels are warp reductions; the
// value gradient is a coalesced f32 `atomicAdd` (compiled to `red`) per corner
// into an f32 scratch [B, S, M, D] that the wrapper zeroes, and a second small
// kernel casts the scratch to bf16. The atomics sum in an order that changes from
// run to run, so dvalue is not bitwise reproducible; a deterministic segmented
// reduction is later work.

#include "msda_common.cuh"

namespace {

__global__ void __launch_bounds__(kWarps * 32)
msda_bwd_kernel(const __nv_bfloat16* __restrict__ value,   // [B, S, M, D]
                const float* __restrict__ loc,             // [B, Q, M, L, P, 2]
                const __nv_bfloat16* __restrict__ attn,    // [B, Q, M, L, P]
                const __nv_bfloat16* __restrict__ grad,    // [B, Q, M*D]
                const int* __restrict__ levels,            // [L, 3]: h, w, start
                float* __restrict__ dvalue,                // [B, S, M, D] f32, zeroed
                float* __restrict__ dloc,                  // [B, Q, M, L, P, 2]
                __nv_bfloat16* __restrict__ dattn,         // [B, Q, M, L, P]
                int B, int Q, int S, int M, int L, int P) {
  __shared__ int s_lv[3 * kMaxLevels];
  load_levels(s_lv, levels, L);

  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (long long)B * Q * M) return;
  const int m = (int)(warp % M);
  const long long bq = warp / M;
  const int b = (int)(bq / Q);
  const int LP = L * P;

  float px, py;
  pixel_location(loc + warp * 2 * LP, 1, s_lv, lane, LP, P, px, py);
  const float a = lane < LP ? __bfloat162float(attn[warp * LP + lane]) : 0.f;
  const float g = __bfloat162float(grad[bq * M * kD + m * kD + lane]);

  const long long row = (long long)M * kD;  // elements between neighbouring tokens
  const long long base = ((long long)b * S * M + m) * kD + lane;
  const __nv_bfloat16* vb = value + base;
  float* dvb = dvalue + base;

  // lane s keeps dattn of sample s; lanes 2s and 2s+1 keep its dloc
  float my_dattn = 0.f, my_dloc = 0.f;
  for (int s = 0; s < LP; ++s) {
    const float x = __shfl_sync(kFull, px, s);
    const float y = __shfl_sync(kFull, py, s);
    const float as = __shfl_sync(kFull, a, s);
    const int l = s / P;
    const int h = s_lv[3 * l], w = s_lv[3 * l + 1], start = s_lv[3 * l + 2];
    // no corner inside the level: every term is zero (x == -1 still has one,
    // with weight 0 but a non-zero derivative)
    if (!(x >= -1.f && x < (float)w && y >= -1.f && y < (float)h)) continue;
    const float x0f = floorf(x), y0f = floorf(y);
    const float tx = x - x0f, ty = y - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;
    const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < w, in_y0 = y0 >= 0, in_y1 = y0 + 1 < h;
    const long long i00 = (long long)(start + y0 * w + x0) * row;
    const long long i01 = i00 + row, i10 = i00 + (long long)w * row, i11 = i10 + row;
    const float v00 = in_y0 && in_x0 ? __bfloat162float(vb[i00]) : 0.f;
    const float v01 = in_y0 && in_x1 ? __bfloat162float(vb[i01]) : 0.f;
    const float v10 = in_y1 && in_x0 ? __bfloat162float(vb[i10]) : 0.f;
    const float v11 = in_y1 && in_x1 ? __bfloat162float(vb[i11]) : 0.f;
    const float w00 = (1.f - tx) * (1.f - ty), w01 = tx * (1.f - ty);
    const float w10 = (1.f - tx) * ty, w11 = tx * ty;

    const float samp = w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11;
    const float gx = (1.f - ty) * (v01 - v00) + ty * (v11 - v10);
    const float gy = (1.f - tx) * (v10 - v00) + tx * (v11 - v01);
    const float sa = warp_sum(g * samp);
    const float sx = warp_sum(g * gx);
    const float sy = warp_sum(g * gy);
    if (lane == s) my_dattn = sa;
    if (lane == 2 * s) my_dloc = as * (float)w * sx;
    if (lane == 2 * s + 1) my_dloc = as * (float)h * sy;

    const float ga = as * g;
    if (in_y0 && in_x0) atomicAdd(dvb + i00, ga * w00);
    if (in_y0 && in_x1) atomicAdd(dvb + i01, ga * w01);
    if (in_y1 && in_x0) atomicAdd(dvb + i10, ga * w10);
    if (in_y1 && in_x1) atomicAdd(dvb + i11, ga * w11);
  }
  if (lane < LP) dattn[warp * LP + lane] = __float2bfloat16(my_dattn);
  if (lane < 2 * LP) dloc[warp * 2 * LP + lane] = my_dloc;
}

__global__ void f32_to_bf16_kernel(const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
                                   long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16(in[i]);
}

}  // namespace

// dvalue_f32 is the zeroed f32 scratch the atomics sum into; dvalue receives it
// as bf16 from the second kernel.
extern "C" int vnext_msda_bwd(const void* value, const void* loc, const void* attn,
                              const void* grad, const void* levels, void* dvalue_f32,
                              void* dloc, void* dattn, void* dvalue, int B, int Q, int S,
                              int M, int L, int P, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long warps = (long long)B * Q * M;
  msda_bwd_kernel<<<(unsigned)((warps + kWarps - 1) / kWarps), kWarps * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(loc),
      static_cast<const __nv_bfloat16*>(attn), static_cast<const __nv_bfloat16*>(grad),
      static_cast<const int*>(levels), static_cast<float*>(dvalue_f32),
      static_cast<float*>(dloc), static_cast<__nv_bfloat16*>(dattn), B, Q, S, M, L, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * S * M * kD;
  const long long blocks = (n + 255) / 256;
  f32_to_bf16_kernel<<<(unsigned)(blocks < 65535 * 16 ? blocks : 65535 * 16), 256, 0, st>>>(
      static_cast<const float*>(dvalue_f32), static_cast<__nv_bfloat16*>(dvalue), n);
  return (int)cudaGetLastError();
}
