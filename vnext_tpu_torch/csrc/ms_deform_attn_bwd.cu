// Multi-scale deformable attention backward of the standard entry (training), K5.
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
// with x = loc_x * w_l - 0.5 (no fused multiply-add, as `pixel_coords` rounds
// it) and v_c = 0 for a corner outside the level. The derivative is taken corner
// by corner at integer pixels (d tx / dx = 1 with floor constant), not by the
// tent's sign: at init the encoder's samples land exactly on pixel centres,
// where the two differ. A sample is skipped only when x < -1, x >= w, y < -1 or
// y >= h: at x = -1 an inside corner has weight 0 but a non-zero derivative.
//
// What bounds it on the card: the gathered corner reads, as in the forward, and
// the value gradient's reductions into L2, one f32 head row (128 bytes) per
// corner inside a level. Design: K1's mapping (ms_deform_attn_fwd.cu). One warp
// per (batch, query) covers 8 heads, 4 lanes a head and 8 channels (16 bytes) a
// lane, so the cotangent's 8 channels are one 16-byte load and one warp
// instruction fetches a corner of all 8 heads. Lane c of a head owns samples
// 4c..4c+3 (their locations in two 16-byte loads, their weights in one 8-byte
// load: the prologue K4 shares, msda_common.cuh); the four lanes of a head take a batch of 4 samples by shuffles and
// issue the corner loads of 2 samples at a time (8 loads of 16 bytes),
// predicated on the range test, before using any; at 128 registers two blocks
// fit an SM, which measured faster than 16 loads in flight at one block.
// Per sample the three sums (dattn, dloc_x, dloc_y) are per-lane partials over
// 8 channels reduced over the head's 4 lanes (2 shuffles each). The value
// gradient leaves by 16-byte vector reductions (`atomicAdd` on float4,
// `red.global.add.v4.f32`) into an f32 scratch [B, S, M, D] that the wrapper
// zeroes. A head's 4 lanes hold only 64 bytes of a row each, and reductions
// that covered half of each 32-byte sector measured slower than the scalar
// kernel's whole 128-byte rows; so the 8 lanes of a head pair cover one head's
// whole row per instruction (the pair swaps each corner's token and
// coefficient by one shuffle each, and the cotangent once): 2 instructions per
// corner and lane in place of 8 scalar ones, each updating whole sectors.
// Corners of weight 0 add nothing and are skipped. Merging a head's corners
// that repeat within a level measured slower (the comparisons cost more than
// the few reductions they save on spread-out samples). A second kernel casts the
// scratch to bf16 with 16-byte loads. The reductions sum in an order that
// changes from run to run, so dvalue is not bitwise reproducible, as upstream
// Deformable-DETR's atomic backward is not.

#include "msda_common.cuh"

namespace {

// samples whose 4 corners a lane loads before using any: 2 (8 loads of 16
// bytes) with 2 blocks per SM (128 registers) measured faster than 4 with 1
constexpr int kLoadGroup = 2;
constexpr int kMinBlocks = 2;

// adds coef * g[0..3] to 4 f32 of the value gradient in one vector reduction
__device__ __forceinline__ void add4(float* dst, float coef, const float* g) {
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(coef * g[0], coef * g[1], coef * g[2], coef * g[3]));
}

// one warp per (batch, query, group of 8 heads); lane = 4 * head + c, and lane c
// of a head owns channels 8c..8c+7 and samples 4c..4c+3 of the head's L*P
__global__ void __launch_bounds__(kQWarps * 32, kMinBlocks)
msda_bwd_kernel(const __nv_bfloat16* __restrict__ value,   // [B, S, M, D]
                const float* __restrict__ loc,             // [B, Q, M, L, P, 2]
                const __nv_bfloat16* __restrict__ attn,    // [B, Q, M, L, P]
                const __nv_bfloat16* __restrict__ grad,    // [B, Q, M*D]
                const int* __restrict__ levels,            // [L, 3]: h, w, start
                float* __restrict__ dvalue,                // [B, S, M, D] f32, zeroed
                float* __restrict__ dloc,                  // [B, Q, M, L, P, 2]
                __nv_bfloat16* __restrict__ dattn,         // [B, Q, M, L, P]
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

  // this lane's samples s = 4c + i: locations, weights and pixel coordinates
  // (a sample past L*P goes to -inf, which the range test below rejects)
  float lx[4], ly[4], at[4], px[4], py[4], lw[4], lh[4];
  load_locations(loc, attn, hrow, c, LP, lx, ly, at);
  pixel_coords(s_lv, c, LP, P, lx, ly, px, py, lw, lh);

  // the cotangent's 8 channels of this lane
  float g[8];
  {
    const uint4 gv = active ? __ldg(reinterpret_cast<const uint4*>(grad + bq * M * kD + 256 * grp + 8 * lane))
                            : make_uint4(0u, 0u, 0u, 0u);
    const unsigned gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      g[2 * u] = bf16_lo(gw[u]);
      g[2 * u + 1] = bf16_hi(gw[u]);
    }
  }

  // the value gradient leaves by head pairs: the 8 lanes r = lane % 8 of heads
  // 2t and 2t+1 together cover one head's 128-byte f32 row per reduction, lane r
  // its floats 4r..4r+3, first for head 2t (A) and then for head 2t+1 (B), so
  // each instruction updates whole 32-byte sectors. gA and gB are the
  // cotangent's channels 4r..4r+3 of the two heads (channel k lives in lane
  // 4 * head + k / 8 of the head)
  const int r = lane & 7, hb = (lane >> 2) & 1;
  float gA[4], gB[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lo_a = __shfl_sync(kFull, g[k], (lane & ~7) | (r >> 1));
    const float hi_a = __shfl_sync(kFull, g[4 + k], (lane & ~7) | (r >> 1));
    const float lo_b = __shfl_sync(kFull, g[k], (lane & ~7) | 4 | (r >> 1));
    const float hi_b = __shfl_sync(kFull, g[4 + k], (lane & ~7) | 4 | (r >> 1));
    gA[k] = r & 1 ? hi_a : lo_a;
    gB[k] = r & 1 ? hi_b : lo_b;
  }

  const long long base = (long long)b * S * M * kD + 256 * grp;
  const __nv_bfloat16* vb = value + base + 8 * lane;
  float* dvA = dvalue + base + 32 * (lane >> 3 << 1) + 4 * r;   // head 2t, floats 4r..
  float* dvB = dvA + 32;                                          // head 2t + 1
  const long long row = (long long)M * kD;
  float o_at[4] = {0.f, 0.f, 0.f, 0.f}, o_lx[4] = {0.f, 0.f, 0.f, 0.f}, o_ly[4] = {0.f, 0.f, 0.f, 0.f};

  // batch j holds samples 4j..4j+3, owned by lane j of each head
  const int batches = (LP + 3) / 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= batches) break;
    const int srcl = (lane & ~3) | j;
    float tx[4], ty[4], as[4], wl[4], hl[4], cf[16];
    int tok[16];
    bool ok[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = __shfl_sync(kFull, px[i], srcl);
      const float y = __shfl_sync(kFull, py[i], srcl);
      as[i] = __shfl_sync(kFull, at[i], srcl);
      const int s = 4 * j + i;
      const int l = s < LP ? s / P : 0;
      const int h = s_lv[3 * l], w = s_lv[3 * l + 1], start = s_lv[3 * l + 2];
      // NaN fails the test too; the int casts below see only in-range values
      const bool inside = x >= -1.f && x < (float)w && y >= -1.f && y < (float)h;
      const float xs = inside ? x : 0.f, ys = inside ? y : 0.f;
      const float x0f = floorf(xs), y0f = floorf(ys);
      tx[i] = xs - x0f;
      ty[i] = ys - y0f;
      wl[i] = (float)w;
      hl[i] = (float)h;
      const int x0 = (int)x0f, y0 = (int)y0f;
      const bool vx0 = inside && x0 >= 0, vx1 = inside && x0 + 1 < w;
      const bool vy0 = y0 >= 0, vy1 = y0 + 1 < h;
      ok[4 * i + 0] = active && vx0 && vy0;
      ok[4 * i + 1] = active && vx1 && vy0;
      ok[4 * i + 2] = active && vx0 && vy1;
      ok[4 * i + 3] = active && vx1 && vy1;
      tok[4 * i + 0] = start + y0 * w + x0;
      tok[4 * i + 1] = tok[4 * i + 0] + 1;
      tok[4 * i + 2] = tok[4 * i + 0] + w;
      tok[4 * i + 3] = tok[4 * i + 0] + w + 1;
      // dvalue's coefficient of each corner: attn * w_corner, 0 out of range
      cf[4 * i + 0] = ok[4 * i + 0] ? as[i] * ((1.f - tx[i]) * (1.f - ty[i])) : 0.f;
      cf[4 * i + 1] = ok[4 * i + 1] ? as[i] * (tx[i] * (1.f - ty[i])) : 0.f;
      cf[4 * i + 2] = ok[4 * i + 2] ? as[i] * ((1.f - tx[i]) * ty[i]) : 0.f;
      cf[4 * i + 3] = ok[4 * i + 3] ? as[i] * (tx[i] * ty[i]) : 0.f;
    }
#pragma unroll
    for (int i0 = 0; i0 < 4; i0 += kLoadGroup) {
      uint4 v[4 * kLoadGroup];
#pragma unroll
      for (int k = 0; k < 4 * kLoadGroup; ++k)
        v[k] = ok[4 * i0 + k] ? __ldg(reinterpret_cast<const uint4*>(vb + (long long)tok[4 * i0 + k] * row))
                              : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int ii = 0; ii < kLoadGroup; ++ii) {
        const int i = i0 + ii;
        const float w00 = (1.f - tx[i]) * (1.f - ty[i]), w01 = tx[i] * (1.f - ty[i]);
        const float w10 = (1.f - tx[i]) * ty[i], w11 = tx[i] * ty[i];
        const unsigned c00[4] = {v[4 * ii].x, v[4 * ii].y, v[4 * ii].z, v[4 * ii].w};
        const unsigned c01[4] = {v[4 * ii + 1].x, v[4 * ii + 1].y, v[4 * ii + 1].z, v[4 * ii + 1].w};
        const unsigned c10[4] = {v[4 * ii + 2].x, v[4 * ii + 2].y, v[4 * ii + 2].z, v[4 * ii + 2].w};
        const unsigned c11[4] = {v[4 * ii + 3].x, v[4 * ii + 3].y, v[4 * ii + 3].z, v[4 * ii + 3].w};
        float sa = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int u = e >> 1;
          const float v00 = e & 1 ? bf16_hi(c00[u]) : bf16_lo(c00[u]);
          const float v01 = e & 1 ? bf16_hi(c01[u]) : bf16_lo(c01[u]);
          const float v10 = e & 1 ? bf16_hi(c10[u]) : bf16_lo(c10[u]);
          const float v11 = e & 1 ? bf16_hi(c11[u]) : bf16_lo(c11[u]);
          const float samp = w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11;
          const float gx = (1.f - ty[i]) * (v01 - v00) + ty[i] * (v11 - v10);
          const float gy = (1.f - tx[i]) * (v10 - v00) + tx[i] * (v11 - v01);
          sa += g[e] * samp;
          sx += g[e] * gx;
          sy += g[e] * gy;
        }
        // the head's sums: a reduction over its 4 lanes
        sa += __shfl_xor_sync(kFull, sa, 1);
        sx += __shfl_xor_sync(kFull, sx, 1);
        sy += __shfl_xor_sync(kFull, sy, 1);
        sa += __shfl_xor_sync(kFull, sa, 2);
        sx += __shfl_xor_sync(kFull, sx, 2);
        sy += __shfl_xor_sync(kFull, sy, 2);
        if (c == j) {
          o_at[i] = sa;
          o_lx[i] = as[i] * wl[i] * sx;
          o_ly[i] = as[i] * hl[i] * sy;
        }
      }
      // dvalue: each corner of this group, this head's and the pair's other
      // head's (lane ^ 4)
#pragma unroll
      for (int k = 4 * i0; k < 4 * (i0 + kLoadGroup); ++k) {
        const float pcf = __shfl_xor_sync(kFull, cf[k], 4);
        const int ptk = __shfl_xor_sync(kFull, tok[k], 4);
        const float ca = hb ? pcf : cf[k], cb = hb ? cf[k] : pcf;
        const int ta = hb ? ptk : tok[k], tb = hb ? tok[k] : ptk;
        if (ca != 0.f) add4(dvA + (long long)ta * row, ca, gA);
        if (cb != 0.f) add4(dvB + (long long)tb * row, cb, gB);
      }
    }
  }

  if (!active) return;
  if (LP == 16) {
    uint2 e;
    e.x = pack_bf16(o_at[0], o_at[1]);
    e.y = pack_bf16(o_at[2], o_at[3]);
    *reinterpret_cast<uint2*>(dattn + hrow * 16 + 4 * c) = e;
    *reinterpret_cast<float4*>(dloc + hrow * 32 + 8 * c) = make_float4(o_lx[0], o_ly[0], o_lx[1], o_ly[1]);
    *reinterpret_cast<float4*>(dloc + hrow * 32 + 8 * c + 4) = make_float4(o_lx[2], o_ly[2], o_lx[3], o_ly[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * c + i;
      if (s < LP) {
        dattn[hrow * LP + s] = __float2bfloat16(o_at[i]);
        dloc[(hrow * LP + s) * 2] = o_lx[i];
        dloc[(hrow * LP + s) * 2 + 1] = o_ly[i];
      }
    }
  }
}

// 4 f32 in (one 16-byte load), 4 bf16 out (one 8-byte store)
__global__ void f32_to_bf16_kernel(const float4* __restrict__ in, uint2* __restrict__ out, long long n4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 v = in[i];
    out[i] = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

}  // namespace

// dvalue_f32 is the zeroed f32 scratch the reductions sum into; dvalue receives
// it as bf16 from the second kernel.
extern "C" int vnext_msda_bwd(const void* value, const void* loc, const void* attn,
                              const void* grad, const void* levels, void* dvalue_f32,
                              void* dloc, void* dattn, void* dvalue, int B, int Q, int S,
                              int M, int L, int P, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long warps = (long long)Q * ((M + 7) / 8);
  const dim3 grid((unsigned)((warps + kQWarps - 1) / kQWarps), (unsigned)B);
  if (grid.x > 0 && grid.y > 0) {
    msda_bwd_kernel<<<grid, kQWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(loc),
        static_cast<const __nv_bfloat16*>(attn), static_cast<const __nv_bfloat16*>(grad),
        static_cast<const int*>(levels), static_cast<float*>(dvalue_f32),
        static_cast<float*>(dloc), static_cast<__nv_bfloat16*>(dattn), Q, S, M, L, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long n4 = (long long)B * S * M * kD / 4;
  if (n4 == 0) return 0;
  const long long blocks = (n4 + 255) / 256;
  f32_to_bf16_kernel<<<(unsigned)(blocks < 65535 * 16 ? blocks : 65535 * 16), 256, 0, st>>>(
      static_cast<const float4*>(dvalue_f32), static_cast<uint2*>(dvalue), n4);
  return (int)cudaGetLastError();
}
