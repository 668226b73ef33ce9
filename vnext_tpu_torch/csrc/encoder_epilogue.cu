// Deformable-encoder layer tail, fused (inference):
//   h1  = LN1(src + attn)                       (f32 statistics, eps 1e-6)
//   out = LN2(h1 + W2 relu(W1 h1 + b1) + b2)    (bf16 operands, f32 accumulate)
// over token-major rows [N, 256], N = batch * tokens.
//
// Replaces the TPU kernel `_epilogue_kernel` in vnext_tpu/ops/encoder_epilogue.py
// (entry `encoder_epilogue_cm`), which ran the same tail channel-major. LayerNorm
// uses the fast variance E[x^2] - E[x]^2 as flax and the TPU kernel do; h1 stays
// f32 for the residual and is rounded to bf16 only as a matmul operand; the FFN
// activation is rounded to bf16 after bias and ReLU, as on the TPU.
//
// What bounds it on the card: 2 * 2 * 256 * 1024 FLOPs per token, ~90 GFLOP per
// layer at IDOL-R50 eval shapes (N = 86170), against 3 * 44 MB of activations
// moved, so it is matrix-unit bound once the [N, 1024] intermediate stays on
// chip. Design: one 256-thread block per 64-token tile. LN1 writes h1 (bf16) and
// h1 + b2 (f32) to shared memory; the f32 copy seeds the second product's
// accumulators, which live in registers (WMMA 16x16x16 bf16 fragments, 8 per
// warp) for the whole tile. The 1024-wide FFN dimension is walked in chunks of
// 64: the chunk's W1 rows and W2 columns (torch layouts, 64 KB, L2-resident) are
// staged in shared memory, h1 x W1c goes through f32 fragments to shared
// memory, bias + ReLU + bf16 rounding make the A operand of the second product,
// and the intermediate never reaches device memory. LN2 then runs on the f32
// result staged back in shared memory. The staging is synchronous: no TMA,
// wgmma or double buffering yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kC = 256;          // d_model
constexpr int kFc = 64;          // FFN chunk
constexpr int kTm = 64;          // tokens per block
constexpr int kThreads = 256;    // 8 warps
constexpr float kEps = 1e-6f;

constexpr int kLdH = kC + 8;     // h1 bf16       [kTm][kLdH]
constexpr int kLdW1 = kC + 8;    // W1 chunk bf16 [kFc][kLdW1]  (rows f, cols c)
constexpr int kLdFb = kFc + 8;   // relu(ff) bf16 [kTm][kLdFb]
constexpr int kLdW2 = kFc + 8;   // W2 chunk bf16 [kC][kLdW2]   (rows c, cols f)
constexpr int kLdY = kC + 4;     // f32 staging   [kTm][kLdY]
constexpr int kLdF = kFc + 4;    // ff f32        [kTm][kLdF], aliases the staging

constexpr int kOffH = 0;
constexpr int kOffW1 = kOffH + kTm * kLdH * 2;
constexpr int kOffFb = kOffW1 + kFc * kLdW1 * 2;
constexpr int kOffW2 = kOffFb + kTm * kLdFb * 2;
constexpr int kOffY = kOffW2 + kC * kLdW2 * 2;
constexpr int kSmem = kOffY + kTm * kLdY * 4;
static_assert(kOffW1 % 32 == 0 && kOffFb % 32 == 0 && kOffW2 % 32 == 0 && kOffY % 32 == 0,
              "WMMA tiles need 32-byte aligned bases");
static_assert(kTm * kLdF <= kTm * kLdY, "ff staging must fit in the f32 staging area");

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__global__ void __launch_bounds__(kThreads)
encoder_epilogue_kernel(const __nv_bfloat16* __restrict__ attn,  // [N, C]
                        const __nv_bfloat16* __restrict__ src,   // [N, C]
                        const float* __restrict__ ln1_w, const float* __restrict__ ln1_b,
                        const __nv_bfloat16* __restrict__ w1,    // [F, C] (linear1.weight)
                        const float* __restrict__ b1,            // [F]
                        const __nv_bfloat16* __restrict__ w2,    // [C, F] (linear2.weight)
                        const float* __restrict__ b2,            // [C]
                        const float* __restrict__ ln2_w, const float* __restrict__ ln2_b,
                        __nv_bfloat16* __restrict__ out,         // [N, C]
                        int N, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(smem + kOffH);
  __nv_bfloat16* s_w1 = reinterpret_cast<__nv_bfloat16*>(smem + kOffW1);
  __nv_bfloat16* s_fb = reinterpret_cast<__nv_bfloat16*>(smem + kOffFb);
  __nv_bfloat16* s_w2 = reinterpret_cast<__nv_bfloat16*>(smem + kOffW2);
  float* s_y = reinterpret_cast<float*>(smem + kOffY);
  float* s_f = s_y;  // ff staging reuses the f32 area while the sums live in registers

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * kTm;
  const int c0 = lane * 8;  // this lane's 8 channels in the LayerNorm passes

  // ---- LN1: warp w normalizes rows 8w .. 8w+7
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    const long long n = row0 + r;
    float h[8];
    if (n < N) {
      float a[8], s[8];
      unpack8(*reinterpret_cast<const uint4*>(attn + n * kC + c0), a);
      unpack8(*reinterpret_cast<const uint4*>(src + n * kC + c0), s);
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        h[i] = a[i] + s[i];
        sum += h[i];
        sq += h[i] * h[i];
      }
      const float mu = warp_sum(sum) * (1.f / kC);
      const float var = fmaxf(warp_sum(sq) * (1.f / kC) - mu * mu, 0.f);
      const float rs = rsqrtf(var + kEps);
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = (h[i] - mu) * rs * ln1_w[c0 + i] + ln1_b[c0 + i];
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = 0.f;
    }
    *reinterpret_cast<uint4*>(s_h + r * kLdH + c0) = pack8(h);
#pragma unroll
    for (int i = 0; i < 8; ++i) s_y[r * kLdY + c0 + i] = h[i] + b2[c0 + i];
  }
  __syncthreads();

  // second-product accumulators: warp w owns rows 16*(w/2).., cols 128*(w%2)..
  const int rb = warp >> 1;
  const int cb2 = (warp & 1) * 128;
  FragC yacc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wmma::load_matrix_sync(yacc[j], s_y + rb * 16 * kLdY + cb2 + j * 16, kLdY, wmma::mem_row_major);

  // first-product tile of this warp: rows 16*(w/2).., cols 32*(w%2)..
  const int cb1 = (warp & 1) * 32;
  for (int f0 = 0; f0 < F; f0 += kFc) {
    __syncthreads();  // previous chunk is done with s_w1, s_w2, s_fb (and yacc loads)
    for (int i = tid; i < kFc * (kC / 8); i += kThreads) {
      const int r = i / (kC / 8), q = i % (kC / 8);
      *reinterpret_cast<uint4*>(s_w1 + r * kLdW1 + 8 * q) =
          *reinterpret_cast<const uint4*>(w1 + (long long)(f0 + r) * kC + 8 * q);
    }
    for (int i = tid; i < kC * (kFc / 8); i += kThreads) {
      const int r = i / (kFc / 8), q = i % (kFc / 8);
      *reinterpret_cast<uint4*>(s_w2 + r * kLdW2 + 8 * q) =
          *reinterpret_cast<const uint4*>(w2 + (long long)r * F + f0 + 8 * q);
    }
    __syncthreads();

    FragC facc[2];
    wmma::fill_fragment(facc[0], 0.f);
    wmma::fill_fragment(facc[1], 0.f);
#pragma unroll 4
    for (int k = 0; k < kC; k += 16) {
      FragA a;
      wmma::load_matrix_sync(a, s_h + rb * 16 * kLdH + k, kLdH);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB bm;
        wmma::load_matrix_sync(bm, s_w1 + (cb1 + j * 16) * kLdW1 + k, kLdW1);
        wmma::mma_sync(facc[j], a, bm, facc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s_f + rb * 16 * kLdF + cb1 + j * 16, facc[j], kLdF, wmma::mem_row_major);
    __syncthreads();

    for (int i = tid; i < kTm * kFc; i += kThreads) {
      const int r = i / kFc, c = i % kFc;
      s_fb[r * kLdFb + c] = __float2bfloat16(fmaxf(s_f[r * kLdF + c] + b1[f0 + c], 0.f));
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kFc; k += 16) {
      FragA a;
      wmma::load_matrix_sync(a, s_fb + rb * 16 * kLdFb + k, kLdFb);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        FragB bm;
        wmma::load_matrix_sync(bm, s_w2 + (cb2 + j * 16) * kLdW2 + k, kLdW2);
        wmma::mma_sync(yacc[j], a, bm, yacc[j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wmma::store_matrix_sync(s_y + rb * 16 * kLdY + cb2 + j * 16, yacc[j], kLdY, wmma::mem_row_major);
  __syncthreads();

  // ---- LN2 and the bf16 store
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    const long long n = row0 + r;
    if (n >= N) break;
    float y[8];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      y[i] = s_y[r * kLdY + c0 + i];
      sum += y[i];
      sq += y[i] * y[i];
    }
    const float mu = warp_sum(sum) * (1.f / kC);
    const float var = fmaxf(warp_sum(sq) * (1.f / kC) - mu * mu, 0.f);
    const float rs = rsqrtf(var + kEps);
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = (y[i] - mu) * rs * ln2_w[c0 + i] + ln2_b[c0 + i];
    *reinterpret_cast<uint4*>(out + n * kC + c0) = pack8(y);
  }
}

}  // namespace

extern "C" int vnext_encoder_epilogue(const void* attn, const void* src, const void* ln1_w,
                                      const void* ln1_b, const void* w1, const void* b1,
                                      const void* w2, const void* b2, const void* ln2_w,
                                      const void* ln2_b, void* out, int N, int F,
                                      void* stream) {
  if (F % kFc != 0) return (int)cudaErrorInvalidValue;
  // per launch, not cached: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(encoder_epilogue_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((N + kTm - 1) / kTm);
  encoder_epilogue_kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(attn), static_cast<const __nv_bfloat16*>(src),
      static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(ln2_w), static_cast<const float*>(ln2_b),
      static_cast<__nv_bfloat16*>(out), N, F);
  return (int)cudaGetLastError();
}
