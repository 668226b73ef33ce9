// ResNet stem: 7x7 / stride 2 / pad 3 convolution from 3 to 64 channels, then
// the folded frozen-BN scale and bias and ReLU, NHWC in and out.
//
// Replaces the TPU kernel `_stem_kernel` in vnext_tpu/ops/stem_conv.py (entry
// `stem_conv7x7s2_bn_relu`). As there, the operands are rounded to bf16 (the
// TPU wrapper casts the input and the kernel to bf16 before its matmuls), the
// products are summed in f32, and the output is bf16.
//
// What bounds it on the card: the reduction is only K = 7*7*3 = 147 deep, so a
// matrix unit buys little; at [10, 480, 864, 3] the layer is 19.5 GFLOP against
// 50 MB read and 133 MB written, i.e. it is bound by the FMA issue rate and the
// shared-memory traffic that feeds it, then by the output write. Design: a
// direct convolution. Each 256-thread block owns an 8 x 16 tile of output pixels
// and all 64 channels; the 147 x 64 weights and the tile's 21 x 37 x 3 input
// halo (zero padded, bf16-rounded) sit in shared memory as f32; each thread keeps
// 8 pixels x 4 channels of f32 accumulators, so one float4 weight read and eight
// broadcast input reads feed 32 FMAs. The epilogue writes 4 channels (8 bytes)
// per pixel per thread; 16 threads cover one pixel's contiguous 128-byte row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kCo = 64, kK = 7, kCi = 3;
constexpr int kTh = 8, kTw = 16;                 // output tile (rows, cols)
constexpr int kIh = 2 * kTh + kK - 2;            // 21 input rows
constexpr int kIw = 2 * kTw + kK - 2;            // 37 input cols
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stem_conv_kernel(const float* __restrict__ x,             // [B, H, W, 3]
                 const __nv_bfloat16* __restrict__ wgt,   // [7, 7, 3, 64] (HWIO)
                 const float* __restrict__ scale,         // [64]
                 const float* __restrict__ bias,          // [64]
                 __nv_bfloat16* __restrict__ out,         // [B, H/2, W/2, 64]
                 int H, int W) {
  __shared__ __align__(16) float s_w[kK * kK * kCi * kCo];
  __shared__ float s_x[kIh][kIw][kCi];

  const int HO = H / 2, WO = W / 2;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kTh, ox0 = blockIdx.x * kTw;
  const int iy0 = 2 * oy0 - 3, ix0 = 2 * ox0 - 3;
  const int tid = threadIdx.x;

  for (int i = tid; i < kK * kK * kCi * kCo; i += kThreads) s_w[i] = __bfloat162float(wgt[i]);
  const float* xb = x + (long long)b * H * W * kCi;
  for (int i = tid; i < kIh * kIw * kCi; i += kThreads) {
    const int r = i / (kIw * kCi), rem = i % (kIw * kCi);
    const int c = rem / kCi, ch = rem % kCi;
    const int iy = iy0 + r, ix = ix0 + c;
    float v = 0.f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) v = xb[((long long)iy * W + ix) * kCi + ch];
    s_x[r][c][ch] = __bfloat162float(__float2bfloat16(v));
  }
  __syncthreads();

  const int cg = tid & 15;   // channels 4*cg .. 4*cg+3
  const int pc = tid >> 4;   // output column within the tile; rows 0..7
  float acc[kTh][4];
#pragma unroll
  for (int r = 0; r < kTh; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;

  for (int ky = 0; ky < kK; ++ky) {
    for (int kx = 0; kx < kK; ++kx) {
#pragma unroll
      for (int ci = 0; ci < kCi; ++ci) {
        const float4 wv =
            *reinterpret_cast<const float4*>(&s_w[((ky * kK + kx) * kCi + ci) * kCo + 4 * cg]);
#pragma unroll
        for (int r = 0; r < kTh; ++r) {
          const float xv = s_x[2 * r + ky][2 * pc + kx][ci];
          acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
          acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
          acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
          acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
        }
      }
    }
  }

  float sc[4], bi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sc[k] = scale[4 * cg + k];
    bi[k] = bias[4 * cg + k];
  }
  const int ox = ox0 + pc;
#pragma unroll
  for (int r = 0; r < kTh; ++r) {
    const int oy = oy0 + r;
    if (oy >= HO || ox >= WO) continue;
    __nv_bfloat162 lo = __floats2bfloat162_rn(fmaxf(acc[r][0] * sc[0] + bi[0], 0.f),
                                              fmaxf(acc[r][1] * sc[1] + bi[1], 0.f));
    __nv_bfloat162 hi = __floats2bfloat162_rn(fmaxf(acc[r][2] * sc[2] + bi[2], 0.f),
                                              fmaxf(acc[r][3] * sc[3] + bi[3], 0.f));
    uint2 packed;
    packed.x = *reinterpret_cast<unsigned*>(&lo);
    packed.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(&out[(((long long)b * HO + oy) * WO + ox) * kCo + 4 * cg]) = packed;
  }
}

}  // namespace

extern "C" int vnext_stem_conv(const void* x, const void* w, const void* scale, const void* bias,
                               void* out, int B, int H, int W, void* stream) {
  const int HO = H / 2, WO = W / 2;
  dim3 grid((WO + kTw - 1) / kTw, (HO + kTh - 1) / kTh, B);
  stem_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, W);
  return (int)cudaGetLastError();
}
