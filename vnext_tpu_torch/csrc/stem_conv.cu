// ResNet stem: 7x7 / stride 2 / pad 3 convolution from 3 to 64 channels, then
// the folded frozen-BN scale and bias and ReLU, NHWC in and out.
//
// Replaces the TPU kernel `_stem_kernel` in vnext_tpu/ops/stem_conv.py (entry
// `stem_conv7x7s2_bn_relu`). As there, the operands are rounded to bf16, the
// products are exact and summed in f32, and the output is rounded to bf16 once.
//
// What bounds it on the card: bytes. At [10, 480, 864, 3] the layer reads 50 MB
// of f32 input and writes 133 MB of bf16 output (0.055 ms at 3.35 TB/s); its
// 19.5 GFLOP take 0.02 ms at the bf16 tensor-core peak but 0.29 ms on the f32
// FMA pipes, where a direct convolution puts them.
//
// Design: an implicit GEMM on the tensor cores, M = output pixels, N = 64,
// K = 147 ordered as 7 runs of 21 (one run per ky): for a fixed ky the 21
// values (kx, ci) of one output pixel lie contiguous in an NHWC input row, at
// (2*ox + kx)*3 + ci. Each run is padded to 22 and K to 160 (10 steps of
// mma.m16n8k16); the wrapper packs the weights into bf16 [64, 160] in that
// order with zeros in the padding (`pack_stem_weights` in ops/stem_conv.py).
// - Persistent blocks of 8 warps walk 16 x 32 output tiles; each holds the
//   packed weights in shared memory for all its tiles (ldmatrix for B).
// - A tile's 37 x 69 x 3 input halo arrives by cp.async in aligned 16-byte
//   pieces (zero-filled where a piece misses the image, so every even width
//   works; TMA would need W % 4 == 0), issued while the previous tile's
//   products run, then is rounded to bf16 in shared memory with zeros outside
//   the image and an even row stride.
// - With even runs and an even stride, each K pair (2p, 2p+1) of a pixel is
//   one aligned 4-byte shared load, so an A fragment is 4 loads through a
//   table of pair offsets (a run's zero column masked).
// - A warp owns one tile row of 32 pixels: 2 m-tiles x 8 n-tiles, 64 f32
//   accumulators. The epilogue (scale, bias, ReLU in f32, one bf16 rounding)
//   stages the row through swizzled shared memory, so it leaves as 4 KB of
//   coalesced 16-byte stores.
// By count, the mma.sync issue rate and the shared-memory traffic for A and B
// each take ~0.04-0.05 ms at the serving shape: with the output's bytes, what
// holds the kernel above its bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCo = 64, kCi = 3;
constexpr int kKRun = 21;                        // (kx, ci) values of one ky
constexpr int kKRunPad = 22;                     // a run and one zero column
constexpr int kK = 7 * kKRunPad;                 // 154
constexpr int kKPad = 160;                       // 10 mma k-steps of 16
constexpr int kKSteps = kKPad / 16;
constexpr int kPairs = kKPad / 2;
constexpr int kHiPad = 1 << 30;                  // pair flag: its high half is a zero column
constexpr int kWStride = 168;                    // bf16 per weight row in shared memory
constexpr int kTh = 16, kTw = 32;                // output tile (rows, cols)
constexpr int kIh = 2 * kTh + 5;                 // 37 input rows
constexpr int kIwc = (2 * kTw + 5) * kCi;        // 207 input values per halo row
constexpr int kIws = kIwc + 1;                   // bf16 halo row stride: even, so pairs are aligned
constexpr int kVecPerRow = (kIwc + 6) / 4;       // 53 float4 loads cover a halo row
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

constexpr int kWBytes = kCo * kWStride * 2;                  // 21504
constexpr int kOutBytes = kWarps * kTw * kCo * 2;            // 32768: the epilogue's rows
constexpr int kHaloBytes = kIh * kIws * 2;                   // 15392: bf16 halo
constexpr int kRawBytes = kIh * kVecPerRow * 16;             // 31376: f32 halo in flight
constexpr int kSmemBytes = kWBytes + kOutBytes + kHaloBytes + kRawBytes + kPairs * 4 + 2 * kCo * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Tile {
  int b, oy0, ox0;
};

__device__ __forceinline__ Tile tile_at(long long tile, int tiles_x, int tiles_y) {
  Tile t;
  t.b = (int)(tile / ((long long)tiles_x * tiles_y));
  t.oy0 = (int)((tile / tiles_x) % tiles_y) * kTh;
  t.ox0 = (int)(tile % tiles_x) * kTw;
  return t;
}

// element offset of halo row r's first value (input column 2*ox0 - 3) above the
// aligned float4 at or below it, where the row's copy in s_raw starts
__device__ __forceinline__ int row_shift(const Tile& t, int r, int H, int W) {
  const long long g = (((long long)t.b * H + 2 * t.oy0 - 3 + r) * W + 2 * t.ox0 - 3) * kCi;
  return (int)(((g % 4) + 4) % 4);
}

// Start copying the tile's f32 halo into s_raw: per halo row, the aligned
// float4s over its 207 values, with cp.async (16 bytes each). A float4 that
// misses the image row reads nothing and lands as zeros; one that overlaps it
// lies inside the tensor, whose size is a multiple of 4 (H and W even).
__device__ __forceinline__ void issue_halo(const float* x, unsigned char* s_raw, const Tile& t,
                                           int H, int W) {
  const long long row_elems = (long long)W * kCi;
  for (int i = threadIdx.x; i < kIh * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow, v = i % kVecPerRow;
    const int iy = 2 * t.oy0 - 3 + r;
    const long long row0 = ((long long)t.b * H + iy) * row_elems;
    const long long gstart = row0 + (long long)(2 * t.ox0 - 3) * kCi;
    const long long g0 = gstart - (((gstart % 4) + 4) % 4) + 4 * v;
    const long long lo = gstart > row0 ? gstart : row0;
    const long long hi = gstart + kIwc < row0 + row_elems ? gstart + kIwc : row0 + row_elems;
    const bool load = iy >= 0 && iy < H && g0 + 4 > lo && g0 < hi;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(s_raw + 16 * i)), "l"(load ? x + g0 : x), "r"(load ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// s_raw (f32) -> s_x (bf16, rounded once), two values per store; values outside
// the image are the convolution's zero padding, and column 207 (a pair's pad) is 0
__device__ __forceinline__ void convert_halo(const unsigned char* s_raw, unsigned short* s_x,
                                             const Tile& t, int H, int W) {
  const float* raw = reinterpret_cast<const float*>(s_raw);
  for (int i = threadIdx.x; i < kIh * (kIws / 2); i += kThreads) {
    const int r = i / (kIws / 2), e = 2 * (i % (kIws / 2));
    const int iy = 2 * t.oy0 - 3 + r;
    const int sh = row_shift(t, r, H, W);
    float f[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int ix = 2 * t.ox0 - 3 + (e + u) / kCi;
      const bool inside = e + u < kIwc && iy >= 0 && iy < H && ix >= 0 && ix < W;
      f[u] = inside ? raw[r * 4 * kVecPerRow + sh + e + u] : 0.f;
    }
    const __nv_bfloat162 pr = __floats2bfloat162_rn(f[0], f[1]);
    *reinterpret_cast<__nv_bfloat162*>(&s_x[r * kIws + e]) = pr;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
stem_conv_kernel(const float* __restrict__ x,             // [B, H, W, 3]
                 const __nv_bfloat16* __restrict__ wgt,   // [64, 160] packed
                 const float* __restrict__ scale,         // [64]
                 const float* __restrict__ bias,          // [64]
                 __nv_bfloat16* __restrict__ out,         // [B, H/2, W/2, 64]
                 int B, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* s_w = reinterpret_cast<unsigned short*>(smem);
  unsigned char* s_out = smem + kWBytes;
  unsigned short* s_x = reinterpret_cast<unsigned short*>(smem + kWBytes + kOutBytes);
  unsigned char* s_raw = smem + kWBytes + kOutBytes + kHaloBytes;
  int* s_pair = reinterpret_cast<int*>(s_raw + kRawBytes);
  float* s_scale = reinterpret_cast<float*>(s_pair + kPairs);
  float* s_bias = s_scale + kCo;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int HO = H / 2, WO = W / 2;
  const int tiles_x = (WO + kTw - 1) / kTw, tiles_y = (HO + kTh - 1) / kTh;
  const long long tiles = (long long)B * tiles_x * tiles_y;

  // the first tile's halo starts moving before anything else
  if (blockIdx.x < tiles) issue_halo(x, s_raw, tile_at(blockIdx.x, tiles_x, tiles_y), H, W);

  // the packed weights, the K pair table, scale and bias: once per block
  for (int i = tid; i < kCo * (kKPad / 8); i += kThreads) {
    const int n = i / (kKPad / 8), c = i % (kKPad / 8);
    *reinterpret_cast<uint4*>(&s_w[n * kWStride + 8 * c]) =
        __ldg(reinterpret_cast<const uint4*>(wgt) + i);
  }
  // K pair (2p, 2p + 1) -> halo offset of its first value from the pixel's
  // corner (ky rows down, j = 2p % 22 values right), -1 past K
  for (int p = tid; p < kPairs; p += kThreads) {
    const int ky = 2 * p / kKRunPad, j = 2 * p % kKRunPad;
    s_pair[p] = 2 * p < kK ? (ky * kIws + j) | (j + 1 == kKRun ? kHiPad : 0) : -1;
  }
  if (tid < kCo) {
    s_scale[tid] = scale[tid];
    s_bias[tid] = bias[tid];
  }

  // this lane's ldmatrix row of B: n = 16*jp + 8*(mat >> 1) + row, k = 8*(mat & 1)
  const int mat = lane >> 3;
  const uint32_t b_lane = smem_addr(&s_w[(8 * (mat >> 1) + (lane & 7)) * kWStride + 8 * (mat & 1)]);
  unsigned char* orow_s = s_out + warp * (kTw * kCo * 2);

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_at(tile, tiles_x, tiles_y);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();   // this tile's halo has landed; the previous tile's A reads are done
    convert_halo(s_raw, s_x, tl, H, W);
    __syncthreads();   // s_x holds the tile; s_raw is free
    if (tile + gridDim.x < tiles)   // the next tile's halo moves during this tile's products
      issue_halo(x, s_raw, tile_at(tile + gridDim.x, tiles_x, tiles_y), H, W);

    for (int rr = warp; rr < kTh; rr += kWarps) {
      const int oy = tl.oy0 + rr;
      if (oy >= HO) break;
      float acc[2][8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;

      // pixel (rr, c) in the halo: 2*rr rows down, 2*c columns right (an even element)
      const unsigned short* px[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        px[mt][0] = s_x + 2 * rr * kIws + 6 * (16 * mt + g);
        px[mt][1] = px[mt][0] + 6 * 8;
      }

#pragma unroll 2
      for (int ks = 0; ks < kKSteps; ++ks) {
        // this lane's K pairs: k = 16*ks + 2t and k + 8, each one aligned 4-byte load
        const int o[2] = {s_pair[8 * ks + t], s_pair[8 * ks + t + 4]};
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t v = 0u;
              if (o[j] >= 0) v = *reinterpret_cast<const uint32_t*>(px[mt][h] + (o[j] & 0xffff));
              if (o[j] & kHiPad) v &= 0xffffu;
              a[mt][2 * j + h] = v;   // a0: row g, a1: row g+8 (k 2t..); a2, a3: k 2t+8..
            }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t b0, b1, b2, b3;
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                       : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
                       : "r"(b_lane + (uint32_t)((16 * jp * kWStride + 16 * ks) * 2)));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * jp], a[mt], b0, b1);
            mma_bf16(acc[mt][2 * jp + 1], a[mt], b2, b3);
          }
        }
      }

      // epilogue: y = relu(acc * scale + bias) in f32, one bf16 rounding, staged with
      // 16-byte chunk c of pixel p at chunk c ^ (p & 7) (no bank conflicts either way)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int ch = 8 * nt + 2 * t;
        const float2 sc = *reinterpret_cast<const float2*>(&s_scale[ch]);
        const float2 bi = *reinterpret_cast<const float2*>(&s_bias[ch]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = 16 * mt + 8 * h + g;
            const float y0 = fmaxf(__fadd_rn(__fmul_rn(acc[mt][nt][2 * h], sc.x), bi.x), 0.f);
            const float y1 = fmaxf(__fadd_rn(__fmul_rn(acc[mt][nt][2 * h + 1], sc.y), bi.y), 0.f);
            const __nv_bfloat162 yb = __floats2bfloat162_rn(y0, y1);
            *reinterpret_cast<__nv_bfloat162*>(orow_s + p * 128 + ((nt ^ (p & 7)) * 16) + 4 * t) = yb;
          }
      }
      __syncwarp();
      const int npix = WO - tl.ox0 < kTw ? WO - tl.ox0 : kTw;
      __nv_bfloat16* orow = out + (((long long)tl.b * HO + oy) * WO + tl.ox0) * kCo;
#pragma unroll
      for (int it = 0; it < kTw * 8 / 32; ++it) {
        const int i = it * 32 + lane;
        const int p = i >> 3, c = i & 7;
        if (p < npix)
          *reinterpret_cast<uint4*>(orow + p * kCo + 8 * c) =
              *reinterpret_cast<const uint4*>(orow_s + p * 128 + ((c ^ (p & 7)) * 16));
      }
      __syncwarp();
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" int vnext_stem_conv(const void* x, const void* w, const void* scale, const void* bias,
                               void* out, int B, int H, int W, void* stream) {
  // the grid fills every SM with as many persistent blocks as fit; asked once per device
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices], per_sm[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(stem_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], stem_conv_kernel, kThreads,
                                                          kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm[dev] < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const int HO = H / 2, WO = W / 2;
  const long long tiles = (long long)B * ((WO + kTw - 1) / kTw) * ((HO + kTh - 1) / kTh);
  const long long slots = (long long)sms[dev] * per_sm[dev];
  const unsigned grid = (unsigned)(tiles < slots ? tiles : slots);
  if (grid == 0) return 0;
  stem_conv_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), B, H, W);
  return (int)cudaGetLastError();
}
