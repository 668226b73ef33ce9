// Deformable-encoder layer tail, fused (inference), K3:
//   h1  = LN1(src + attn)                       (f32 statistics, eps 1e-6)
//   out = LN2(h1 + W2 relu(W1 h1 + b1) + b2)    (bf16 operands, f32 accumulate)
// over token-major rows [N, 256], N = batch * tokens.
//
// Replaces the TPU kernel `_epilogue_kernel` in vnext_tpu/ops/encoder_epilogue.py
// (entry `encoder_epilogue_cm`), which ran the same tail channel-major. LayerNorm
// uses the fast variance E[x^2] - E[x]^2 as flax and the TPU kernel do; h1 stays
// f32 for the residual and is rounded to bf16 only as the first product's
// operand; the FFN activation is rounded to bf16 once, after bias and ReLU.
//
// What bounds it on the card: 2 * 2 * 256 * F FLOPs per token, 90.35 GFLOP per
// call at IDOL-R50's serving shape (N = 86170, F = 1024), against 132 MB of
// activations: the tensor cores, once the [N, F] intermediate stays on chip and
// the weights (1 MB in bf16) are fed without stalling them.
//
// Design: a persistent block per SM walks tiles of 128 tokens. Its three
// warpgroups split the work:
// - a producer warp streams the weights, repacked by the wrapper
//   (`pack_epilogue_weights`) into F/64 chunks of two 32 KB pieces, W1c
//   [64 x 256] and W2c [256 x 64], each the exact shared-memory image that
//   `wgmma` reads (K-major, 128-byte swizzle). Each piece is one 1-D
//   `cp.async.bulk` into a ring of 4 slots that completes on an mbarrier; the
//   consumers free a slot (a second mbarrier) as soon as the product reading it
//   has retired, so the next pieces load while the tensor cores run.
// - two consumer warpgroups own 64 tokens each. LN1 runs in the `wgmma`
//   accumulator layout (a row's 256 values live in the 4 lanes of a quad: a
//   per-thread partial and 2 shuffles) straight from global memory, writes h1
//   as bf16 into shared memory in the swizzled layout the first product reads,
//   and seeds the second product's 64 x 256 f32 accumulator (128 registers a
//   thread, resident for the whole tile) with h1 + b2. Per chunk, `wgmma`
//   m64n64k16 computes h1 W1c^T; bias, ReLU and the bf16 rounding happen in
//   registers, and the result is re-laid in registers as the A operand of
//   `wgmma` m64n256k16 with W2c (the accumulator's fragment of a 16-column
//   slice is exactly the A fragment of a k16 step). The intermediate touches
//   neither device nor shared memory. The next chunk's first product is issued
//   behind the current second product, so the tensor cores see them back to
//   back. LN2 runs in the accumulator layout and stages the bf16 rows in
//   shared memory (h1's space, free by then); warp 0 sends each row out with a
//   512-byte bulk store that runs while the next tile's LN1 loads.
// `setmaxnreg` moves registers from the producer warpgroup to the consumers.
// Two variants measured slower: an L2 prefetch of the next tile's rows by the
// producer, and issuing the next first product ahead of the second so that the
// activation forms under it (ptxas then serializes the wgmmas).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kC = 256;                      // d_model
constexpr int kFc = 64;                      // FFN chunk
constexpr int kRows = 64;                    // tokens per consumer warpgroup
constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kTile = kRows * kConsumers;    // tokens per tile
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kPiece = 32768;                // bytes of one W1c or W2c image
constexpr int kStages = 4;                   // ring slots, one piece each
constexpr int kOutRow = kC * 2 + 16;         // a staged output row: 512 bytes + 16 of padding
// one warpgroup's h1 (bf16, 32 KB), reused to stage its 64 output rows
constexpr int kHBytes = (kRows * kOutRow + 1023) / 1024 * 1024;
constexpr int kOffH = kStages * kPiece;
constexpr int kOffBar = kOffH + kConsumers * kHBytes;
constexpr int kSmem = kOffBar + 2 * kStages * 8 + 1024;   // + slack to align the base to 1024
constexpr float kEps = 1e-6f;

// ---- PTX wrappers (shared-space addresses are 32-bit)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" :: "r"(bar)
               : "memory");
}

// waits for the phase of `parity` to complete; a wait that outlasts ~2^34 cycles
// (seconds) traps, so that a protocol fault ends the launch with an error
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// one contiguous global -> shared copy by the bulk-copy engine, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// one contiguous shared -> global copy by the bulk-copy engine, in this thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}

// waits until this thread's bulk stores have read their shared memory (READ) or
// are done
template <bool READ>
__device__ __forceinline__ void bulk_store_wait() {
  if (READ) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving register reads or writes across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading offset is unused in this mode)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

#define VN_F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, both from shared memory
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : VN_F8(0), VN_F8(8), VN_F8(16), VN_F8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 256] += A[64 x 16] B[256 x 16]^T, A from registers, B from shared memory
__device__ __forceinline__ void wgmma_m64n256_rs(float (&d)[128], const uint32_t (&a)[16], int k,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : VN_F8(0), VN_F8(8), VN_F8(16), VN_F8(24), VN_F8(32), VN_F8(40), VN_F8(48), VN_F8(56),
        VN_F8(64), VN_F8(72), VN_F8(80), VN_F8(88), VN_F8(96), VN_F8(104), VN_F8(112), VN_F8(120)
      : "r"(a[4 * k]), "r"(a[4 * k + 1]), "r"(a[4 * k + 2]), "r"(a[4 * k + 3]), "l"(db), "r"(1));
}

#undef VN_F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Accumulator layout of a 64-row wgmma tile (per thread of the warpgroup):
// element d[4 i + 2 h + e] is row 16 * warp + lane / 4 + 8 h, column
// 8 i + 2 (lane % 4) + e. So a thread holds two rows, r0 and r0 + 8, and in each
// the column pairs 8 i + 2 (lane % 4), i = 0 .. N / 8 - 1.

__global__ void __launch_bounds__(kThreads, 1)
encoder_epilogue_kernel(const __nv_bfloat16* __restrict__ attn,  // [N, C]
                        const __nv_bfloat16* __restrict__ src,   // [N, C]
                        const float* __restrict__ ln1_w, const float* __restrict__ ln1_b,
                        const __nv_bfloat16* __restrict__ wpk,   // [F / 64, 2, 16384] packed W1c, W2c
                        const float* __restrict__ b1,            // [F]
                        const float* __restrict__ b2,            // [C]
                        const float* __restrict__ ln2_w, const float* __restrict__ ln2_b,
                        __nv_bfloat16* __restrict__ out,         // [N, C]
                        int N, int F) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of address bits 4-9: every image starts on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full_bar = ring + kOffBar;             // kStages barriers: piece landed
  const uint32_t empty_bar = full_bar + 8 * kStages;    // kStages barriers: slot free

  const int nc = F / kFc;
  const int pieces = 2 * nc;                            // per tile: W1c(0), W2c(0), W1c(1), ...
  const int tiles = (N + kTile - 1) / kTile;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread streams the pieces of every tile through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      uint32_t g = 0;   // pieces issued so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int p = 0; p < pieces; ++p, ++g) {
          const uint32_t s = g % kStages;
          if (g >= kStages) mbar_wait(empty_bar + 8 * s, (g / kStages - 1) & 1);
          mbar_expect_tx(full_bar + 8 * s, kPiece);
          bulk_load(ring + s * kPiece, reinterpret_cast<const unsigned char*>(wpk) + (size_t)p * kPiece,
                    kPiece, full_bar + 8 * s);
        }
      }
    }
    return;
  }

  // ---- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  const int t = threadIdx.x - 128 * wg;
  const int warp = t >> 5, lane = t & 31;
  const int qc = 2 * (lane & 3);                 // first column of this thread's pairs
  const int r0 = 16 * warp + (lane >> 2);        // rows r0 and r0 + 8 of the warpgroup's 64
  unsigned char* hb = smem + kOffH + cw * kHBytes;
  const uint32_t hb_addr = smem_addr(hb);

  uint32_t g = 0;   // pieces consumed so far (the producer's order)
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * kTile + cw * kRows;
    const long long n[2] = {row0 + r0, row0 + r0 + 8};
    const bool live[2] = {n[0] < N, n[1] < N};

    // ---- LN1 in the accumulator layout; acc = h1 + b2 seeds the second product
    float acc[128];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t* a32 = reinterpret_cast<const uint32_t*>(attn + (live[h] ? n[h] : 0) * kC + qc);
      const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src + (live[h] ? n[h] : 0) * kC + qc);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float2 x = make_float2(0.f, 0.f);
        if (live[h]) {
          const float2 av = unpack_bf16(__ldg(a32 + 4 * i)), sv = unpack_bf16(__ldg(s32 + 4 * i));
          x = make_float2(sv.x + av.x, sv.y + av.y);
        }
        acc[4 * i + 2 * h] = x.x;
        acc[4 * i + 2 * h + 1] = x.y;
      }
    }
    // the previous tile's products are done reading h1, and its staged output
    // rows have been read by their bulk stores
    if (warp == 0) bulk_store_wait<true>();
    wg_barrier(1 + cw);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float x0 = acc[4 * i + 2 * h], x1 = acc[4 * i + 2 * h + 1];
        sum += x0 + x1;
        sq += x0 * x0 + x1 * x1;
      }
      const float mu = quad_sum(sum) * (1.f / kC);
      const float var = fmaxf(quad_sum(sq) * (1.f / kC) - mu * mu, 0.f);
      const float rs = rsqrtf(var + kEps);
      const int r = r0 + 8 * h;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * i + qc;
        const float2 gw = __ldg(reinterpret_cast<const float2*>(ln1_w + col));
        const float2 gb = __ldg(reinterpret_cast<const float2*>(ln1_b + col));
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + col));
        const float y0 = (acc[4 * i + 2 * h] - mu) * rs * gw.x + gb.x;
        const float y1 = (acc[4 * i + 2 * h + 1] - mu) * rs * gw.y + gb.y;
        // h1 (bf16) at (r, col): 64-column atom col / 64, 16-byte group swizzled by r % 8
        const int grp = ((col & 63) >> 3) ^ (r & 7);
        *reinterpret_cast<uint32_t*>(hb + (col >> 6) * (kRows * 128) + r * 128 + grp * 16 + (col & 7) * 2) =
            pack_bf16(y0, y1);
        acc[4 * i + 2 * h] = y0 + bb.x;
        acc[4 * i + 2 * h + 1] = y1 + bb.y;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // h1 visible to wgmma
    wg_barrier(1 + cw);

    // ---- the FFN, chunk by chunk: chunk j's pieces are W1c(j) = gb + 2j and
    // W2c(j) = gb + 2j + 1 in the producer's order
    const uint32_t gb = g;
    g += pieces;
    float facc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) facc[i] = 0.f;
    // issue facc = h1 W1c^T (16 k16 steps, A and B from shared memory)
    auto first_product = [&](uint32_t piece) {
      const uint32_t s = piece % kStages;
      mbar_wait(full_bar + 8 * s, (piece / kStages) & 1);
      const uint32_t w1c = ring + s * kPiece;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        wgmma_m64n64_ss(facc, make_desc(hb_addr + (k >> 2) * (kRows * 128) + (k & 3) * 32),
                        make_desc(w1c + (k >> 2) * (kFc * 128) + (k & 3) * 32), k > 0);
      wgmma_commit();
    };
    // issue acc += a W2c^T (4 k16 steps, A from registers)
    auto second_product = [&](uint32_t piece, const uint32_t (&a)[16]) {
      const uint32_t s = piece % kStages;
      mbar_wait(full_bar + 8 * s, (piece / kStages) & 1);
      const uint32_t w2c = ring + s * kPiece;
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_m64n256_rs(acc, a, k, make_desc(w2c + k * 32));
      wgmma_commit();
    };
    // bias, ReLU, bf16: facc's 16-column slice k is the A fragment of k16 step k.
    // a[2 i] holds row r0 of columns 8 i.., a[2 i + 1] row r0 + 8, so step k takes
    // {a[4k], a[4k + 1], a[4k + 2], a[4k + 3]} = (r0, 16k..), (r0+8, 16k..),
    // (r0, 16k+8..), (r0+8, 16k+8..), the A fragment's order
    auto activation = [&](int j, uint32_t (&a)[16]) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + j * kFc + 8 * i + qc));
        a[2 * i] = pack_bf16(fmaxf(facc[4 * i] + bb.x, 0.f), fmaxf(facc[4 * i + 1] + bb.y, 0.f));
        a[2 * i + 1] = pack_bf16(fmaxf(facc[4 * i + 2] + bb.x, 0.f), fmaxf(facc[4 * i + 3] + bb.y, 0.f));
      }
    };
    auto release = [&](uint32_t piece) {
      if (t == 0) mbar_arrive(empty_bar + 8 * (piece % kStages));
    };

    wgmma_fence();
    first_product(gb);
    wgmma_wait<0>();
    fence_regs(facc);
    release(gb);
    // chunk j: the next chunk's first product runs behind this second product
    uint32_t af[16];
    for (int j = 0; j < nc; ++j) {
      activation(j, af);
      fence_regs(acc);
      fence_regs(af);
      wgmma_fence();
      second_product(gb + 2 * j + 1, af);
      if (j + 1 < nc) {
        first_product(gb + 2 * j + 2);
        wgmma_wait<1>();
        fence_regs(af);
        release(gb + 2 * j + 1);
        wgmma_wait<0>();
        fence_regs(facc);
        release(gb + 2 * j + 2);
      } else {
        wgmma_wait<0>();
        fence_regs(af);
        release(gb + 2 * j + 1);
      }
    }
    fence_regs(acc);

    // ---- LN2 in the accumulator layout, the bf16 rows staged in shared memory
    // (rows 528 bytes apart: the 8 rows of a warp's store fall in distinct banks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float x0 = acc[4 * i + 2 * h], x1 = acc[4 * i + 2 * h + 1];
        sum += x0 + x1;
        sq += x0 * x0 + x1 * x1;
      }
      const float mu = quad_sum(sum) * (1.f / kC);
      const float var = fmaxf(quad_sum(sq) * (1.f / kC) - mu * mu, 0.f);
      const float rs = rsqrtf(var + kEps);
      uint32_t* o32 = reinterpret_cast<uint32_t*>(hb + (r0 + 8 * h) * kOutRow + qc * 2);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * i + qc;
        const float2 gw = __ldg(reinterpret_cast<const float2*>(ln2_w + col));
        const float2 gb = __ldg(reinterpret_cast<const float2*>(ln2_b + col));
        o32[4 * i] = pack_bf16((acc[4 * i + 2 * h] - mu) * rs * gw.x + gb.x,
                               (acc[4 * i + 2 * h + 1] - mu) * rs * gw.y + gb.y);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to the bulk stores
    wg_barrier(1 + cw);
    // warp 0 sends the live rows out, one 512-byte bulk store each (lane l: rows
    // l and l + 32); they run while the next tile's LN1 loads
    if (warp == 0) {
#pragma unroll
      for (int rr = lane; rr < kRows; rr += 32)
        if (row0 + rr < N) bulk_store(out + (row0 + rr) * kC, hb_addr + rr * kOutRow, kC * 2);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (warp == 0) bulk_store_wait<false>();
}

}  // namespace

extern "C" int vnext_encoder_epilogue(const void* attn, const void* src, const void* ln1_w,
                                      const void* ln1_b, const void* wpk, const void* b1,
                                      const void* b2, const void* ln2_w, const void* ln2_b,
                                      void* out, int N, int F, void* stream) {
  if (F % kFc != 0 || F <= 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  // per launch, not cached: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(encoder_epilogue_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  int device = 0, sms = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)e;
  const int tiles = (N + kTile - 1) / kTile;
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);
  encoder_epilogue_kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(attn), static_cast<const __nv_bfloat16*>(src),
      static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b),
      static_cast<const __nv_bfloat16*>(wpk), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(ln2_w),
      static_cast<const float*>(ln2_b), static_cast<__nv_bfloat16*>(out), N, F);
  return (int)cudaGetLastError();
}
