// Read-modify-write accumulate at a data-dependent row offset (K9).
//
// Replaces the probe kernel `kernel` in tools/exp_dynstore.py, which checks
// that a Pallas TPU kernel can add a block into its output at a row offset it
// computes itself, revisiting the same output block across the grid's steps.
// Per batch element b and step t = 0 .. T-1, in that order:
//
//     r0 = (sum_{i<8} int32(r[b, 8t + i, 0])) // T          (floor division)
//     out[b, start : start + HB*D, :] += float(x[b, :HB*D, :]) + 1
//
// with out zeroed before t = 0 and start = r0 * D placed as the probe's
// `pl.ds` places it: a negative start counts from the end of the H*D rows (as a
// negative index does), and the block is then clamped inside them.
//
// On the TPU the steps run in order on one core and carry the sum in VMEM. On
// the card the blocks run in parallel in no order, so the sequential axis is a
// loop inside the thread: one thread owns one output column of one batch
// element and walks the steps in order, so every read-modify-write of an
// element is its own and the result is deterministic. What bounds it: nothing
// at the probe's size (16 KB of x and 256 B of r read, 128 KB out); it is a
// launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRowsPerStep = 8;   // rows of r each step reads (the probe's r block)
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
dynstore_kernel(const __nv_bfloat16* __restrict__ x,  // [B, H*D, W]
                const float* __restrict__ r,          // [B, T*8, W]
                float* __restrict__ out,              // [B, H*D, W]
                int rows, int W, int T, int D, int block_rows) {
  const int b = blockIdx.y;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= W) return;
  const __nv_bfloat16* xb = x + (long long)b * rows * W + col;
  const float* rb = r + (long long)b * T * kRowsPerStep * W;
  float* ob = out + (long long)b * rows * W + col;
  for (int i = 0; i < rows; ++i) ob[(long long)i * W] = 0.f;
  for (int t = 0; t < T; ++t) {
    int sum = 0;
    for (int i = 0; i < kRowsPerStep; ++i) {
      sum += (int)rb[(long long)(kRowsPerStep * t + i) * W];   // truncates, as astype(int32)
    }
    int r0 = sum / T;
    if (sum % T != 0 && (sum < 0) != (T < 0)) --r0;            // floor, as jnp's //
    int start = r0 * D;
    if (start < 0) start += rows;
    start = min(max(start, 0), rows - block_rows);
    for (int i = 0; i < block_rows; ++i) {
      ob[(long long)(start + i) * W] += __bfloat162float(xb[(long long)i * W]) + 1.f;
    }
  }
}

}  // namespace

extern "C" int vnext_dynstore(const void* x, const void* r, void* out, int B, int rows, int W,
                              int T, int D, int block_rows, void* stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  dynstore_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(r),
      static_cast<float*>(out), rows, W, T, D, block_rows);
  return (int)cudaGetLastError();
}
