// The card's rate for mma.sync.m16n8k8 TF32 (the instruction of the FAVOR
// kernel, gridnext_tpu_torch/csrc/favor.cu), with no device-memory traffic:
// each warp issues `iters` rounds of 12 products into 4 accumulators.
//   mode 0: the products alone, operands fixed in registers;
//   mode 1: as the FAVOR kernel issues them: per round, 8 B values split
//           into TF32 hi and lo (an AND and a subtract each) and 3
//           products (lo hi, hi lo, hi hi) per accumulator;
//   mode 2: mode 1 with the 8 B values loaded from shared memory first.
// Built and run by tools/time_favor.py --peak.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <int MODE>
__global__ void mma_tf32_loop(float* out, int iters) {
  __shared__ float s[32 * 9];
  for (int i = threadIdx.x; i < 32 * 9; i += blockDim.x) s[i] = 1.f + i * 1e-3f;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const uint32_t a_hi[4] = {0x3f800000u, 0x3f000000u, 0x3e800000u, 0x3f800000u};
  const uint32_t a_lo[4] = {0x33800000u, 0x33000000u, 0x32800000u, 0x33800000u};
  float c[4][4] = {};
  float bx[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) bx[j][0] = bx[j][1] = 0.5f + lane * 1e-3f + j;
  for (int i = 0; i < iters; ++i) {
    uint32_t b_hi[4][2], b_lo[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (MODE == 2) {
        bx[j][0] = s[(lane * 9 + j + i) & 255];
        bx[j][1] = s[(lane * 9 + j + 4 + i) & 255];
      }
      if (MODE == 0) {
        b_hi[j][0] = b_lo[j][0] = b_hi[j][1] = b_lo[j][1] = 0x3f800000u;
      } else {
        split(bx[j][0] + i, b_hi[j][0], b_lo[j][0]);
        split(bx[j][1] + i, b_hi[j][1], b_lo[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(c[j], a_lo, b_hi[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(c[j], a_hi, b_lo[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(c[j], a_hi, b_hi[j]);
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

template <int MODE>
void run(int blocks, int threads, int iters, float* out) {
  mma_tf32_loop<MODE><<<blocks, threads>>>(out, iters);
}

}  // namespace

// Runs the loop of `mode` on `blocks` x `threads` threads (out holds one
// float per thread) and returns its CUDA-event milliseconds in *ms; the
// return value is the CUDA error code.
extern "C" int mma_tf32_peak(int mode, int blocks, int threads, int iters, void* out,
                             float* ms) {
  auto* o = static_cast<float*>(out);
  void (*fn)(int, int, int, float*) = mode == 0 ? run<0> : mode == 1 ? run<1> : run<2>;
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  fn(blocks, threads, iters, o);   // warm-up
  cudaEventRecord(start);
  fn(blocks, threads, iters, o);
  cudaEventRecord(end);
  cudaEventSynchronize(end);
  cudaEventElapsedTime(ms, start, end);
  cudaEventDestroy(start);
  cudaEventDestroy(end);
  return static_cast<int>(cudaGetLastError());
}
