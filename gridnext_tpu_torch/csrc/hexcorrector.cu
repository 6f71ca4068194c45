// Hex corrector: one radius-1 hex convolution layer over (B, H, W, C) f32
// odd-right grids, with bias and an optional ReLU; the labels variant of the
// last layer also takes argmax+1 and masks background cells to 0.
//
// Replaces the TPU kernels gridnext_tpu/ops/hexcorrector_pallas.py
// fused_hex_corrector and fused_hex_corrector_labels (one pallas_call at
// :165 that ran all five layers in VMEM). The caller folds BatchNorm into
// the weights first and launches one layer at a time.
//
// Bound: operations. Per 78x64 grid the corrector does ~246 MFLOP of f32
// multiply-adds on ~150 KB of input; the CUDA cores (no tensor cores in
// f32 here) are the limit. Design: one thread per (cell, group of G output
// channels); the layer's (7, C_in, C_out) weights and bias sit in shared
// memory (28 KB at 32 x 32), read by all threads of a warp at few distinct
// addresses; accumulation is f32 in registers, taps in HEX_TAPS_R1 order,
// input channels ascending, bias first (the Pallas kernel's order). Between
// layers the 639 KB (78, 64, 32) intermediate goes through device memory
// and stays in L2. Fusing the five layers into one launch (row bands with a
// halo, or a thread-block cluster sharing the grid in distributed shared
// memory) is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// HEX_TAPS_R1 (geometry.py): (dr, dc for an even row, dc for an odd row)
__constant__ int kTapDr[7] = {0, 0, 0, -1, -1, 1, 1};
__constant__ int kTapDcEven[7] = {0, -1, 1, -1, 0, -1, 0};
__constant__ int kTapDcOdd[7] = {0, -1, 1, 0, 1, 0, 1};

constexpr int kThreads = 256;
constexpr int kGroup = 8;         // output channels per thread, logits layers
constexpr int kMaxClasses = 32;   // output channels per thread, labels layer

// Loads the layer's weights (7 * c_in * c_out) and bias (c_out) into shared memory.
__device__ __forceinline__ void load_weights(const float* __restrict__ wgt,
                                             const float* __restrict__ bias,
                                             int c_in, int c_out, float* smem) {
  const int n_w = 7 * c_in * c_out;
  for (int k = threadIdx.x; k < n_w; k += blockDim.x) smem[k] = wgt[k];
  for (int k = threadIdx.x; k < c_out; k += blockDim.x) smem[n_w + k] = bias[k];
  __syncthreads();
}

// acc[j] = bias[co0 + j] + sum over taps and input channels, for
// j < min(G, c_out - co0). Cells outside the grid contribute zero.
template <int G>
__device__ __forceinline__ void hex_cell(const float* __restrict__ x, const float* smem,
                                         int h, int w, int c_in, int c_out,
                                         int64_t bi, int r, int c, int co0, float (&acc)[G]) {
  const float* sb = smem + 7 * c_in * c_out;
#pragma unroll
  for (int j = 0; j < G; ++j) acc[j] = (co0 + j < c_out) ? sb[co0 + j] : 0.f;
  const bool odd = (r & 1) != 0;
#pragma unroll
  for (int t = 0; t < 7; ++t) {
    const int rr = r + kTapDr[t];
    const int cc = c + (odd ? kTapDcOdd[t] : kTapDcEven[t]);
    if (rr < 0 || rr >= h || cc < 0 || cc >= w) continue;
    const float* xin = x + ((bi * h + rr) * w + cc) * c_in;
    const float* wt = smem + t * c_in * c_out + co0;
    for (int ci = 0; ci < c_in; ++ci) {
      const float v = __ldg(xin + ci);
      const float* wrow = wt + ci * c_out;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (co0 + j < c_out) acc[j] = fmaf(v, wrow[j], acc[j]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hex_layer_kernel(const float* __restrict__ x, const float* __restrict__ wgt,
                 const float* __restrict__ bias, int nb, int h, int w, int c_in,
                 int c_out, int relu, float* __restrict__ out) {
  extern __shared__ float smem[];
  load_weights(wgt, bias, c_in, c_out, smem);
  const int groups = (c_out + kGroup - 1) / kGroup;
  const int64_t total = static_cast<int64_t>(nb) * h * w * groups;
  for (int64_t item = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       item < total; item += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int g = static_cast<int>(item % groups);  // fastest: a warp writes contiguous cells
    const int64_t cell = item / groups;
    const int c = static_cast<int>(cell % w);
    const int r = static_cast<int>((cell / w) % h);
    const int64_t bi = cell / (static_cast<int64_t>(w) * h);
    const int co0 = g * kGroup;
    float acc[kGroup];
    hex_cell<kGroup>(x, smem, h, w, c_in, c_out, bi, r, c, co0, acc);
    float* o = out + cell * c_out + co0;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (co0 + j < c_out) o[j] = relu ? fmaxf(acc[j], 0.f) : acc[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hex_labels_kernel(const float* __restrict__ x, const float* __restrict__ wgt,
                  const float* __restrict__ bias, const int32_t* __restrict__ fg,
                  int nb, int h, int w, int c_in, int c_out, int relu,
                  int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  load_weights(wgt, bias, c_in, c_out, smem);
  const int64_t total = static_cast<int64_t>(nb) * h * w;
  for (int64_t cell = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       cell < total; cell += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(cell % w);
    const int r = static_cast<int>((cell / w) % h);
    const int64_t bi = cell / (static_cast<int64_t>(w) * h);
    float acc[kMaxClasses];
    hex_cell<kMaxClasses>(x, smem, h, w, c_in, c_out, bi, r, c, 0, acc);
    // argmax with a strict '>': ties resolve to the first index, as jnp.argmax
    int best = 0;
    float best_v = relu ? fmaxf(acc[0], 0.f) : acc[0];
#pragma unroll
    for (int j = 1; j < kMaxClasses; ++j) {
      if (j < c_out) {
        const float v = relu ? fmaxf(acc[j], 0.f) : acc[j];
        if (v > best_v) {
          best_v = v;
          best = j;
        }
      }
    }
    out[cell] = fg[cell] > 0 ? best + 1 : 0;
  }
}

int num_blocks(int64_t items) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t needed = (items + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 2;
  return static_cast<int>(needed < cap ? (needed > 0 ? needed : 1) : cap);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One hex-conv layer: x (nb, h, w, c_in) f32 -> out (nb, h, w, c_out) f32;
// weight (7, c_in, c_out), bias (c_out). Returns cudaGetLastError().
extern "C" int hex_layer_f32(const void* x, const void* weight, const void* bias, int nb,
                             int h, int w, int c_in, int c_out, int relu, void* out,
                             void* stream) {
  const size_t smem = (static_cast<size_t>(7) * c_in * c_out + c_out) * sizeof(float);
  if (int err = set_smem(hex_layer_kernel, smem)) return err;
  const int64_t items = static_cast<int64_t>(nb) * h * w * ((c_out + kGroup - 1) / kGroup);
  hex_layer_kernel<<<num_blocks(items), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(weight),
      static_cast<const float*>(bias), nb, h, w, c_in, c_out, relu, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The last layer with argmax + background mask: fg (nb, h, w) int32 ->
// out (nb, h, w) int32 labels, 0 background, 1..c_out foreground.
// Needs c_out <= 32 (all logits of a cell live in one thread's registers).
extern "C" int hex_layer_labels_f32(const void* x, const void* weight, const void* bias,
                                    const void* fg, int nb, int h, int w, int c_in,
                                    int c_out, int relu, void* out, void* stream) {
  if (c_out < 1 || c_out > kMaxClasses) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(7) * c_in * c_out + c_out) * sizeof(float);
  if (int err = set_smem(hex_labels_kernel, smem)) return err;
  const int64_t items = static_cast<int64_t>(nb) * h * w;
  hex_labels_kernel<<<num_blocks(items), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<const int32_t*>(fg), nb, h, w, c_in, c_out,
      relu, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
