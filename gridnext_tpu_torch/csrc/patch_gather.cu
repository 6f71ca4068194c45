// Patch gather: one window x window x 3 uint8 crop per spot from a stack of
// raw (B, H, W, 3) uint8 slides.
//
// Replaces the TPU kernel gridnext_tpu/ops/patch_gather_pallas.py
// gather_patches (pallas_call at :214). That kernel packed RGB into int32
// lanes and DMA'd lane-aligned superblocks, because of the TPU's (8, 128)
// tiling; on Hopper neither is needed, so this kernel reads the raw slide.
//
// Bound: bytes. Each crop is read once and written once, 2 * N * w * w * 3
// bytes in all, with no arithmetic. Design: one block per (spot, group of
// kRowsPerBlock rows); consecutive threads copy consecutive bytes of each
// w*3-byte row, so every warp reads and writes whole 32-byte sectors. The
// corner and the slide index are clamped here, as lax.dynamic_slice and the
// JAX wrapper clamp them. All offsets are 64-bit: a batch of four slides at
// 0.25 GB each is close to 2^31 bytes.
// Later work: 16-byte vector copies (unaligned source rows need a funnel
// shift) or TMA tile loads.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
gather_patches_kernel(const uint8_t* __restrict__ imgs, int64_t b, int64_t h,
                      int64_t w, const int32_t* __restrict__ y0,
                      const int32_t* __restrict__ x0,
                      const int32_t* __restrict__ slide, int window,
                      uint8_t* __restrict__ out) {
  const int64_t i = blockIdx.x;
  const int64_t yy = clamp64(y0[i], 0, h - window);
  const int64_t xx = clamp64(x0[i], 0, w - window);
  const int64_t s = slide == nullptr ? 0 : clamp64(slide[i], 0, b - 1);
  const int64_t row_bytes = static_cast<int64_t>(window) * 3;
  const int64_t src_pitch = w * 3;
  const uint8_t* src = imgs + ((s * h + yy) * w + xx) * 3;
  uint8_t* dst = out + i * window * row_bytes;

  const int row0 = blockIdx.y * kRowsPerBlock;
  const int row_end = min(row0 + kRowsPerBlock, window);
  for (int r = row0; r < row_end; ++r) {
    const uint8_t* s_row = src + r * src_pitch;
    uint8_t* d_row = dst + r * row_bytes;
    for (int64_t c = threadIdx.x; c < row_bytes; c += kThreads) {
      d_row[c] = __ldg(s_row + c);
    }
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// imgs: (b, h, w, 3) uint8; y0, x0, slide: (n,) int32 (slide may be null for
// all-zero); out: (n, window, window, 3) uint8. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int gather_patches_u8(const void* imgs, long long b, long long h,
                                 long long w, const void* y0, const void* x0,
                                 const void* slide, long long n, int window,
                                 void* out, void* stream) {
  if (n == 0) return 0;
  const dim3 grid(static_cast<unsigned>(n),
                  static_cast<unsigned>((window + kRowsPerBlock - 1) / kRowsPerBlock));
  gather_patches_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(imgs), b, h, w, static_cast<const int32_t*>(y0),
      static_cast<const int32_t*>(x0), static_cast<const int32_t*>(slide), window,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
