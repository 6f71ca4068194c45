// Patch gather: one window x window x 3 uint8 crop per spot from a stack of
// raw (B, H, W, 3) uint8 slides.
//
// Replaces the TPU kernel gridnext_tpu/ops/patch_gather_pallas.py
// gather_patches (pallas_call at :214). That kernel packed RGB into int32
// lanes and DMA'd lane-aligned superblocks, because of the TPU's (8, 128)
// tiling; on Hopper neither is needed, so this kernel reads the raw slide.
//
// Bound: bytes. Each crop is read once and written once, 2 * N * w * w * 3
// bytes in all, with no arithmetic. A source row starts at any byte (3 x0
// into a pitch of 3 W, which need not be a multiple of 16), so a TMA tensor
// map over the slide is impossible (its strides must be multiples of 16).
// One byte per load and store (the first design) left the load/store units as
// the limit: 1.45 ms at N = 19,976, 40 % of the bound on an H100.
//
// Design (gather_bulk_kernel, for rows of a multiple of 16 bytes, which
// every window that is a multiple of 16 gives): one CTA per crop. A 1D bulk
// copy needs only a 16-byte aligned address and size, not a tensor map, so
// each row's 16-byte-aligned covering span is copied into shared memory by
// cp.async.bulk (one lane of warp 0 per row), completing on an mbarrier.
// Rows go in stages of 32, double-buffered: stage s + 1's copies are in
// flight while the warps realign stage s (two aligned 16-byte words and
// funnel shifts by the row's src & 15 bytes) and write 16-byte stores. The
// copy engine moves the bytes, so a thread holds few registers and many
// CTAs fit an SM. The covering span may start up to 15 bytes before the row
// and end up to 15 after it: an aligned 16-byte word that holds one byte of
// the slide never crosses a page, so these extra bytes are read and
// dropped. Measured against the other acceptable design, one warp per row
// with 16-byte loads realigned in registers: 0.698 against 1.244 ms at
// 128 px on an H100 (PERF.md).
// Other windows, or rows too long for the stages' shared memory, take
// gather_bytes_kernel (consecutive threads on consecutive bytes of each
// row); the wrapper chooses by shape.
// The corner and the slide index are clamped here, as lax.dynamic_slice and
// the JAX wrapper clamp them. All offsets are 64-bit: a batch of four slides
// at 0.25 GB each is close to 2^31 bytes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageRows = 32;                           // rows of one stage, bulk path
constexpr int kByteThreads = 128;
constexpr int kRowsPerBlock = 8;                         // rows of one block, byte path
constexpr long long kMaxSmem = 200 * 1024;               // the bulk path's two stages, at most

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Byte offset of crop i's first byte in the slide stack, corner and slide clamped.
__device__ __forceinline__ int64_t crop_origin(int64_t i, int64_t b, int64_t h, int64_t w,
                                               const int32_t* __restrict__ y0,
                                               const int32_t* __restrict__ x0,
                                               const int32_t* __restrict__ slide, int window) {
  const int64_t yy = clamp64(y0[i], 0, h - window);
  const int64_t xx = clamp64(x0[i], 0, w - window);
  const int64_t s = slide == nullptr ? 0 : clamp64(slide[i], 0, b - 1);
  return ((s * h + yy) * w + xx) * 3;
}

// Bytes [sh, sh + 16) of the 32 bytes (lo, hi), little-endian.
__device__ __forceinline__ uint4 realign(const uint4& lo, const uint4& hi, int sh) {
  const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t a[5];
  const int q = sh >> 2;                 // whole 4-byte words to skip (uniform in the warp)
#pragma unroll
  for (int j = 0; j < 5; ++j)
    a[j] = q == 0 ? v[j] : q == 1 ? v[j + 1] : q == 2 ? v[j + 2] : v[j + 3];
  const uint32_t bits = 8u * (sh & 3);
  return make_uint4(__funnelshift_r(a[0], a[1], bits), __funnelshift_r(a[1], a[2], bits),
                    __funnelshift_r(a[2], a[3], bits), __funnelshift_r(a[3], a[4], bits));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  uint64_t state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
               : "=l"(state)
               : "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  (void)state;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_addr(bar))
               : "memory");
  (void)state;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Bytes of dynamic shared memory of the bulk path: two stages of 32 rows of
// the covering span (row_bytes / 16 + 1 words).
__host__ __device__ inline long long bulk_smem(int window) {
  return 2LL * kStageRows * ((window * 3) / 16 + 1) * 16;
}

// Whether the bulk path takes this window: rows of a multiple of 16 bytes
// whose two stages fit shared memory (the wrapper's patch_gather_cuda.bulk).
inline bool bulk_ok(int window) {
  return (window * 3) % 16 == 0 && bulk_smem(window) <= kMaxSmem;
}

__global__ void __launch_bounds__(kThreads)
gather_bulk_kernel(const uint8_t* __restrict__ imgs, int64_t b, int64_t h, int64_t w,
                   const int32_t* __restrict__ y0, const int32_t* __restrict__ x0,
                   const int32_t* __restrict__ slide, int window, uint8_t* __restrict__ out) {
  extern __shared__ uint4 buf[];                       // [2][kStageRows][span]
  __shared__ uint64_t full[2];
  const int64_t i = blockIdx.x;
  const uint8_t* src = imgs + crop_origin(i, b, h, w, y0, x0, slide, window);
  const int64_t row_bytes = static_cast<int64_t>(window) * 3;
  const int64_t pitch = w * 3;
  const int words = static_cast<int>(row_bytes / 16);  // output words of a row
  const int span = words + 1;                          // shared words of a row slot
  uint8_t* dst = out + i * window * row_bytes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int stages = (window + kStageRows - 1) / kStageRows;
  if (threadIdx.x == 0) {
    mbar_init(&full[0], kStageRows);
    mbar_init(&full[1], kStageRows);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int stage, int slot) {              // warp 0: one row a lane
    if (warp != 0) return;
    const int r = stage * kStageRows + lane;
    if (r < window) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(src + r * pitch);
      const int sh = static_cast<int>(a & 15);
      const uint32_t bytes = static_cast<uint32_t>((sh + row_bytes + 15) / 16 * 16);
      mbar_arrive_tx(&full[slot], bytes);
      bulk_copy(buf + (slot * kStageRows + lane) * span, reinterpret_cast<const void*>(a - sh),
                bytes, &full[slot]);
    } else {
      mbar_arrive(&full[slot]);                        // every lane arrives each phase
    }
  };
  issue(0, 0);
  for (int stage = 0; stage < stages; ++stage) {
    const int slot = stage & 1;
    if (stage + 1 < stages) issue(stage + 1, slot ^ 1);
    mbar_wait(&full[slot], (stage >> 1) & 1);
#pragma unroll
    for (int k = 0; k < kStageRows / kWarps; ++k) {
      const int rr = warp * (kStageRows / kWarps) + k;
      const int r = stage * kStageRows + rr;
      if (r >= window) continue;
      const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(src + r * pitch) & 15);
      const uint4* row = buf + (slot * kStageRows + rr) * span;
      for (int j = lane; j < words; j += 32) {
        const uint4 lo = row[j];
        const uint4 hi = sh ? row[j + 1] : lo;         // sh > 0: the span has words + 1
        *reinterpret_cast<uint4*>(dst + r * row_bytes + 16 * j) = realign(lo, hi, sh);
      }
    }
    __syncthreads();                                   // the slot's readers are done before it refills
  }
}

__global__ void __launch_bounds__(kByteThreads)
gather_bytes_kernel(const uint8_t* __restrict__ imgs, int64_t b, int64_t h, int64_t w,
                    const int32_t* __restrict__ y0, const int32_t* __restrict__ x0,
                    const int32_t* __restrict__ slide, int window, uint8_t* __restrict__ out) {
  const int64_t i = blockIdx.x;
  const uint8_t* src = imgs + crop_origin(i, b, h, w, y0, x0, slide, window);
  const int64_t row_bytes = static_cast<int64_t>(window) * 3;
  const int64_t src_pitch = w * 3;
  uint8_t* dst = out + i * window * row_bytes;

  const int row0 = blockIdx.y * kRowsPerBlock;
  const int row_end = min(row0 + kRowsPerBlock, window);
  for (int r = row0; r < row_end; ++r) {
    const uint8_t* s_row = src + r * src_pitch;
    uint8_t* d_row = dst + r * row_bytes;
    for (int64_t c = threadIdx.x; c < row_bytes; c += kByteThreads) {
      d_row[c] = __ldg(s_row + c);
    }
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// imgs: (b, h, w, 3) uint8; y0, x0, slide: (n,) int32 (slide may be null for
// all-zero); out: (n, window, window, 3) uint8, 16-byte aligned. bulk = 1
// launches gather_bulk_kernel (bulk_ok(window) must hold), 0
// gather_bytes_kernel. Launches one kernel on `stream` and returns
// cudaGetLastError().
extern "C" int gather_patches_u8(const void* imgs, long long b, long long h,
                                 long long w, const void* y0, const void* x0,
                                 const void* slide, long long n, int window, int bulk,
                                 void* out, void* stream) {
  if (n == 0) return 0;
  if (bulk && (!bulk_ok(window) || reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* src = static_cast<const uint8_t*>(imgs);
  const auto* py = static_cast<const int32_t*>(y0);
  const auto* px = static_cast<const int32_t*>(x0);
  const auto* ps = static_cast<const int32_t*>(slide);
  auto* dst = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (bulk) {
    const long long smem = bulk_smem(window);
    if (smem > 48 * 1024) {
      if (cudaError_t err = cudaFuncSetAttribute(
              gather_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
              static_cast<int>(smem)))
        return static_cast<int>(err);
    }
    gather_bulk_kernel<<<static_cast<unsigned>(n), kThreads, static_cast<size_t>(smem), st>>>(
        src, b, h, w, py, px, ps, window, dst);
  } else {
    const dim3 grid(static_cast<unsigned>(n),
                    static_cast<unsigned>((window + kRowsPerBlock - 1) / kRowsPerBlock));
    gather_bytes_kernel<<<grid, kByteThreads, 0, st>>>(src, b, h, w, py, px, ps, window, dst);
  }
  return static_cast<int>(cudaGetLastError());
}
