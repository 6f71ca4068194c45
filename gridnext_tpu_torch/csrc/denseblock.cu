// Fused DenseNet-BC block, inference mode: per layer a 1x1 bottleneck and a
// 3x3 convolution over a bf16 concat buffer (B, H, W, Cmax) that grows in
// place by `growth` channels per layer. One launch of dense_layer_kernel
// per layer.
//
// Replaces the TPU kernel gridnext_tpu/ops/denseblock_pallas.py
// fused_dense_block (_block_kernel, pallas_call at :150), which held a batch
// tile's whole concat buffer in VMEM across all layers. On Hopper one
// patch's buffer does not fit a block's 227 KB of shared memory in the first
// two blocks of DenseNet-121 at 128 px (32x32x256 bf16 = 512 KB, 16x16x512 =
// 256 KB), so the buffer stays in device memory and each layer reads its
// c_in written channels and appends `growth`. What stays on chip is the
// bottleneck's output u:
//
//   t = bf16(relu(buf * a1 + b1))                    registers
//   u = bf16(relu((t @ W1) * a2 + b2))               shared memory, never HBM
//   buf[..., c_in:c_in+growth] = bf16(sum_taps shift(u) @ W2[tap])
//
// A CTA owns the pixels it appends to and the u they need:
//   - whole patches (blocks 2-4 of DenseNet-121): `patches` consecutive
//     patches; the 3x3's zero padding is the patch edge, no halo;
//   - row bands (block 1, or any patch whose u is too large): `band_rows`
//     whole image rows of one patch, with u recomputed for the row above and
//     below inside the patch.
// The Python planner (ops/denseblock_cuda.py, plan_dense_block) picks the
// mode, the warpgroups (1-4, one 64-pixel wgmma tile each per round) and the
// ring depth; dense_block_bf16 checks the shared-memory size.
//
// Products: wgmma with A from registers and B from shared memory.
//   - 1x1: m64n128k16 per warpgroup tile, K = c_in in 32-channel stages of a
//     2-4 slot cp.async ring (the buffer tile, W1's [k][n] slice and the
//     stage's a1, b1). Each warp loads its A fragment with ldmatrix, applies
//     relu(x * a1 + b1) and rounds to bf16; W1 stays in the JAX layout
//     ([k][n], N-major: the transposed-B form of wgmma) as 8x8 core
//     matrices. The next stage's copies are issued while the wgmma runs.
//   - 3x3: m64n32k16, K = 9 taps x Cb, with all of W2 copied into the ring
//     once the 1x1 is done (while u's epilogue runs). A is the shifted u rows
//     through ldmatrix (a one-pixel shift breaks the core-matrix layout a
//     shared-memory descriptor needs); a tap that falls outside the patch
//     reads a row of zeros. Each half tap (64 channels) is one wgmma group;
//     the next half's A fragments load while it runs, in a second set of
//     registers (a whole tap's two sets spilled at 128 registers).
// cp.async, not TMA: A passes through registers for its affine anyway, the
// rows are padded to 80 bytes for ldmatrix without a swizzle, and no
// driver-API tensor map is encoded per call.
//
// Rounding points, as the JAX function's on the TPU: the buffer and u are
// bf16; both products take bf16 operands (t is rounded to bf16, as the TPU's
// default-precision f32 dot rounds it) and accumulate in f32; the affines
// multiply and add in separate f32 roundings (__fmul_rn, __fadd_rn: no FMA
// contraction), as the plain version does. The plain version keeps t in
// f32; the difference is about one bf16 rounding of u. Channels >= c_in are
// never read (zero-filled copies) and t is zeroed there, so whatever the
// unwritten buffer channels hold cannot reach the product. No atomics and no
// split K: the same inputs give the same bits.
//
// Bound: operations. Counting written channels only, a 624-patch chunk of
// DenseNet-121 at 128 px does 424 / 291 / 224 / 43 GFLOP in blocks 1-4:
// 0.43 / 0.29 / 0.23 / 0.043 ms at the 989 TFLOP/s bf16 tensor-core peak.
// A layer-at-a-time design must still read each layer's c_in channels and
// write its growth (3.7 GB read, 0.44 GB written a chunk, 1.24 ms at 3.35
// TB/s); keeping u on chip removes the other half of the old kernel's
// traffic (4.1 GB a chunk) and one launch per layer. What holds this kernel
// (measured on an H100, PERF.md): each 1x1 ring stage costs some 3,000-4,500
// SM clocks against 512 of tensor work, in its barrier, the per-thread
// cp.async issue of the next stage, the affine and one wgmma group waited
// for. A copy warp beside four warpgroups (544 threads) lost: 96 registers
// and serialised wgmma. TMA for the ring is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;            // wgmma M: pixels per warpgroup tile
constexpr int kMaxWarpgroups = 4;
constexpr int kBK = 32;              // 1x1 channels (K) per ring stage
constexpr int kAStride = kBK + 8;    // bf16 per A row in a stage: 80 bytes, conflict-free
constexpr int kCbMax = 128;          // the 1x1's N (wgmma n128); Cb is at most this
constexpr int kGrowthMax = 32;       // the 3x3's N (wgmma n32); growth is at most this
constexpr int kW1StageBytes = kBK * kCbMax * 2;
constexpr int kAffineStageBytes = 2 * kBK * 4;  // a1, b1 of the stage's channels (f32)
constexpr int kSmemLimit = 232448;   // a block's dynamic shared memory on sm_90

struct Layer {
  uint16_t* buf;
  const float* a1;
  const float* b1;
  const uint16_t* w1;  // [c_max][cb] of this layer
  const float* a2;
  const float* b2;
  const uint16_t* w2;  // [9][cb][growth] of this layer
  long long m;         // pixels: nb * h * w
  int h, w, c_max, c_in, cb, cbp, growth;
  int band_rows;       // > 0: a band of rows of one patch per CTA; 0: whole patches
  int patches;         // patches per CTA when band_rows == 0
  int u_pix;           // u pixels a CTA holds at most
  int stages;          // ring depth, 2..4
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !ok (no read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// Wait until at most `pending` (0..2) committed groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory written by cp.async (generic proxy), read by wgmma's
// descriptors (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across an
// asynchronous wgmma that uses them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor, no swizzle: 8x8 core matrices of 128
// contiguous bytes; lbo = byte stride between core matrices along K, sbo =
// along N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D(64 x 128, f32) += A(64 x 16, bf16 registers) * B(16 x 128, bf16 shared,
// N-major: the transposed-B form).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// D(64 x 32, f32) += A(64 x 16, bf16 registers) * B(16 x 32, bf16 shared, N-major).
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ uint16_t float_to_bf16_bits(float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  return *reinterpret_cast<const uint16_t*>(&b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(float_to_bf16_bits(lo)) |
         (static_cast<uint32_t>(float_to_bf16_bits(hi)) << 16);
}

// relu(x * a + b) with separate f32 roundings.
__device__ __forceinline__ float affine_relu(float x, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(x, a), b), 0.f);
}

// Two bf16 buffer values (channels k, k + 1; kk = k within the stage) ->
// bf16 t; zero at k >= c_in (c_in is a multiple of 8 and k even: both
// channels are in or both out). aff holds the stage's a1 then b1.
__device__ __forceinline__ uint32_t bottleneck_input(uint32_t x, int k, int kk, int c_in,
                                                     const float* aff) {
  if (k >= c_in) return 0u;
  const float2 a = *reinterpret_cast<const float2*>(aff + kk);
  const float2 b = *reinterpret_cast<const float2*>(aff + kBK + kk);
  return pack_bf16(affine_relu(__uint_as_float(x << 16), a.x, b.x),
                   affine_relu(__uint_as_float(x & 0xffff0000u), a.y, b.y));
}

// A ring of `stages` shared-memory slots: stage s + stages - 1 is copied in
// while stage s is multiplied. load(s, slot) issues the cp.async of stage s;
// compute(s, slot, issue) multiplies stage s, calls issue() (which copies the
// next stage in) while its wgmma runs, and waits for the wgmma.
template <class Load, class Compute>
__device__ __forceinline__ void pipeline(int n, int stages, int slot_bytes, uint8_t* ring,
                                         Load&& load, Compute&& compute) {
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n) load(s, ring + s * slot_bytes);
    cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    cp_async_wait(stages - 2);
    fence_proxy_async();
    __syncthreads();  // stage s landed; every warpgroup is done with stage s - 1
    compute(s, ring + (s % stages) * slot_bytes, [&] {
      const int next = s + stages - 1;
      if (next < n) load(next, ring + (next % stages) * slot_bytes);
      cp_async_commit();
    });
  }
  cp_async_wait(0);
  __syncthreads();  // the ring is free for the next pipeline
}

__device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// One layer. blockDim.x = 128 * warpgroups; dynamic shared memory:
// [ring: stages slots, later W2][u: u_pix rounded to 64 rows][a zero row].
__global__ void __launch_bounds__(kMaxWarpgroups * 128, 1) dense_layer_kernel(const Layer p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int nwg = blockDim.x / 128;
  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int a_bytes = nwg * kTile * kAStride * 2;
  const int slot_bytes = a_bytes + kW1StageBytes + kAffineStageBytes;
  const int ustride = p.cbp + 8;  // bf16 per u row: an odd number of 16-byte units
  const int w2_tap_bytes = p.cbp * kGrowthMax * 2;
  const int ring_bytes = max(p.stages * slot_bytes, 9 * w2_tap_bytes);
  uint16_t* u = reinterpret_cast<uint16_t*>(smem + ring_bytes);
  uint16_t* zero = u + ceil_div(p.u_pix, kTile) * kTile * ustride;
  for (int i = tid; i < ustride; i += blockDim.x) zero[i] = 0;

  // This CTA's u pixels [base, base + n_u) of the flat (B*H*W) axis; its
  // outputs are n_out of them from out_off, the first opx0 pixels into its patch.
  const int hw = p.h * p.w;
  long long base;
  int n_u, out_off, n_out, opx0;
  if (p.band_rows > 0) {
    const int bands = ceil_div(p.h, p.band_rows);
    const long long patch = blockIdx.x / bands;
    const int y0 = static_cast<int>(blockIdx.x % bands) * p.band_rows;
    const int rows = min(p.band_rows, p.h - y0);
    base = (patch * p.h + y0 - 1) * p.w;  // the row above (another patch's, or none)
    n_u = (rows + 2) * p.w;
    out_off = p.w;
    n_out = rows * p.w;
    opx0 = y0 * p.w;
  } else {
    base = static_cast<long long>(blockIdx.x) * p.patches * hw;
    n_u = p.patches * hw;
    out_off = 0;
    n_out = static_cast<int>(min(static_cast<long long>(n_u), p.m - base));
    opx0 = 0;
  }

  // ---- 1x1 bottleneck: u = bf16(relu((t @ W1) * a2 + b2)) into shared memory
  const int tiles_u = ceil_div(n_u, kTile);
  const int k_stages = ceil_div(p.c_in, kBK);
  for (int t0 = 0; t0 < tiles_u; t0 += nwg) {
    const int tile = t0 + wg;
    const bool active = tile < tiles_u;
    const int row0 = t0 * kTile;  // first u row of this round
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    auto load = [&](int s, uint8_t* slot) {
      const int k0 = s * kBK;
      uint16_t* as = reinterpret_cast<uint16_t*>(slot);
      for (int v = tid; v < nwg * kTile * (kBK / 8); v += blockDim.x) {
        const int r = v / (kBK / 8), kc = (v % (kBK / 8)) * 8;
        const int lr = row0 + r;
        const long long q = base + lr;
        const bool ok = lr < n_u && q >= 0 && q < p.m && k0 + kc < p.c_in;
        cp_async16(as + r * kAStride + kc, ok ? p.buf + q * p.c_max + k0 + kc : p.buf, ok);
      }
      // W1[k0:k0+32, 0:128] as core matrices (k/8, n/8); eight neighbouring
      // threads take eight k rows of one core matrix (distinct banks)
      uint8_t* bs = slot + a_bytes;
      for (int v = tid; v < kBK * (kCbMax / 8); v += blockDim.x) {
        const int k = (v >> 7) * 8 + (v & 7), nc = (v >> 3) & 15;
        const bool ok = k0 + k < p.c_in && nc * 8 < p.cb;
        cp_async16(bs + ((k >> 3) * (kCbMax / 8) + nc) * 128 + (k & 7) * 16,
                   ok ? p.w1 + static_cast<long long>(k0 + k) * p.cb + nc * 8 : p.w1, ok);
      }
      if (tid < kAffineStageBytes / 16) {  // a1[k0:k0+32], b1[k0:k0+32]
        const int kk = (tid % (kBK / 4)) * 4;
        const float* src = (tid < kBK / 4 ? p.a1 : p.b1) + k0 + kk;
        cp_async16(bs + kW1StageBytes + tid * 16, src, k0 + kk < p.c_in);
      }
    };
    auto compute = [&](int s, const uint8_t* slot, auto&& issue) {
      if (!active) {
        issue();
        return;
      }
      const uint16_t* as = reinterpret_cast<const uint16_t*>(slot);
      const float* aff = reinterpret_cast<const float*>(slot + a_bytes + kW1StageBytes);
      const int k0 = s * kBK;
      uint32_t a[kBK / 16][4];
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t x[4];  // rows g, g + 8 of the warp's 16; channels 2tg, 2tg + 8
        ldmatrix_x4(x, as + (wg * kTile + wi * 16 + (lane & 15)) * kAStride + ks * 16 +
                           (lane >> 4) * 8);
        const int kk = ks * 16 + 2 * tg;
        a[ks][0] = bottleneck_input(x[0], k0 + kk, kk, p.c_in, aff);
        a[ks][1] = bottleneck_input(x[1], k0 + kk, kk, p.c_in, aff);
        a[ks][2] = bottleneck_input(x[2], k0 + kk + 8, kk + 8, p.c_in, aff);
        a[ks][3] = bottleneck_input(x[3], k0 + kk + 8, kk + 8, p.c_in, aff);
      }
      const uint8_t* bs = slot + a_bytes;
      fence_regs(acc);
      fence_regs(a);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
        wgmma_n128(acc, a[ks], smem_desc(bs + ks * 2 * (kCbMax / 8) * 128,
                                         (kCbMax / 8) * 128, 128));
      wgmma_commit();
      issue();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(a);
    };
    pipeline(k_stages, p.stages, slot_bytes, smem, load, compute);
    if (t0 + nwg >= tiles_u) {
      // the ring is free: W2 of all nine taps, as core matrices (k/8, n/8)
      // per tap, arrives while the last round's epilogue writes u
      for (int v = tid; v < 9 * p.cbp * (kGrowthMax / 8); v += blockDim.x) {
        const int tap = v / (p.cbp * (kGrowthMax / 8)), r = v % (p.cbp * (kGrowthMax / 8));
        const int k = (r >> 5) * 8 + (r & 7), nc = (r >> 3) & 3;
        const bool ok = k < p.cb && nc * 8 < p.growth;
        cp_async16(smem + tap * w2_tap_bytes + ((k >> 3) * (kGrowthMax / 8) + nc) * 128 +
                       (k & 7) * 16,
                   ok ? p.w2 + static_cast<long long>(tap * p.cb + k) * p.growth + nc * 8
                      : p.w2,
                   ok);
      }
      cp_async_commit();
    }

    if (active) {  // accumulator: rows g, g + 8 of the warp's 16; columns 8j + 2tg, +1
#pragma unroll
      for (int j = 0; j < kCbMax / 8; ++j) {
        const int n = j * 8 + 2 * tg;
        if (n >= p.cbp) continue;
        const bool real = n < p.cb;  // cb % 8 == 0: n and n + 1 together
        const float s0 = real ? p.a2[n] : 0.f, s1 = real ? p.a2[n + 1] : 0.f;
        const float o0 = real ? p.b2[n] : 0.f, o1 = real ? p.b2[n + 1] : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = tile * kTile + wi * 16 + g + hh * 8;
          *reinterpret_cast<uint32_t*>(u + row * ustride + n) =
              real ? pack_bf16(affine_relu(acc[4 * j + 2 * hh], s0, o0),
                               affine_relu(acc[4 * j + 2 * hh + 1], s1, o1))
                   : 0u;
        }
      }
    }
  }

  // ---- 3x3: buf[..., c_in:c_in+growth] = bf16(sum_taps shift(u) @ W2[tap])
  cp_async_wait(0);
  fence_proxy_async();
  __syncthreads();  // u and W2 are in shared memory
  const int tiles_o = ceil_div(n_out, kTile);
  const int k_steps = p.cbp / 16;
  for (int t0 = 0; t0 < tiles_o; t0 += nwg) {
    const int tile = t0 + wg;
    const bool active = tile < tiles_o;
    // the output pixel whose u row this lane addresses in ldmatrix, and a
    // bit per tap (3 (dy + 1) + dx + 1) that stays inside its patch
    const int jp = tile * kTile + wi * 16 + (lane & 15);
    int taps = 0;
    if (active && jp < n_out) {
      const int q = (opx0 + jp) % hw;
      const int y = q / p.w, x = q % p.w;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int yy = y + t / 3 - 1, xx = x + t % 3 - 1;
        if (yy >= 0 && yy < p.h && xx >= 0 && xx < p.w) taps |= 1 << t;
      }
    }
    const uint16_t* urow = u + (out_off + jp) * ustride + (lane >> 4) * 8;
    const uint16_t* zrow = zero + (lane >> 4) * 8;
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    if (active) {
      // nine taps with W2 resident: each tap's eight products are one wgmma
      // group; the next tap's A fragments load while it runs (two register sets)
      uint32_t a[2][kCbMax / 32][4] = {};
#pragma unroll
      for (int half = 0; half < 18; ++half) {
        const int tap = half >> 1, k_half = (half & 1) * (kCbMax / 32);
        uint32_t(&at)[kCbMax / 32][4] = a[half & 1];
        const uint16_t* src =
            (taps >> tap) & 1 ? urow + ((tap / 3 - 1) * p.w + tap % 3 - 1) * ustride : zrow;
#pragma unroll
        for (int ks = 0; ks < kCbMax / 32; ++ks)
          if (k_half + ks < k_steps) ldmatrix_x4(at[ks], src + (k_half + ks) * 16);
        fence_regs(acc);
        fence_regs(at);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kCbMax / 32; ++ks)
          if (k_half + ks < k_steps)
            wgmma_n32(acc, at[ks],
                      smem_desc(smem + tap * w2_tap_bytes + (k_half + ks) * 2 * (kGrowthMax / 8) * 128,
                                (kGrowthMax / 8) * 128, 128));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(a[(half + 1) & 1]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(a[0]);
      fence_regs(a[1]);
    }

    if (active) {
#pragma unroll
      for (int j = 0; j < kGrowthMax / 8; ++j) {
        const int n = j * 8 + 2 * tg;
        if (n >= p.growth) continue;  // growth % 8 == 0
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = tile * kTile + wi * 16 + g + hh * 8;
          if (row >= n_out) continue;
          *reinterpret_cast<uint32_t*>(p.buf + (base + out_off + row) * p.c_max + p.c_in + n) =
              pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        }
      }
    }
  }
}

// Dynamic shared memory of one CTA (the planner in ops/denseblock_cuda.py
// repeats this sum).
long long dense_block_smem_bytes(int u_pix, int cb, int warpgroups, int stages) {
  const long long cbp = (cb + 15) / 16 * 16;
  const long long slot = static_cast<long long>(warpgroups) * kTile * kAStride * 2 +
                         kW1StageBytes + kAffineStageBytes;
  const long long u_rows = (u_pix + kTile - 1) / kTile * kTile;
  const long long ring = stages * slot > 9 * cbp * kGrowthMax * 2 ? stages * slot
                                                                  : 9 * cbp * kGrowthMax * 2;
  return ring + (u_rows + 1) * (cbp + 8) * 2;
}

// The general route, for blocks the wgmma kernel does not take (growth
// above 32 or Cb above 128 after the wrapper pads widths to multiples of
// 8): two plain f32-FMA tile products a layer, any widths, no alignment.
// dense_bottleneck_general_kernel writes u (m, cb) bf16 to a device
// scratch, dense_conv3x3_general_kernel appends the 3x3 from it. t stays in
// f32 here, as the plain version keeps it; the rounding points are
// otherwise the wgmma kernel's. Each block: 64 pixels x 64 outputs, K in
// stages of 32 through shared memory, a thread 4 x 4 outputs.
constexpr int kGenThreads = 256;
constexpr int kGenPix = 64;
constexpr int kGenN = 64;
constexpr int kGenK = 32;

__device__ __forceinline__ float bf16_to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// acc[i][j] += sum_k a_s[k][tp + i] b_s[k][tn + j]
__device__ __forceinline__ void tile_fma(float (&acc)[4][4], float (*a_s)[kGenPix + 4],
                                         float (*b_s)[kGenN + 4], int tp, int tn) {
#pragma unroll 8
  for (int k = 0; k < kGenK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&a_s[k][tp]);
    const float4 b = *reinterpret_cast<const float4*>(&b_s[k][tn]);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// u[p][n] = bf16(relu((sum_c relu(buf[p][c] a1[c] + b1[c]) w1[c][n]) a2[n] + b2[n])), c < c_in
__global__ void __launch_bounds__(kGenThreads)
dense_bottleneck_general_kernel(const uint16_t* __restrict__ buf, long long m, int c_max,
                                int c_in, const float* __restrict__ a1,
                                const float* __restrict__ b1, const uint16_t* __restrict__ w1,
                                const float* __restrict__ a2, const float* __restrict__ b2,
                                int cb, uint16_t* __restrict__ u) {
  __shared__ __align__(16) float a_s[kGenK][kGenPix + 4];
  __shared__ __align__(16) float b_s[kGenK][kGenN + 4];
  const long long p0 = static_cast<long long>(blockIdx.x) * kGenPix;
  const int n0 = blockIdx.y * kGenN;
  const int tid = threadIdx.x, tp = (tid % 16) * 4, tn = (tid / 16) * 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < c_in; k0 += kGenK) {
    __syncthreads();
    for (int i = tid; i < kGenK * kGenPix; i += kGenThreads) {
      const int kk = i % kGenK, pp = i / kGenK;       // channels fastest: contiguous reads
      const long long p = p0 + pp;
      const int c = k0 + kk;
      a_s[kk][pp] = (p < m && c < c_in)
                        ? affine_relu(bf16_to_float(buf[p * c_max + c]), a1[c], b1[c])
                        : 0.f;
    }
    for (int i = tid; i < kGenK * kGenN; i += kGenThreads) {
      const int nn = i % kGenN, kk = i / kGenN;
      b_s[kk][nn] = (k0 + kk < c_in && n0 + nn < cb)
                        ? bf16_to_float(w1[static_cast<long long>(k0 + kk) * cb + n0 + nn])
                        : 0.f;
    }
    __syncthreads();
    tile_fma(acc, a_s, b_s, tp, tn);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + tp + i;
    if (p >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn + j;
      if (n < cb) u[p * cb + n] = float_to_bf16_bits(affine_relu(acc[i][j], a2[n], b2[n]));
    }
  }
}

// buf[p][c_in + g] = bf16(sum over the 9 taps (dr, dc) and n < cb of
// u[p shifted by (dr, dc)][n] w2[tap][n][g]), zero outside the patch
__global__ void __launch_bounds__(kGenThreads)
dense_conv3x3_general_kernel(const uint16_t* __restrict__ u, long long m, int h, int w, int cb,
                             const uint16_t* __restrict__ w2, int growth,
                             uint16_t* __restrict__ buf, int c_max, int c_in) {
  __shared__ __align__(16) float a_s[kGenK][kGenPix + 4];
  __shared__ __align__(16) float b_s[kGenK][kGenN + 4];
  const long long p0 = static_cast<long long>(blockIdx.x) * kGenPix;
  const int n0 = blockIdx.y * kGenN;
  const int tid = threadIdx.x, tp = (tid % 16) * 4, tn = (tid / 16) * 4;
  float acc[4][4] = {};
  for (int tap = 0; tap < 9; ++tap) {
    const int dr = tap / 3 - 1, dc = tap % 3 - 1;
    for (int k0 = 0; k0 < cb; k0 += kGenK) {
      __syncthreads();
      for (int i = tid; i < kGenK * kGenPix; i += kGenThreads) {
        const int kk = i % kGenK, pp = i / kGenK;
        const long long p = p0 + pp;
        const int y = static_cast<int>((p / w) % h) + dr, x = static_cast<int>(p % w) + dc;
        const bool ok = p < m && k0 + kk < cb && y >= 0 && y < h && x >= 0 && x < w;
        a_s[kk][pp] = ok ? bf16_to_float(u[(p + dr * w + dc) * cb + k0 + kk]) : 0.f;
      }
      for (int i = tid; i < kGenK * kGenN; i += kGenThreads) {
        const int nn = i % kGenN, kk = i / kGenN;
        b_s[kk][nn] =
            (k0 + kk < cb && n0 + nn < growth)
                ? bf16_to_float(w2[(static_cast<long long>(tap) * cb + k0 + kk) * growth + n0 + nn])
                : 0.f;
      }
      __syncthreads();
      tile_fma(acc, a_s, b_s, tp, tn);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + tp + i;
    if (p >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn + j;
      if (n < growth) buf[p * c_max + c_in + n] = float_to_bf16_bits(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All layers of one block over buf (nb, h, w, c_in0 + n_layers * growth)
// bf16, whose first c_in0 channels hold the input; the layers append in
// place. a1, b1 (n_layers, c_max) and a2, b2 (n_layers, cb) f32; w1
// (n_layers, c_max, cb) and w2 (n_layers, 9, cb, growth) bf16. c_in0, growth
// and cb are multiples of 8, growth <= 32, cb <= 128, every pointer 16-byte
// aligned. The tile plan: band_rows > 0 gives each CTA that many rows of one
// patch, else `patches` whole patches; warpgroups (1-4) and stages (2-4)
// size the CTA. Launches n_layers kernels on `stream`; returns the first
// launch error (cudaGetLastError) or 0.
extern "C" int dense_block_bf16(void* buf, const void* a1, const void* b1, const void* w1,
                                const void* a2, const void* b2, const void* w2, long long nb,
                                int h, int w, int c_in0, int growth, int n_layers, int cb,
                                int band_rows, int patches, int warpgroups, int stages,
                                void* stream) {
  if (c_in0 % 8 || growth % 8 || cb % 8 || growth > kGrowthMax || cb > kCbMax || h < 1 ||
      w < 1 || nb < 0 || band_rows < 0 || (band_rows == 0 && patches < 1) ||
      warpgroups < 1 || warpgroups > kMaxWarpgroups || stages < 2 || stages > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c_max = c_in0 + n_layers * growth;
  const long long m = nb * h * w;
  if (m == 0 || n_layers == 0) return 0;
  Layer p{};
  p.buf = static_cast<uint16_t*>(buf);
  p.m = m;
  p.h = h;
  p.w = w;
  p.c_max = c_max;
  p.cb = cb;
  p.cbp = (cb + 15) / 16 * 16;
  p.growth = growth;
  p.band_rows = band_rows;
  p.patches = band_rows > 0 ? 1 : patches;
  p.u_pix = band_rows > 0 ? ((band_rows < h ? band_rows : h) + 2) * w : patches * h * w;
  p.stages = stages;
  const long long smem = dense_block_smem_bytes(p.u_pix, cb, warpgroups, stages);
  const long long ctas =
      band_rows > 0 ? nb * ((h + band_rows - 1) / band_rows) : (nb + patches - 1) / patches;
  if (smem > kSmemLimit || ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      dense_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < n_layers; ++l) {
    p.c_in = c_in0 + l * growth;
    p.a1 = static_cast<const float*>(a1) + static_cast<long long>(l) * c_max;
    p.b1 = static_cast<const float*>(b1) + static_cast<long long>(l) * c_max;
    p.w1 = static_cast<const uint16_t*>(w1) + static_cast<long long>(l) * c_max * cb;
    p.a2 = static_cast<const float*>(a2) + static_cast<long long>(l) * cb;
    p.b2 = static_cast<const float*>(b2) + static_cast<long long>(l) * cb;
    p.w2 = static_cast<const uint16_t*>(w2) + static_cast<long long>(l) * 9 * cb * growth;
    dense_layer_kernel<<<static_cast<unsigned>(ctas), 128 * warpgroups, smem, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The general route: the same block as dense_block_bf16 at any widths, two
// launches a layer (bottleneck into u, then the 3x3), on `stream`. u holds
// nb * h * w * cb bf16. No alignment needed. Returns the first launch error
// (cudaGetLastError) or 0.
extern "C" int dense_block_general_bf16(void* buf, const void* a1, const void* b1,
                                        const void* w1, const void* a2, const void* b2,
                                        const void* w2, long long nb, int h, int w, int c_in0,
                                        int growth, int n_layers, int cb, void* u,
                                        void* stream) {
  if (c_in0 < 1 || growth < 1 || cb < 1 || h < 1 || w < 1 || nb < 0 || n_layers < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c_max = c_in0 + n_layers * growth;
  const long long m = nb * h * w;
  if (m == 0 || n_layers == 0) return 0;
  const long long pix_blocks = (m + kGenPix - 1) / kGenPix;
  if (pix_blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* bp = static_cast<uint16_t*>(buf);
  auto* up = static_cast<uint16_t*>(u);
  for (int l = 0; l < n_layers; ++l) {
    const int c_in = c_in0 + l * growth;
    dense_bottleneck_general_kernel<<<dim3(static_cast<unsigned>(pix_blocks),
                                           (cb + kGenN - 1) / kGenN),
                                      kGenThreads, 0, s>>>(
        bp, m, c_max, c_in, static_cast<const float*>(a1) + static_cast<long long>(l) * c_max,
        static_cast<const float*>(b1) + static_cast<long long>(l) * c_max,
        static_cast<const uint16_t*>(w1) + static_cast<long long>(l) * c_max * cb,
        static_cast<const float*>(a2) + static_cast<long long>(l) * cb,
        static_cast<const float*>(b2) + static_cast<long long>(l) * cb, cb, up);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dense_conv3x3_general_kernel<<<dim3(static_cast<unsigned>(pix_blocks),
                                        (growth + kGenN - 1) / kGenN),
                                   kGenThreads, 0, s>>>(
        up, m, h, w, cb,
        static_cast<const uint16_t*>(w2) + static_cast<long long>(l) * 9 * cb * growth, growth,
        bp, c_max, c_in);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
