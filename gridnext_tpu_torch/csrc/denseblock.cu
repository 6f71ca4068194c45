// Fused DenseNet-BC block, inference mode: per layer a 1x1 bottleneck and a
// 3x3 convolution over a bf16 concat buffer (B, H, W, Cmax) that grows in
// place by `growth` channels per layer.
//
// Replaces the TPU kernel gridnext_tpu/ops/denseblock_pallas.py
// fused_dense_block (_block_kernel, pallas_call at :150), which held a batch
// tile's whole concat buffer in VMEM across all layers. On Hopper one
// patch's buffer is too large for a block's 227 KB of shared memory in the
// first two blocks of DenseNet-121 at 128 px (32x32x256 bf16 = 512 KB,
// 16x16x512 = 256 KB), so here the buffer stays in device memory (and the
// 50 MB L2) and each layer is two launches:
//
//   dense_bottleneck_kernel: u = bf16(relu((bf16(relu(buf*a1 + b1)) @ W1) * a2 + b2))
//     over the layer's written channels c_in only (the folded tails are
//     zero, so the result is the same and the work smaller). A CTA takes 128
//     rows of the flat (B*H*W) axis and 128 of the Cb outputs.
//   dense_conv3x3_kernel: buf[..., c_in:c_in+growth] = bf16(sum_taps shift(u) @ W2[tap])
//     an implicit GEMM with K = 9*Cb and N = growth. A CTA takes whole
//     image rows (about 256 pixels, 32 per warp) of the flat (B*H) row
//     axis, stages them with a one-pixel halo in shared memory once per
//     32-channel slice, and reads all 9 taps from there. Zero padding works
//     per patch and per row: halo pixels outside the image row are zero
//     when staged, and a tap row that would cross into the previous or next
//     patch (y +- 1 outside [0, H)) reads a row of zeros instead.
//
// Rounding points, as the JAX function's on the TPU: the buffer and u are
// bf16; both products take bf16 operands (t is rounded to bf16, as the TPU's
// default-precision f32 dot rounds it) and accumulate in f32 (mma.sync
// m16n8k16); the affines multiply and add in separate f32 roundings
// (__fmul_rn, __fadd_rn: no FMA contraction), as the plain version does.
// The plain version keeps t in f32; the difference is about one bf16
// rounding of u.
//
// Bound: operations. Counting written channels only, a 624-patch chunk of
// DenseNet-121 at 128 px does 424 / 291 / 224 / 43 GFLOP in blocks 1-4:
// 0.43 / 0.29 / 0.23 / 0.043 ms at the 989 TFLOP/s bf16 tensor-core peak,
// against 0.12 / 0.06 / 0.03 / 0.01 ms to read each block's input and write
// its output once at 3.35 TB/s. What the design does about it: bf16
// tensor-core products (mma.sync m16n8k16) with f32 accumulation; two
// shared-memory stages per kernel, the next 32-channel slice arriving by
// cp.async while the warps multiply this one (the bottleneck's activations,
// which need their affine, wait in registers instead); fragments loaded
// with ldmatrix (.trans for the [k][n] weights) from rows padded to 80 or
// 272 bytes, so the loads are free of bank conflicts; the 3x3's input read
// once per CTA with its halo instead of once per tap, and each warp's
// weight fragments reused for 32 pixels. Measured on an H100 (PERF.md) it
// runs at 5-15 % of the bound. Later work: wgmma with TMA-fed multi-stage
// pipelines, the bottleneck fused into the 3x3 (u kept on chip), more CTAs
// for the small late blocks, and patch groups whose whole buffer stays in
// the 50 MB L2 across the block's layers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kBK = 32;         // channels (K) per shared-memory stage
constexpr int kAStride = kBK + 8;  // bf16 per A row in smem: 80 bytes, conflict-free

// bottleneck tile: 128 rows x 128 outputs; warps 4 (rows) x 2 (cols), 32 x 64 each
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBStride = kBN + 8;  // bf16 per B row (k) in smem

// 3x3 tile: up to 256 output pixels (two m16 fragments per warp) x 32 outputs
constexpr int kConvPix = 256;
constexpr int kConvN = 32;
constexpr int kCStride = kConvN + 8;

// Four 8x8 bf16 matrices from shared memory, one row address per lane (lanes
// 8i..8i+7 give matrix i's rows): an A fragment of m16n8k16, or with .trans
// the B fragments of two n8 tiles from a [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_bits_to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ uint16_t float_to_bf16_bits(float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  return *reinterpret_cast<const uint16_t*>(&b);
}

// relu(x * a + b) with separate f32 roundings.
__device__ __forceinline__ float affine_relu(float x, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(x, a), b), 0.f);
}

__device__ __forceinline__ void store_pair(uint16_t* dst, float v0, float v1) {
  const uint32_t packed = static_cast<uint32_t>(float_to_bf16_bits(v0)) |
                          (static_cast<uint32_t>(float_to_bf16_bits(v1)) << 16);
  *reinterpret_cast<uint32_t*>(dst) = packed;
}

// 16-byte asynchronous copy global -> shared; zero-fills when !ok (no read).
__device__ __forceinline__ void cp_async16(uint16_t* dst, const uint16_t* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The bottleneck's A operand for one stage, held in registers between its
// global load and its shared-memory store: 2 x 8 channels of one row each.
struct AStage {
  uint4 raw[2];
  bool ok[2];
};

__device__ __forceinline__ void load_a(AStage& st, const uint16_t* __restrict__ buf,
                                       int64_t row0, int64_t m, int c_max, int c_in, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int r = v / (kBK / 8), k = k0 + (v % (kBK / 8)) * 8;
    const int64_t row = row0 + r;
    st.ok[i] = row < m && k < c_in;  // c_in % 8 == 0: 8 channels all in or all out
    if (st.ok[i]) st.raw[i] = *reinterpret_cast<const uint4*>(buf + row * c_max + k);
  }
}

// t = bf16(relu(x * a1 + b1)) into the A tile (zeros outside the matrix);
// a1 and b1 of the stage's 32 channels are the same for every row (L1 hits).
__device__ __forceinline__ void store_a(const AStage& st, const float* __restrict__ a1,
                                        const float* __restrict__ b1, int k0, uint16_t* As) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int r = v / (kBK / 8), kv = (v % (kBK / 8)) * 8;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (st.ok[i]) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) = __ldg(reinterpret_cast<const float4*>(a1 + k0 + kv));
      *reinterpret_cast<float4*>(a + 4) =
          __ldg(reinterpret_cast<const float4*>(a1 + k0 + kv + 4));
      *reinterpret_cast<float4*>(b) = __ldg(reinterpret_cast<const float4*>(b1 + k0 + kv));
      *reinterpret_cast<float4*>(b + 4) =
          __ldg(reinterpret_cast<const float4*>(b1 + k0 + kv + 4));
      const uint16_t* x = reinterpret_cast<const uint16_t*>(&st.raw[i]);
      uint16_t* t = reinterpret_cast<uint16_t*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        t[j] = float_to_bf16_bits(affine_relu(bf16_bits_to_float(x[j]), a[j], b[j]));
    }
    *reinterpret_cast<uint4*>(&As[r * kAStride + kv]) = packed;
  }
}

// W1[k0:k0+32, n0:n0+128] as [k][n], asynchronously.
__device__ __forceinline__ void load_b(const uint16_t* __restrict__ w1, int c_in, int cb,
                                       int k0, int n0, uint16_t* Bs) {
  for (int v = threadIdx.x; v < kBK * (kBN / 8); v += kThreads) {
    const int kk = v / (kBN / 8), nv = (v % (kBN / 8)) * 8;
    const int k = k0 + kk, n = n0 + nv;
    const bool ok = k < c_in && n < cb;
    cp_async16(&Bs[kk * kBStride + nv], ok ? w1 + static_cast<int64_t>(k) * cb + n : w1, ok);
  }
}

// Two shared-memory stages: while the warps multiply stage s, stage s + 1's
// weights arrive by cp.async and its activations wait in registers.
__global__ void __launch_bounds__(kThreads, 2)
dense_bottleneck_kernel(const uint16_t* __restrict__ buf, int64_t m, int c_max, int c_in,
                        const float* __restrict__ a1, const float* __restrict__ b1,
                        const uint16_t* __restrict__ w1, const float* __restrict__ a2,
                        const float* __restrict__ b2, int cb, uint16_t* __restrict__ u) {
  __shared__ __align__(16) uint16_t As[2][kBM * kAStride];
  __shared__ __align__(16) uint16_t Bs[2][kBK * kBStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  AStage st;
  load_a(st, buf, row0, m, c_max, c_in, 0);
  load_b(w1, c_in, cb, 0, n0, Bs[0]);
  cp_async_commit();
  store_a(st, a1, b1, 0, As[0]);
  const int n_stages = (c_in + kBK - 1) / kBK;
  for (int s = 0; s < n_stages; ++s) {
    const int cur = s & 1;
    cp_async_wait_all();
    __syncthreads();  // stage s is in smem; every warp is done with stage s - 1
    const bool more = s + 1 < n_stages;
    if (more) {
      load_a(st, buf, row0, m, c_max, c_in, (s + 1) * kBK);
      load_b(w1, c_in, cb, (s + 1) * kBK, n0, Bs[cur ^ 1]);
      cp_async_commit();
    }
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      // lane l addresses row (l & 15), column block (l >> 4) of the 16 x 16 tile
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i], As[cur] + (wm * 32 + i * 16 + (lane & 15)) * kAStride + ks +
                               (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];  // b0, b1 of n-tile j, then of n-tile j + 1
        ldmatrix_x4_trans(b, Bs[cur] + (ks + (lane & 15)) * kBStride + wn * 64 + j * 8 +
                                 (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][j], af[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], af[i], b[2], b[3]);
        }
      }
    }
    if (more) store_a(st, a1, b1, (s + 1) * kBK, As[cur ^ 1]);
  }

  // epilogue: u = bf16(relu(acc * a2 + b2)); accumulator (row g | g+8, cols 2tg, 2tg+1)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + wn * 64 + j * 8 + tg * 2;
    if (n >= cb) continue;  // cb % 8 == 0: n and n + 1 are both in or both out
    const float s0 = a2[n], s1 = a2[n + 1], o0 = b2[n], o1 = b2[n + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t row = row0 + wm * 32 + i * 16 + g + hh * 8;
        if (row >= m) continue;
        store_pair(u + row * cb + n, affine_relu(acc[i][j][2 * hh], s0, o0),
                   affine_relu(acc[i][j][2 * hh + 1], s1, o1));
      }
    }
  }
}

// One 32-channel slice of the 3x3's operands, asynchronously: the tile's u
// with its one-pixel halo (zero outside the image rows and columns) and
// W2[tap, c0:c0+32, n0:n0+32] as [tap*32 + k][n].
__device__ __forceinline__ void load_conv_stage(
    const uint16_t* __restrict__ u, const uint16_t* __restrict__ w2, int64_t n_rows, int w,
    int cb, int growth, int64_t r0, int x0, int halo_w, int halo_pix, int c0, int n0,
    uint16_t* halo, uint16_t* Bs) {
  for (int v = threadIdx.x; v < halo_pix * (kBK / 8); v += kThreads) {
    const int q = v / (kBK / 8), cv = (v % (kBK / 8)) * 8;
    const int j = q / halo_w, xc = q % halo_w;
    const int64_t r = r0 - 1 + j;
    const int x = x0 - 1 + xc;
    const int c = c0 + cv;
    const bool ok = r >= 0 && r < n_rows && x >= 0 && x < w && c < cb;
    cp_async16(&halo[q * kAStride + cv], ok ? u + (r * w + x) * cb + c : u, ok);
  }
  for (int v = threadIdx.x; v < 9 * kBK * (kConvN / 8); v += kThreads) {
    const int kt = v / (kConvN / 8), nv = (v % (kConvN / 8)) * 8;
    const int tap = kt / kBK, kk = kt % kBK;
    const int c = c0 + kk, n = n0 + nv;
    const bool ok = c < cb && n < growth;
    cp_async16(&Bs[kt * kCStride + nv],
               ok ? w2 + (static_cast<int64_t>(tap) * cb + c) * growth + n : w2, ok);
  }
}

// One CTA: `rows` image rows (flat over (b, y)) starting at r0, columns
// [x0, x0 + tile_w), 32 output channels from n0; each warp takes 32 of the
// tile's pixels (two m16 fragments). Two shared-memory stages of 32 channels
// each: the next slice arrives by cp.async during this one's products. A tap
// row that falls outside its patch (y +- 1 outside [0, H)), or a pixel past
// the tile, reads a row of zeros.
__global__ void __launch_bounds__(kThreads)
dense_conv3x3_kernel(const uint16_t* __restrict__ u, int64_t n_rows, int h, int w, int cb,
                     const uint16_t* __restrict__ w2, int growth, int rows, int tile_w,
                     uint16_t* __restrict__ out, int c_max, int c_off) {
  extern __shared__ __align__(16) uint16_t smem[];
  __shared__ __align__(16) uint16_t zero_row[kAStride];
  const int halo_w = tile_w + 2;
  const int halo_pix = (rows + 2) * halo_w;
  const int stage_elems = halo_pix * kAStride + 9 * kBK * kCStride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int col_tiles = (w + tile_w - 1) / tile_w;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x / col_tiles) * rows;
  const int x0 = static_cast<int>(blockIdx.x % col_tiles) * tile_w;
  const int n0 = blockIdx.y * kConvN;
  const int n_pix = rows * tile_w;
  const bool active = warp * 32 < n_pix;
  if (threadIdx.x < kAStride) zero_row[threadIdx.x] = 0;

  // the pixel whose row this lane addresses in each fragment's ldmatrix:
  // its halo offset (-1: none) and a bit mask of the tap rows dy = -1, 0, +1
  // that stay inside its patch
  int base[2], tap_rows[2];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int p = warp * 32 + f * 16 + (lane & 15);
    const int i = p / tile_w, xl = p % tile_w;
    const int y = static_cast<int>((r0 + i) % h);
    base[f] = (i + 1) * halo_w + xl + 1;
    tap_rows[f] = p < n_pix ? ((y > 0) | 2 | ((y < h - 1) << 2)) : 0;
  }

  float acc[2][4][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;

  const int n_stages = (cb + kBK - 1) / kBK;
  load_conv_stage(u, w2, n_rows, w, cb, growth, r0, x0, halo_w, halo_pix, 0, n0, smem,
                  smem + halo_pix * kAStride);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    const uint16_t* halo = smem + (s & 1) * stage_elems;
    const uint16_t* Bs = halo + halo_pix * kAStride;
    cp_async_wait_all();
    __syncthreads();  // slice s is in smem; every warp is done with slice s - 1
    if (s + 1 < n_stages) {
      uint16_t* nxt = smem + ((s + 1) & 1) * stage_elems;
      load_conv_stage(u, w2, n_rows, w, cb, growth, r0, x0, halo_w, halo_pix,
                      (s + 1) * kBK, n0, nxt, nxt + halo_pix * kAStride);
      cp_async_commit();
    }
    if (!active) continue;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const uint16_t* rowp[2];
#pragma unroll
      for (int f = 0; f < 2; ++f)
        rowp[f] = ((tap_rows[f] >> (dy + 1)) & 1)
                      ? halo + (base[f] + dy * halo_w + dx) * kAStride + (lane >> 4) * 8
                      : zero_row + (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int f = 0; f < 2; ++f)
          ldmatrix_x4(a[f], rowp[f] + ks);  // the zero row is kAStride wide too
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Bs + (tap * kBK + ks + (lane & 15)) * kCStride + j * 8 +
                                   (lane >> 4) * 8);
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            mma_bf16(acc[f][j], a[f], b[0], b[1]);
            mma_bf16(acc[f][j + 1], a[f], b[2], b[3]);
          }
        }
      }
    }
  }

  // epilogue: accumulator rows g and g + 8 of each fragment, columns 2tg, 2tg+1
#pragma unroll
  for (int f = 0; f < 2; ++f) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = warp * 32 + f * 16 + g + hh * 8;
      const int64_t r = r0 + p / tile_w;
      const int x = x0 + p % tile_w;
      if (p >= n_pix || r >= n_rows || x >= w) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + j * 8 + tg * 2;
        if (n >= growth) continue;  // growth % 8 == 0
        store_pair(out + (r * w + x) * c_max + c_off + n, acc[f][j][2 * hh],
                   acc[f][j][2 * hh + 1]);
      }
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
// (n_layers, c_max, cb) and w2 (n_layers, 9, cb, growth) bf16; u is
// (nb * h * w, cb) bf16 scratch. c_in0, growth and cb are multiples of 8 and
// every pointer is 16-byte aligned. Launches 2 * n_layers kernels on
// `stream`; returns the first launch error (cudaGetLastError) or 0.
extern "C" int dense_block_bf16(void* buf, const void* a1, const void* b1, const void* w1,
                                const void* a2, const void* b2, const void* w2, long long nb,
                                int h, int w, int c_in0, int growth, int n_layers, int cb,
                                void* u, void* stream) {
  if (c_in0 % 8 || growth % 8 || cb % 8 || h < 1 || w < 1 || nb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c_max = c_in0 + n_layers * growth;
  const int64_t n_rows = static_cast<int64_t>(nb) * h;
  const int64_t m = n_rows * w;
  if (m == 0 || n_layers == 0) return 0;
  const int tile_w = w < kConvPix ? w : kConvPix;
  const int rows = kConvPix / tile_w;
  const size_t smem =  // two stages
      2 * (static_cast<size_t>(rows + 2) * (tile_w + 2) * kAStride + 9 * kBK * kCStride) *
      sizeof(uint16_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t row_tiles = (n_rows + rows - 1) / rows;
  const int64_t conv_tiles = row_tiles * ((w + tile_w - 1) / tile_w);
  const int64_t mm_tiles = (m + kBM - 1) / kBM;
  if (conv_tiles > 0x7fffffff || mm_tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid_mm(static_cast<unsigned>(mm_tiles), (cb + kBN - 1) / kBN);
  const dim3 grid_conv(static_cast<unsigned>(conv_tiles), (growth + kConvN - 1) / kConvN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint16_t* out = static_cast<uint16_t*>(buf);
  uint16_t* scratch = static_cast<uint16_t*>(u);
  for (int l = 0; l < n_layers; ++l) {
    const int c_in = c_in0 + l * growth;
    dense_bottleneck_kernel<<<grid_mm, kThreads, 0, s>>>(
        out, m, c_max, c_in, static_cast<const float*>(a1) + static_cast<int64_t>(l) * c_max,
        static_cast<const float*>(b1) + static_cast<int64_t>(l) * c_max,
        static_cast<const uint16_t*>(w1) + static_cast<int64_t>(l) * c_max * cb,
        static_cast<const float*>(a2) + static_cast<int64_t>(l) * cb,
        static_cast<const float*>(b2) + static_cast<int64_t>(l) * cb, cb, scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dense_conv3x3_kernel<<<grid_conv, kThreads, smem, s>>>(
        scratch, n_rows, h, w, cb,
        static_cast<const uint16_t*>(w2) + static_cast<int64_t>(l) * 9 * cb * growth, growth,
        rows, tile_w, out, c_max, c_in);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
