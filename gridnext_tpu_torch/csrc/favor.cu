// ReLU-FAVOR linear attention, non-causal, f32: for q, k, v of shape
// (B, H, N, d) and a projection proj (m, d), per (b, h)
//
//   phi(x)  = relu((d^-1/4 x) @ proj^T) + 1e-3                 (m features)
//   ksum    = sum_n phi(k_n)                                    (m)
//   ctx     = sum_n phi(k_n) v_n^T                              (m, d)
//   out_n   = (phi(q_n) @ ctx) / (phi(q_n) . ksum)              (d)
//
// Replaces the TPU kernel gridnext_tpu/ops/favor_pallas.py
// fused_generalized_linear_attention (pallas_call at :142 accumulates,
// :161 applies). Like it, the (N, m) feature maps never reach device
// memory: here they never leave registers.
//
// Bound: operations. At scBERT's shape (B 8, H 10, N 16,907, d 64, m 266)
// the four products (phi(k), ctx, phi(q), out) are 2 B H N d m FLOP each,
// 1.85e11 FLOP per call. The products run on the tensor cores in split
// TF32, three TF32 products per f32 product: 3 x 1.85e11 FLOP at the
// 495 TFLOP/s TF32 peak is 1.12 ms, against 2.76 ms for the same work as
// f32 FMA on the CUDA cores (67 TFLOP/s) and 0.41 ms to read q, k, v and
// write out once at 3.35 TB/s.
//
// Why split TF32 and not one pass: the contract is the JAX tests' rtol
// 2e-4 / atol 2e-5 against the f32 plain version. Emulating the kernel's
// operand rounding at the card tests' shapes (with standard-normal inputs),
// one TF32 pass (10-bit mantissa) reaches 5.2 times that tolerance rounded
// to nearest and 7.1 times toward zero (worst at N 45, m 266); the split
//   a_hi = tf32(a), a_lo = tf32(a - a_hi),
//   a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi   (f32 sums)
// stays within 1 % of it (tests/test_torch_favor_precision.py pins both;
// on the card it comes within 3 %). The split is made once per operand
// value as it lands in registers (proj and q once per block, k, v, phi and
// ctx once per fragment load), never once per product (split()).
//
// Design (three launches on the caller's stream), mma.sync.m16n8k8 TF32:
// 1. favor_accum_kernel: one block per (group of 16-feature tiles of m,
//    split of the sequence, (b, h)). Each warp owns 16 features: their
//    rows of (d^-1/4 proj) sit in registers as split A fragments for the
//    whole kernel, and their 16 x d slice of ctx is its accumulator. The
//    block walks its rows in tiles of 32, copied by cp.async into a
//    double-buffered shared tile of k and v. Per tile a warp forms
//    S^T = proj k^T (16 features x 32 rows, four accumulators), applies
//    ReLU, +eps and the masks (rows >= N and features >= m exactly 0: the
//    +eps would otherwise leak into ksum and ctx), and feeds the result
//    straight back as the A operand of ctx += phi^T v: the C fragment of
//    one m16n8k8 product is the A fragment of the next once the 8 rows of
//    the k step are taken in the order (0, 2, 4, 6, 1, 3, 5, 7), and v's
//    B fragment reads its rows in the same order. ksum is summed from the
//    same registers. Each block writes its partial ctx/ksum; Hopper
//    blocks run in parallel, where the TPU kernel carried them across a
//    sequential grid. A split sums at most 32 tiles (the host's
//    _SPLIT_TILES): the f32 chain's rounding grows with its length. Blocks of at most 6 warps, two to an SM (the launch
//    bounds hold a thread to 168 registers): one block an SM, at 173
//    registers, took 47 % more time.
// 2. favor_reduce_kernel sums the partials over the splits in a fixed
//    order, so the result does not depend on the schedule (no atomics).
// 3. favor_apply_kernel: one block per (kApplyWarps x 16 rows, (b, h)).
//    Each warp holds its 16 rows of d^-1/4 q as split A fragments; the
//    block walks m in chunks of 32 features (proj, ctx and ksum copied by
//    cp.async, double-buffered). Per chunk a warp forms S = q proj^T
//    (16 rows x 32 features), phi of it, the denominator phi . ksum in f32
//    FMA, and out += phi ctx with phi's C fragment reused as A as above.
// Shared rows are padded to d + 4 floats, so every fragment load of a
// warp hits 32 distinct banks. What holds the kernel back is the
// instruction mix, not the tensor cores: mma.sync TF32 alone reaches
// ~315 TFLOP/s on an H100, ~210 with this split of a fresh B operand
// beside each product and ~175 with its shared-memory loads as well
// (tools/time_favor.py --peak); the kernel runs at ~160. Splitting k, v,
// proj and ctx once per block into (hi, lo) pairs in shared memory, read
// 8 bytes at a time, was 27 % slower (more shared traffic, a third
// barrier per tile, fewer blocks an SM). Sums run in a fixed order: d
// ascending in phi, rows ascending within a split and splits ascending in
// ctx/ksum, features ascending in the output; a call gives the same bits
// every time.
// Entry points: favor_attention_f32 runs the three launches back to back.
// favor_accumulate_f32 (launches 1 and 2, then ctx and ksum copied out at
// m rows) and favor_apply_f32 (ctx and ksum copied back in, padded, then
// launch 3) split it at the one point where a sequence sharded over ranks
// must sum ctx and ksum over the ranks; without that sum, the two in turn
// give the fused entry's bits at the same splits.
// q, k and v may be strided views (the heads split of a (B, N, H d)
// projection): their element strides over b, h and n are arguments, the
// last dimension must be contiguous, and the strides multiples of 4.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kAccWarpsMax = 6;        // 16-feature tiles (warps) per accumulate block, at most
constexpr int kRows = 32;              // sequence rows per accumulate tile (four k steps of 8)
constexpr int kApplyWarps = 4;         // 16-row tiles (warps) per apply block
constexpr int kApplyRows = 16 * kApplyWarps;
constexpr int kFeat = 32;              // features per apply chunk (four k steps of 8)
constexpr int kFeatTile = 16;          // m pads to a multiple of this
constexpr float kEps = 1e-3f;          // generalized_kernel_features kernel_epsilon

// x = hi + lo exactly, as TF32 operands: hi is x with its low 13 mantissa
// bits cleared (TF32 toward zero), lo = x - hi is exact in f32 (|lo| <
// 2^-10 |x|), and the tensor core reads lo as TF32 by dropping its own low
// 13 bits, so a product loses at most ~2^-20 of each operand. One AND and
// one subtract: cvt.rna.tf32.f32 for each half took 26 % more time at
// scBERT's shape, and rounding hi to nearest in integer operations 5 %.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[i] += a b_i in split TF32 for N products that share the A fragment
// (b_i's fragment is b[i][0], b[i][1]): the two small cross products first,
// each of the three terms issued over all N accumulators before the next,
// so that no product waits on the one issued before it.
template <int N>
__device__ __forceinline__ void mma3(float (*c)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], const float (&b)[N][2]) {
  uint32_t b_hi[N][2], b_lo[N][2];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    split(b[i][0], b_hi[i][0], b_lo[i][0]);
    split(b[i][1], b_hi[i][1], b_lo[i][1]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[i], a_lo, b_hi[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[i], a_hi, b_lo[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[i], a_hi, b_hi[i]);
}

// relu(s) + eps, or exactly 0 where masked
__device__ __forceinline__ float phi(float s, bool keep) {
  return keep ? fmaxf(s, 0.f) + kEps : 0.f;
}

// The A fragment of a product over 8 phi values per row, from the C
// fragment c of the product that made them (columns 2t, 2t+1 of rows g,
// g+8): logical k = t is column 2t and k = t + 4 is column 2t + 1.
__device__ __forceinline__ void phi_as_a(const float (&p)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(p[0], hi[0], lo[0]);
  split(p[2], hi[1], lo[1]);
  split(p[1], hi[2], lo[2]);
  split(p[3], hi[3], lo[3]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + rows) of one (n, D) slice with row stride `stride`
// into a (rows, D + 4) shared tile by cp.async; rows >= n are zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(const float* __restrict__ base, int64_t stride,
                                           int row0, int rows, int n, float* dst) {
  constexpr int EG = D / 4;
  for (int idx = threadIdx.x; idx < rows * EG; idx += blockDim.x) {
    const int r = idx / EG, c4 = idx % EG;
    const bool ok = row0 + r < n;
    const float* src = ok ? base + (row0 + r) * stride + 4 * c4 : base;
    cp_async16(dst + r * (D + 4) + 4 * c4, src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kAccWarpsMax * 32, 2)
favor_accum_kernel(const float* __restrict__ k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
                   const float* __restrict__ v, int64_t v_sb, int64_t v_sh, int64_t v_sn,
                   int heads, const float* __restrict__ proj, int n, int m, int groups,
                   int splits, int tiles_per_split, float scale,
                   float* __restrict__ part_ctx, float* __restrict__ part_ks) {
  constexpr int KS = D / 8, PD = D + 4;
  constexpr int kGroup = KS;                       // ctx n tiles issued together
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);   // stage i: k tile, then v tile

  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  int blk = blockIdx.x;
  const int grp = blk % groups;       // fastest: the groups of one row range share k, v in L2
  blk /= groups;
  const int s = blk % splits;
  const int bh = blk / splits;
  const int b = bh / heads, h = bh % heads;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const int m_tiles = (m + kFeatTile - 1) / kFeatTile;
  const int mt = grp * warps + warp;
  const bool active = mt < m_tiles;   // the last group may have a warp to spare
  const int f0 = mt * kFeatTile;
  const bool f_lo = f0 + g < m, f_hi = f0 + g + 8 < m;

  // A fragments of d^-1/4 proj for this warp's 16 features, split once
  uint32_t p_hi[KS][4], p_lo[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = f0 + g + (i & 1) * 8, col = ks * 8 + t + (i >> 1) * 4;
      const float x = (active && row < m) ? scale * __ldg(proj + row * D + col) : 0.f;
      split(x, p_hi[ks][i], p_lo[ks][i]);
    }
  float ctx[KS][4], ks_lo = 0.f, ks_hi = 0.f;
#pragma unroll
  for (int nt = 0; nt < KS; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) ctx[nt][i] = 0.f;

  const int tiles = (n + kRows - 1) / kRows;
  const int t0 = s * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, tiles);
  auto stage = [&](int tile, int buf) {
    float* dst = smem + buf * 2 * kRows * PD;
    stage_rows<D>(kb, k_sn, tile * kRows, kRows, n, dst);
    stage_rows<D>(vb, v_sn, tile * kRows, kRows, n, dst + kRows * PD);
    cp_async_commit();
  };
  if (t0 < t1) stage(t0, 0);
  for (int tile = t0; tile < t1; ++tile) {
    const int buf = (tile - t0) & 1;
    if (tile + 1 < t1) {
      stage(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* k_s = smem + buf * 2 * kRows * PD;
      const float* v_s = k_s + kRows * PD;
      // S^T (16 features x 8 rows) for each 8-row step c of the tile
      float acc[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        float bk[4][2];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* kr = k_s + (c * 8 + g) * PD + ks * 8 + t;
          bk[c][0] = kr[0];
          bk[c][1] = kr[4];
        }
        mma3<4>(acc, p_hi[ks], p_lo[ks], bk);
      }
      const int row0 = tile * kRows;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = row0 + c * 8 + 2 * t;
        const float p[4] = {phi(acc[c][0], r < n && f_lo), phi(acc[c][1], r + 1 < n && f_lo),
                            phi(acc[c][2], r < n && f_hi), phi(acc[c][3], r + 1 < n && f_hi)};
        ks_lo += p[0];
        ks_lo += p[1];
        ks_hi += p[2];
        ks_hi += p[3];
        uint32_t a_hi[4], a_lo[4];
        phi_as_a(p, a_hi, a_lo);
        const float* vr = v_s + (c * 8 + 2 * t) * PD + g;
#pragma unroll
        for (int nt = 0; nt < KS; nt += kGroup) {
          float bv[kGroup][2];
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            bv[i][0] = vr[(nt + i) * 8];
            bv[i][1] = vr[PD + (nt + i) * 8];
          }
          mma3<kGroup>(ctx + nt, a_hi, a_lo, bv);
        }
      }
    }
    __syncthreads();                   // this buffer's readers are done before it refills
  }
  if (!active) return;
  const int m_pad = m_tiles * kFeatTile;
  const int64_t part = static_cast<int64_t>(bh) * splits + s;
  float* pc = part_ctx + (part * m_pad + f0 + g) * D + 2 * t;
#pragma unroll
  for (int nt = 0; nt < KS; ++nt) {
    *reinterpret_cast<float2*>(pc + nt * 8) = make_float2(ctx[nt][0], ctx[nt][1]);
    *reinterpret_cast<float2*>(pc + 8 * D + nt * 8) = make_float2(ctx[nt][2], ctx[nt][3]);
  }
  // the four lanes of a feature pair hold its row partial sums
  ks_lo += __shfl_xor_sync(0xffffffffu, ks_lo, 1);
  ks_lo += __shfl_xor_sync(0xffffffffu, ks_lo, 2);
  ks_hi += __shfl_xor_sync(0xffffffffu, ks_hi, 1);
  ks_hi += __shfl_xor_sync(0xffffffffu, ks_hi, 2);
  if (t == 0) {
    part_ks[part * m_pad + f0 + g] = ks_lo;
    part_ks[part * m_pad + f0 + g + 8] = ks_hi;
  }
}

// ctx[bh] = sum over splits of part_ctx[bh][s], ksum likewise, splits in order.
__global__ void __launch_bounds__(256)
favor_reduce_kernel(const float* __restrict__ part_ctx, const float* __restrict__ part_ks,
                    int bh_total, int splits, int m_pad, int d, float* __restrict__ ctx,
                    float* __restrict__ ks) {
  const int64_t per = static_cast<int64_t>(m_pad) * (d + 1);   // d ctx values + 1 ksum a feature
  const int64_t total = per * bh_total;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t bh = idx / per, rem = idx % per;
    float sum = 0.f;
    if (rem < static_cast<int64_t>(m_pad) * d) {
      for (int s = 0; s < splits; ++s)
        sum += part_ctx[(bh * splits + s) * m_pad * d + rem];
      ctx[bh * m_pad * d + rem] = sum;
    } else {
      const int64_t j = rem - static_cast<int64_t>(m_pad) * d;
      for (int s = 0; s < splits; ++s) sum += part_ks[(bh * splits + s) * m_pad + j];
      ks[bh * m_pad + j] = sum;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kApplyWarps * 32)
favor_apply_kernel(const float* __restrict__ q, int64_t q_sb, int64_t q_sh, int64_t q_sn,
                   int heads, const float* __restrict__ proj, const float* __restrict__ ctx,
                   const float* __restrict__ ks, int n, int m, int m_pad, float scale,
                   float* __restrict__ out) {
  constexpr int KS = D / 8, PD = D + 4;
  // out n tiles issued together: a divisor of KS (KS 2, 4, 6, 8: 2, 4, 3, 4)
  constexpr int kGroup = KS % 4 == 0 ? 4 : (KS % 3 == 0 ? 3 : (KS < 4 ? KS : 1));
  constexpr int kStage = 2 * kFeat * PD + kFeat;   // proj chunk, ctx chunk, ksum chunk
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (n + kApplyRows - 1) / kApplyRows;
  const int tile = blockIdx.x % tiles;  // fastest: the tiles of one (b, h) share ctx in L2
  const int bh = blockIdx.x / tiles;
  const int b = bh / heads, h = bh % heads;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* ctx_bh = ctx + static_cast<int64_t>(bh) * m_pad * D;
  const float* ks_bh = ks + static_cast<int64_t>(bh) * m_pad;
  const int r0 = tile * kApplyRows + warp * 16;   // this warp's first row

  // A fragments of d^-1/4 q for this warp's 16 rows, split once
  uint32_t q_hi[KS][4], q_lo[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + (i & 1) * 8, col = kk * 8 + t + (i >> 1) * 4;
      const float x = row < n ? scale * __ldg(qb + row * q_sn + col) : 0.f;
      split(x, q_hi[kk][i], q_lo[kk][i]);
    }
  float acc[KS][4], den_lo = 0.f, den_hi = 0.f;
#pragma unroll
  for (int nt = 0; nt < KS; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  const int chunks = (m_pad + kFeat - 1) / kFeat;
  auto stage = [&](int chunk, int buf) {
    float* dst = smem + buf * kStage;
    const int j0 = chunk * kFeat;
    stage_rows<D>(proj, D, j0, kFeat, m, dst);
    stage_rows<D>(ctx_bh, D, j0, kFeat, m_pad, dst + kFeat * PD);
    for (int i = threadIdx.x; i < kFeat / 4; i += blockDim.x) {
      const bool ok = j0 + 4 * i < m_pad;            // m_pad is a multiple of 4
      cp_async16(dst + 2 * kFeat * PD + 4 * i, ok ? ks_bh + j0 + 4 * i : ks_bh, ok);
    }
    cp_async_commit();
  };
  stage(0, 0);
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int buf = chunk & 1;
    if (chunk + 1 < chunks) {
      stage(chunk + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* p_s = smem + buf * kStage;
    const float* c_s = p_s + kFeat * PD;
    const float* k_s = c_s + kFeat * PD;
    // S (16 rows x 8 features) for each 8-feature step c of the chunk
    float sacc[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) sacc[c][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float bp[4][2];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float* pr = p_s + (c * 8 + g) * PD + kk * 8 + t;
        bp[c][0] = pr[0];
        bp[c][1] = pr[4];
      }
      mma3<4>(sacc, q_hi[kk], q_lo[kk], bp);
    }
    // features >= m: proj rows are 0 (phi = eps), ctx rows and ksum exactly 0
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p[4] = {phi(sacc[c][0], true), phi(sacc[c][1], true),
                          phi(sacc[c][2], true), phi(sacc[c][3], true)};
      const float k0 = k_s[c * 8 + 2 * t], k1 = k_s[c * 8 + 2 * t + 1];
      den_lo = fmaf(p[0], k0, den_lo);
      den_lo = fmaf(p[1], k1, den_lo);
      den_hi = fmaf(p[2], k0, den_hi);
      den_hi = fmaf(p[3], k1, den_hi);
      uint32_t a_hi[4], a_lo[4];
      phi_as_a(p, a_hi, a_lo);
      const float* cr = c_s + (c * 8 + 2 * t) * PD + g;
#pragma unroll
      for (int nt = 0; nt < KS; nt += kGroup) {
        float bc[kGroup][2];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          bc[i][0] = cr[(nt + i) * 8];
          bc[i][1] = cr[PD + (nt + i) * 8];
        }
        mma3<kGroup>(acc + nt, a_hi, a_lo, bc);
      }
    }
    __syncthreads();                   // this buffer's readers are done before it refills
  }
  den_lo += __shfl_xor_sync(0xffffffffu, den_lo, 1);
  den_lo += __shfl_xor_sync(0xffffffffu, den_lo, 2);
  den_hi += __shfl_xor_sync(0xffffffffu, den_hi, 1);
  den_hi += __shfl_xor_sync(0xffffffffu, den_hi, 2);
  const float inv_lo = 1.f / den_lo, inv_hi = 1.f / den_hi;
  float* o = out + (static_cast<int64_t>(bh) * n + r0 + g) * D + 2 * t;
  const bool lo_ok = r0 + g < n, hi_ok = r0 + g + 8 < n;
#pragma unroll
  for (int nt = 0; nt < KS; ++nt) {
    if (lo_ok)
      *reinterpret_cast<float2*>(o + nt * 8) =
          make_float2(acc[nt][0] * inv_lo, acc[nt][1] * inv_lo);
    if (hi_ok)
      *reinterpret_cast<float2*>(o + 8 * D + nt * 8) =
          make_float2(acc[nt][2] * inv_hi, acc[nt][3] * inv_hi);
  }
}

// The general path, for head widths above the largest compiled instance
// (64): plain f32 FMA, every width d >= 1. The x proj^T contraction is
// staged in chunks of kGenCols columns, and each block owns kGenVal of the
// independent ctx/out columns, so neither is bounded by registers or shared
// memory; phi is formed once per block and value chunk. Same partials, the
// same reduce and the same fixed orders as the tensor-core path.
constexpr int kGenThreads = 256;
constexpr int kGenFeat = 32;           // features per block (one per lane)
constexpr int kGenRows = 32;           // sequence rows per accumulate tile
constexpr int kGenCols = 32;           // contraction columns per staged chunk
constexpr int kGenVal = 64;            // ctx/out columns per block
constexpr int kGenApplyRows = 64;      // sequence rows per apply block

// grid: (feature block, value chunk, split, (b, h)), feature block fastest
__global__ void __launch_bounds__(kGenThreads)
favor_accum_general_kernel(const float* __restrict__ k, int64_t k_sb, int64_t k_sh,
                           int64_t k_sn, const float* __restrict__ v, int64_t v_sb,
                           int64_t v_sh, int64_t v_sn, int heads, const float* __restrict__ proj,
                           int n, int m, int m_pad, int d, int fblocks, int vchunks, int splits,
                           int tiles_per_split, float scale, float* __restrict__ part_ctx,
                           float* __restrict__ part_ks) {
  __shared__ float k_s[kGenRows][kGenCols + 1];
  __shared__ float p_s[kGenFeat][kGenCols + 1];
  __shared__ float phi_s[kGenRows][kGenFeat + 1];
  __shared__ float v_s[kGenRows][kGenVal];
  int blk = blockIdx.x;
  const int fb = blk % fblocks;
  blk /= fblocks;
  const int vc = blk % vchunks;
  blk /= vchunks;
  const int s = blk % splits;
  const int bh = blk / splits;
  const int b = bh / heads, hh = bh % heads;
  const float* kb = k + b * k_sb + hh * k_sh;
  const float* vb = v + b * v_sb + hh * v_sh;
  const int f0 = fb * kGenFeat, j0 = vc * kGenVal;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int sr = warp * 4;               // S: this lane's feature, rows sr .. sr + 3
  const int cj = warp * 8;               // ctx: this lane's feature, columns cj .. cj + 7
  float ctx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float ksum = 0.f;
  const int tiles = (n + kGenRows - 1) / kGenRows;
  const int t0 = s * tiles_per_split, t1 = min(t0 + tiles_per_split, tiles);
  for (int tile = t0; tile < t1; ++tile) {
    const int row0 = tile * kGenRows;
    float sacc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < d; c0 += kGenCols) {
      __syncthreads();                 // the last tile's readers are done
      for (int i = tid; i < kGenRows * kGenCols; i += kGenThreads) {
        const int r = i / kGenCols, c = i % kGenCols;
        const bool in_c = c0 + c < d;
        k_s[r][c] = (row0 + r < n && in_c) ? scale * kb[(row0 + r) * k_sn + c0 + c] : 0.f;
        p_s[r][c] = (f0 + r < m && in_c) ? proj[static_cast<int64_t>(f0 + r) * d + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kGenCols; ++c) {
        const float pv = p_s[lane][c];
#pragma unroll
        for (int q = 0; q < 4; ++q) sacc[q] = fmaf(k_s[sr + q][c], pv, sacc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      phi_s[sr + q][lane] = phi(sacc[q], row0 + sr + q < n && f0 + lane < m);
    for (int i = tid; i < kGenRows * kGenVal; i += kGenThreads) {
      const int r = i / kGenVal, j = i % kGenVal;
      v_s[r][j] = (row0 + r < n && j0 + j < d) ? vb[(row0 + r) * v_sn + j0 + j] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kGenRows; ++r) {
      const float p = phi_s[r][lane];
      ksum += p;
#pragma unroll
      for (int e = 0; e < 8; ++e) ctx[e] = fmaf(p, v_s[r][cj + e], ctx[e]);
    }
  }
  if (f0 + lane >= m_pad) return;
  const int64_t part = static_cast<int64_t>(bh) * splits + s;
  float* pc = part_ctx + (part * m_pad + f0 + lane) * d;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (j0 + cj + e < d) pc[j0 + cj + e] = ctx[e];
  if (vc == 0 && warp == 0) part_ks[part * m_pad + f0 + lane] = ksum;
}

// grid: (row tile, value chunk, (b, h)), row tile fastest
__global__ void __launch_bounds__(kGenThreads)
favor_apply_general_kernel(const float* __restrict__ q, int64_t q_sb, int64_t q_sh,
                           int64_t q_sn, int heads, const float* __restrict__ proj,
                           const float* __restrict__ ctx, const float* __restrict__ ks, int n,
                           int m, int m_pad, int d, int vchunks, float scale,
                           float* __restrict__ out) {
  __shared__ float q_s[kGenApplyRows][kGenCols + 1];
  __shared__ float p_s[kGenFeat][kGenCols + 1];
  __shared__ float phi_s[kGenApplyRows][kGenFeat + 1];
  __shared__ __align__(16) float c_s[kGenFeat][kGenVal];
  __shared__ float k_s[kGenFeat];
  const int tiles = (n + kGenApplyRows - 1) / kGenApplyRows;
  int blk = blockIdx.x;
  const int tile = blk % tiles;
  blk /= tiles;
  const int vc = blk % vchunks;
  const int bh = blk / vchunks;
  const int b = bh / heads, hh = bh % heads;
  const float* qb = q + b * q_sb + hh * q_sh;
  const float* ctx_bh = ctx + static_cast<int64_t>(bh) * m_pad * d;
  const float* ks_bh = ks + static_cast<int64_t>(bh) * m_pad;
  const int row0 = tile * kGenApplyRows, j0 = vc * kGenVal;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int sr = warp * 8;               // S: this lane's feature, rows sr .. sr + 7
  const int orow = tid / 4, oq = (tid % 4) * 4;   // out: columns 16 kk + oq + e
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  float den = 0.f;
  for (int f0 = 0; f0 < m_pad; f0 += kGenFeat) {
    float sacc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < d; c0 += kGenCols) {
      __syncthreads();                 // the last chunk's readers are done
      for (int i = tid; i < kGenApplyRows * kGenCols; i += kGenThreads) {
        const int r = i / kGenCols, c = i % kGenCols;
        q_s[r][c] = (row0 + r < n && c0 + c < d) ? scale * qb[(row0 + r) * q_sn + c0 + c] : 0.f;
      }
      for (int i = tid; i < kGenFeat * kGenCols; i += kGenThreads) {
        const int f = i / kGenCols, c = i % kGenCols;
        p_s[f][c] =
            (f0 + f < m && c0 + c < d) ? proj[static_cast<int64_t>(f0 + f) * d + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kGenCols; ++c) {
        const float pv = p_s[lane][c];
#pragma unroll
        for (int r = 0; r < 8; ++r) sacc[r] = fmaf(q_s[sr + r][c], pv, sacc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) phi_s[sr + r][lane] = phi(sacc[r], f0 + lane < m);
    for (int i = tid; i < kGenFeat * kGenVal; i += kGenThreads) {
      const int f = i / kGenVal, j = i % kGenVal;
      c_s[f][j] = (f0 + f < m_pad && j0 + j < d) ? ctx_bh[static_cast<int64_t>(f0 + f) * d + j0 + j]
                                                 : 0.f;
    }
    if (tid < kGenFeat) k_s[tid] = f0 + tid < m_pad ? ks_bh[f0 + tid] : 0.f;
    __syncthreads();
    for (int f = 0; f < kGenFeat; ++f) {
      const float p = phi_s[orow][f];
      den = fmaf(p, k_s[f], den);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 c4 = *reinterpret_cast<const float4*>(&c_s[f][16 * kk + oq]);
        acc[4 * kk + 0] = fmaf(p, c4.x, acc[4 * kk + 0]);
        acc[4 * kk + 1] = fmaf(p, c4.y, acc[4 * kk + 1]);
        acc[4 * kk + 2] = fmaf(p, c4.z, acc[4 * kk + 2]);
        acc[4 * kk + 3] = fmaf(p, c4.w, acc[4 * kk + 3]);
      }
    }
  }
  if (row0 + orow >= n) return;
  const float inv = 1.f / den;
  float* o = out + (static_cast<int64_t>(bh) * n + row0 + orow) * d;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + 16 * kk + oq + e;
      if (j < d) o[j] = acc[4 * kk + e] * inv;
    }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

int m_padded(int m) { return (m + kFeatTile - 1) / kFeatTile * kFeatTile; }

int sm_count() {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

// The reduce pass: part_ctx/part_ks (bh, splits, m_pad, d) -> ctx (bh, m_pad, d), ksum (bh, m_pad).
cudaError_t reduce(const float* part_ctx, const float* part_ks, int bh, int splits, int m_pad,
                   int d, float* ctx, float* ksum, cudaStream_t stream) {
  const int64_t items = static_cast<int64_t>(bh) * m_pad * (d + 1);
  const int64_t want = (items + 255) / 256;
  const int sms = sm_count();
  const int reduce_blocks = static_cast<int>(want < 4 * sms ? want : 4 * sms);
  favor_reduce_kernel<<<reduce_blocks, 256, 0, stream>>>(part_ctx, part_ks, bh, splits, m_pad,
                                                         d, ctx, ksum);
  return cudaGetLastError();
}

// Accumulate and reduce: ctx (bh, m_pad, D) and ksum (bh, m_pad) at the end of `work`,
// whose head holds the partials.
template <int D>
cudaError_t accumulate(const float* k, const int64_t* ks_, const float* v, const int64_t* vs,
                       int batch, int heads, int n, const float* proj, int m, int splits,
                       float scale, float* work, float** ctx, float** ksum,
                       cudaStream_t stream) {
  constexpr int PD = D + 4;
  const int m_tiles = (m + kFeatTile - 1) / kFeatTile;
  const int m_pad = m_padded(m);
  const int groups = (m_tiles + kAccWarpsMax - 1) / kAccWarpsMax;
  const int warps = (m_tiles + groups - 1) / groups;
  const int bh = batch * heads;
  const int tiles = (n + kRows - 1) / kRows;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  float* part_ctx = work;
  float* part_ks = part_ctx + static_cast<int64_t>(bh) * splits * m_pad * D;
  *ctx = part_ks + static_cast<int64_t>(bh) * splits * m_pad;
  *ksum = *ctx + static_cast<int64_t>(bh) * m_pad * D;

  const size_t smem_accum = sizeof(float) * 2 * 2 * kRows * PD;
  if (cudaError_t err = set_smem(favor_accum_kernel<D>, smem_accum)) return err;
  favor_accum_kernel<D><<<groups * splits * bh, warps * 32, smem_accum, stream>>>(
      k, ks_[0], ks_[1], ks_[2], v, vs[0], vs[1], vs[2], heads, proj, n, m, groups, splits,
      tiles_per_split, scale, part_ctx, part_ks);
  if (cudaError_t err = cudaGetLastError()) return err;
  return reduce(part_ctx, part_ks, bh, splits, m_pad, D, *ctx, *ksum, stream);
}

// The apply pass over ctx (bh, m_pad, D) and ksum (bh, m_pad), rows >= m zero.
template <int D>
cudaError_t apply(const float* q, const int64_t* qs, int batch, int heads, int n,
                  const float* proj, int m, const float* ctx, const float* ksum, float scale,
                  float* out, cudaStream_t stream) {
  constexpr int PD = D + 4;
  const size_t smem_apply = sizeof(float) * 2 * (2 * kFeat * PD + kFeat);
  if (cudaError_t err = set_smem(favor_apply_kernel<D>, smem_apply)) return err;
  const int apply_tiles = (n + kApplyRows - 1) / kApplyRows;
  favor_apply_kernel<D><<<apply_tiles * batch * heads, kApplyWarps * 32, smem_apply, stream>>>(
      q, qs[0], qs[1], qs[2], heads, proj, ctx, ksum, n, m, m_padded(m), scale, out);
  return cudaGetLastError();
}

cudaError_t accumulate_general(const float* k, const int64_t* ks_, const float* v,
                               const int64_t* vs, int batch, int heads, int n, int d,
                               const float* proj, int m, int splits, float scale, float* work,
                               float** ctx, float** ksum, cudaStream_t stream) {
  const int m_pad = m_padded(m);
  const int bh = batch * heads;
  const int fblocks = (m_pad + kGenFeat - 1) / kGenFeat;
  const int vchunks = (d + kGenVal - 1) / kGenVal;
  const int tiles = (n + kGenRows - 1) / kGenRows;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  float* part_ctx = work;
  float* part_ks = part_ctx + static_cast<int64_t>(bh) * splits * m_pad * d;
  *ctx = part_ks + static_cast<int64_t>(bh) * splits * m_pad;
  *ksum = *ctx + static_cast<int64_t>(bh) * m_pad * d;

  favor_accum_general_kernel<<<fblocks * vchunks * splits * bh, kGenThreads, 0, stream>>>(
      k, ks_[0], ks_[1], ks_[2], v, vs[0], vs[1], vs[2], heads, proj, n, m, m_pad, d, fblocks,
      vchunks, splits, tiles_per_split, scale, part_ctx, part_ks);
  if (cudaError_t err = cudaGetLastError()) return err;
  return reduce(part_ctx, part_ks, bh, splits, m_pad, d, *ctx, *ksum, stream);
}

cudaError_t apply_general(const float* q, const int64_t* qs, int batch, int heads, int n, int d,
                          const float* proj, int m, const float* ctx, const float* ksum,
                          float scale, float* out, cudaStream_t stream) {
  const int vchunks = (d + kGenVal - 1) / kGenVal;
  const int apply_tiles = (n + kGenApplyRows - 1) / kGenApplyRows;
  favor_apply_general_kernel<<<apply_tiles * vchunks * batch * heads, kGenThreads, 0, stream>>>(
      q, qs[0], qs[1], qs[2], heads, proj, ctx, ksum, n, m, m_padded(m), d, vchunks, scale, out);
  return cudaGetLastError();
}

cudaError_t accumulate_any(const float* k, const int64_t* ks_, const float* v, const int64_t* vs,
                           int batch, int heads, int n, int d, const float* proj, int m,
                           int splits, float scale, float* work, float** ctx, float** ksum,
                           cudaStream_t st) {
  switch (d) {
    case 16:
      return accumulate<16>(k, ks_, v, vs, batch, heads, n, proj, m, splits, scale, work, ctx,
                            ksum, st);
    case 32:
      return accumulate<32>(k, ks_, v, vs, batch, heads, n, proj, m, splits, scale, work, ctx,
                            ksum, st);
    case 48:
      return accumulate<48>(k, ks_, v, vs, batch, heads, n, proj, m, splits, scale, work, ctx,
                            ksum, st);
    case 64:
      return accumulate<64>(k, ks_, v, vs, batch, heads, n, proj, m, splits, scale, work, ctx,
                            ksum, st);
    default:
      return accumulate_general(k, ks_, v, vs, batch, heads, n, d, proj, m, splits, scale, work,
                                ctx, ksum, st);
  }
}

cudaError_t apply_any(const float* q, const int64_t* qs, int batch, int heads, int n, int d,
                      const float* proj, int m, const float* ctx, const float* ksum, float scale,
                      float* out, cudaStream_t st) {
  switch (d) {
    case 16: return apply<16>(q, qs, batch, heads, n, proj, m, ctx, ksum, scale, out, st);
    case 32: return apply<32>(q, qs, batch, heads, n, proj, m, ctx, ksum, scale, out, st);
    case 48: return apply<48>(q, qs, batch, heads, n, proj, m, ctx, ksum, scale, out, st);
    case 64: return apply<64>(q, qs, batch, heads, n, proj, m, ctx, ksum, scale, out, st);
    default:
      return apply_general(q, qs, batch, heads, n, d, proj, m, ctx, ksum, scale, out, st);
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of scratch that favor_attention_f32 needs (partial and reduced
// ctx/ksum) for b*h = bh, the given splits, m features and head width d.
extern "C" long long favor_workspace_floats(int bh, int splits, int m, int d) {
  return static_cast<long long>(bh) * m_padded(m) * (d + 1) * (splits + 1);
}

// out (batch, heads, n, d) contiguous f32 = ReLU-FAVOR attention of q, k, v
// (element strides over batch, heads and rows in q_s/k_s/v_s; the last
// dimension contiguous) with proj (m, d) contiguous. d 16, 32, 48 or 64
// runs the tensor-core kernels (pointers 16-byte aligned, strides multiples
// of 4); any other d >= 1 the general f32 kernels. `work` holds
// favor_workspace_floats(batch * heads, splits, m, d) floats. Returns
// cudaGetLastError() after the last launch (or the first failure).
extern "C" int favor_attention_f32(const void* q, long long q_sb, long long q_sh,
                                   long long q_sn, const void* k, long long k_sb,
                                   long long k_sh, long long k_sn, const void* v,
                                   long long v_sb, long long v_sh, long long v_sn, int batch,
                                   int heads, int n, int d, const void* proj, int m,
                                   int splits, float scale, void* work, void* out,
                                   void* stream) {
  if (batch < 1 || heads < 1 || n < 1 || m < 1 || d < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t qs[3] = {q_sb, q_sh, q_sn}, ks[3] = {k_sb, k_sh, k_sn},
                vs[3] = {v_sb, v_sh, v_sn};
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* pf = static_cast<const float*>(proj);
  auto* wf = static_cast<float*>(work);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  float* ctx = nullptr;
  float* ksum = nullptr;
  if (cudaError_t err = accumulate_any(kf, ks, vf, vs, batch, heads, n, d, pf, m, splits, scale,
                                       wf, &ctx, &ksum, st))
    return static_cast<int>(err);
  return static_cast<int>(apply_any(qf, qs, batch, heads, n, d, pf, m, ctx, ksum, scale, of, st));
}

// The accumulate half of favor_attention_f32, for callers that sum ctx and
// ksum over the ranks holding the other rows of the sequence before the
// apply half: the same accumulate and reduce launches, then ctx (batch *
// heads, m, d) and ksum (batch * heads, m), contiguous f32, copied out of
// `work` (favor_workspace_floats(batch * heads, splits, m, d) floats).
extern "C" int favor_accumulate_f32(const void* k, long long k_sb, long long k_sh,
                                    long long k_sn, const void* v, long long v_sb,
                                    long long v_sh, long long v_sn, int batch, int heads, int n,
                                    int d, const void* proj, int m, int splits, float scale,
                                    void* work, void* ctx, void* ksum, void* stream) {
  if (batch < 1 || heads < 1 || n < 1 || m < 1 || d < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ks[3] = {k_sb, k_sh, k_sn}, vs[3] = {v_sb, v_sh, v_sn};
  auto st = static_cast<cudaStream_t>(stream);
  float* ctx_w = nullptr;
  float* ksum_w = nullptr;
  if (cudaError_t err = accumulate_any(static_cast<const float*>(k), ks,
                                       static_cast<const float*>(v), vs, batch, heads, n, d,
                                       static_cast<const float*>(proj), m, splits, scale,
                                       static_cast<float*>(work), &ctx_w, &ksum_w, st))
    return static_cast<int>(err);
  const size_t f = sizeof(float), pad = m_padded(m), bh = static_cast<size_t>(batch) * heads;
  if (cudaError_t err = cudaMemcpy2DAsync(ctx, f * m * d, ctx_w, f * pad * d, f * m * d, bh,
                                          cudaMemcpyDeviceToDevice, st))
    return static_cast<int>(err);
  return static_cast<int>(cudaMemcpy2DAsync(ksum, f * m, ksum_w, f * pad, f * m, bh,
                                            cudaMemcpyDeviceToDevice, st));
}

// Floats of scratch that favor_apply_f32 needs: ctx and ksum with m padded.
extern "C" long long favor_apply_workspace_floats(int bh, int m, int d) {
  return static_cast<long long>(bh) * m_padded(m) * (d + 1);
}

// The apply half: out (batch, heads, n, d) contiguous f32 from q (strided as
// in favor_attention_f32), proj (m, d) and ctx (batch * heads, m, d), ksum
// (batch * heads, m), contiguous f32 (favor_accumulate_f32's layout, summed
// over ranks or not). ctx and ksum are copied into `work`
// (favor_apply_workspace_floats floats) with the features padded by zero
// rows, the layout the apply kernels read.
extern "C" int favor_apply_f32(const void* q, long long q_sb, long long q_sh, long long q_sn,
                               int batch, int heads, int n, int d, const void* proj, int m,
                               const void* ctx, const void* ksum, float scale, void* work,
                               void* out, void* stream) {
  if (batch < 1 || heads < 1 || n < 1 || m < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t qs[3] = {q_sb, q_sh, q_sn};
  auto st = static_cast<cudaStream_t>(stream);
  const size_t f = sizeof(float), pad = m_padded(m), bh = static_cast<size_t>(batch) * heads;
  float* ctx_w = static_cast<float*>(work);
  float* ksum_w = ctx_w + bh * pad * d;
  if (pad > static_cast<size_t>(m)) {
    if (cudaError_t err = cudaMemset2DAsync(ctx_w + static_cast<size_t>(m) * d, f * pad * d, 0,
                                            f * (pad - m) * d, bh, st))
      return static_cast<int>(err);
    if (cudaError_t err = cudaMemset2DAsync(ksum_w + m, f * pad, 0, f * (pad - m), bh, st))
      return static_cast<int>(err);
  }
  if (cudaError_t err = cudaMemcpy2DAsync(ctx_w, f * pad * d, ctx, f * m * d, f * m * d, bh,
                                          cudaMemcpyDeviceToDevice, st))
    return static_cast<int>(err);
  if (cudaError_t err = cudaMemcpy2DAsync(ksum_w, f * pad, ksum, f * m, f * m, bh,
                                          cudaMemcpyDeviceToDevice, st))
    return static_cast<int>(err);
  return static_cast<int>(apply_any(static_cast<const float*>(q), qs, batch, heads, n, d,
                                    static_cast<const float*>(proj), m, ctx_w, ksum_w, scale,
                                    static_cast<float*>(out), st));
}
