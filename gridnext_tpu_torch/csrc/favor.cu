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
// memory: each is made tile by tile in shared memory and consumed there.
//
// Bound: operations. At scBERT's shape (B 8, H 10, N 16,907, d 64, m 266)
// the four products (phi(k), ctx, phi(q), out) are 2 B H N d m FLOP each,
// 1.85e11 FLOP per call: 2.76 ms at the 67 TFLOP/s f32 CUDA-core peak,
// against 0.41 ms to read q, k, v and write out once at 3.35 TB/s. This
// first version multiplies in f32 on the CUDA cores (no tensor cores), so
// the FLOP bound is the one it can approach.
//
// Design (three launches on the caller's stream):
// 1. favor_accum_kernel: one block per (64-feature chunk of m, split of the
//    sequence, (b, h)). The TPU kernel carried ksum/ctx across a sequential
//    grid; Hopper blocks run in parallel, so the sequence is split into
//    `splits` ranges (enough blocks to fill 132 SMs even at B H = 80) and
//    each block writes its own partial ctx/ksum. A block keeps its
//    64 x d slice of ctx in registers while it walks its row tiles:
//    load 64 rows of k (scaled by d^-1/4) and v, phi = relu(k proj^T) + eps
//    into shared memory (rows >= N and features >= m set to exactly 0:
//    the +eps would otherwise leak into ksum and ctx), then ctx += phi^T v.
// 2. favor_reduce_kernel sums the partials over the splits in a fixed
//    order, so the result does not depend on the schedule (no atomics).
// 3. favor_apply_kernel: one block per (64-row tile of the sequence, (b, h));
//    it holds its q tile in shared memory and walks the feature chunks,
//    loading each chunk of proj, ctx and ksum, making phi(q) for the chunk
//    and accumulating phi(q) ctx and phi(q) . ksum in registers.
// Shared memory per block is ~70 KB at d = 64 (four 64 x (d+4) tiles):
// the 266 x 64 proj and ctx (68 KB each) are never held whole, the m axis
// is tiled instead. Register tiles are 4 x 4 per thread at d = 64; smem
// rows are padded by 4 floats so the float4 reads of a quarter-warp hit
// eight distinct 16-byte bank groups. Sums run in a fixed order: d
// ascending in phi, rows ascending within a split and splits ascending in
// ctx/ksum, features ascending in the output.
// q, k and v may be strided views (the heads split of a (B, N, H d)
// projection): their element strides over b, h and n are arguments, the
// last dimension must be contiguous, and the strides multiples of 4.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 64;             // sequence rows per tile
constexpr int kTileM = 64;             // features per chunk
constexpr int kPadM = kTileM + 4;      // shared row stride of feature tiles
constexpr float kEps = 1e-3f;          // generalized_kernel_features kernel_epsilon

template <int D>
struct Geo {
  static constexpr int kPadD = D + 4;                        // smem row stride of (rows, d) tiles
  static constexpr int kEG = D / 4;                          // float4 groups along d
  static constexpr int kFW = kTileM * kEG / kThreads;        // features per thread in ctx
  static constexpr int kRW = kTileN * kEG / kThreads;        // rows per thread in out
  static_assert(kFW >= 1 && kRW >= 1, "d must be 16, 32 or 64");
};

// Rows [row0, row0 + 64) of one (rows, D) slice with row stride `stride`
// into a (64, D + 4) shared tile, times `scale`; rows >= n read as zeros.
template <int D>
__device__ __forceinline__ void load_rows(const float* __restrict__ base, int64_t stride,
                                          int row0, int n, float scale, float* dst) {
  constexpr int EG = Geo<D>::kEG;
  for (int idx = threadIdx.x; idx < kTileN * EG; idx += kThreads) {
    const int r = idx / EG, c4 = idx % EG;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) {
      val = __ldg(reinterpret_cast<const float4*>(base + (row0 + r) * stride) + c4);
      val.x *= scale;
      val.y *= scale;
      val.z *= scale;
      val.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * Geo<D>::kPadD + 4 * c4) = val;
  }
}

// phi tile (64 rows x 64 features) of x_s (rows) against p_s (features):
// thread (a = tid % 16, b = tid / 16) owns rows 4b..4b+3 and features
// a, a+16, a+32, a+48; the products are stored with the ReLU, the +eps and
// the masks (row0 + r >= n or j0 + j >= m gives exactly 0).
template <int D>
__device__ __forceinline__ void feature_tile(const float* x_s, const float* p_s, int row0,
                                             int n, int j0, int m, float* phi_s) {
  constexpr int PD = Geo<D>::kPadD;
  const int a = threadIdx.x & 15, b = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 xv[4], pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xv[i] = *reinterpret_cast<const float4*>(x_s + (4 * b + i) * PD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      pv[c] = *reinterpret_cast<const float4*>(p_s + (a + 16 * c) * PD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[i][c] = fmaf(xv[i].x, pv[c].x, acc[i][c]);
        acc[i][c] = fmaf(xv[i].y, pv[c].y, acc[i][c]);
        acc[i][c] = fmaf(xv[i].z, pv[c].z, acc[i][c]);
        acc[i][c] = fmaf(xv[i].w, pv[c].w, acc[i][c]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * b + i;
    const bool row_ok = row0 + r < n;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = a + 16 * c;
      phi_s[r * kPadM + j] = (row_ok && j0 + j < m) ? fmaxf(acc[i][c], 0.f) + kEps : 0.f;
    }
  }
}

// W consecutive floats of shared memory (W = 1, 2 or 4; 4W-byte aligned).
template <int W>
__device__ __forceinline__ void load_w(const float* src, float (&dst)[W]) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x;
    dst[1] = t.y;
    dst[2] = t.z;
    dst[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x;
    dst[1] = t.y;
  } else {
    dst[0] = src[0];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
favor_accum_kernel(const float* __restrict__ k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
                   const float* __restrict__ v, int64_t v_sb, int64_t v_sh, int64_t v_sn,
                   int heads, const float* __restrict__ proj, int n, int m, int m_chunks,
                   int splits, int tiles_per_split, float scale,
                   float* __restrict__ part_ctx, float* __restrict__ part_ks) {
  constexpr int PD = Geo<D>::kPadD, EG = Geo<D>::kEG, FW = Geo<D>::kFW;
  extern __shared__ float4 smem4[];
  float* p_s = reinterpret_cast<float*>(smem4);
  float* k_s = p_s + kTileM * PD;
  float* v_s = k_s + kTileN * PD;
  float* phi_s = v_s + kTileN * PD;

  int blk = blockIdx.x;
  const int mc = blk % m_chunks;       // fastest: the chunks of one row range share k, v in L2
  blk /= m_chunks;
  const int s = blk % splits;
  const int bh = blk / splits;
  const int b = bh / heads, h = bh % heads;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const int j0 = mc * kTileM;
  load_rows<D>(proj, D, j0, m, 1.f, p_s);

  const int e = threadIdx.x % EG, f = threadIdx.x / EG;
  float acc[FW][4], ks[FW];
#pragma unroll
  for (int u = 0; u < FW; ++u) {
    ks[u] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[u][c] = 0.f;
  }
  const int tiles = (n + kTileN - 1) / kTileN;
  const int t0 = s * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, tiles);
  for (int t = t0; t < t1; ++t) {
    const int row0 = t * kTileN;
    __syncthreads();                   // the previous tile's readers are done
    load_rows<D>(kb, k_sn, row0, n, scale, k_s);
    load_rows<D>(vb, v_sn, row0, n, 1.f, v_s);
    __syncthreads();
    feature_tile<D>(k_s, p_s, row0, n, j0, m, phi_s);
    __syncthreads();
    // ctx[j][4e..4e+3] += sum_r phi[r][j] v[r][4e..4e+3], j = f FW + u
#pragma unroll 4
    for (int r = 0; r < kTileN; ++r) {
      const float4 vv = *reinterpret_cast<const float4*>(v_s + r * PD + 4 * e);
      float pf[FW];
      load_w<FW>(phi_s + r * kPadM + f * FW, pf);
#pragma unroll
      for (int u = 0; u < FW; ++u) {
        acc[u][0] = fmaf(pf[u], vv.x, acc[u][0]);
        acc[u][1] = fmaf(pf[u], vv.y, acc[u][1]);
        acc[u][2] = fmaf(pf[u], vv.z, acc[u][2]);
        acc[u][3] = fmaf(pf[u], vv.w, acc[u][3]);
      }
    }
    // ksum: this thread's rows are e, e + EG, ...; lanes are summed below
    for (int r = e; r < kTileN; r += EG) {
      float pf[FW];
      load_w<FW>(phi_s + r * kPadM + f * FW, pf);
#pragma unroll
      for (int u = 0; u < FW; ++u) ks[u] += pf[u];
    }
  }
  const int m_pad = m_chunks * kTileM;
  const int64_t part = static_cast<int64_t>(bh) * splits + s;
#pragma unroll
  for (int u = 0; u < FW; ++u) {
    const int j = j0 + f * FW + u;
    *reinterpret_cast<float4*>(part_ctx + (part * m_pad + j) * D + 4 * e) =
        make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    // the EG lanes of a feature group are consecutive lanes of one warp
    for (int off = EG / 2; off > 0; off >>= 1)
      ks[u] += __shfl_xor_sync(0xffffffffu, ks[u], off);
    if (e == 0) part_ks[part * m_pad + j] = ks[u];
  }
}

// ctx[bh] = sum over splits of part_ctx[bh][s], ksum likewise, splits in order.
__global__ void __launch_bounds__(kThreads)
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
__global__ void __launch_bounds__(kThreads)
favor_apply_kernel(const float* __restrict__ q, int64_t q_sb, int64_t q_sh, int64_t q_sn,
                   int heads, const float* __restrict__ proj, const float* __restrict__ ctx,
                   const float* __restrict__ ks, int n, int m, int m_chunks, float scale,
                   float* __restrict__ out) {
  constexpr int PD = Geo<D>::kPadD, EG = Geo<D>::kEG, RW = Geo<D>::kRW;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* p_s = q_s + kTileN * PD;
  float* c_s = p_s + kTileM * PD;
  float* phi_s = c_s + kTileM * PD;
  float* ks_s = phi_s + kTileN * kPadM;

  const int tiles = (n + kTileN - 1) / kTileN;
  const int t = blockIdx.x % tiles;    // fastest: the tiles of one (b, h) share ctx in L2
  const int bh = blockIdx.x / tiles;
  const int b = bh / heads, h = bh % heads;
  const int row0 = t * kTileN;
  const int m_pad = m_chunks * kTileM;
  const float* ctx_bh = ctx + static_cast<int64_t>(bh) * m_pad * D;
  load_rows<D>(q + b * q_sb + h * q_sh, q_sn, row0, n, scale, q_s);

  const int e = threadIdx.x % EG, g = threadIdx.x / EG;
  float acc[RW][4], den[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    den[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }
  for (int mc = 0; mc < m_chunks; ++mc) {
    const int j0 = mc * kTileM;
    __syncthreads();                   // the previous chunk's readers are done
    load_rows<D>(proj, D, j0, m, 1.f, p_s);
    load_rows<D>(ctx_bh, D, j0, m_pad, 1.f, c_s);
    for (int j = threadIdx.x; j < kTileM; j += kThreads)
      ks_s[j] = ks[static_cast<int64_t>(bh) * m_pad + j0 + j];
    __syncthreads();
    feature_tile<D>(q_s, p_s, row0, n, j0, m, phi_s);
    __syncthreads();
    // out[r][4e..4e+3] += sum_j phi[r][j] ctx[j][4e..4e+3], r = g RW + i
#pragma unroll 2
    for (int j = 0; j < kTileM; j += 4) {
      float4 cv[4], pf[RW];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        cv[jj] = *reinterpret_cast<const float4*>(c_s + (j + jj) * PD + 4 * e);
#pragma unroll
      for (int i = 0; i < RW; ++i)
        pf[i] = *reinterpret_cast<const float4*>(phi_s + (g * RW + i) * kPadM + j);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        acc[i][0] = fmaf(pf[i].x, cv[0].x, acc[i][0]);
        acc[i][1] = fmaf(pf[i].x, cv[0].y, acc[i][1]);
        acc[i][2] = fmaf(pf[i].x, cv[0].z, acc[i][2]);
        acc[i][3] = fmaf(pf[i].x, cv[0].w, acc[i][3]);
        acc[i][0] = fmaf(pf[i].y, cv[1].x, acc[i][0]);
        acc[i][1] = fmaf(pf[i].y, cv[1].y, acc[i][1]);
        acc[i][2] = fmaf(pf[i].y, cv[1].z, acc[i][2]);
        acc[i][3] = fmaf(pf[i].y, cv[1].w, acc[i][3]);
        acc[i][0] = fmaf(pf[i].z, cv[2].x, acc[i][0]);
        acc[i][1] = fmaf(pf[i].z, cv[2].y, acc[i][1]);
        acc[i][2] = fmaf(pf[i].z, cv[2].z, acc[i][2]);
        acc[i][3] = fmaf(pf[i].z, cv[2].w, acc[i][3]);
        acc[i][0] = fmaf(pf[i].w, cv[3].x, acc[i][0]);
        acc[i][1] = fmaf(pf[i].w, cv[3].y, acc[i][1]);
        acc[i][2] = fmaf(pf[i].w, cv[3].z, acc[i][2]);
        acc[i][3] = fmaf(pf[i].w, cv[3].w, acc[i][3]);
      }
    }
    // denominator: this thread's features are e, e + EG, ...; lanes summed below
    for (int j = e; j < kTileM; j += EG) {
      const float kv = ks_s[j];
#pragma unroll
      for (int i = 0; i < RW; ++i) den[i] = fmaf(phi_s[(g * RW + i) * kPadM + j], kv, den[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    for (int off = EG / 2; off > 0; off >>= 1)
      den[i] += __shfl_xor_sync(0xffffffffu, den[i], off);
    const int r = g * RW + i;
    if (row0 + r < n) {
      const float inv = 1.f / den[i];
      *reinterpret_cast<float4*>(out + (static_cast<int64_t>(bh) * n + row0 + r) * D + 4 * e) =
          make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D>
int launch(const float* q, const int64_t* qs, const float* k, const int64_t* ks_,
           const float* v, const int64_t* vs, int batch, int heads, int n, const float* proj,
           int m, int splits, float scale, float* work, float* out, cudaStream_t stream) {
  constexpr int PD = Geo<D>::kPadD;
  const int m_chunks = (m + kTileM - 1) / kTileM;
  const int m_pad = m_chunks * kTileM;
  const int bh = batch * heads;
  const int tiles = (n + kTileN - 1) / kTileN;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  float* part_ctx = work;
  float* part_ks = part_ctx + static_cast<int64_t>(bh) * splits * m_pad * D;
  float* ctx = part_ks + static_cast<int64_t>(bh) * splits * m_pad;
  float* ksum = ctx + static_cast<int64_t>(bh) * m_pad * D;

  const size_t smem_accum = sizeof(float) * ((kTileM + 2 * kTileN) * PD + kTileN * kPadM);
  const size_t smem_apply =
      sizeof(float) * ((kTileN + 2 * kTileM) * PD + kTileN * kPadM + kTileM);
  if (cudaError_t err = set_smem(favor_accum_kernel<D>, smem_accum)) return err;
  if (cudaError_t err = set_smem(favor_apply_kernel<D>, smem_apply)) return err;

  favor_accum_kernel<D><<<m_chunks * splits * bh, kThreads, smem_accum, stream>>>(
      k, ks_[0], ks_[1], ks_[2], v, vs[0], vs[1], vs[2], heads, proj, n, m, m_chunks, splits,
      tiles_per_split, scale, part_ctx, part_ks);
  if (cudaError_t err = cudaGetLastError()) return err;

  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t items = static_cast<int64_t>(bh) * m_pad * (D + 1);
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int reduce_blocks = static_cast<int>(want < 4 * sms ? want : 4 * sms);
  favor_reduce_kernel<<<reduce_blocks, kThreads, 0, stream>>>(part_ctx, part_ks, bh, splits,
                                                              m_pad, D, ctx, ksum);
  if (cudaError_t err = cudaGetLastError()) return err;

  favor_apply_kernel<D><<<tiles * bh, kThreads, smem_apply, stream>>>(
      q, qs[0], qs[1], qs[2], heads, proj, ctx, ksum, n, m, m_chunks, scale, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of scratch that favor_attention_f32 needs (partial and reduced
// ctx/ksum) for b*h = bh, the given splits, m features and head width d.
extern "C" long long favor_workspace_floats(int bh, int splits, int m, int d) {
  const long long m_pad = (m + kTileM - 1) / kTileM * static_cast<long long>(kTileM);
  return static_cast<long long>(bh) * m_pad * (d + 1) * (splits + 1);
}

// out (batch, heads, n, d) contiguous f32 = ReLU-FAVOR attention of q, k, v
// (element strides over batch, heads and rows in q_s/k_s/v_s; the last
// dimension contiguous) with proj (m, d) contiguous. d is 16, 32 or 64;
// pointers 16-byte aligned and strides multiples of 4. `work` holds
// favor_workspace_floats(batch * heads, splits, m, d) floats. Returns
// cudaGetLastError() after the last launch (or the first failure).
extern "C" int favor_attention_f32(const void* q, long long q_sb, long long q_sh,
                                   long long q_sn, const void* k, long long k_sb,
                                   long long k_sh, long long k_sn, const void* v,
                                   long long v_sb, long long v_sh, long long v_sn, int batch,
                                   int heads, int n, int d, const void* proj, int m,
                                   int splits, float scale, void* work, void* out,
                                   void* stream) {
  if (batch < 1 || heads < 1 || n < 1 || m < 1 || splits < 1)
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
  switch (d) {
    case 16:
      return launch<16>(qf, qs, kf, ks, vf, vs, batch, heads, n, pf, m, splits, scale, wf, of, st);
    case 32:
      return launch<32>(qf, qs, kf, ks, vf, vs, batch, heads, n, pf, m, splits, scale, wf, of, st);
    case 64:
      return launch<64>(qf, qs, kf, ks, vf, vs, batch, heads, n, pf, m, splits, scale, wf, of, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
