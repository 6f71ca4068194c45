// Hex corrector: a stack of radius-1 hex convolutions over (B, H, W, C) f32
// odd-right grids, each with a bias and an optional ReLU, in one launch;
// the labels variant also takes argmax+1 of the last layer and masks
// background cells to 0.
//
// Replaces the TPU kernels gridnext_tpu/ops/hexcorrector_pallas.py
// fused_hex_corrector and fused_hex_corrector_labels (one pallas_call at
// :165 that ran all five layers in VMEM). The caller folds BatchNorm into
// the weights first.
//
// Bound: operations. Per 78x64 grid the five-layer corrector does ~246
// MFLOP of f32 multiply-adds on ~140 KB of input; the CUDA cores are the
// limit (0.0147 ms for 4 grids at 67 TFLOP/s). A first version ran a launch
// per layer, with every one of up to 264 blocks reloading the layer's
// weights and scalar, uncoalesced loads of each cell's 7 x 32 inputs: 47 us
// a layer on an H100.
//
// Design: one thread-block cluster per grid, all layers in one launch. The
// cluster's CTAs (up to 16, the non-portable size, else fewer) split the
// grid into bands of band_rows whole rows. A layer's output band stays in
// the CTA's shared memory: two buffers, ping-ponged between layers, laid
// out [channel][band_rows + 2][W + 2] with a halo row above and below and
// zero pad columns, so a tap is a fixed offset with no bounds checks. Each
// CTA writes its own rows and pushes its first and last row into the halo
// rows of the CTAs above and below (distributed shared memory stores,
// cluster.map_shared_rank, which do not wait as remote loads would); one
// cluster.sync() per layer orders the writes before the next layer's
// reads. The next layer reads its input in place. Layer 0 stages slices of
// x, halo rows included, into the buffer it does not write, by cp.async.
// Where two band buffers do not fit (hidden widths above about 55, or
// grids far wider than Visium's 64 columns), the bands live in a
// device-memory scratch instead and each slice is staged from there, with
// the same sync, a tile of the band at a time (whole rows first; the band
// itself where it fits), so no width or grid size is refused. The layers'
// weights and shapes come in a device array, so their number is not
// limited, and the grids lie along the x dimension of the launch, so their
// number is not limited by the 65,535 of y. Input channels go in
// slices of kc, and the weights of each slice [tap][ci][32 outputs] are
// copied by cp.async into one of two buffers while the slice before is
// computed, so neither c_in nor the weights' size is limited by shared
// memory. A thread computes 8 outputs of up to kCells cells (cells
// consecutive across a warp, outputs uniform across a warp: the band loads
// hit 32 banks, the weight loads broadcast), only its valid cells, in f32
// FMA: bias first, taps in HEX_TAPS_R1 order, input channels ascending (the
// Pallas kernel's order). Output channels go in tiles of 32. The labels
// variant keeps a running (max, argmax) per cell over the tiles with a
// strict '>' and joins the threads of a cell with ties to the lower class,
// so ties take the first class, as jnp.argmax does, at any class count; the
// last layer's logits never reach device memory. Only 64 of 132 SMs work at
// B = 4 (one 16-CTA cluster a grid); f32 FMA, not the tensor cores, does
// the products (PERF.md: where the time goes and what is next).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// HEX_TAPS_R1 (geometry.py) for tap t: the row offset, and the column
// offset in an even (odd = 0) or odd (odd = 1) row: dr (0, 0, 0, -1, -1, 1,
// 1); dc even (0, -1, 1, -1, 0, -1, 0); dc odd (0, -1, 1, 0, 1, 0, 1).
__host__ __device__ constexpr int tap_dr(int t) { return t < 3 ? 0 : (t < 5 ? -1 : 1); }
__host__ __device__ constexpr int tap_dc(int t, int odd) {
  return t == 0 ? 0 : t == 1 ? -1 : t == 2 ? 1 : ((t & 1) ? -1 : 0) + odd;
}

constexpr int kThreads = 256;
constexpr int kCells = 5;        // cells per thread and pass
constexpr int kOuts = 8;         // output channels per thread
constexpr int kTileOut = 32;     // output channels per tile (up to 4 groups of 8)
constexpr int kWarps = kThreads / 32;
constexpr int kRowBatch = 4;     // tile rows a warp stages at once (8 loads in flight a lane)
constexpr int kSharedLayers = 16;  // layers whose descriptors a CTA keeps in shared memory

// 4-byte asynchronous copy global -> shared; zero-fills when !ok (no read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !ok (no read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for all committed groups but the latest.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

#ifdef HEX_PROBE
// Built with -DHEX_PROBE (tools/time_gather_corrector.py --probe): clocks
// of thread 0 of the first CTA, summed per layer over staging (a slice's
// inputs and weights in), products, epilogue (with the labels' join) and
// the cluster sync; read and zeroed by hex_corrector_probe.
constexpr int kProbeLayers = 16;
__device__ long long probe_clocks[kProbeLayers][4];
#define PROBE(l, k)                                                        \
  do {                                                                     \
    if (blockIdx.x == 0 && threadIdx.x == 0 && (l) < kProbeLayers) {       \
      const long long now = clock64();                                     \
      probe_clocks[l][k] += now - probe_t;                                 \
      probe_t = now;                                                       \
    }                                                                      \
  } while (0)
#else
#define PROBE(l, k) \
  do {              \
  } while (0)
#endif

// One layer of the stack; the caller passes a device array of them, so the
// number of layers is not limited.
struct Layer {
  const float* weight;             // (7, c_in, c_out)
  const float* bias;               // (c_out)
  int c_in, c_out, relu, pad;
};

struct CorrectorArgs {
  const float* x;                  // (nb, h, w, layers[0].c_in)
  const int32_t* fg;               // (nb, h, w), labels only
  float* logits;                   // (nb, h, w, layers[n_layers - 1].c_out), logits only
  int32_t* labels;                 // (nb, h, w), labels only
  float* scratch;                  // (nb, 2, buf_c, h, w) when !smem_bands
  const Layer* layers;             // (n_layers) in device memory
  int n_layers, h, w, band_rows, tile_rows, tile_cols, kc, buf_c;
};

struct Layout {                    // float offsets into dynamic shared memory
  int64_t band, tile, wsl, red;
};

__host__ __device__ inline int64_t up4(int64_t n) { return (n + 3) / 4 * 4; }

// With smem_bands: two band buffers [buf_c][band_rows + 2][w + 2] (own rows,
// a halo row above and below, zero pad columns; the tile is the band), no
// staging tile (layer 0's slices are staged into the second band buffer).
// Without: a staging tile [kc][tile_rows + 2][tile_cols + 2]. Then two
// weight slices (the next one is copied while this one is used) and the
// labels' join buffers. Regions start on 16-byte boundaries (the weight
// slice is read as float4).
__host__ __device__ inline Layout layout(int tile_rows, int tile_cols, int kc, int buf_c,
                                         int smem_bands) {
  Layout l;
  const int64_t plane = static_cast<int64_t>(tile_rows + 2) * (tile_cols + 2);
  l.band = smem_bands ? up4(buf_c * plane) : 0;      // floats of one band buffer
  l.tile = 2 * l.band;
  l.wsl = l.tile + (smem_bands ? 0 : up4(kc * plane));
  l.red = l.wsl + 2 * 7 * kc * kTileOut;             // two weight slices
  return l;
}

__host__ __device__ inline int64_t smem_floats(int tile_rows, int tile_cols, int kc, int buf_c,
                                               int smem_bands) {
  return layout(tile_rows, tile_cols, kc, buf_c, smem_bands).red + 2 * kThreads * kCells;
}

// The weight slice [tap][ci][32 outputs] of layer L, output tile o0 and
// input channels ci0 .. ci0 + kc, into dst by cp.async (not committed);
// outputs past the layer's last are zero.
__device__ __forceinline__ void issue_weights(const Layer& L, int o0, int ci0, int kc,
                                              float* dst) {
  const int c_in = L.c_in, c_out = L.c_out;
  const int kn = min(kc, c_in - ci0), tn = min(kTileOut, c_out - o0);
  const float* __restrict__ wgt = L.weight;
  if (c_out % 4 == 0 && reinterpret_cast<uintptr_t>(wgt) % 16 == 0) {
    // 16-byte copies of 4 outputs (tn is a multiple of 4: a chunk is all in or out)
    for (int i = threadIdx.x; i < 7 * kn * (kTileOut / 4); i += kThreads) {
      const int q = i % (kTileOut / 4), rest = i / (kTileOut / 4);
      const int ci = rest % kn, t = rest / kn;
      const bool ok = 4 * q < tn;
      cp_async16(dst + (t * kc + ci) * kTileOut + 4 * q,
                 ok ? wgt + (static_cast<int64_t>(t) * c_in + ci0 + ci) * c_out + o0 + 4 * q : wgt,
                 ok);
    }
    return;
  }
  for (int i = threadIdx.x; i < 7 * kn * kTileOut; i += kThreads) {
    const int o = i % kTileOut, rest = i / kTileOut;
    const int ci = rest % kn, t = rest / kn;
    const bool ok = o < tn;
    cp_async4(dst + (t * kc + ci) * kTileOut + o,
              ok ? wgt + (static_cast<int64_t>(t) * c_in + ci0 + ci) * c_out + o0 + o : wgt, ok);
  }
}

// acc[j][k] += sum over taps t and slice channels ci < kn of
// in[ci][cell j shifted by tap t] w[t][ci][og * 8 + k], for the first NJ
// cells of the thread (the others are not computed).
template <int NJ>
__device__ __forceinline__ void accumulate(float (&acc)[kCells][kOuts], const float* in,
                                           const float* wsl, int kc, int kn, int plane, int w2,
                                           const int (&base)[kCells], const int (&odd)[kCells],
                                           int og) {
#pragma unroll
  for (int t = 0; t < 7; ++t) {
    int off[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) off[j] = base[j] + tap_dr(t) * w2 + tap_dc(t, odd[j]);
    const float* wt = wsl + t * kc * kTileOut + og * kOuts;
#pragma unroll 2
    for (int ci = 0; ci < kn; ++ci) {
      const float4 wa = *reinterpret_cast<const float4*>(wt + ci * kTileOut);
      const float4 wb = *reinterpret_cast<const float4*>(wt + ci * kTileOut + 4);
      const float wv[kOuts] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const float* tc = in + ci * plane;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float v = tc[off[j]];
#pragma unroll
        for (int k = 0; k < kOuts; ++k) acc[j][k] = fmaf(v, wv[k], acc[j][k]);
      }
    }
  }
}

// kBands: the hidden bands in shared memory (the tile is the band), else
// in the device scratch.
template <bool kBands>
__global__ void __launch_bounds__(kThreads, 1) hex_corrector_kernel(const CorrectorArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h = a.h, w = a.w, rb = a.band_rows, kc = a.kc;
  const int tr = kBands ? rb : a.tile_rows, tw = kBands ? w : a.tile_cols, w2 = tw + 2;
  const Layout lay = layout(tr, tw, kc, a.buf_c, kBands);
  float* wsl = smem + lay.wsl;
  float* red_v = smem + lay.red;
  int* red_i = reinterpret_cast<int*>(red_v + kThreads * kCells);
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int grid = blockIdx.x / n_ranks;
  const int r0 = rank * rb;
  const int rows = max(0, min(rb, h - r0));
  // the band's tiles, row-major: one (the band) with shared bands, else
  // pieces of tr rows and tw columns
  const int tiles_x = kBands ? 1 : (w + tw - 1) / tw;
  const int n_tiles = rows > 0 ? (rows + tr - 1) / tr * tiles_x : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int plane = (tr + 2) * w2;                    // floats of one channel of a band or tile
  // the neighbours' shared memory, for the halo rows this CTA's layers push
  // to them: the CTA above takes this band's first row as its bottom halo,
  // the CTA below its last row as its top halo
  float* up = (kBands && rank > 0) ? cluster.map_shared_rank(smem, rank - 1) : nullptr;
  float* down = (kBands && rank + 1 < n_ranks && r0 + rb < h)
                    ? cluster.map_shared_rank(smem, rank + 1)
                    : nullptr;
  // the first layers' descriptors in shared memory (read at every layer and
  // weight slice), deeper ones from device memory
  __shared__ Layer layer_s[kSharedLayers];
  if (tid < min(a.n_layers, kSharedLayers)) layer_s[tid] = a.layers[tid];
  const auto layer = [&](int l) -> Layer { return l < kSharedLayers ? layer_s[l] : a.layers[l]; };
  // columns of a tile that are staged: whole-width tiles leave the zero pad
  // columns alone, part-row tiles take their neighbours' columns
  const int first_col = tiles_x > 1 ? 0 : 1;

  // bands (or the staging tile) start zero: halo rows at the grid's edge,
  // rows past it and the pad columns are never written and read as zero
  {
    const int64_t n0 = kBands ? 2 * lay.band : up4(static_cast<int64_t>(kc) * plane);
    float* z = smem + (kBands ? 0 : lay.tile);
    for (int64_t i = tid; i < n0; i += kThreads) z[i] = 0.f;
  }
  cluster.sync();                                     // every CTA zeroed before any pushes
  const int wsz = 7 * kc * kTileOut;                  // floats of one weight slice
  int slice = 0;                                      // slices done: slice & 1 holds the next
  if (n_tiles > 0) issue_weights(layer(0), 0, 0, kc, wsl);
  cp_async_commit();
#ifdef HEX_PROBE
  long long probe_t = clock64();
#endif

  for (int l = 0; l < a.n_layers; ++l) {
    const Layer L = layer(l);
    const int c_in = L.c_in, c_out = L.c_out;
    const bool last = l == a.n_layers - 1;
    const bool labels = last && a.labels != nullptr;
    const int in_par = (l + 1) & 1, out_par = l & 1;  // band buffers read and written
    // where a slice of the input is read: layer 0 and scratch bands are
    // staged (layer 0 into the band buffer it does not write), shared bands
    // are read in place
    float* staged = kBands ? smem + lay.band : smem + lay.tile;
    const bool stage_in = l == 0 || !kBands;
    const float* __restrict__ bias = L.bias;
    const bool relu = L.relu != 0;
    // output groups of 8 a tile needs (1, 2 or 4); threads per group
    const int first_tile = min(c_out, kTileOut);
    const int groups = first_tile <= kOuts ? 1 : first_tile <= 2 * kOuts ? 2 : 4;
    const int ncg = kThreads / groups;
    const int og = tid / ncg, cgi = tid % ncg;

    for (int t = 0; t < n_tiles; ++t) {
      const int tr0 = t / tiles_x * tr, tc0 = t % tiles_x * tw;  // in the band, in the grid
      const int trows = min(tr, rows - tr0), tcols = min(tw, w - tc0);
      const int gr0 = r0 + tr0;                       // the tile's first grid row
      const int cells = trows * tcols;
      const int ncols = tcols + 2 - 2 * first_col;    // columns staged from first_col
      const bool last_tile = t + 1 == n_tiles;

      for (int p0 = 0; p0 < cells; p0 += ncg * kCells) {
        int base[kCells], odd[kCells];
#pragma unroll
        for (int j = 0; j < kCells; ++j) {
          const int cell = min(p0 + cgi + ncg * j, cells - 1);   // spare slots repeat a cell
          const int lr = cell / tcols, c = cell % tcols;
          base[j] = (lr + 1) * w2 + c + 1;
          odd[j] = (gr0 + lr) & 1;
        }
        // valid cells of this thread in this pass (cell p0 + cgi + ncg j < cells)
        const int nj = min(kCells, max(0, (cells - p0 - cgi + ncg - 1) / ncg));
        float best_v[kCells];
        int best_i[kCells];
#pragma unroll
        for (int j = 0; j < kCells; ++j) {
          best_v[j] = 0.f;
          best_i[j] = -1;
        }

        for (int o0 = 0; o0 < c_out; o0 += kTileOut) {
          const int tn = min(kTileOut, c_out - o0);
          const int my0 = o0 + og * kOuts;            // this thread's first output
          const bool active = og * kOuts < tn;
          float acc[kCells][kOuts];
#pragma unroll
          for (int k = 0; k < kOuts; ++k) {
            const float b0 = (active && my0 + k < c_out) ? __ldg(bias + my0 + k) : 0.f;
#pragma unroll
            for (int j = 0; j < kCells; ++j) acc[j][k] = b0;
          }

          for (int ci0 = 0; ci0 < c_in; ci0 += kc) {
            const int kn = min(kc, c_in - ci0);
            __syncthreads();                          // the slices' last readers are done
            // the input slice of the tile with its halo rows and columns,
            // zero outside the grid
            if (l == 0) {                             // x from device memory by cp.async
              const float* __restrict__ xg = a.x + static_cast<int64_t>(grid) * h * w * c_in;
              for (int i = tid; i < (tr + 2) * ncols * kn; i += kThreads) {
                const int ci = i % kn, rest = i / kn;   // channels fastest: coalesced
                const int tc = first_col + rest % ncols, trr = rest / ncols;
                const int gr = gr0 - 1 + trr, gc = tc0 - 1 + tc;
                const bool ok = gr >= 0 && gr < h && gc >= 0 && gc < w;
                cp_async4(staged + ci * plane + trr * w2 + tc,
                          ok ? xg + (static_cast<int64_t>(gr) * w + gc) * c_in + ci0 + ci : xg, ok);
              }
            } else if (stage_in) {  // scratch bands: a warp copies kRowBatch rows, 2 columns a lane
              const int nrows = kn * (tr + 2);
              for (int row0 = warp * kRowBatch; row0 < nrows; row0 += kWarps * kRowBatch) {
                const float* src[kRowBatch];
                int dst[kRowBatch];
#pragma unroll
                for (int u = 0; u < kRowBatch; ++u) {
                  const int row = row0 + u;
                  src[u] = nullptr;
                  dst[u] = -1;
                  if (row < nrows) {
                    const int ci = row / (tr + 2), trr = row % (tr + 2);
                    const int gr = gr0 - 1 + trr;
                    dst[u] = ci * plane + trr * w2;
                    if (gr >= 0 && gr < h)
                      src[u] = a.scratch +
                               ((static_cast<int64_t>(grid) * 2 + in_par) * a.buf_c + ci0 + ci) *
                                   h * w +
                               static_cast<int64_t>(gr) * w;
                  }
                }
                for (int c0 = 0; c0 < ncols; c0 += 64) {
                  float v[kRowBatch][2];
#pragma unroll
                  for (int u = 0; u < kRowBatch; ++u)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                      const int c = c0 + lane + 32 * e;
                      const int gc = tc0 - 1 + first_col + c;
                      v[u][e] = (src[u] != nullptr && c < ncols && gc >= 0 && gc < w)
                                    ? __ldcg(src[u] + gc)
                                    : 0.f;
                    }
#pragma unroll
                  for (int u = 0; u < kRowBatch; ++u)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                      const int c = c0 + lane + 32 * e;
                      if (dst[u] >= 0 && c < ncols) staged[dst[u] + first_col + c] = v[u][e];
                    }
                }
              }
            }
            cp_async_commit();                        // layer 0's input slice
            // the next slice's weights, into the other buffer (its last readers
            // were the slice before this one): layer, output tile and channels
            {
              int nl = l, no0 = o0, nci0 = ci0 + kc;
              if (nci0 >= c_in) {
                nci0 = 0;
                no0 = o0 + kTileOut;
                if (no0 >= c_out) {
                  no0 = 0;
                  if (last_tile && p0 + ncg * kCells >= cells) nl = l + 1;
                }
              }
              if (nl < a.n_layers)
                issue_weights(nl == l ? L : layer(nl), no0, nci0, kc,
                              wsl + ((slice + 1) & 1) * wsz);
              cp_async_commit();
            }
            cp_async_wait_one();                      // all but the next slice's weights
            __syncthreads();
            PROBE(l, 0);
            const float* in = stage_in ? staged : smem + in_par * lay.band + ci0 * plane;
            const float* ws = wsl + (slice & 1) * wsz;
            if (active) {
              switch (nj) {                           // the thread's valid cells
                case 0: break;
                case 1: accumulate<1>(acc, in, ws, kc, kn, plane, w2, base, odd, og); break;
                case 2: accumulate<2>(acc, in, ws, kc, kn, plane, w2, base, odd, og); break;
                case 3: accumulate<3>(acc, in, ws, kc, kn, plane, w2, base, odd, og); break;
                case 4: accumulate<4>(acc, in, ws, kc, kn, plane, w2, base, odd, og); break;
                default: accumulate<kCells>(acc, in, ws, kc, kn, plane, w2, base, odd, og);
              }
            }
            PROBE(l, 1);
            ++slice;
          }

          // epilogue of this output tile
          if (active) {
#pragma unroll
            for (int j = 0; j < kCells; ++j) {
              if (j >= nj) break;
              const int cell = p0 + cgi + ncg * j;
              const int lr = cell / tcols, c = cell % tcols;
              const int64_t at = (static_cast<int64_t>(grid) * h + gr0 + lr) * w + tc0 + c;
              const int kmax = min(kOuts, c_out - my0);
              if (labels) {
#pragma unroll
                for (int k = 0; k < kOuts; ++k) {
                  const float v = relu ? fmaxf(acc[j][k], 0.f) : acc[j][k];
                  if (k < kmax && (best_i[j] < 0 || v > best_v[j])) {  // strict: the first maximum
                    best_v[j] = v;
                    best_i[j] = my0 + k;
                  }
                }
              } else if (last) {
                float* o = a.logits + at * c_out + my0;
#pragma unroll
                for (int k = 0; k < kOuts; ++k)
                  if (k < kmax) o[k] = relu ? fmaxf(acc[j][k], 0.f) : acc[j][k];
              } else if (kBands) {
                // own row, and the halo row of the CTA above (first row) or below
                // (last row); the tile is the whole band
                const int64_t ch = out_par * lay.band + static_cast<int64_t>(my0) * plane + c + 1;
                float* own = smem + ch + (lr + 1) * w2;
                float* above = lr == 0 && up != nullptr ? up + ch + (rb + 1) * w2 : nullptr;
                float* below = lr == rb - 1 && down != nullptr ? down + ch : nullptr;
#pragma unroll
                for (int k = 0; k < kOuts; ++k) {
                  if (k >= kmax) break;
                  const float v = relu ? fmaxf(acc[j][k], 0.f) : acc[j][k];
                  own[k * plane] = v;
                  if (above != nullptr) above[k * plane] = v;
                  if (below != nullptr) below[k * plane] = v;
                }
              } else {
                float* o = a.scratch + ((static_cast<int64_t>(grid) * 2 + out_par) * a.buf_c + my0) *
                                           h * w +
                           (at - static_cast<int64_t>(grid) * h * w);
#pragma unroll
                for (int k = 0; k < kOuts; ++k)
                  if (k < kmax) o[static_cast<int64_t>(k) * h * w] = relu ? fmaxf(acc[j][k], 0.f) : acc[j][k];
              }
            }
          }
          PROBE(l, 2);
        }

        if (labels) {
          // join the output groups of each cell: larger value, or the lower class on a tie
#pragma unroll
          for (int j = 0; j < kCells; ++j) {
            red_v[og * ncg * kCells + j * ncg + cgi] = best_v[j];
            red_i[og * ncg * kCells + j * ncg + cgi] = best_i[j];
          }
          __syncthreads();
          if (og == 0) {
#pragma unroll
            for (int j = 0; j < kCells; ++j) {
              const int cell = p0 + cgi + ncg * j;
              if (cell >= cells) continue;
              float bv = best_v[j];
              int bi = best_i[j];
              for (int g = 1; g < groups; ++g) {
                const float v = red_v[g * ncg * kCells + j * ncg + cgi];
                const int i = red_i[g * ncg * kCells + j * ncg + cgi];
                if (i >= 0 && (bi < 0 || v > bv || (v == bv && i < bi))) {
                  bv = v;
                  bi = i;
                }
              }
              const int lr = cell / tcols, c = cell % tcols;
              const int64_t at = (static_cast<int64_t>(grid) * h + gr0 + lr) * w + tc0 + c;
              a.labels[at] = a.fg[at] > 0 ? bi + 1 : 0;
            }
          }
          __syncthreads();
          PROBE(l, 2);
        }
      }
    }
    // this layer's bands and the halo rows pushed to the neighbours are
    // written before any CTA reads them, and read by all before the layer
    // after next overwrites them; no CTA exits while another may still
    // write its shared memory
    if (!kBands) __threadfence();
    cluster.sync();
    PROBE(l, 3);
  }
}

template <bool kBands>
cudaError_t allow_smem(int smem) {
  cudaFuncAttributes fa = {};
  if (cudaError_t err = cudaFuncGetAttributes(&fa, hex_corrector_kernel<kBands>)) return err;
  if (cudaError_t err = cudaFuncSetAttribute(hex_corrector_kernel<kBands>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             smem - static_cast<int>(fa.sharedSizeBytes)))
    return err;
  return cudaFuncSetAttribute(hex_corrector_kernel<kBands>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t config(int n_blocks, int cluster, size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Lets hex_corrector_kernel use all the shared memory a block may opt into
// (less its static descriptors) and 16-CTA clusters, on the current device.
// Call once per device before the functions below.
extern "C" int hex_corrector_prepare() {
  int dev = 0, smem = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return static_cast<int>(err);
  if (cudaError_t err =
          cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
    return static_cast<int>(err);
  if (cudaError_t err = allow_smem<true>(smem)) return static_cast<int>(err);
  return static_cast<int>(allow_smem<false>(smem));
}

#ifdef HEX_PROBE
// Copies the probe clocks (kProbeLayers x 4 long long) to host memory and
// zeroes them.
extern "C" int hex_corrector_probe(long long* out) {
  if (cudaError_t err = cudaMemcpyFromSymbol(out, probe_clocks, sizeof(probe_clocks)))
    return static_cast<int>(err);
  static const long long zero[kProbeLayers][4] = {};
  return static_cast<int>(cudaMemcpyToSymbol(probe_clocks, zero, sizeof(zero)));
}
#endif

// How many clusters of `cluster` CTAs with `smem` bytes each the card can
// hold at once (0: this cluster size cannot launch), bands in shared memory
// or not.
extern "C" int hex_corrector_max_clusters(int cluster, long long smem, int smem_bands) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(cluster, cluster, static_cast<size_t>(smem), nullptr, &attr);
  int n = 0;
  const cudaError_t err =
      smem_bands ? cudaOccupancyMaxActiveClusters(&n, hex_corrector_kernel<true>, &cfg)
                 : cudaOccupancyMaxActiveClusters(&n, hex_corrector_kernel<false>, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// The corrector over nb grids in one launch: x (nb, h, w, layers[0].c_in)
// f32; layers a device array of n_layers Layer (weights (7, c_in, c_out)
// and biases (c_out) f32 in device memory). fg == null: logits (nb, h, w,
// c_out of the last layer) f32 into out; else labels (nb, h, w) int32 into
// out (argmax + 1, 0 where fg == 0). A cluster of `cluster` CTAs per grid,
// bands of band_rows rows, worked in tiles of tile_rows x tile_cols (the
// whole band when smem_bands). scratch holds nb * 2 * buf_c * h * w floats
// when smem_bands == 0 and n_layers > 1 (else may be null). Returns
// cudaGetLastError() after the launch, or the first failure.
extern "C" int hex_corrector_f32(const void* x, const void* fg, void* out, void* scratch,
                                 const void* layers, int n_layers, int nb, int h, int w,
                                 int cluster, int band_rows, int tile_rows, int tile_cols,
                                 int kc, int buf_c, int smem_bands, void* stream) {
  if (n_layers < 1 || nb < 1 || h < 1 || w < 1 || cluster < 1 || band_rows < 1 || kc < 1 ||
      static_cast<long long>(cluster) * band_rows < h ||
      static_cast<long long>(cluster) * nb > 0x7fffffffLL || tile_rows < 1 ||
      tile_rows > band_rows || tile_cols < 1 || tile_cols > w ||
      (smem_bands && (tile_rows != band_rows || tile_cols != w)) ||
      (!smem_bands && n_layers > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CorrectorArgs args = {};
  args.x = static_cast<const float*>(x);
  args.fg = static_cast<const int32_t*>(fg);
  if (fg == nullptr)
    args.logits = static_cast<float*>(out);
  else
    args.labels = static_cast<int32_t*>(out);
  args.scratch = static_cast<float*>(scratch);
  args.layers = static_cast<const Layer*>(layers);
  args.n_layers = n_layers;
  args.h = h;
  args.w = w;
  args.band_rows = band_rows;
  args.tile_rows = tile_rows;
  args.tile_cols = tile_cols;
  args.kc = kc;
  args.buf_c = buf_c;
  const size_t smem =
      static_cast<size_t>(smem_floats(tile_rows, tile_cols, kc, buf_c, smem_bands)) * sizeof(float);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(cluster * nb, cluster, smem, static_cast<cudaStream_t>(stream), &attr);
  if (cudaError_t err = smem_bands ? cudaLaunchKernelEx(&cfg, hex_corrector_kernel<true>, args)
                                   : cudaLaunchKernelEx(&cfg, hex_corrector_kernel<false>, args))
    return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
