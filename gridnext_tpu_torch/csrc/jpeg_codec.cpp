// Baseline JPEG codec on the host, self-contained (no libjpeg, no PIL).
//
// It reproduces libjpeg-turbo's default integer path as Pillow drives it, bit
// for bit: what ``Image.save(..., "JPEG", quality=q)`` writes and what
// ``np.asarray(Image.open(path))`` decodes.
//
// Encoder: RGB -> YCbCr in 16-bit fixed point, 2x2 chroma downsampling
// (Pillow's default 4:2:0) with libjpeg's alternating rounding bias, edge replication to
// whole blocks and DC-only dummy blocks to whole MCUs, the ``islow`` forward
// DCT, quantisation by libjpeg-turbo's reciprocal multiply, the IJG quality
// scaling of the Annex K tables, the Annex K Huffman tables (Pillow's
// default ``optimize=False``) and a JFIF APP0 header.
//
// Decoder: SOF0, SOF1 (8-bit Huffman sequential) and SOF2 (progressive
// Huffman: DC and AC first and refinement scans, spectral selection and
// successive approximation in any order a scan script allows, EOB runs);
// SOF9 and SOF10, the same coefficients arithmetic-coded (ITU T.81 Annex D's
// QM decoder, the statistics areas and DAC conditioning of Annexes F and G,
// as libjpeg's jdarith.c decodes them); SOF3, lossless (Annex H: predictors
// 1-7, point transforms, restarts, as libjpeg-turbo 3's jdlossls.c);
// 1, 3 or 4 components, every integral sampling factor of 1 to 4 per axis,
// interleaved or one scan a component, DRI and restart markers, the ``islow``
// inverse DCT as libjpeg-turbo's SIMD code computes it, libjpeg-turbo's
// upsamplers (fancy h2v1 and h2v2 where the component is wider than 2
// samples, fancy h1v2, replication for every other factor) and fixed-point
// YCbCr -> RGB and YCCK -> CMYK. A progressive file whose scans leave any of
// the first nine AC coefficients of a component unsent or unrefined is
// smoothed between blocks at output as libjpeg-turbo 2.1+ does (jdcoefct.c,
// decompress_smooth_data). Damaged data decodes as libjpeg decodes it: a
// Huffman segment that ends at a marker gives zeros to the end of its
// restart interval, an arithmetic one reads zero bytes, a bad code reads as
// symbol 0. Refused with a message: what Pillow refuses (12-bit samples,
// SOF11, hierarchical files (SOF5-7, SOF13-15), lossless with a colour
// transform, a file that ends inside its data) and lossless files with
// subsampled components.
//
// Plain C interface for ctypes; every entry returns 0 on success or writes a
// message into ``err``. Threads: a slide decodes its entropy data on one
// thread and runs the inverse DCT and colour conversion on ``n_threads``
// (its pixels do not depend on the count); batches run one image a thread.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError(msg); }

// Zigzag position -> natural (row-major) position; 16 extra entries keep a
// corrupt run inside the block, as libjpeg's table does.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ITU-T T.81 Annex K tables, natural order
const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ---------------------------------------------------------------- DCTs --
// jfdctint.c / jidctint.c: 13-bit constants, 2 extra bits between passes.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

// libjpeg computes these products in 64-bit ``long``
using jl = int64_t;

inline jl descale(jl x, int n) { return (x + (jl(1) << (n - 1))) >> n; }

// In place on an 8x8 block of (sample - 128); outputs scaled up by 8.
void fdct_islow(jl* d) {
  for (int r = 0; r < 8; ++r) {
    jl* p = d + 8 * r;
    jl tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    jl tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    jl tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    jl tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    jl tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    jl tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
    p[4] = (tmp10 - tmp11) * (1 << kPass1Bits);
    jl z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = descale(z1 + tmp13 * FIX_0_765366865, kConstBits - kPass1Bits);
    p[6] = descale(z1 + tmp12 * -FIX_1_847759065, kConstBits - kPass1Bits);
    z1 = tmp4 + tmp7;
    jl z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    jl z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = descale(tmp4 + z1 + z3, kConstBits - kPass1Bits);
    p[5] = descale(tmp5 + z2 + z4, kConstBits - kPass1Bits);
    p[3] = descale(tmp6 + z2 + z3, kConstBits - kPass1Bits);
    p[1] = descale(tmp7 + z1 + z4, kConstBits - kPass1Bits);
  }
  for (int c = 0; c < 8; ++c) {
    jl* p = d + c;
    jl tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    jl tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    jl tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    jl tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    jl tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    jl tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = descale(tmp10 + tmp11, kPass1Bits);
    p[32] = descale(tmp10 - tmp11, kPass1Bits);
    jl z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = descale(z1 + tmp13 * FIX_0_765366865, kConstBits + kPass1Bits);
    p[48] = descale(z1 + tmp12 * -FIX_1_847759065, kConstBits + kPass1Bits);
    z1 = tmp4 + tmp7;
    jl z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    jl z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = descale(tmp4 + z1 + z3, kConstBits + kPass1Bits);
    p[40] = descale(tmp5 + z2 + z4, kConstBits + kPass1Bits);
    p[24] = descale(tmp6 + z2 + z3, kConstBits + kPass1Bits);
    p[8] = descale(tmp7 + z1 + z4, kConstBits + kPass1Bits);
  }
}

// Dequantise and inverse-transform one block into 8 rows of ``out``, as
// libjpeg-turbo's SIMD ``islow`` IDCT (jidctint-sse2/-avx2, what Pillow runs
// on x86-64) computes it: the products coefficient * quantiser and the sums
// in0 + in4, in0 - in4, in7 + in3 and in5 + in1 in 16-bit lanes (wrapping),
// the rotations in 32-bit lanes, each pass's outputs saturated to 16 bits,
// the samples to -128..127. Inside 16 bits (every well-formed file) this is
// jidctint.c's arithmetic exactly; a corrupt file's extreme coefficients
// wrap and saturate as Pillow's do.
inline int16_t wrap16(int64_t v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }
inline int32_t wrap32(int64_t v) { return static_cast<int32_t>(static_cast<uint32_t>(v)); }
inline int16_t sat16(int64_t v) {
  return static_cast<int16_t>(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
}

// One 1-D pass over d[0..7] (stride ``step``), outputs (x + 2^(n-1)) >> n
// saturated to 16 bits.
inline void idct_1d(const int16_t* d, int step, int n, int16_t* o, int ostep) {
  const jl z2 = d[2 * step], z3 = d[6 * step];
  const jl tmp2 = z2 * FIX_0_541196100 + z3 * (FIX_0_541196100 - FIX_1_847759065);
  const jl tmp3 = z2 * (FIX_0_541196100 + FIX_0_765366865) + z3 * FIX_0_541196100;
  const jl tmp0 = jl(wrap16(jl(d[0]) + d[4 * step])) * (1 << kConstBits);
  const jl tmp1 = jl(wrap16(jl(d[0]) - d[4 * step])) * (1 << kConstBits);
  const jl tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const jl t0 = d[7 * step], t1 = d[5 * step], t2 = d[3 * step], t3 = d[step];
  const jl s3 = wrap16(t0 + t2), s4 = wrap16(t1 + t3);
  const jl z3r = s3 * (FIX_1_175875602 - FIX_1_961570560) + s4 * FIX_1_175875602;
  const jl z4r = s3 * FIX_1_175875602 + s4 * (FIX_1_175875602 - FIX_0_390180644);
  const jl o0 = t0 * (FIX_0_298631336 - FIX_0_899976223) + t3 * -FIX_0_899976223 + z3r;
  const jl o1 = t1 * (FIX_2_053119869 - FIX_2_562915447) + t2 * -FIX_2_562915447 + z4r;
  const jl o2 = t1 * -FIX_2_562915447 + t2 * (FIX_3_072711026 - FIX_2_562915447) + z3r;
  const jl o3 = t0 * -FIX_0_899976223 + t3 * (FIX_1_501321110 - FIX_0_899976223) + z4r;
  const jl half = jl(1) << (n - 1);
  auto put = [&](int i, jl v) { o[i * ostep] = sat16(wrap32(v + half) >> n); };
  put(0, tmp10 + o3);
  put(7, tmp10 - o3);
  put(1, tmp11 + o2);
  put(6, tmp11 - o2);
  put(2, tmp12 + o1);
  put(5, tmp12 - o1);
  put(3, tmp13 + o0);
  put(4, tmp13 - o0);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int64_t stride) {
  int16_t dq[64], ws[64], px[64];
  bool ac_zero = true;                 // rows 1-7 all zero: DC only, 16-bit shift
  for (int i = 8; i < 64; ++i) ac_zero &= in[i] == 0;
  for (int i = 0; i < 64; ++i) dq[i] = wrap16(jl(in[i]) * q[i]);
  if (ac_zero) {
    for (int c = 0; c < 8; ++c)
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = wrap16(jl(dq[c]) * (1 << kPass1Bits));
  } else {
    for (int c = 0; c < 8; ++c) {
      const int16_t* d = dq + c;
      if (d[8] == 0 && d[16] == 0 && d[24] == 0 && d[32] == 0 && d[40] == 0 && d[48] == 0 &&
          d[56] == 0) {                // what idct_1d gives a column of zero AC
        const int16_t v = sat16(jl(d[0]) * (1 << kPass1Bits));
        for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
      } else {
        idct_1d(d, 8, kConstBits - kPass1Bits, ws + c, 8);
      }
    }
  }
  for (int r = 0; r < 8; ++r) idct_1d(ws + 8 * r, 1, kConstBits + kPass1Bits + 3, px + 8 * r, 1);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) {
      const int v = px[8 * r + c];
      out[r * stride + c] = static_cast<uint8_t>((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
    }
}

// ------------------------------------------------------ colour tables --
constexpr int kScaleBits = 16;
constexpr int32_t kOneHalf = 1 << (kScaleBits - 1);
constexpr int32_t fix(double x) { return static_cast<int32_t>(x * (1 << kScaleBits) + 0.5); }

struct ColorTables {
  // encoder (jccolor.c)
  int32_t ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256], gcr[256], bcr[256];
  // decoder (jdcolor.c)
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  ColorTables() {
    const int32_t cbcr_offset = 128 << kScaleBits;
    for (int i = 0; i < 256; ++i) {
      ry[i] = fix(0.29900) * i;
      gy[i] = fix(0.58700) * i;
      by[i] = fix(0.11400) * i + kOneHalf;
      rcb[i] = -fix(0.16874) * i;
      gcb[i] = -fix(0.33126) * i;
      bcb[i] = fix(0.50000) * i + cbcr_offset + kOneHalf - 1;  // also R's Cr term
      gcr[i] = -fix(0.41869) * i;
      bcr[i] = -fix(0.08131) * i;
      int x = i - 128;
      cr_r[i] = (fix(1.40200) * x + kOneHalf) >> kScaleBits;
      cb_b[i] = (fix(1.77200) * x + kOneHalf) >> kScaleBits;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// Run fn(i) for i in [0, n) on up to n_threads threads (0: all cores). A
// failure stops the hand-out of further i; the one of the lowest i is
// rethrown (indices go out in order, so no lower one was left untried).
template <class F>
void parallel_for(int64_t n, int n_threads, F fn) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (static_cast<int64_t>(n_threads) > n) n_threads = static_cast<int>(n);
  if (n_threads <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::atomic<bool> failed(false);
  std::vector<std::thread> ts;
  std::vector<std::pair<int64_t, std::string>> errors(n_threads, {n, ""});
  ts.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    ts.emplace_back([&, t]() {
      for (;;) {
        if (failed.load(std::memory_order_relaxed)) return;
        const int64_t i = next.fetch_add(1);
        if (i >= n) return;
        try {
          fn(i);
        } catch (const std::exception& e) {
          errors[t] = {i, e.what()};
          failed.store(true);
          return;
        }
      }
    });
  }
  for (auto& th : ts) th.join();
  const auto first = std::min_element(errors.begin(), errors.end());
  if (first->first < n) fail(first->second);
}

// ------------------------------------------------------------ decoder --

constexpr int kLookBits = 10;  // Huffman lookahead (codes up to 10 bits in one probe)

struct HuffDecoder {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];  // code length of the lookahead (0: longer code)
  uint8_t look_val[1 << kLookBits];
  // AC tables: code and magnitude bits together within the lookahead, as
  // value * 65536 + run * 256 + bits used (0: take the general path)
  int32_t fast_ac[1 << kLookBits];
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valoffset[18];  // symbol index = code + valoffset[length]
  uint8_t vals[256];

  void build(const uint8_t* bits, const uint8_t* symbols, int n_symbols, bool ac) {
    std::memset(look_len, 0, sizeof(look_len));
    std::memset(fast_ac, 0, sizeof(fast_ac));
    std::memcpy(vals, symbols, n_symbols);
    int32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code) {
        if (code >= (1 << len)) fail("bad Huffman table");
        if (len > kLookBits) continue;
        const int shift = kLookBits - len;
        const int rs = symbols[k], run = rs >> 4, size = rs & 15;
        for (int j = 0; j < (1 << shift); ++j) {
          const int idx = (code << shift) | j;
          look_len[idx] = static_cast<uint8_t>(len);
          look_val[idx] = static_cast<uint8_t>(rs);
          if (ac && size && len + size <= kLookBits) {
            const uint32_t extra = static_cast<uint32_t>(j >> (shift - size)) & ((1u << size) - 1);
            const int v = extra < (1u << (size - 1)) ? static_cast<int>(extra) - (1 << size) + 1
                                                     : static_cast<int>(extra);
            fast_ac[idx] = v * 65536 + run * 256 + len + size;
          }
        }
      }
      maxcode[len] = bits[len - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;  // sentinel: ends the slow search
    defined = true;
  }
};

struct BitReader {
  const uint8_t* data;
  int64_t size;
  int64_t pos;          // next byte of entropy data (at a marker: its 0xFF)
  uint64_t buf = 0;     // ``bits`` unread bits in the low end
  int bits = 0;
  int64_t fake = 0;     // zero bytes fed after the segment ended
  bool at_marker = false;
  bool eof = false;     // the data ended without a marker (a truncated file)

  void fill() {
    while (bits <= 56) {
      // 8 bytes at a time while none of them is 0xFF (no stuffing, no marker)
      if (!at_marker && pos + 8 <= size) {
        uint64_t x;
        std::memcpy(&x, data + pos, 8);
        x = __builtin_bswap64(x);
        const uint64_t nx = ~x;
        if (!((nx - 0x0101010101010101ull) & ~nx & 0x8080808080808080ull)) {
          const int n = (64 - bits) >> 3;
          buf = n == 8 ? x : (buf << (8 * n)) | (x >> (64 - 8 * n));
          bits += 8 * n;
          pos += n;
          continue;
        }
      }
      uint32_t byte = 0;
      if (at_marker) {
        ++fake;
      } else if (pos >= size) {
        at_marker = eof = true;
        ++fake;
      } else {
        byte = data[pos];
        if (byte == 0xFF) {
          uint8_t next = pos + 1 < size ? data[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {       // a marker (or fill bytes before one) ends the segment
            at_marker = true;
            ++fake;
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      buf = (buf << 8) | byte;
      bits += 8;
    }
  }
  // at least 32 unread bits: a code and its magnitude bits need no more
  inline void need32() {
    if (bits < 32) fill();
  }
  inline uint32_t show(int n) const {
    return static_cast<uint32_t>(buf >> (bits - n)) & ((1u << n) - 1);
  }
  // One Huffman symbol; at least 17 bits unread. A code that no table
  // entry matches takes 17 bits and reads as symbol 0, as libjpeg reads it
  // (jpeg_huff_decode, after its "corrupt JPEG data" warning).
  inline int decode(const HuffDecoder& h) {
    const uint32_t look = show(16);
    int len = h.look_len[look >> (16 - kLookBits)];
    if (len) {
      bits -= len;
      return h.look_val[look >> (16 - kLookBits)];
    }
    for (len = kLookBits + 1; len <= 16; ++len) {
      const int32_t code = static_cast<int32_t>(look >> (16 - len));
      if (code <= h.maxcode[len]) {
        bits -= len;
        return h.vals[(code + h.valoffset[len]) & 0xFF];
      }
    }
    bits -= 17;
    return 0;
  }
  // s magnitude bits as the coefficient they code; at least s bits unread
  inline int value(int s) {
    if (s == 0) return 0;
    const uint32_t v = show(s);
    bits -= s;
    return v < (1u << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1 : static_cast<int>(v);
  }
  // n (1 to 16) raw bits, refilling as needed
  inline uint32_t get(int n) {
    if (bits < n) fill();
    const uint32_t v = show(n);
    bits -= n;
    return v;
  }
  // Whether the data consumed ran past the segment's end (into the zero
  // bits fed after it). Past a marker libjpeg warns "premature end of data
  // segment" and decodes the rest of the restart interval as zeros; past
  // the end of the file it cannot go on, and Pillow raises "image file is
  // truncated".
  bool over() const {
    if (static_cast<int64_t>(bits) >= 8 * fake) return false;
    if (eof) fail("truncated JPEG: the file ends inside its entropy-coded data");
    return true;
  }
};

// ITU-T T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS. Entry 113 is the
// fixed bin of probability 0.5 (signs and refinement bits).
const int32_t kAriTab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171};

// The QM decoder of T.81 Annex D as libjpeg's jdarith.c runs it. Reaching a
// marker is legal in arithmetic coding: zero bytes are read after it.
struct ArithDecoder {
  const uint8_t* data;
  int64_t size;
  int64_t pos;               // next byte
  int64_t c = 0, a = 0;      // the C and A registers
  int ct = -16;              // -16: two bytes to read first; -1: a decoding error (decode no more)
  int marker = 0;            // the marker that ended the data, 0 none yet
  int64_t marker_pos = -1;   // its 0xFF

  int next_byte() {
    if (marker) return 0;
    if (pos >= size) fail("truncated JPEG: the file ends inside its entropy-coded data");
    int b = data[pos++];
    if (b != 0xFF) return b;
    do {
      if (pos >= size) fail("truncated JPEG: the file ends inside its entropy-coded data");
      b = data[pos++];
    } while (b == 0xFF);
    if (b == 0) return 0xFF;   // a stuffed zero
    marker = b;
    marker_pos = pos - 2;
    return 0;
  }

  // One binary decision in context ``st`` (D.2.4-D.2.6), its statistics
  // bin updated
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;   // the two initial bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {              // conditional exchange: the MPS after all
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// The statistics areas of an arithmetic-coded scan or restart interval,
// one a table, cleared at its start
struct ArithStats {
  uint8_t dc[16][64];
  uint8_t ac[16][256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;             // samples of the component (downsampled)
  int wib = 0, hib = 0;           // blocks holding them
  int bw = 0, bh = 0;             // blocks allocated (MCU-padded)
  uint16_t qt[64];                // latched quantisation table, natural order
  bool qt_latched = false;
  bool scanned = false;           // in a scan already
  int coef_bits[64];              // progressive: the Al of each zigzag coefficient, -1 unsent
  std::vector<int16_t> coef;      // bh * bw blocks of 64, natural order
  std::vector<uint8_t> plane;     // hib*8 rows of bw*8 samples
  std::vector<uint8_t> samples;   // lossless: dh rows of dw samples, as the scan left them

  int16_t* block(int row, int col) { return &coef[(static_cast<size_t>(row) * bw + col) * 64]; }
  const int16_t* block(int row, int col) const {
    return &coef[(static_cast<size_t>(row) * bw + col) * 64];
  }
};

const char* sof_name(int m) {
  switch (m) {
    case 0xC5: return "differential sequential (SOF5)";
    case 0xC6: return "differential progressive (SOF6)";
    case 0xC7: return "differential lossless (SOF7)";
    case 0xCB: return "arithmetic-coded lossless (SOF11)";
    case 0xCD: return "arithmetic-coded differential sequential (SOF13)";
    case 0xCE: return "arithmetic-coded differential progressive (SOF14)";
    case 0xCF: return "arithmetic-coded differential lossless (SOF15)";
    default: return nullptr;
  }
}

// Natural positions of the first nine AC coefficients in zigzag order
// (libjpeg's Q01 Q10 Q20 Q11 Q02 Q03 Q12 Q21 Q30), for block smoothing.
const int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// libjpeg's prediction of one AC coefficient from ``num`` (Q00 times a
// combination of DC values): round(num / (q * 256)), at most 2^Al - 1 in
// magnitude when Al > 0.
inline int16_t smooth_pred(jl num, jl q, int al) {
  const jl mag = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
  int pred = static_cast<int>(mag);
  if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return static_cast<int16_t>(num >= 0 ? pred : -pred);
}

class Decoder {
 public:
  Decoder(const uint8_t* data, int64_t size) : d_(data), n_(size) {}

  // Header only: up to the frame header.
  void probe() { parse(false); }

  // Full decode into ``out`` (height * width * out_components bytes).
  void decode(uint8_t* out, int n_threads) {
    threads_ = n_threads;
    parse(true);
    for (auto& c : comps_)
      if (!c.scanned) fail("no scan holds component " + std::to_string(c.id));
    const bool smooth = smoothing();
    // inverse DCT, a block row of a component per task (lossless: the
    // scans' samples as they are)
    std::vector<std::pair<int, int>> rows;
    for (int ci = 0; ci < static_cast<int>(comps_.size()); ++ci) {
      comps_[ci].plane.assign(static_cast<size_t>(comps_[ci].hib) * 8 * comps_[ci].bw * 8, 0);
      for (int r = 0; r < comps_[ci].hib; ++r) rows.emplace_back(ci, r);
    }
    parallel_for(static_cast<int64_t>(rows.size()), n_threads, [&](int64_t i) {
      Component& c = comps_[rows[i].first];
      int r = rows[i].second;
      int64_t stride = static_cast<int64_t>(c.bw) * 8;
      uint8_t* o = &c.plane[static_cast<size_t>(r) * 8 * stride];
      if (lossless_) {
        for (int y = 8 * r; y < std::min(8 * r + 8, c.dh); ++y)
          std::memcpy(o + (y - 8 * r) * stride, &c.samples[static_cast<size_t>(y) * c.dw], c.dw);
        return;
      }
      if (smooth) {
        smooth_row(c, r, o, stride);
        return;
      }
      for (int b = 0; b < c.wib; ++b) idct_islow(c.block(r, b), c.qt, o + b * 8, stride);
    });
    for (auto& c : comps_) std::vector<int16_t>().swap(c.coef);
    // upsampling and colour conversion, 16 output rows per task
    const int64_t bands = (height_ + 15) / 16;
    const int nc = static_cast<int>(comps_.size());
    parallel_for(bands, n_threads, [&](int64_t band) {
      std::vector<uint8_t> up(comps_.size() * (static_cast<size_t>(width_) + 2));
      std::vector<int> colsum(width_ + 2);
      for (int y = static_cast<int>(band * 16); y < std::min<int64_t>(height_, band * 16 + 16);
           ++y) {
        for (size_t ci = 0; ci < comps_.size(); ++ci)
          upsample_row(comps_[ci], y, &up[ci * (width_ + 2)], colsum.data());
        uint8_t* o = out + static_cast<int64_t>(y) * width_ * out_components();
        const uint8_t* p0 = up.data();
        const uint8_t* p1 = p0 + width_ + 2;
        const uint8_t* p2 = p1 + width_ + 2;
        if (nc == 1) {
          std::memcpy(o, p0, width_);
        } else if (transform_) {    // YCbCr -> RGB, or YCCK -> CMYK (K as stored)
          const int oc = nc;
          for (int x = 0; x < width_; ++x) {
            const int l = p0[x], cb = p1[x], cr = p2[x];
            const int r = clamp255(l + kColor.cr_r[cr]);
            const int g = clamp255(l + ((kColor.cb_g[cb] + kColor.cr_g[cr]) >> kScaleBits));
            const int b = clamp255(l + kColor.cb_b[cb]);
            if (nc == 3) {
              o[3 * x] = static_cast<uint8_t>(r);
              o[3 * x + 1] = static_cast<uint8_t>(g);
              o[3 * x + 2] = static_cast<uint8_t>(b);
            } else {
              o[oc * x] = static_cast<uint8_t>(255 - r);
              o[oc * x + 1] = static_cast<uint8_t>(255 - g);
              o[oc * x + 2] = static_cast<uint8_t>(255 - b);
              o[oc * x + 3] = p2[width_ + 2 + x];
            }
          }
        } else {                    // RGB or CMYK as stored
          for (int x = 0; x < width_; ++x)
            for (int c = 0; c < nc; ++c) o[nc * x + c] = up[c * (width_ + 2) + x];
        }
      }
    });
  }

  int width() const { return width_; }
  int height() const { return height_; }
  int components() const { return static_cast<int>(comps_.size()); }
  int out_components() const { return static_cast<int>(comps_.size()); }
  int sof() const { return sof_; }

  // Three components as stored (1: RGB, libtiff's JCS_UNKNOWN for a TIFF of
  // Photometric RGB) or as YCbCr (0), whatever the markers say; -1 (the
  // default) picks by libjpeg's rule.
  void set_colour(int colour) { colour_ = colour; }

 private:
  const uint8_t* d_;
  int64_t n_;
  int64_t pos_ = 0;
  int width_ = 0, height_ = 0, sof_ = -1;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0, colour_ = -1, threads_ = 1;
  bool saw_jfif_ = false, saw_adobe_ = false, transform_ = false, progressive_ = false;
  bool arith_ = false, lossless_ = false;
  int adobe_transform_ = 0;
  // arithmetic conditioning (DAC; libjpeg's defaults L 0, U 1, Kx 5)
  uint8_t dac_l_[16], dac_u_[16], dac_k_[16];
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  HuffDecoder dc_[4], ac_[4];
  std::vector<Component> comps_;

  uint8_t byte() {
    if (pos_ >= n_) fail("truncated JPEG: ends inside a marker segment");
    return d_[pos_++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  void parse(bool decode_scans) {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos_ = 2;
    std::fill(dac_l_, dac_l_ + 16, 0);
    std::fill(dac_u_, dac_u_ + 16, 1);
    std::fill(dac_k_, dac_k_ + 16, 5);
    for (;;) {
      // next marker (libjpeg's next_marker): skip anything up to 0xFF, then
      // fill bytes; a stuffed 0xFF 0x00 is data, not a marker
      int m = 0;
      while (m == 0 && pos_ < n_) {
        while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
        while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
        if (pos_ < n_) m = d_[pos_++];
      }
      if (m == 0) {
        if (decode_scans || sof_ < 0) fail("truncated JPEG: no EOI marker");
        return;
      }
      if (m == 0xD9) {
        if (sof_ < 0) fail("JPEG has no frame header");
        return;
      }
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 || m == 0xCA) {
        read_sof(m);
        if (!decode_scans) return;
        continue;
      }
      if (const char* name = sof_name(m))
        fail(std::string("unsupported JPEG: ") + name + "; Huffman (SOF0-SOF3) and "
             "arithmetic-coded sequential and progressive (SOF9, SOF10) files are decoded");
      if (m == 0xC8) fail("unsupported JPEG: JPG marker (a reserved frame type)");
      if (m >= 0xD0 && m <= 0xD7) continue;  // a stray RSTn: nothing to skip
      if (m == 0x01) continue;               // TEM
      int64_t len = word();
      if (len < 2 || pos_ + len - 2 > n_) fail("truncated JPEG: bad marker length");
      int64_t end = pos_ + len - 2;
      switch (m) {
        case 0xC4: read_dht(end); break;
        case 0xCC: read_dac(end); break;
        case 0xDB: read_dqt(end); break;
        case 0xDD:
          if (len != 4) fail("bad DRI marker");
          restart_interval_ = word();
          break;
        case 0xDA:
          if (sof_ < 0) fail("JPEG scan before its frame header");
          if (!decode_scans) return;
          read_scan(end);
          continue;  // pos_ is past the scan's data
        case 0xDC: fail("unsupported JPEG: DNL marker");
        case 0xE0:
          if (len >= 7 && std::memcmp(d_ + pos_, "JFIF\0", 5) == 0) saw_jfif_ = true;
          break;
        case 0xEE:
          if (len >= 14 && std::memcmp(d_ + pos_, "Adobe", 5) == 0) {
            saw_adobe_ = true;
            adobe_transform_ = d_[pos_ + 11];
          }
          break;
        default: break;  // APPn, COM and the like
      }
      pos_ = end;
    }
  }

  void read_sof(int m) {
    if (sof_ >= 0) fail("JPEG has two frame headers");
    int len = word();
    int precision = byte();
    if (precision != 8)
      fail("unsupported JPEG: " + std::to_string(precision) + "-bit samples (only 8-bit)");
    height_ = word();
    width_ = word();
    int nc = byte();
    if (height_ == 0) fail("unsupported JPEG: height defined by a DNL marker");
    if (width_ == 0) fail("bad JPEG: width 0");
    if (nc != 1 && nc != 3 && nc != 4)
      fail("unsupported JPEG: " + std::to_string(nc) + " components (only 1, 3 or 4)");
    if (len != 8 + 3 * nc) fail("bad JPEG frame header length");
    comps_.resize(nc);
    for (auto& c : comps_) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad JPEG frame header");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    if (nc == 1) {
      comps_[0].h = comps_[0].v = 1;  // one component: its MCU is one block
      hmax_ = vmax_ = 1;
    } else {
      int blocks = 0;
      for (auto& c : comps_) {
        // libjpeg's upsamplers take integral ratios only
        if (hmax_ % c.h || vmax_ % c.v)
          fail("unsupported JPEG: sampling factors " + std::to_string(c.h) + "x" +
               std::to_string(c.v) + " of " + std::to_string(hmax_) + "x" +
               std::to_string(vmax_) + " (a fractional ratio)");
        blocks += c.h * c.v;
      }
      if (blocks > 10) fail("bad JPEG: more than 10 blocks in an MCU");
    }
    sof_ = m - 0xC0;
    progressive_ = m == 0xC2 || m == 0xCA;
    arith_ = m >= 0xC9;
    lossless_ = m == 0xC3;
    if (lossless_ && (hmax_ != 1 || vmax_ != 1))
      fail("unsupported JPEG: lossless with subsampled components");
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comps_) {
      c.dw = static_cast<int>((static_cast<int64_t>(width_) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>((static_cast<int64_t>(height_) * c.v + vmax_ - 1) / vmax_);
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
    }
    // colour transform of the decoded components (libjpeg's
    // default_decompress_parms): 3 components YCbCr -> RGB, 4 YCCK -> CMYK
    if (nc == 3 && colour_ >= 0) {
      transform_ = colour_ == 0;
      if (!transform_ && (hmax_ != 1 || vmax_ != 1))
        fail("unsupported JPEG: RGB components (no colour transform) with subsampled chroma");
    } else if (nc == 3) {
      if (saw_jfif_) {
        transform_ = true;
      } else if (saw_adobe_) {
        transform_ = adobe_transform_ != 0;
      } else if (lossless_) {     // libjpeg-turbo 3 guesses RGB for a lossless file
        transform_ = false;
      } else {
        transform_ = !(comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B');
      }
    } else if (nc == 4) {
      transform_ = saw_adobe_ && adobe_transform_ != 0;
    }
    if (lossless_ && transform_)   // libjpeg-turbo 3 converts no lossless colour
      fail("unsupported JPEG: lossless with a colour transform (YCbCr or YCCK components)");
  }

  void read_dqt(int64_t end) {
    while (pos_ < end) {
      int pq = byte();
      int tq = pq & 15, prec = pq >> 4;
      if (tq > 3 || prec > 1) fail("bad DQT marker");
      for (int i = 0; i < 64; ++i)
        qt_[tq][kNatural[i]] = static_cast<uint16_t>(prec ? word() : byte());
      qt_defined_[tq] = true;
    }
    if (pos_ != end) fail("bad DQT marker length");
  }

  void read_dht(int64_t end) {
    while (pos_ < end) {
      int tc = byte();
      int th = tc & 15, cls = tc >> 4;
      if (th > 3 || cls > 1) fail("bad DHT marker");
      uint8_t bits[16], vals[256];
      int count = 0;
      for (int i = 0; i < 16; ++i) count += bits[i] = byte();
      if (count > 256) fail("bad DHT marker: more than 256 codes");
      for (int i = 0; i < count; ++i) vals[i] = byte();
      (cls ? ac_ : dc_)[th].build(bits, vals, count, cls == 1);
    }
    if (pos_ != end) fail("bad DHT marker length");
  }

  // DAC: the conditioning of arithmetic DC (L, U) and AC (Kx) tables
  void read_dac(int64_t end) {
    while (pos_ < end) {
      const int index = byte(), value = byte();
      if (index >= 32) fail("bad DAC marker: table " + std::to_string(index));
      if (index >= 16) {
        dac_k_[index - 16] = static_cast<uint8_t>(value);
      } else {
        dac_l_[index] = static_cast<uint8_t>(value & 15);
        dac_u_[index] = static_cast<uint8_t>(value >> 4);
        if (dac_l_[index] > dac_u_[index]) fail("bad DAC marker: L > U");
      }
    }
    if (pos_ != end) fail("bad DAC marker length");
  }

  // Index of the 0xFF of the first marker at or after p (libjpeg's
  // next_marker: other bytes and stuffed zeros are skipped)
  int64_t marker_at(int64_t p) const {
    for (;;) {
      while (p < n_ && d_[p] != 0xFF) ++p;
      int64_t q = p;
      while (q < n_ && d_[q] == 0xFF) ++q;
      if (q >= n_) fail("truncated JPEG: the file ends inside its entropy-coded data");
      if (d_[q] != 0) return q - 1;
      p = q + 1;
    }
  }

  // The restart marker RSTn due at the marker found from p; the data after it
  int64_t restart_at(int64_t p, int& next_rst) const {
    p = marker_at(p);
    if (d_[p + 1] != 0xD0 + next_rst)
      fail("corrupt JPEG data: missing restart marker RST" + std::to_string(next_rst));
    next_rst = (next_rst + 1) & 7;
    return p + 2;
  }

  void read_scan(int64_t header_end) {
    int ns = byte();
    if (ns < 1 || ns > 4 || ns > static_cast<int>(comps_.size())) fail("bad SOS marker");
    std::vector<int> in_scan(ns), td(ns), ta(ns);
    for (int i = 0; i < ns; ++i) {
      int id = byte(), t = byte();
      int ci = -1;
      for (size_t k = 0; k < comps_.size(); ++k)
        if (comps_[k].id == id) ci = static_cast<int>(k);
      if (ci < 0) fail("SOS names an unknown component");
      in_scan[i] = ci;
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (!arith_ && (td[i] > 3 || ta[i] > 3)) fail("SOS names a Huffman table past 3");
    }
    const int ss = byte(), se = byte(), ahal = byte();
    const int ah = ahal >> 4, al = ahal & 15;
    if (pos_ != header_end) fail("bad SOS marker length");
    if (lossless_) {
      // jdlossls.c: predictor 1-7, Se 0, Ah 0, point transform below the precision
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al > 7)
        fail("bad lossless scan: predictor " + std::to_string(ss) + ", Se " +
             std::to_string(se) + ", Ah " + std::to_string(ah) + ", Pt " + std::to_string(al));
    } else if (!progressive_) {
      if (ss != 0 || se != 63 || ahal != 0) fail("bad SOS parameters for a sequential JPEG");
    } else {
      // jdphuff.c's checks: a DC band is Ss = Se = 0; an AC band one
      // component and Ss <= Se < 64; a refinement Al = Ah - 1; Al <= 13
      const bool bad = (ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1)) ||
                       (ah != 0 && al != ah - 1) || al > 13;
      if (bad)
        fail("bad progression: Ss " + std::to_string(ss) + ", Se " + std::to_string(se) +
             ", Ah " + std::to_string(ah) + ", Al " + std::to_string(al));
    }
    const bool dc_scan = ss == 0, refine = ah != 0;
    for (int i = 0; !arith_ && i < ns; ++i) {
      // sequential scans use both tables; progressive DC first scans the
      // DC table, AC scans the AC table, DC refinements none; lossless the DC table
      const bool need_dc = !progressive_ || (dc_scan && !refine);
      const bool need_ac = !lossless_ && (!progressive_ || !dc_scan);
      if ((need_dc && !dc_[td[i]].defined) || (need_ac && !ac_[ta[i]].defined))
        fail("SOS uses an undefined Huffman table");
    }
    for (int ci : in_scan) {
      Component& c = comps_[ci];
      if (!progressive_ && c.scanned) fail("component in two scans of a sequential JPEG");
      c.scanned = true;
      if (lossless_) continue;
      if (!c.qt_latched) {     // libjpeg latches a table at the component's first scan
        if (!qt_defined_[c.tq]) fail("component uses an undefined quantisation table");
        std::memcpy(c.qt, qt_[c.tq], sizeof(c.qt));
        c.qt_latched = true;
      }
      if (c.coef.empty()) c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      if (progressive_)
        for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
    }
    // MCU layout: interleaved scans use the frame's MCUs, a single
    // component's scan one block per MCU over its own blocks (lossless:
    // one sample a block)
    int mx = mcux_, my = mcuy_;
    if (lossless_) {
      mx = width_;
      my = height_;
    } else if (ns == 1) {
      mx = comps_[in_scan[0]].wib;
      my = comps_[in_scan[0]].hib;
    }
    if (lossless_) {
      lossless_scan(in_scan, td, ss, al);
    } else if (arith_) {
      arith_scan(in_scan, td, ta, ss, se, ah, al, mx, my);
    } else {
      huffman_scan(in_scan, td, ta, ss, se, ah, al, mx, my);
    }
  }

  // The blocks of one MCU of a scan: fn(scan index, block)
  template <class F>
  void mcu_blocks(const std::vector<int>& in_scan, int mx, int64_t mcu, F fn) {
    const int ns = static_cast<int>(in_scan.size());
    const int mcu_x = static_cast<int>(mcu % mx), mcu_y = static_cast<int>(mcu / mx);
    for (int i = 0; i < ns; ++i) {
      Component& c = comps_[in_scan[i]];
      const int bh = ns == 1 ? 1 : c.v, bwm = ns == 1 ? 1 : c.h;
      for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bwm; ++bx)
          fn(i, c.block(ns == 1 ? mcu_y : mcu_y * c.v + by, ns == 1 ? mcu_x : mcu_x * c.h + bx));
    }
  }

  // A Huffman scan (jdhuff.c, jdphuff.c). Where the data of a restart
  // interval ends early (a marker where more bits were due), libjpeg warns
  // and decodes that MCU on zero bits and the rest of the interval as no
  // data: zero coefficients (sequential) or unchanged ones (progressive).
  void huffman_scan(const std::vector<int>& in_scan, const std::vector<int>& td,
                    const std::vector<int>& ta, int ss, int se, int ah, int al, int mx, int my) {
    const bool dc_scan = ss == 0, refine = ah != 0;
    BitReader br{d_, n_, pos_};
    int last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0;
    bool no_data = false;
    const int64_t total = static_cast<int64_t>(mx) * my;
    int next_rst = 0;
    for (int64_t mcu = 0; mcu < total; ++mcu) {
      if (restart_interval_ && mcu > 0 && mcu % restart_interval_ == 0) {
        br = BitReader{d_, n_, restart_at(br.pos, next_rst)};
        std::memset(last_dc, 0, sizeof(last_dc));
        eobrun = 0;
        no_data = false;
      }
      if (no_data) continue;
      mcu_blocks(in_scan, mx, mcu, [&](int i, int16_t* blk) {
        if (!progressive_) {
          sequential_block(br, dc_[td[i]], ac_[ta[i]], blk, last_dc[i]);
        } else if (dc_scan && !refine) {
          br.need32();
          const int s = br.decode(dc_[td[i]]);
          if (s > 16) fail("corrupt JPEG data: bad DC coefficient size");
          last_dc[i] += br.value(s);
          blk[0] = static_cast<int16_t>(static_cast<unsigned>(last_dc[i]) << al);
        } else if (dc_scan) {
          if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        } else if (!refine) {
          ac_first(br, ac_[ta[i]], blk, ss, se, al, eobrun);
        } else {
          ac_refine(br, ac_[ta[i]], blk, ss, se, al, eobrun);
        }
      });
      no_data = br.over();
    }
    pos_ = br.pos;
  }

  // An arithmetic-coded scan (jdarith.c): sequential, or a progressive DC
  // first or refinement scan or AC first or refinement scan. Each scan and
  // restart interval starts with cleared statistics and a fresh decoder, so
  // where the scan's restart markers all stand in order its intervals decode
  // on threads_ threads, bit-equal to one after another.
  void arith_scan(const std::vector<int>& in_scan, const std::vector<int>& td,
                  const std::vector<int>& ta, int ss, int se, int ah, int al, int mx, int my) {
    const int64_t total = static_cast<int64_t>(mx) * my;
    const int64_t every = restart_interval_ ? restart_interval_ : total;
    const int64_t intervals = (total + every - 1) / every;
    auto interval = [&](int64_t k, int64_t p) {
      return arith_interval(in_scan, td, ta, ss, se, ah, al, mx, k * every,
                            std::min(total, (k + 1) * every), p);
    };
    std::vector<int64_t> starts;
    int64_t end = 0;
    if (intervals > 1 && threads_ != 1 && restart_starts(intervals, starts, end)) {
      parallel_for(intervals, threads_, [&](int64_t k) { interval(k, starts[k]); });
      pos_ = end;
      return;
    }
    int64_t p = pos_;
    int next_rst = 0;
    for (int64_t k = 0; k < intervals; ++k) p = interval(k, k ? restart_at(p, next_rst) : p);
    pos_ = marker_at(p);
  }

  // Where each of ``intervals`` restart intervals of the scan at pos_
  // starts, and the 0xFF of the marker that ends the scan, when the scan's
  // data holds RST0, RST1, ... in order and no other marker; else false.
  bool restart_starts(int64_t intervals, std::vector<int64_t>& starts, int64_t& end) const {
    starts.assign(1, pos_);
    for (int64_t p = pos_;;) {
      const void* ff = std::memchr(d_ + p, 0xFF, static_cast<size_t>(n_ - p));
      if (!ff) return false;
      int64_t q = static_cast<const uint8_t*>(ff) - d_;
      while (q < n_ && d_[q] == 0xFF) ++q;
      if (q >= n_) return false;
      const int m = d_[q];
      p = q + 1;
      if (m == 0) continue;                      // a stuffed zero
      if (m < 0xD0 || m > 0xD7) {
        end = q - 1;
        return static_cast<int64_t>(starts.size()) == intervals;
      }
      if (m != 0xD0 + static_cast<int>((starts.size() - 1) & 7) ||
          static_cast<int64_t>(starts.size()) >= intervals)
        return false;
      starts.push_back(p);
    }
  }

  // MCUs [m0, m1) of an arithmetic-coded scan, their data from byte p with
  // cleared statistics; returns where the data ended (the 0xFF of the marker
  // that stopped the decoder, or the next byte it would read).
  int64_t arith_interval(const std::vector<int>& in_scan, const std::vector<int>& td,
                         const std::vector<int>& ta, int ss, int se, int ah, int al, int mx,
                         int64_t m0, int64_t m1, int64_t p) {
    const bool dc_scan = ss == 0, refine = ah != 0;
    ArithStats st;
    std::memset(&st, 0, sizeof(st));
    ArithDecoder ad{d_, n_, p};
    int last_dc[4] = {0, 0, 0, 0}, context[4] = {0, 0, 0, 0};
    for (int64_t mcu = m0; mcu < m1; ++mcu) {
      if (ad.ct == -1 && !(progressive_ && dc_scan && refine)) continue;  // after an error
      mcu_blocks(in_scan, mx, mcu, [&](int i, int16_t* blk) {
        if (!progressive_) {
          if (!arith_dc(ad, st, td[i], last_dc[i], context[i])) return;
          blk[0] = static_cast<int16_t>(last_dc[i]);
          arith_ac(ad, st, ta[i], blk, 1, 63, 0);
        } else if (dc_scan && !refine) {
          if (!arith_dc(ad, st, td[i], last_dc[i], context[i])) return;
          blk[0] = static_cast<int16_t>(static_cast<unsigned>(last_dc[i]) << al);
        } else if (dc_scan) {
          uint8_t fixed = 113;
          if (ad.decode(&fixed)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        } else if (!refine) {
          arith_ac(ad, st, ta[i], blk, ss, se, al);
        } else {
          arith_ac_refine(ad, st, ta[i], blk, ss, se, al);
        }
      });
    }
    return ad.marker ? ad.marker_pos : ad.pos;
  }

  // One DC difference (F.1.4.4.1, Figures F.19-F.24) added to last_dc;
  // false on a magnitude overflow, which stops the decoder (ct -1)
  bool arith_dc(ArithDecoder& ad, ArithStats& areas, int tbl, int& last_dc, int& context) {
    if (ad.ct == -1) return false;
    uint8_t* stats = areas.dc[tbl];
    uint8_t* st = stats + context;
    if (ad.decode(st) == 0) {
      context = 0;
      return true;
    }
    const int sign = ad.decode(st + 1);
    st += 2 + sign;
    int m = ad.decode(st);
    if (m != 0) {
      st = stats + 20;
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ad.ct = -1;
          return false;
        }
        ++st;
      }
    }
    // the conditioning category of the next difference
    if (m < ((1 << dac_l_[tbl]) >> 1))
      context = 0;
    else if (m > ((1 << dac_u_[tbl]) >> 1))
      context = 12 + sign * 4;
    else
      context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ad.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc = (last_dc + v) & 0xFFFF;
    return true;
  }

  // AC coefficients ss..se (F.1.4.4.2, Figure F.20), each shifted by al
  void arith_ac(ArithDecoder& ad, ArithStats& areas, int tbl, int16_t* blk, int ss, int se,
                int al) {
    if (ad.ct == -1) return;
    uint8_t* stats = areas.ac[tbl];
    uint8_t fixed = 113;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ad.decode(st)) break;                // end of block
      while (ad.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {                        // a run past the band
          ad.ct = -1;
          return;
        }
      }
      const int sign = ad.decode(&fixed);
      st += 2;
      int m = ad.decode(st);
      if (m != 0 && ad.decode(st)) {
        m <<= 1;
        st = stats + (k <= dac_k_[tbl] ? 189 : 217);
        while (ad.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ad.ct = -1;
            return;
          }
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ad.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
    }
  }

  // An AC refinement scan's bits for one block (G.1.3.3)
  void arith_ac_refine(ArithDecoder& ad, ArithStats& areas, int tbl, int16_t* blk, int ss,
                       int se, int al) {
    uint8_t* stats = areas.ac[tbl];
    uint8_t fixed = 113;
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;                              // the previous stage's end of block
    while (kex > 0 && blk[kNatural[kex]] == 0) --kex;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ad.decode(st)) break;
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {                           // a correction bit
          if (ad.decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ad.decode(st + 1)) {               // newly nonzero
          *coef = static_cast<int16_t>(ad.decode(&fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ad.ct = -1;
          return;
        }
      }
    }
  }

  // A lossless scan (libjpeg-turbo 3's jdlhuff.c, jddiffct.c and
  // jdlossls.c): Huffman-coded differences a row at a time, undifferenced
  // by predictor ``psv``; a scan's first row, and the first row after each
  // restart (restart intervals are whole rows), predicts its first sample
  // as 2^(7 - Pt) and the others from the left, and every later row its
  // first sample from the one above. Samples leave as (x << Pt) mod 256.
  void lossless_scan(const std::vector<int>& in_scan, const std::vector<int>& td, int psv,
                     int pt) {
    const int ns = static_cast<int>(in_scan.size()), w = width_;
    if (restart_interval_ % w)
      fail("bad JPEG: lossless restart interval " + std::to_string(restart_interval_) +
           " is not a multiple of the " + std::to_string(w) + " samples of a row");
    std::vector<int32_t> diff(static_cast<size_t>(ns) * w), prev(diff.size()), cur(diff.size());
    for (int ci : in_scan) comps_[ci].samples.assign(static_cast<size_t>(w) * height_, 0);
    BitReader br{d_, n_, pos_};
    const int rows_per_interval = restart_interval_ / w;
    int rows_to_go = rows_per_interval, next_rst = 0;
    bool first = true;
    for (int y = 0; y < height_; ++y) {
      if (restart_interval_ && rows_to_go == 0) {
        br = BitReader{d_, n_, restart_at(br.pos, next_rst)};
        rows_to_go = rows_per_interval;
        first = true;
      }
      for (int x = 0; x < w; ++x)
        for (int i = 0; i < ns; ++i) {
          br.need32();
          const int s = br.decode(dc_[td[i]]);
          if (s > 16) fail("corrupt JPEG data: bad difference size");
          diff[static_cast<size_t>(i) * w + x] = s == 16 ? 32768 : br.value(s);
        }
      if (br.over())
        fail("corrupt JPEG data: premature end of a lossless scan (not decoded)");
      --rows_to_go;
      for (int i = 0; i < ns; ++i) {
        const int32_t* d = &diff[static_cast<size_t>(i) * w];
        const int32_t* up = &prev[static_cast<size_t>(i) * w];
        int32_t* o = &cur[static_cast<size_t>(i) * w];
        if (first) {
          o[0] = (d[0] + (1 << (7 - pt))) & 0xFFFF;
          for (int x = 1; x < w; ++x) o[x] = (d[x] + o[x - 1]) & 0xFFFF;
        } else {
          o[0] = (d[0] + up[0]) & 0xFFFF;
          for (int x = 1; x < w; ++x) {
            const int64_t ra = o[x - 1], rb = up[x], rc = up[x - 1];
            int64_t p;
            switch (psv) {
              case 1: p = ra; break;
              case 2: p = rb; break;
              case 3: p = rc; break;
              case 4: p = ra + rb - rc; break;
              case 5: p = ra + ((rb - rc) >> 1); break;
              case 6: p = rb + ((ra - rc) >> 1); break;
              default: p = (ra + rb) >> 1; break;
            }
            o[x] = static_cast<int32_t>((d[x] + p) & 0xFFFF);
          }
        }
        uint8_t* row = &comps_[in_scan[i]].samples[static_cast<size_t>(y) * w];
        for (int x = 0; x < w; ++x) row[x] = static_cast<uint8_t>(o[x] << pt);
      }
      std::swap(prev, cur);
      first = false;
    }
    pos_ = br.pos;
  }

  void sequential_block(BitReader& br, const HuffDecoder& dc, const HuffDecoder& ac,
                        int16_t* blk, int& last_dc) {
    br.need32();
    int s = br.decode(dc);
    if (s > 16) fail("corrupt JPEG data: bad DC coefficient size");
    last_dc += br.value(s);
    blk[0] = static_cast<int16_t>(last_dc);
    for (int k = 1; k < 64; ++k) {
      br.need32();
      const int32_t fast = ac.fast_ac[br.show(kLookBits)];
      if (fast) {
        k += (fast >> 8) & 0xFF;
        br.bits -= fast & 0xFF;
        blk[kNatural[k]] = static_cast<int16_t>(fast >> 16);
        continue;
      }
      const int rs = br.decode(ac);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(br.value(s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_first
  static void ac_first(BitReader& br, const HuffDecoder& ac, int16_t* blk, int ss, int se,
                       int al, int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      br.need32();
      const int32_t fast = ac.fast_ac[br.show(kLookBits)];
      if (fast) {                      // a short code and its magnitude bits at once
        k += (fast >> 8) & 0xFF;
        br.bits -= fast & 0xFF;
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(fast >> 16) << al);
        continue;
      }
      const int rs = br.decode(ac);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(br.value(s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += static_cast<int>(br.get(r));
        --eobrun;
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine
  static void ac_refine(BitReader& br, const HuffDecoder& ac, int16_t* blk, int ss, int se,
                        int al, int& eobrun) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        br.need32();
        const int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;   // a size other than 1: libjpeg warns and reads on
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += static_cast<int>(br.get(r));
          break;
        }
        // pass over nonzero coefficients (a correction bit each) and r zero ones
        for (; k <= se; ++k) {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.get(1) && (*coef & p1) == 0)
              *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
          } else if (--r < 0) {
            break;
          }
        }
        if (s) {
            blk[kNatural[k]] = static_cast<int16_t>(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.get(1) && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
      }
      --eobrun;
    }
  }

  // jdcoefct.c smoothing_ok: a progressive file with every DC known and some
  // of the first nine AC coefficients of a component unsent or unrefined
  bool smoothing() const {
    if (!progressive_) return false;
    bool useful = false;
    for (const auto& c : comps_) {
      for (int k = 0; k < 10; ++k)
        if (c.qt[kSmoothPos[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1+) for block row r
  // of c: each block's still-zero, not fully known first AC coefficients
  // estimated from the DC values of a 5x5 neighbourhood (DC too, where no
  // AC coefficient was sent), then the inverse DCT.
  void smooth_row(const Component& c, int r, uint8_t* out, int64_t stride) const {
    // neighbouring block rows as libjpeg picks them within its iMCU rows
    const int total = mcuy_, imcu = r / c.v, in_row = r % c.v;
    int block_rows = c.v;
    if (imcu == total - 1 && c.hib % c.v) block_rows = c.hib % c.v;
    const int ibr = imcu * block_rows + in_row, ibrs = block_rows * total;
    const int prev = ibr > 0 ? r - 1 : r;
    const int pprev = ibr > 1 ? r - 2 : prev;
    const int next = ibr < ibrs - 1 ? r + 1 : r;
    const int nnext = ibr < ibrs - 2 ? r + 2 : next;
    const int rws[5] = {pprev, prev, r, next, nnext};
    const int* bits = c.coef_bits;
    const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                           bits[5] == -1 && bits[6] == -1 && bits[7] == -1 && bits[8] == -1 &&
                           bits[9] == -1;
    const jl Q00 = c.qt[0], Q01 = c.qt[1], Q10 = c.qt[8], Q20 = c.qt[16], Q11 = c.qt[9],
             Q02 = c.qt[2], Q03 = c.qt[3], Q12 = c.qt[10], Q21 = c.qt[17], Q30 = c.qt[24];
    const int last = c.wib - 1;
    // DC[5 * row + col], rows pprev..nnext, columns b - 2 .. b + 2 (libjpeg's
    // DC01..DC25 sliding registers, edge columns repeated as it does)
    int dc[25];
    for (int i = 0; i < 5; ++i)
      for (int j = 0; j < 5; ++j) dc[5 * i + j] = c.block(rws[i], 0)[0];
    int16_t ws[64];
    for (int b = 0; b <= last; ++b) {
      std::memcpy(ws, c.block(r, b), sizeof(ws));
      if (b == 0 && b < last)
        for (int i = 0; i < 5; ++i) dc[5 * i + 3] = dc[5 * i + 4] = c.block(rws[i], 1)[0];
      if (b + 1 < last)
        for (int i = 0; i < 5; ++i) dc[5 * i + 4] = c.block(rws[i], b + 2)[0];
      const int DC01 = dc[0], DC02 = dc[1], DC03 = dc[2], DC04 = dc[3], DC05 = dc[4],
                DC06 = dc[5], DC07 = dc[6], DC08 = dc[7], DC09 = dc[8], DC10 = dc[9],
                DC11 = dc[10], DC12 = dc[11], DC13 = dc[12], DC14 = dc[13], DC15 = dc[14],
                DC16 = dc[15], DC17 = dc[16], DC18 = dc[17], DC19 = dc[18], DC20 = dc[19],
                DC21 = dc[20], DC22 = dc[21], DC23 = dc[22], DC24 = dc[23], DC25 = dc[24];
      int al;
      if ((al = bits[1]) != 0 && ws[1] == 0)       // AC01
        ws[1] = smooth_pred(Q00 * (change_dc ?
            (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
             3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
             13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25) :
            (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)), Q01, al);
      if ((al = bits[2]) != 0 && ws[8] == 0)       // AC10
        ws[8] = smooth_pred(Q00 * (change_dc ?
            (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
             13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
             3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
            (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)), Q10, al);
      if ((al = bits[3]) != 0 && ws[16] == 0)      // AC20
        ws[16] = smooth_pred(Q00 * (change_dc ?
            (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
             2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
            (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)), Q20, al);
      if ((al = bits[4]) != 0 && ws[9] == 0)       // AC11
        ws[9] = smooth_pred(Q00 * (change_dc ?
            (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25) :
            (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 -
             DC06 + 10 * DC07 - 10 * DC09)), Q11, al);
      if ((al = bits[5]) != 0 && ws[2] == 0)       // AC02
        ws[2] = smooth_pred(Q00 * (change_dc ?
            (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 +
             DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19) :
            (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)), Q02, al);
      if (change_dc) {
        if ((al = bits[6]) != 0 && ws[3] == 0)     // AC03
          ws[3] = smooth_pred(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03, al);
        if ((al = bits[7]) != 0 && ws[10] == 0)    // AC12
          ws[10] = smooth_pred(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12,
                               al);
        if ((al = bits[8]) != 0 && ws[17] == 0)    // AC21
          ws[17] = smooth_pred(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21,
                               al);
        if ((al = bits[9]) != 0 && ws[24] == 0)    // AC30
          ws[24] = smooth_pred(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30,
                               al);
        // DC, from a Gaussian-like kernel over the 25 DC values
        ws[0] = smooth_pred(Q00 * (
            -2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
            42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
            42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
            2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25), Q00, 0);
      }
      idct_islow(ws, c.qt, out + b * 8, stride);
      for (int i = 0; i < 5; ++i)
        for (int j = 0; j < 4; ++j) dc[5 * i + j] = dc[5 * i + j + 1];
    }
  }

  // Row y of component c at full resolution, as libjpeg-turbo's upsamplers
  // produce it (jdsample.c): fancy (triangle) h2v1 and h2v2 where the
  // component is wider than 2 samples, fancy h1v2, replication otherwise.
  // ``out`` holds width_ + 2 samples (a fancy row fills 2 * dw <= width_ + 1
  // of them). Rows past the component's last take that row, as libjpeg's
  // context rows do.
  void upsample_row(const Component& c, int y, uint8_t* out, int* colsum) const {
    const int64_t stride = static_cast<int64_t>(c.bw) * 8;
    const int hr = hmax_ / c.h, vr = vmax_ / c.v;
    if (hr == 1 && vr == 1) {
      std::memcpy(out, &c.plane[y * stride], width_);
      return;
    }
    const int dw = c.dw;
    if (hr == 2 && vr == 1 && dw > 2) {
      const uint8_t* in = &c.plane[y * stride];
      out[0] = in[0];
      out[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        int v = in[i] * 3;
        out[2 * i] = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
        out[2 * i + 1] = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
      }
      out[2 * dw - 2] = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      out[2 * dw - 1] = in[dw - 1];
      return;
    }
    const int inrow = y >> 1;
    const int other = (y & 1) ? std::min(inrow + 1, c.dh - 1) : std::max(inrow - 1, 0);
    if (hr == 1 && vr == 2) {
      const uint8_t* in0 = &c.plane[inrow * stride];
      const uint8_t* in1 = &c.plane[other * stride];
      const int bias = (y & 1) ? 2 : 1;
      for (int i = 0; i < dw; ++i) out[i] = static_cast<uint8_t>((in0[i] * 3 + in1[i] + bias) >> 2);
      return;
    }
    if (hr == 2 && vr == 2 && dw > 2) {
      const uint8_t* in0 = &c.plane[inrow * stride];
      const uint8_t* in1 = &c.plane[other * stride];
      for (int i = 0; i < dw; ++i) colsum[i] = in0[i] * 3 + in1[i];
      out[0] = static_cast<uint8_t>((colsum[0] * 4 + 8) >> 4);
      out[1] = static_cast<uint8_t>((colsum[0] * 3 + colsum[1] + 7) >> 4);
      for (int i = 1; i < dw - 1; ++i) {
        out[2 * i] = static_cast<uint8_t>((colsum[i] * 3 + colsum[i - 1] + 8) >> 4);
        out[2 * i + 1] = static_cast<uint8_t>((colsum[i] * 3 + colsum[i + 1] + 7) >> 4);
      }
      out[2 * dw - 2] = static_cast<uint8_t>((colsum[dw - 1] * 3 + colsum[dw - 2] + 8) >> 4);
      out[2 * dw - 1] = static_cast<uint8_t>((colsum[dw - 1] * 4 + 7) >> 4);
      return;
    }
    // int_upsample (and the narrow h2v1 / h2v2 cases): replication
    const uint8_t* in = &c.plane[(y / vr) * stride];
    for (int x = 0; x < width_; ++x) out[x] = in[x / hr];
  }
};

// ------------------------------------------------------------ encoder --

struct HuffEncoder {
  uint16_t code[256];
  uint8_t size[256];
  HuffEncoder(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    uint32_t c = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len, c <<= 1)
      for (int i = 0; i < bits[len - 1]; ++i, ++k, ++c) {
        code[vals[k]] = static_cast<uint16_t>(c);
        size[vals[k]] = static_cast<uint8_t>(len);
      }
  }
};

const HuffEncoder kDcLuma(kDcLumaBits, kDcVals), kAcLuma(kAcLumaBits, kAcLumaVals);
const HuffEncoder kDcChroma(kDcChromaBits, kDcVals), kAcChroma(kAcChromaBits, kAcChromaVals);

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out), pos_(out.size()) {
    out_.resize(pos_ + 65536);
  }
  inline void put(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1));
    n_ += size;
    if (n_ >= 32) {
      n_ -= 32;
      emit32(static_cast<uint32_t>(acc_ >> n_));
    }
  }
  // pad the last byte with 1 bits; the output ends at the last byte written
  void flush() {
    while (n_ >= 8) {
      n_ -= 8;
      emit(static_cast<uint8_t>(acc_ >> n_));
    }
    if (n_ > 0) emit(static_cast<uint8_t>((acc_ << (8 - n_)) | (0xFF >> n_)));
    n_ = 0;
    out_.resize(pos_);
  }

 private:
  std::vector<uint8_t>& out_;
  size_t pos_;
  uint64_t acc_ = 0;
  int n_ = 0;
  inline void emit(uint8_t b) {
    if (pos_ + 2 > out_.size()) out_.resize(out_.size() * 2);
    out_[pos_++] = b;
    if (b == 0xFF) out_[pos_++] = 0;
  }
  // four bytes, each 0xFF followed by a stuffed 0x00
  inline void emit32(uint32_t w) {
    if (pos_ + 8 > out_.size()) out_.resize(out_.size() * 2);
    const uint32_t nw = ~w;
    if (!((nw - 0x01010101u) & ~nw & 0x80808080u)) {
      const uint32_t be = __builtin_bswap32(w);
      std::memcpy(&out_[pos_], &be, 4);
      pos_ += 4;
      return;
    }
    for (int sh = 24; sh >= 0; sh -= 8) {
      const uint8_t b = static_cast<uint8_t>(w >> sh);
      out_[pos_++] = b;
      if (b == 0xFF) out_[pos_++] = 0;
    }
  }
};

inline int nbits(int v) { return v ? 32 - __builtin_clz(static_cast<unsigned>(v)) : 0; }

void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc, const HuffEncoder& dc,
                  const HuffEncoder& ac) {
  int t = blk[0] - last_dc, t2 = t;
  last_dc = blk[0];
  if (t < 0) {
    t = -t;
    --t2;
  }
  int nb = nbits(t);
  if (nb > 11) fail("JPEG encoder: DC coefficient out of range");
  // the code and the magnitude bits in one put (at most 16 + 11 bits)
  const uint32_t mask = (1u << nb) - 1;
  bw.put((static_cast<uint32_t>(dc.code[nb]) << nb) | (static_cast<uint32_t>(t2) & mask),
         dc.size[nb] + nb);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    int v = blk[kNatural[k]];
    if (v == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    int v2 = v;
    if (v < 0) {
      v = -v;
      --v2;
    }
    nb = nbits(v);
    if (nb > 10) fail("JPEG encoder: AC coefficient out of range");
    const int sym = (r << 4) + nb;
    const uint32_t bits = static_cast<uint32_t>(v2) & ((1u << nb) - 1);
    bw.put((static_cast<uint32_t>(ac.code[sym]) << nb) | bits, ac.size[sym] + nb);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

// libjpeg-turbo's quantiser for 16-bit DCT elements: round half away from
// zero of x / divisor by a reciprocal multiply (jcdctmgr.c).
struct Divisor {
  uint32_t recip, corr;
  int shift;
  explicit Divisor(uint32_t d = 8) {
    int b = 31 - __builtin_clz(d);
    int r = 16 + b;
    uint64_t fq = (uint64_t(1) << r) / d, fr = (uint64_t(1) << r) % d;
    uint32_t c = d / 2;
    if (fr == 0) {
      fq >>= 1;
      --r;
    } else if (fr <= d / 2) {
      ++c;
    } else {
      ++fq;
    }
    recip = static_cast<uint32_t>(fq);
    corr = c;
    shift = r;
  }
  inline int16_t operator()(int64_t x) const {
    if (x < 0)
      return static_cast<int16_t>(-static_cast<int64_t>(((uint64_t(-x) + corr) * recip) >> shift));
    return static_cast<int16_t>(((uint64_t(x) + corr) * recip) >> shift);
  }
};

// IJG quality scaling of an Annex K table (jcparam.c, force_baseline).
void scaled_table(const int* basic, int quality, uint16_t* out) {
  quality = std::max(1, std::min(100, quality));
  long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(basic[i]) * scale + 50L) / 100L;
    out[i] = static_cast<uint16_t>(std::max(1L, std::min(255L, t)));
  }
}

struct EncComponent {
  int id, h, v, tq;
  int wib, hib, bw, bh;
  std::vector<uint8_t> samples;  // hib*8 rows of wib*8 (edge-replicated)
  std::vector<int16_t> coef;     // bh * bw blocks
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_dht(std::vector<uint8_t>& o, int index, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + n);
  o.push_back(static_cast<uint8_t>(index));
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + n);
}

// (h, w, c) uint8 pixels (c = 1 gray, 3 RGB) -> JFIF bytes appended to out,
// colour with Pillow's default 4:2:0 sampling (luma 2x2, chroma 1x1).
void encode_image(const uint8_t* px, int h, int w, int c, int quality, int n_threads,
                  std::vector<uint8_t>& out) {
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535) fail("JPEG sides must be in 1..65535");
  if (c != 1 && c != 3) fail("JPEG encoder takes 1 (gray) or 3 (RGB) channels");
  uint16_t q[2][64];
  scaled_table(kLumaQuant, quality, q[0]);
  scaled_table(kChromaQuant, quality, q[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = Divisor(q[t][i] * 8u);

  const int hmax = c == 3 ? 2 : 1, vmax = hmax;
  const int mcux = (w + 8 * hmax - 1) / (8 * hmax), mcuy = (h + 8 * vmax - 1) / (8 * vmax);
  std::vector<EncComponent> comps;
  if (c == 1) {
    comps.push_back({1, 1, 1, 0, 0, 0, 0, 0, {}, {}});
  } else {
    comps.push_back({1, 2, 2, 0, 0, 0, 0, 0, {}, {}});
    comps.push_back({2, 1, 1, 1, 0, 0, 0, 0, {}, {}});
    comps.push_back({3, 1, 1, 1, 0, 0, 0, 0, {}, {}});
  }
  const int hpad = (h + vmax - 1) / vmax * vmax;  // rows after the prep's bottom padding
  for (auto& cp : comps) {
    int dw = static_cast<int>((static_cast<int64_t>(w) * cp.h + hmax - 1) / hmax);
    int dh = static_cast<int>((static_cast<int64_t>(h) * cp.v + vmax - 1) / vmax);
    cp.wib = (dw + 7) / 8;
    cp.hib = (dh + 7) / 8;
    cp.bw = c == 1 ? cp.wib : mcux * cp.h;
    cp.bh = c == 1 ? cp.hib : mcuy * cp.v;
    cp.samples.assign(static_cast<size_t>(cp.hib) * 8 * cp.wib * 8, 0);
    cp.coef.assign(static_cast<size_t>(cp.bw) * cp.bh * 64, 0);
  }
  auto value = [&](int ci, int y, int x) -> int {
    y = std::min(y, h - 1);
    x = std::min(x, w - 1);
    const uint8_t* p = px + (static_cast<int64_t>(y) * w + x) * c;
    if (c == 1) return p[0];
    const ColorTables& t = kColor;
    if (ci == 0) return (t.ry[p[0]] + t.gy[p[1]] + t.by[p[2]]) >> kScaleBits;
    if (ci == 1) return (t.rcb[p[0]] + t.gcb[p[1]] + t.bcb[p[2]]) >> kScaleBits;
    return (t.bcb[p[0]] + t.gcr[p[1]] + t.bcr[p[2]]) >> kScaleBits;
  };
  // colour conversion, downsampling and edge replication: one sample row per
  // task; rows past the downsampled image repeat its last row
  std::vector<std::pair<int, int>> rows;
  for (int ci = 0; ci < static_cast<int>(comps.size()); ++ci)
    for (int y = 0; y < comps[ci].hib * 8; ++y) rows.emplace_back(ci, y);
  parallel_for(static_cast<int64_t>(rows.size()), n_threads, [&](int64_t i) {
    const int ci = rows[i].first;
    EncComponent& cp = comps[ci];
    const int hr = hmax / cp.h, vr = vmax / cp.v;
    const int real_rows = hpad / vr;
    const int y = std::min(rows[i].second, real_rows - 1);
    const int cols = cp.wib * 8;
    uint8_t* o = &cp.samples[static_cast<size_t>(rows[i].second) * cols];
    for (int x = 0; x < cols; ++x) {
      if (hr == 1) {
        o[x] = static_cast<uint8_t>(value(ci, y, x));
      } else {            // libjpeg's h2v2 downsample: bias 1, 2, 1, 2, ...
        o[x] = static_cast<uint8_t>((value(ci, 2 * y, 2 * x) + value(ci, 2 * y, 2 * x + 1) +
                                     value(ci, 2 * y + 1, 2 * x) +
                                     value(ci, 2 * y + 1, 2 * x + 1) + 1 + (x & 1)) >> 2);
      }
    }
  });
  // forward DCT and quantisation of the real blocks, a block row per task
  rows.clear();
  for (int ci = 0; ci < static_cast<int>(comps.size()); ++ci)
    for (int r = 0; r < comps[ci].hib; ++r) rows.emplace_back(ci, r);
  parallel_for(static_cast<int64_t>(rows.size()), n_threads, [&](int64_t i) {
    EncComponent& cp = comps[rows[i].first];
    const int r = rows[i].second;
    const int64_t stride = static_cast<int64_t>(cp.wib) * 8;
    const Divisor* dv = div[cp.tq];
    jl ws[64];
    for (int b = 0; b < cp.wib; ++b) {
      const uint8_t* s = &cp.samples[static_cast<size_t>(r) * 8 * stride + b * 8];
      for (int yy = 0; yy < 8; ++yy)
        for (int xx = 0; xx < 8; ++xx) ws[8 * yy + xx] = s[yy * stride + xx] - 128;
      fdct_islow(ws);
      int16_t* blk = &cp.coef[(static_cast<size_t>(r) * cp.bw + b) * 64];
      for (int k = 0; k < 64; ++k) blk[k] = dv[k](ws[k]);
    }
  });
  for (auto& cp : comps) std::vector<uint8_t>().swap(cp.samples);
  // dummy blocks filling the last MCUs: the DC of the block to their left
  // (right edge) or of the MCU's last block above (bottom edge), no AC
  for (auto& cp : comps) {
    for (int by = 0; by < cp.bh; ++by)
      for (int bx = 0; bx < cp.bw; ++bx) {
        if (bx < cp.wib && by < cp.hib) continue;
        int16_t* blk = &cp.coef[(static_cast<size_t>(by) * cp.bw + bx) * 64];
        const int16_t* src = by < cp.hib
            ? blk - 64
            : &cp.coef[(static_cast<size_t>(by - 1) * cp.bw + (bx / cp.h) * cp.h + cp.h - 1) * 64];
        blk[0] = src[0];
      }
  }

  // headers: SOI, JFIF APP0, DQT, SOF0, DHT, SOS
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  out.insert(out.end(), head, head + sizeof(head));
  for (int t = 0; t < (c == 1 ? 1 : 2); ++t) {
    out.push_back(0xFF);
    out.push_back(0xDB);
    put16(out, 67);
    out.push_back(static_cast<uint8_t>(t));
    for (int i = 0; i < 64; ++i) out.push_back(static_cast<uint8_t>(q[t][kNatural[i]]));
  }
  out.push_back(0xFF);
  out.push_back(0xC0);
  put16(out, 8 + 3 * c);
  out.push_back(8);
  put16(out, h);
  put16(out, w);
  out.push_back(static_cast<uint8_t>(c));
  for (auto& cp : comps) {
    out.push_back(static_cast<uint8_t>(cp.id));
    out.push_back(static_cast<uint8_t>((cp.h << 4) | cp.v));
    out.push_back(static_cast<uint8_t>(cp.tq));
  }
  put_dht(out, 0x00, kDcLumaBits, kDcVals);
  put_dht(out, 0x10, kAcLumaBits, kAcLumaVals);
  if (c == 3) {
    put_dht(out, 0x01, kDcChromaBits, kDcVals);
    put_dht(out, 0x11, kAcChromaBits, kAcChromaVals);
  }
  out.push_back(0xFF);
  out.push_back(0xDA);
  put16(out, 6 + 2 * c);
  out.push_back(static_cast<uint8_t>(c));
  for (auto& cp : comps) {
    out.push_back(static_cast<uint8_t>(cp.id));
    out.push_back(static_cast<uint8_t>(cp.tq ? 0x11 : 0x00));
  }
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);

  BitWriter bw(out);
  int last_dc[3] = {0, 0, 0};
  if (c == 1) {
    EncComponent& cp = comps[0];
    for (size_t b = 0; b < static_cast<size_t>(cp.bw) * cp.bh; ++b)
      encode_block(bw, &cp.coef[b * 64], last_dc[0], kDcLuma, kAcLuma);
  } else {
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx)
        for (int ci = 0; ci < 3; ++ci) {
          EncComponent& cp = comps[ci];
          const HuffEncoder& dc = ci ? kDcChroma : kDcLuma;
          const HuffEncoder& ac = ci ? kAcChroma : kAcLuma;
          for (int by = 0; by < cp.v; ++by)
            for (int bx = 0; bx < cp.h; ++bx)
              encode_block(
                  bw, &cp.coef[(static_cast<size_t>(my * cp.v + by) * cp.bw + mx * cp.h + bx) * 64],
                  last_dc[ci], dc, ac);
        }
  }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
}

std::vector<uint8_t> read_file(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) fail(std::string("cannot open ") + path);
  std::vector<uint8_t> data;
  uint8_t chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof(chunk), f)) > 0)
    data.insert(data.end(), chunk, chunk + got);
  bool bad = std::ferror(f);
  std::fclose(f);
  if (bad) fail(std::string("cannot read ") + path);
  return data;
}

void write_file(const char* path, const std::vector<uint8_t>& data) {
  FILE* f = std::fopen(path, "wb");
  if (!f) fail(std::string("cannot create ") + path);
  size_t put = std::fwrite(data.data(), 1, data.size(), f);
  bool bad = put != data.size() || std::fclose(f) != 0;
  if (bad) fail(std::string("cannot write ") + path);
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg.c_str(), errlen - 1);
    err[errlen - 1] = '\0';
  }
}

}  // namespace

extern "C" {

// info: width, height, components in the file, SOF kind (0 or 1), output
// channels (1 gray, 3 RGB).
int jpeg_probe(const uint8_t* data, int64_t size, int32_t* info, char* err, int errlen) {
  try {
    Decoder d(data, size);
    d.probe();
    info[0] = d.width();
    info[1] = d.height();
    info[2] = d.components();
    info[3] = d.sof();
    info[4] = d.out_components();
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Decode into out (height * width * channels bytes, from jpeg_probe).
int jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t out_size,
                int n_threads, char* err, int errlen) {
  try {
    Decoder d(data, size);
    d.probe();
    if (static_cast<int64_t>(d.width()) * d.height() * d.out_components() != out_size)
      fail("output buffer does not match the image");
    Decoder full(data, size);
    full.decode(out, n_threads);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Decode n files of side x side RGB into out (n, side, side, 3), one file a
// thread. On failure names the first failing file.
int jpeg_decode_files(const char** paths, int64_t n, int64_t side, uint8_t* out, int n_threads,
                      char* err, int errlen) {
  try {
    parallel_for(n, n_threads, [&](int64_t i) {
      try {
        std::vector<uint8_t> data = read_file(paths[i]);
        Decoder d(data.data(), static_cast<int64_t>(data.size()));
        d.probe();
        if (d.width() != side || d.height() != side || d.out_components() != 3)
          fail("is " + std::to_string(d.width()) + "x" + std::to_string(d.height()) + "x" +
               std::to_string(d.out_components()) + ", not " + std::to_string(side) + "x" +
               std::to_string(side) + "x3");
        Decoder full(data.data(), static_cast<int64_t>(data.size()));
        full.decode(out + i * side * side * 3, 1);
      } catch (const std::exception& e) {
        fail(std::string(paths[i]) + ": " + e.what());
      }
    });
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Decode n abbreviated JPEG streams (a TIFF's JPEG strips or tiles) into out
// (H, W, oc), one stream a thread. Stream i is base[offsets[i], offsets[i] +
// counts[i]); with tables (a TIFF's JPEGTables, tables_len > 0) it decodes
// as the tables without their EOI followed by the stream without its SOI.
// geom[4 i ..]: y0, x0, rows, cols, the part of the stream's image inside
// out. colour: as Decoder::set_colour. kind names a stream in messages.
int jpeg_decode_segments(const uint8_t* tables, int64_t tables_len, const uint8_t* base,
                         const int64_t* offsets, const int64_t* counts, const int32_t* geom,
                         int64_t n, int colour, uint8_t* out, int W, int oc, const char* kind,
                         int n_threads, char* err, int errlen) {
  try {
    int64_t head = tables_len;
    if (head >= 2 && tables[head - 2] == 0xFF && tables[head - 1] == 0xD9) head -= 2;
    parallel_for(n, n_threads, [&](int64_t i) {
      try {
        const uint8_t* seg = base + offsets[i];
        int64_t len = counts[i];
        std::vector<uint8_t> spliced;
        if (tables_len > 0) {
          if (len >= 2 && seg[0] == 0xFF && seg[1] == 0xD8) {
            seg += 2;
            len -= 2;
          }
          spliced.resize(static_cast<size_t>(head + len));
          std::memcpy(spliced.data(), tables, static_cast<size_t>(head));
          std::memcpy(spliced.data() + head, seg, static_cast<size_t>(len));
          seg = spliced.data();
          len = static_cast<int64_t>(spliced.size());
        }
        Decoder d(seg, len);
        d.set_colour(colour);
        d.probe();
        const int32_t* g = geom + 4 * i;
        if (d.out_components() != oc)
          fail("holds " + std::to_string(d.components()) + " components, not " +
               std::to_string(oc));
        if (d.width() < g[3] || d.height() < g[2])
          fail("is " + std::to_string(d.width()) + "x" + std::to_string(d.height()) +
               ", smaller than its " + std::to_string(g[3]) + "x" + std::to_string(g[2]) +
               " pixels");
        std::vector<uint8_t> px(static_cast<size_t>(d.width()) * d.height() * oc);
        Decoder full(seg, len);
        full.set_colour(colour);
        full.decode(px.data(), 1);
        const int64_t row = static_cast<int64_t>(d.width()) * oc;
        for (int r = 0; r < g[2]; ++r)
          std::memcpy(out + (static_cast<int64_t>(g[0] + r) * W + g[1]) * oc, &px[r * row],
                      static_cast<size_t>(g[3]) * oc);
      } catch (const std::exception& e) {
        fail(std::string(kind) + " " + std::to_string(i) + ": " + e.what());
      }
    });
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Encode (h, w, c) pixels; *out is malloc'ed (free with jpeg_free). Returns
// the byte count, or -1.
int64_t jpeg_encode(const uint8_t* px, int h, int w, int c, int quality, int n_threads,
                    uint8_t** out, char* err, int errlen) {
  try {
    std::vector<uint8_t> bytes;
    encode_image(px, h, w, c, quality, n_threads, bytes);
    *out = static_cast<uint8_t*>(std::malloc(bytes.size()));
    if (!*out) fail("out of memory");
    std::memcpy(*out, bytes.data(), bytes.size());
    return static_cast<int64_t>(bytes.size());
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

void jpeg_free(uint8_t* p) { std::free(p); }

// Encode n images (n, h, w, c) to n files, one image a thread.
int jpeg_encode_files(const uint8_t* px, int64_t n, int h, int w, int c, const char** paths,
                      int quality, int n_threads, char* err, int errlen) {
  try {
    const int64_t each = static_cast<int64_t>(h) * w * c;
    parallel_for(n, n_threads, [&](int64_t i) {
      try {
        std::vector<uint8_t> bytes;
        bytes.reserve(static_cast<size_t>(each / 4 + 1024));
        encode_image(px + i * each, h, w, c, quality, 1, bytes);
        write_file(paths[i], bytes);
      } catch (const std::exception& e) {
        fail(std::string(paths[i]) + ": " + e.what());
      }
    });
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

}  // extern "C"
