// Host raster codecs of the port's TIFF and PNG readers (io/tiff.py,
// io/png.py): TIFF's LZW, PackBits and CCITT fax (Modified Huffman, Group 3
// 1-D and 2-D, Group 4), the horizontal predictor, and PNG's row filters. No libtiff, no libpng, no zlib: the readers inflate Deflate
// with Python's zlib and hand the inflated bytes here.
//
// Plain C interface for ctypes, built at first use by ops/_host.py:
//
//   raster_decode   n TIFF strips or tiles of one codec (none, LZW,
//                   PackBits, CCITT), each decoded (its bits first reversed for
//                   FillOrder 2), its predictor undone and its rows placed
//                   into the caller's raster of stored bytes (rows of
//                   samples as the file packs them, any bit depth, one
//                   plane after another for PlanarConfiguration 2), one
//                   segment a task over n_threads threads
//   png_unfilter    rows of PNG scanlines (a filter byte each) undone into
//                   the caller's rows of bytes, with the previous row
//                   carried across calls
//   lab_to_rgb      Pillow's LAB pixels to RGB through LittleCMS's
//                   resampled Lab -> sRGB table (io/pillow_modes.py builds
//                   the 33^3 nodes), a block of pixels a task
//
// Decoding follows libtiff 4.x, which Pillow reads TIFF through:
//  * LZW is the "new-style" code (TIFF 6.0): codes MSB-first, 9 to 12 bits,
//    Clear 256, EOI 257, the first free code 258, and the code width grows
//    one code early (at 511, 1023, 2047). Old-style LSB-first LZW (files of
//    libtiff before 5.0, first bytes 0x00 0x01) is refused. A strip that
//    ends without EOI stops where its data ends; one that holds fewer bytes
//    than its rows is refused; bytes past its rows are dropped.
//  * PackBits: a header n in 0..127 copies n + 1 bytes, -127..-1 repeats
//    the next byte 1 - n times, -128 is skipped.
//  * Predictor 2 (8-, 16- and 32-bit samples): each sample adds the same
//    sample of the pixel to its left, along each stored row (a tile's full
//    width), in the file's byte order (libtiff swaps to the host's order,
//    adds and keeps the sum modulo the sample's range).
//  * FillOrder 2: libtiff reverses the bits of each byte of a segment's
//    stored bytes before its codec sees them (for every codec but JPEG).

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

struct RasterError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw RasterError(msg); }

void set_error(char* err, int errlen, const std::string& msg) {
  if (!err || errlen <= 0) return;
  std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

// fn(i) for i in [0, n) over n_threads threads (0: all cores); the first
// failure (lowest index among the threads that failed) is rethrown.
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
  for (auto& t : ts) t.join();
  if (failed.load()) {
    auto first = std::min_element(errors.begin(), errors.end());
    fail(first->second);
  }
}

// ---- LZW ----------------------------------------------------------------

class LzwDecoder {
 public:
  LzwDecoder() {
    for (int i = 0; i < 256; ++i) {
      prefix_[i] = 0;
      suffix_[i] = first_[i] = static_cast<uint8_t>(i);
      length_[i] = 1;
    }
  }

  // Decode src into dst[0, want); fails if src holds fewer bytes.
  void decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t want) {
    if (n >= 2 && src[0] == 0 && (src[1] & 1))
      fail("old-style (LSB-first) LZW is not supported");
    int64_t in = 0, pos = 0;
    uint64_t bitbuf = 0;
    int bits = 0, nbits = 9, next = kFirst, prev = -1;
    while (pos < want) {
      while (bits < nbits && in < n) {
        bitbuf = (bitbuf << 8) | src[in++];
        bits += 8;
      }
      if (bits < nbits) break;  // the data ends without EOI: libtiff stops here
      const int code = static_cast<int>((bitbuf >> (bits - nbits)) & ((1u << nbits) - 1));
      bits -= nbits;
      if (code == kEoi) break;
      if (code == kClear) {
        next = kFirst;
        nbits = 9;
        prev = -1;
        continue;
      }
      if (prev < 0) {
        if (code > 255) fail("corrupt LZW data: a code above 255 after Clear");
        dst[pos++] = static_cast<uint8_t>(code);
        prev = code;
        continue;
      }
      if (code > next || (code == next && next >= kMax))
        fail("corrupt LZW data: code " + std::to_string(code) + " is not in the table");
      if (next < kMax) {
        prefix_[next] = static_cast<uint16_t>(prev);
        first_[next] = first_[prev];
        suffix_[next] = code < next ? first_[code] : first_[prev];
        length_[next] = static_cast<uint16_t>(length_[prev] + 1);
        ++next;
      }
      pos = emit(code, dst, pos, want);
      prev = code;
      if (next >= (1 << nbits) - 1 && nbits < 12) ++nbits;  // early change
    }
    if (pos < want)
      fail("LZW data ends after " + std::to_string(pos) + " of " + std::to_string(want) +
           " bytes");
  }

 private:
  static constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMax = 4096;
  uint16_t prefix_[kMax], length_[kMax];
  uint8_t suffix_[kMax], first_[kMax];

  int64_t emit(int code, uint8_t* dst, int64_t pos, int64_t want) {
    const int len = length_[code];
    if (pos + len <= want) {
      int64_t p = pos + len - 1;
      for (int c = code; c > 255; c = prefix_[c]) dst[p--] = suffix_[c];
      dst[p] = first_[code];
      return pos + len;
    }
    uint8_t tmp[kMax];
    int p = len - 1;
    for (int c = code; c > 255; c = prefix_[c]) tmp[p--] = suffix_[c];
    tmp[p] = first_[code];
    std::memcpy(dst + pos, tmp, static_cast<size_t>(want - pos));
    return want;
  }
};

// LittleCMS's 16-bit tetrahedral interpolation (cmsintrp.c
// TetrahedralInterp16) of a 33^3 table of 3 outputs, at 8-bit inputs v * 257
// (v: L, and a* and b* offset by 128 from the two's-complement bytes of
// ``in``), each output then reduced to 8 bits as lcms's FROM_16_TO_8.
void lab_pixel(const uint8_t* in, const uint16_t* table, uint8_t* out) {
  constexpr int kGrid = 33;
  constexpr int32_t kOpta[3] = {3 * kGrid * kGrid, 3 * kGrid, 3};
  int32_t base = 0, r[3], step[3];
  for (int c = 0; c < 3; ++c) {
    const int32_t v = (in[c] ^ (c ? 0x80 : 0)) * 257;
    const int32_t a = v * (kGrid - 1);
    const int32_t f = a + (a + 0x7FFF) / 0xFFFF;     // _cmsToFixedDomain
    base += kOpta[c] * (f >> 16);
    r[c] = f & 0xFFFF;
    step[c] = v == 0xFFFF ? 0 : kOpta[c];
  }
  const int32_t rx = r[0], ry = r[1], rz = r[2];
  int32_t o1, o2, o3;           // offsets of the tetrahedron's other three corners
  int32_t w1, w2, w3;           // and the weights of its edges
  if (rx >= ry && ry >= rz) {
    o1 = step[0]; o2 = o1 + step[1]; o3 = o2 + step[2]; w1 = rx; w2 = ry; w3 = rz;
  } else if (rx >= ry && rz >= rx) {
    o1 = step[2]; o2 = o1 + step[0]; o3 = o2 + step[1]; w1 = rz; w2 = rx; w3 = ry;
  } else if (rx >= ry) {
    o1 = step[0]; o2 = o1 + step[2]; o3 = o2 + step[1]; w1 = rx; w2 = rz; w3 = ry;
  } else if (rx >= rz) {
    o1 = step[1]; o2 = o1 + step[0]; o3 = o2 + step[2]; w1 = ry; w2 = rx; w3 = rz;
  } else if (ry >= rz) {
    o1 = step[1]; o2 = o1 + step[2]; o3 = o2 + step[0]; w1 = ry; w2 = rz; w3 = rx;
  } else {
    o1 = step[2]; o2 = o1 + step[1]; o3 = o2 + step[0]; w1 = rz; w2 = ry; w3 = rx;
  }
  const uint16_t* t = table + base;
  for (int k = 0; k < 3; ++k) {
    const int32_t c0 = t[k], c1 = t[o1 + k], c2 = t[o2 + k], c3 = t[o3 + k];
    const int32_t rest = (c1 - c0) * w1 + (c2 - c1) * w2 + (c3 - c2) * w3 + 0x8001;
    const uint32_t v16 = static_cast<uint16_t>(c0 + ((rest + (rest >> 16)) >> 16));
    out[k] = static_cast<uint8_t>(((v16 * 65281u + 8388608u) >> 24) & 0xFF);
  }
}

// ---- PackBits -------------------------------------------------------------

void packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t want) {
  int64_t in = 0, pos = 0;
  while (pos < want && in < n) {
    const int c = static_cast<int8_t>(src[in++]);
    if (c >= 0) {
      int64_t count = c + 1;
      if (in + count > n) fail("truncated PackBits data");
      count = std::min(count, want - pos);
      std::memcpy(dst + pos, src + in, static_cast<size_t>(count));
      in += c + 1;
      pos += count;
    } else if (c != -128) {
      if (in >= n) fail("truncated PackBits data");
      const int64_t count = std::min<int64_t>(1 - c, want - pos);
      std::memset(dst + pos, src[in++], static_cast<size_t>(count));
      pos += count;
    }
  }
  if (pos < want)
    fail("PackBits data ends after " + std::to_string(pos) + " of " + std::to_string(want) +
         " bytes");
}

// ---- predictor and placement ----------------------------------------------

uint8_t kReversed[256];
struct ReversedInit {
  ReversedInit() {
    for (int i = 0; i < 256; ++i) {
      int r = 0;
      for (int b = 0; b < 8; ++b) r |= ((i >> b) & 1) << (7 - b);
      kReversed[i] = static_cast<uint8_t>(r);
    }
  }
} kReversedInit;

template <int N>
inline uint32_t load(const uint8_t* p, bool big) {
  uint32_t v = 0;
  for (int i = 0; i < N; ++i) v |= static_cast<uint32_t>(p[big ? N - 1 - i : i]) << (8 * i);
  return v;
}

template <int N>
inline void store(uint8_t* p, uint32_t v, bool big) {
  for (int i = 0; i < N; ++i) p[big ? N - 1 - i : i] = static_cast<uint8_t>(v >> (8 * i));
}

// Predictor 2 on samples of N bytes, spp of them a pixel, in the file's order.
template <int N>
void undo_horizontal_n(uint8_t* data, int64_t rows, int64_t row_bytes, int spp, bool big) {
  const int64_t stride = static_cast<int64_t>(spp) * N;
  for (int64_t r = 0; r < rows; ++r) {
    uint8_t* row = data + r * row_bytes;
    for (int64_t i = stride; i + N <= row_bytes; i += N)
      store<N>(row + i, load<N>(row + i, big) + load<N>(row + i - stride, big), big);
  }
}

void undo_horizontal(uint8_t* data, int64_t rows, int64_t row_bytes, int spp, int sample_bytes,
                     bool big) {
  switch (sample_bytes) {
    case 1: undo_horizontal_n<1>(data, rows, row_bytes, spp, big); break;
    case 2: undo_horizontal_n<2>(data, rows, row_bytes, spp, big); break;
    case 4: undo_horizontal_n<4>(data, rows, row_bytes, spp, big); break;
    default: fail("Predictor 2 on " + std::to_string(8 * sample_bytes) + "-bit samples");
  }
}

// Copy ``rows`` rows of ``cols`` bytes of a segment (stored rows of
// stored_row bytes) to out (rows of out_row bytes; plane p starts at
// p * plane_bytes) at row y0, byte x0.
void place(const uint8_t* src, int64_t stored_row, int y0, int64_t x0, int rows, int64_t cols,
           int plane, uint8_t* out, int64_t out_row, int64_t plane_bytes) {
  uint8_t* base = out + (plane > 0 ? plane * plane_bytes : 0);
  for (int r = 0; r < rows; ++r)
    std::memcpy(base + static_cast<int64_t>(y0 + r) * out_row + x0, src + r * stored_row,
                static_cast<size_t>(cols));
}

// ---- PNG ----------------------------------------------------------------

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

void unfilter_row(int type, const uint8_t* f, const uint8_t* prev, uint8_t* cur, int64_t n,
                  int bpp) {
  switch (type) {
    case 0:
      std::memcpy(cur, f, static_cast<size_t>(n));
      break;
    case 1:
      for (int64_t i = 0; i < n; ++i)
        cur[i] = static_cast<uint8_t>(f[i] + (i >= bpp ? cur[i - bpp] : 0));
      break;
    case 2:
      for (int64_t i = 0; i < n; ++i) cur[i] = static_cast<uint8_t>(f[i] + prev[i]);
      break;
    case 3:
      for (int64_t i = 0; i < n; ++i)
        cur[i] = static_cast<uint8_t>(f[i] + (((i >= bpp ? cur[i - bpp] : 0) + prev[i]) >> 1));
      break;
    case 4:
      for (int64_t i = 0; i < n; ++i)
        cur[i] = static_cast<uint8_t>(
            f[i] + (i >= bpp ? paeth(cur[i - bpp], prev[i], prev[i - bpp]) : prev[i]));
      break;
    default:
      fail("PNG row filter type " + std::to_string(type) + " is not 0-4");
  }
}

// ---- CCITT fax (compressions 2, 3 and 4) ------------------------------------
//
// ITU-T T.4 (Group 3: Modified Huffman rows, each after an EOL, or 2-D READ
// rows with a tag bit after the EOL) and T.6 (Group 4: 2-D rows, no EOL),
// and TIFF's compression 2 (Modified Huffman rows, each starting on a byte,
// no EOL), decoded as libtiff 4.x does (tif_fax3.c, tif_fax3.h), which
// Pillow reads fax through:
//  * a decoded row has 1 bits for black runs and 0 for white ones, whatever
//    the photometric interpretation (the reader maps bits as Pillow does);
//  * bits are fetched as libtiff's NeedBits8 / NeedBits16 fetch them: a code
//    is looked up in 12 (white), 13 (black) or 7 (2-D mode) bits, and where
//    the segment ends inside that window libtiff counts the missing bits as
//    zeros it has read. Compression 2 then aligns each row end to libtiff's
//    count of bits held, so a row that follows such a window loses bits
//    exactly as it does in Pillow;
//  * a 1-D row whose runs do not sum to its width is mended as libtiff's
//    CLEANUP_RUNS mends it (the runs past the width dropped, the rest
//    white); an EOL ends a 1-D row (the 11 zero bits; the 1 after them is
//    taken with the next row's EOL search);
//  * each strip or tile starts from an all-white reference row; a segment
//    that ends before its rows raises.

enum FaxState : uint8_t { kNull, kTerm, kMakeUp, kEolCode, kPassCode, kHorizCode, kVert, kExt };

struct FaxCode {
  const char* bits;
  int value;
};

// Modified Huffman terminating and make-up codes (T.4 tables 2 and 3)
const FaxCode kWhiteCodes[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4}, {"1100", 5},
    {"1110", 6}, {"1111", 7}, {"10011", 8}, {"10100", 9}, {"00111", 10}, {"01000", 11},
    {"001000", 12}, {"000011", 13}, {"110100", 14}, {"110101", 15}, {"101010", 16},
    {"101011", 17}, {"0100111", 18}, {"0001100", 19}, {"0001000", 20}, {"0010111", 21},
    {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25}, {"0010011", 26},
    {"0100100", 27}, {"0011000", 28}, {"00000010", 29}, {"00000011", 30}, {"00011010", 31},
    {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35}, {"00010101", 36},
    {"00010110", 37}, {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45}, {"00000101", 46},
    {"00001010", 47}, {"00001011", 48}, {"01010010", 49}, {"01010011", 50}, {"01010100", 51},
    {"01010101", 52}, {"00100100", 53}, {"00100101", 54}, {"01011000", 55}, {"01011001", 56},
    {"01011010", 57}, {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61},
    {"00110011", 62}, {"00110100", 63}, {"11011", 64}, {"10010", 128}, {"010111", 192},
    {"0110111", 256}, {"00110110", 320}, {"00110111", 384}, {"01100100", 448},
    {"01100101", 512}, {"01101000", 576}, {"01100111", 640}, {"011001100", 704},
    {"011001101", 768}, {"011010010", 832}, {"011010011", 896}, {"011010100", 960},
    {"011010101", 1024}, {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216},
    {"011011001", 1280}, {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472},
    {"010011001", 1536}, {"010011010", 1600}, {"011000", 1664}, {"010011011", 1728}};
const FaxCode kBlackCodes[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4}, {"0011", 5},
    {"0010", 6}, {"00011", 7}, {"000101", 8}, {"000100", 9}, {"0000100", 10},
    {"0000101", 11}, {"0000111", 12}, {"00000100", 13}, {"00000111", 14}, {"000011000", 15},
    {"0000010111", 16}, {"0000011000", 17}, {"0000001000", 18}, {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23},
    {"00000010111", 24}, {"00000011000", 25}, {"000011001010", 26}, {"000011001011", 27},
    {"000011001100", 28}, {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31},
    {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34}, {"000011010011", 35},
    {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38}, {"000011010111", 39},
    {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47},
    {"000001100100", 48}, {"000001100101", 49}, {"000001010010", 50}, {"000001010011", 51},
    {"000000100100", 52}, {"000000110111", 53}, {"000000111000", 54}, {"000000100111", 55},
    {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63},
    {"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192}, {"000001011011", 256},
    {"000000110011", 320}, {"000000110100", 384}, {"000000110101", 448},
    {"0000001101100", 512}, {"0000001101101", 576}, {"0000001001010", 640},
    {"0000001001011", 704}, {"0000001001100", 768}, {"0000001001101", 832},
    {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344}, {"0000001010100", 1408},
    {"0000001010101", 1472}, {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}};
// make-up codes of either colour (T.4 table 3, extended)
const FaxCode kExtendedCodes[] = {
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};

struct FaxEntry {
  uint8_t width = 0;
  uint8_t state = kNull;
  int16_t param = 0;
};

// A lookup of ``bits`` bits (the next bits of the stream, first bit the
// most significant) -> the code they start with.
struct FaxTable {
  int bits;
  std::vector<FaxEntry> t;
  explicit FaxTable(int b) : bits(b), t(size_t(1) << b) {}
  void add(const char* code, uint8_t state, int param) {
    const int len = static_cast<int>(std::strlen(code));
    uint32_t c = 0;
    for (int k = 0; k < len; ++k) c = c << 1 | (code[k] == '1');
    const uint32_t lo = c << (bits - len), hi = lo + (1u << (bits - len));
    for (uint32_t e = lo; e < hi; ++e) {
      if (t[e].state != kNull) fail("CCITT code tables clash");   // a typo in a table
      t[e] = FaxEntry{static_cast<uint8_t>(len), state, static_cast<int16_t>(param)};
    }
  }
};

// libtiff's white (12-bit) and black (13-bit) tables: the run codes, the
// extended make-up codes and EOL as 11 zero bits (mkg3states.c's EOLH)
FaxTable run_table(bool black) {
  FaxTable t(black ? 13 : 12);
  for (const FaxCode& c : black ? kBlackCodes : kWhiteCodes)
    t.add(c.bits, c.value < 64 ? kTerm : kMakeUp, c.value);
  for (const FaxCode& c : kExtendedCodes) t.add(c.bits, kMakeUp, c.value);
  t.add("00000000000", kEolCode, 0);
  return t;
}

// libtiff's main (7-bit) table of 2-D modes (T.4 table 4), EOL as 7 zeros
FaxTable mode_table() {
  FaxTable t(7);
  t.add("1", kVert, 0);
  t.add("011", kVert, 1);
  t.add("000011", kVert, 2);
  t.add("0000011", kVert, 3);
  t.add("010", kVert, -1);
  t.add("000010", kVert, -2);
  t.add("0000010", kVert, -3);
  t.add("001", kHorizCode, 0);
  t.add("0001", kPassCode, 0);
  t.add("0000001", kExt, 0);
  t.add("0000000", kEolCode, 0);
  return t;
}

const FaxTable& white_codes() {
  static const FaxTable t = run_table(false);
  return t;
}
const FaxTable& black_codes() {
  static const FaxTable t = run_table(true);
  return t;
}
const FaxTable& mode_codes() {
  static const FaxTable t = mode_table();
  return t;
}

// libtiff's fax bit reader: ``held`` bits fetched a byte at a time; at the
// segment's end a fetch of n bits that finds some held counts n held (the
// rest zeros), and one that finds none is the end of the data.
class FaxBits {
 public:
  FaxBits(const uint8_t* d, int64_t n) : d_(d), n_(n) {}
  bool need8(int k) {
    if (held() < k) {
      if (bytes_ >= n_) {
        if (held() == 0) return false;
        end_ = pos_ + k;
      } else {
        ++bytes_;
        end_ += 8;
      }
    }
    return true;
  }
  bool need16(int k) {
    if (held() < k) {
      if (bytes_ >= n_) {
        if (held() == 0) return false;
        end_ = pos_ + k;
      } else {
        ++bytes_;
        end_ += 8;
        if (held() < k) {
          if (bytes_ >= n_) {
            end_ = pos_ + k;
          } else {
            ++bytes_;
            end_ += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int k) const {            // the next k bits; zeros past those held
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      const int64_t p = pos_ + i;
      v = v << 1 | (p < end_ && p < 8 * n_ ? (d_[p >> 3] >> (7 - (p & 7))) & 1 : 0);
    }
    return v;
  }
  void clear(int k) { pos_ += k; }
  int64_t held() const { return end_ - pos_; }
  // One code of table t, or a null entry at the end of the data.
  bool lookup(const FaxTable& t, FaxEntry& e) {
    if (!(t.bits > 8 ? need16(t.bits) : need8(t.bits))) return false;
    e = t.t[get(t.bits)];
    clear(e.width);
    return true;
  }

 private:
  const uint8_t* d_;
  int64_t n_, pos_ = 0, end_ = 0, bytes_ = 0;
};

[[noreturn]] void fax_eof() { fail("CCITT data ends before its rows"); }

// tif_fax3.h SYNC_EOL: unless the last row ended on an EOL, find 11 zero
// bits; then pass zero bytes and zero bits, and the EOL's 1.
void fax_sync_eol(FaxBits& br, bool& eol) {
  if (!eol) {
    for (;;) {
      if (!br.need16(11)) fax_eof();
      if (br.get(11) == 0) break;
      br.clear(1);
    }
  }
  for (;;) {
    if (!br.need8(8)) fax_eof();
    if (br.get(8)) break;
    br.clear(8);
  }
  while (br.get(1) == 0) br.clear(1);
  br.clear(1);
  eol = false;
}

// tif_fax3.h EXPAND1D and CLEANUP_RUNS: the runs (white first) of one
// Modified Huffman row of ``width`` pixels.
void fax_row_1d(FaxBits& br, int width, std::vector<int>& runs, bool& eol) {
  runs.clear();
  int64_t a0 = 0, pending = 0;
  auto set = [&](int64_t x) {
    runs.push_back(static_cast<int>(pending + x));
    a0 += x;
    pending = 0;
  };
  FaxEntry e;
  bool done = false;
  while (!done) {
    for (int colour = 0; colour < 2 && !done; ++colour) {
      for (;;) {
        if (!br.lookup(colour ? black_codes() : white_codes(), e)) fax_eof();
        if (e.state == kEolCode) {
          eol = true;
          done = true;
        } else if (e.state == kTerm) {
          set(e.param);
        } else if (e.state == kMakeUp) {
          a0 += e.param;
          pending += e.param;
          continue;
        } else {
          done = true;                       // libtiff: "bad code", the row ends
        }
        break;
      }
      if (a0 >= width) done = true;
    }
    if (!done && runs.size() >= 2 && runs[runs.size() - 1] == 0 && runs[runs.size() - 2] == 0)
      runs.resize(runs.size() - 2);
  }
  if (pending) set(0);
  if (a0 != width) {                         // mend a row of the wrong length
    while (a0 > width && !runs.empty()) {
      a0 -= runs.back();
      runs.pop_back();
    }
    if (a0 < width) {
      if (a0 < 0) a0 = 0;
      if (runs.size() & 1) set(0);
      set(width - a0);
    } else if (a0 > width) {
      set(width);
      set(0);
    }
  }
}

// A 2-D row against the reference row's changing elements ``ref`` (then
// width three times): its changing elements.
void fax_row_2d(FaxBits& br, int width, const std::vector<int>& ref, std::vector<int>& cur) {
  cur.clear();
  int a0 = -1;
  bool black = false;
  size_t bi = 0;
  FaxEntry e;
  auto run = [&](bool b) {
    int total = 0;
    for (;;) {
      if (!br.lookup(b ? black_codes() : white_codes(), e)) fax_eof();
      if (e.state == kMakeUp) {
        total += e.param;
      } else if (e.state == kTerm) {
        return total + e.param;
      } else {
        fail("corrupt CCITT data: bad run code in a 2-D row");
      }
    }
  };
  while (a0 < width) {
    // b1: the first changing element past a0 of the colour opposite a0's
    // (black elements at even indices); b2 the next one
    bi = bi >= 2 ? bi - 2 : 0;
    while (ref[bi] <= a0 || (bi & 1) != static_cast<size_t>(black)) ++bi;
    const int b1 = ref[bi], b2 = ref[bi + 1];
    if (!br.lookup(mode_codes(), e)) fax_eof();
    if (e.state == kPassCode) {
      a0 = b2;
    } else if (e.state == kHorizCode) {
      const int start = std::max(a0, 0);
      const int a1 = start + run(black);
      const int a2 = a1 + run(!black);
      if (a2 > width) fail("corrupt CCITT data: runs past the row");
      cur.push_back(a1);
      cur.push_back(a2);
      a0 = a2;
    } else if (e.state == kVert) {
      const int a1 = b1 + e.param;
      if (a1 < std::max(a0, 0) || a1 > width)
        fail("corrupt CCITT data: a vertical code off the row");
      cur.push_back(a1);
      a0 = a1;
      black = !black;
    } else {
      fail(e.state == kExt ? "unsupported CCITT data: an extension (uncompressed) code"
                           : "corrupt CCITT data: an EOL or a bad code inside a 2-D row");
    }
  }
}

// Set the bits of the black spans [x0, x1) of a row.
void fax_black(uint8_t* row, int x0, int x1) {
  for (int x = x0; x < x1; ++x) row[x >> 3] = static_cast<uint8_t>(row[x >> 3] | (0x80 >> (x & 7)));
}

// Decode ``rows`` rows of ``width`` pixels of compression 2, 3 (options:
// TIFF's T4Options) or 4 into dst (rows of row_bytes, zeroed here).
void fax_decode(int codec, int options, const uint8_t* src, int64_t n, uint8_t* dst, int rows,
                int width, int64_t row_bytes) {
  if (codec == 3 && (options & 2)) fail("unsupported CCITT Group 3: uncompressed mode");
  std::memset(dst, 0, static_cast<size_t>(rows * row_bytes));
  FaxBits br(src, n);
  std::vector<int> ref(3, width), cur, runs;
  bool eol = false;
  for (int y = 0; y < rows; ++y) {
    uint8_t* row = dst + y * row_bytes;
    bool two_d = codec == 4;
    if (codec == 3) {
      fax_sync_eol(br, eol);
      if (options & 1) {           // after the EOL a tag bit: 1 a 1-D row, 0 a 2-D row
        if (!br.need8(1)) fax_eof();
        two_d = br.get(1) == 0;
        br.clear(1);
      }
    }
    if (two_d) {
      fax_row_2d(br, width, ref, cur);
      for (size_t i = 0; i < cur.size(); i += 2)
        fax_black(row, std::min(cur[i], width), i + 1 < cur.size() ? std::min(cur[i + 1], width)
                                                                  : width);
    } else {
      fax_row_1d(br, width, runs, eol);
      cur.clear();
      int x = 0;
      for (size_t i = 0; i < runs.size(); ++i) {
        const int x1 = std::min(x + runs[i], width);
        if (i & 1) fax_black(row, x, x1);
        x = x1;
        cur.push_back(x);
      }
      if (codec == 2) br.clear(static_cast<int>(br.held() & 7));   // libtiff's byte align
    }
    ref = cur;
    ref.insert(ref.end(), 3, width);
  }
}

}  // namespace

extern "C" {

// codec: 1 none, 2 / 3 / 4 CCITT (fax_options: T4Options for 3; rows of
// fax_width pixels), 5 LZW, 32773 PackBits. Segment i's bytes are base[offsets[i],
// offsets[i] + counts[i]); geom[6 i ..]: y0, x0 (in bytes), rows, cols (in
// bytes; the part inside the image), plane (-1 for interleaved samples),
// stored rows. A segment holds stored rows of stored_row bytes; predictor 2
// works on samples of sample_bytes bytes, spp a pixel, big-endian when
// ``big``; ``reverse`` reverses each stored byte's bits first. kind names a
// segment in messages ("strip" or "tile").
int raster_decode(int codec, const uint8_t* base, const int64_t* offsets, const int64_t* counts,
                  const int32_t* geom, int64_t n, int64_t stored_row, int sample_bytes, int spp,
                  int predictor, int big, int reverse, int fax_options, int fax_width,
                  uint8_t* out, int64_t out_row, int64_t plane_bytes, const char* kind,
                  int n_threads, char* err, int errlen) {
  try {
    if (codec != 1 && codec != 2 && codec != 3 && codec != 4 && codec != 5 && codec != 32773)
      fail("raster_decode: codec " + std::to_string(codec));
    parallel_for(n, n_threads, [&](int64_t i) {
      try {
        const int32_t* g = geom + 6 * i;
        const int64_t want = stored_row * g[5];
        const uint8_t* src = base + offsets[i];
        int64_t count = counts[i];
        std::vector<uint8_t> flipped;
        if (reverse) {
          flipped.resize(static_cast<size_t>(count));
          for (int64_t k = 0; k < count; ++k) flipped[k] = kReversed[src[k]];
          src = flipped.data();
        }
        const uint8_t* pixels = src;
        std::vector<uint8_t> buf;
        if (codec == 1) {
          if (count < want)
            fail("holds " + std::to_string(count) + " bytes of " + std::to_string(want));
          if (predictor == 2) buf.assign(src, src + want);
        } else {
          buf.resize(static_cast<size_t>(want));
          if (codec == 5) {
            LzwDecoder lzw;
            lzw.decode(src, count, buf.data(), want);
          } else if (codec <= 4) {
            fax_decode(codec, fax_options, src, count, buf.data(), g[5], fax_width, stored_row);
          } else {
            packbits_decode(src, count, buf.data(), want);
          }
        }
        if (!buf.empty()) {
          if (predictor == 2) undo_horizontal(buf.data(), g[5], stored_row, spp, sample_bytes, big);
          pixels = buf.data();
        }
        place(pixels, stored_row, g[0], g[1], g[2], g[3], g[4], out, out_row, plane_bytes);
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

// Undo the filters of ``rows`` scanlines (a filter byte, then row_bytes bytes
// each) of src, ``bpp`` bytes a filter unit (PNG's bytes a complete pixel,
// at least 1), into out (rows of row_bytes). prev holds the unfiltered row
// above the first (zeros for a pass's first row) and is left holding the
// last.
int png_unfilter(const uint8_t* src, int64_t src_len, int64_t rows, int64_t row_bytes, int bpp,
                 uint8_t* prev, uint8_t* out, char* err, int errlen) {
  try {
    if (src_len < rows * (row_bytes + 1)) fail("PNG image data is truncated");
    for (int64_t r = 0; r < rows; ++r) {
      const uint8_t* f = src + r * (row_bytes + 1);
      uint8_t* cur = out + r * row_bytes;
      unfilter_row(f[0], f + 1, prev, cur, row_bytes, bpp);
      std::memcpy(prev, cur, static_cast<size_t>(row_bytes));
    }
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// n Lab pixels (L, then a* and b* as two's-complement bytes: Pillow's LAB
// array) to RGB through the 33^3 x 3 table of 16-bit nodes, 2^16 pixels a
// task.
int lab_to_rgb(const uint8_t* lab, int64_t n, const uint16_t* table, uint8_t* rgb,
               int n_threads, char* err, int errlen) {
  try {
    constexpr int64_t kBlock = 1 << 16;
    parallel_for((n + kBlock - 1) / kBlock, n_threads, [&](int64_t b) {
      for (int64_t i = b * kBlock; i < std::min(n, (b + 1) * kBlock); ++i)
        lab_pixel(lab + 3 * i, table, rgb + 3 * i);
    });
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

}  // extern "C"
