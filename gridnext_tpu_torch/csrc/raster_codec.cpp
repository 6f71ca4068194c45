// Host raster codecs of the port's TIFF and PNG readers (io/tiff.py,
// io/png.py): TIFF's LZW and PackBits, the horizontal predictor, and PNG's
// row filters. No libtiff, no libpng, no zlib: the readers inflate Deflate
// with Python's zlib and hand the inflated bytes here.
//
// Plain C interface for ctypes, built at first use by ops/_host.py:
//
//   raster_decode   n TIFF strips or tiles of one codec (none, LZW,
//                   PackBits), each decoded, its predictor undone and its
//                   rows placed into the caller's (H, W, oc) uint8 array,
//                   one segment a task over n_threads threads
//   png_unfilter    rows of PNG scanlines (a filter byte each) undone into
//                   the caller's (rows, W, oc) array, with the previous row
//                   carried across calls
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
//  * Predictor 2 (8-bit samples): each sample adds the same sample of the
//    pixel to its left, along each stored row (a tile's full width).

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

void undo_horizontal(uint8_t* data, int64_t rows, int64_t row_bytes, int spp) {
  for (int64_t r = 0; r < rows; ++r) {
    uint8_t* row = data + r * row_bytes;
    for (int64_t i = spp; i < row_bytes; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - spp]);
  }
}

// Copy rows x cols pixels of a segment (stored rows of stored_w pixels of
// seg_spp samples) to out (H, W, oc) at (y0, x0): the first oc samples of a
// pixel, or for a plane (planar configuration 2, seg_spp 1) its one sample
// into channel ``plane``.
void place(const uint8_t* src, int stored_w, int seg_spp, int y0, int x0, int rows, int cols,
           int plane, uint8_t* out, int W, int oc) {
  const int64_t src_row = static_cast<int64_t>(stored_w) * seg_spp;
  for (int r = 0; r < rows; ++r) {
    const uint8_t* s = src + r * src_row;
    uint8_t* o = out + (static_cast<int64_t>(y0 + r) * W + x0) * oc;
    if (plane >= 0) {
      if (plane >= oc) return;
      for (int x = 0; x < cols; ++x) o[x * oc + plane] = s[x];
    } else if (seg_spp == oc) {
      std::memcpy(o, s, static_cast<size_t>(cols) * oc);
    } else {
      for (int x = 0; x < cols; ++x)
        for (int c = 0; c < oc; ++c) o[x * oc + c] = s[x * seg_spp + c];
    }
  }
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

}  // namespace

extern "C" {

// codec: 1 none, 5 LZW, 32773 PackBits. Segment i's bytes are base[offsets[i],
// offsets[i] + counts[i]); geom[6 i ..]: y0, x0, rows, cols (the part inside
// the image), plane (-1 for interleaved samples), stored rows. kind names a
// segment in messages ("strip" or "tile").
int raster_decode(int codec, const uint8_t* base, const int64_t* offsets, const int64_t* counts,
                  const int32_t* geom, int64_t n, int stored_w, int seg_spp, int predictor,
                  uint8_t* out, int W, int oc, const char* kind, int n_threads, char* err,
                  int errlen) {
  try {
    if (codec != 1 && codec != 5 && codec != 32773)
      fail("raster_decode: codec " + std::to_string(codec));
    parallel_for(n, n_threads, [&](int64_t i) {
      try {
        const int32_t* g = geom + 6 * i;
        const int64_t row_bytes = static_cast<int64_t>(stored_w) * seg_spp;
        const int64_t want = row_bytes * g[5];
        const uint8_t* src = base + offsets[i];
        const uint8_t* pixels = src;
        std::vector<uint8_t> buf;
        if (codec == 1) {
          if (counts[i] < want)
            fail("holds " + std::to_string(counts[i]) + " bytes of " + std::to_string(want));
          if (predictor == 2) buf.assign(src, src + want);
        } else {
          buf.resize(static_cast<size_t>(want));
          if (codec == 5) {
            LzwDecoder lzw;
            lzw.decode(src, counts[i], buf.data(), want);
          } else {
            packbits_decode(src, counts[i], buf.data(), want);
          }
        }
        if (!buf.empty()) {
          if (predictor == 2) undo_horizontal(buf.data(), g[5], row_bytes, seg_spp);
          pixels = buf.data();
        }
        place(pixels, stored_w, seg_spp, g[0], g[1], g[2], g[3], g[4], out, W, oc);
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
// each) of src, pixels of ``channels`` bytes (bpp = channels), into out: the
// first oc bytes of each pixel, rows of row_bytes / channels * oc bytes.
// prev holds the unfiltered row above the first (zeros for the image's
// first row) and is left holding the last.
int png_unfilter(const uint8_t* src, int64_t src_len, int64_t rows, int64_t row_bytes,
                 int channels, uint8_t* prev, uint8_t* out, int oc, char* err, int errlen) {
  try {
    if (src_len < rows * (row_bytes + 1)) fail("PNG image data is truncated");
    std::vector<uint8_t> cur(static_cast<size_t>(row_bytes));
    const int64_t width = row_bytes / channels;
    for (int64_t r = 0; r < rows; ++r) {
      const uint8_t* f = src + r * (row_bytes + 1);
      unfilter_row(f[0], f + 1, prev, cur.data(), row_bytes, channels);
      uint8_t* o = out + r * width * oc;
      if (oc == channels) {
        std::memcpy(o, cur.data(), static_cast<size_t>(row_bytes));
      } else {
        for (int64_t x = 0; x < width; ++x)
          for (int c = 0; c < oc; ++c) o[x * oc + c] = cur[x * channels + c];
      }
      std::memcpy(prev, cur.data(), static_cast<size_t>(row_bytes));
    }
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

}  // extern "C"
