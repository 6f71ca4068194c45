// Host codecs of the port's Parquet reader (io/parquet.py): the page
// decompressors SNAPPY, LZ4 (raw blocks and Hadoop's framing), ZSTD and
// Brotli, and the sequential parts of the DELTA encodings. Each decoder is
// written here from its format's specification; no zstd, lz4, brotli or
// snappy library is included or loaded.
//
// Plain C interface for ctypes, built at first use by ops/_host.py. Every
// decompressor takes (src, n, dst, cap) and returns the bytes it wrote, or
// a negative code (see Code below) with a message that pq_last_error copies
// out. A decoder never reads past src + n nor writes past dst + cap, for any
// input.
//
//   pq_snappy            one raw Snappy block (Parquet codec 1)
//   pq_lz4_raw           one raw LZ4 block (codec 7, LZ4_RAW)
//   pq_lz4_hadoop        codec 5 (LZ4) as Arrow reads it: Hadoop frames
//                        ([BE u32 decompressed size][BE u32 compressed
//                        size][raw block])*, which must account for the
//                        whole page and decode to exactly their sizes;
//                        otherwise the page is one raw block
//   pq_zstd              ZSTD frames (RFC 8878), concatenated, skippable
//                        frames skipped; a frame naming a dictionary is
//                        refused
//   pq_brotli            one Brotli stream (RFC 7932), WBITS 10 to 24; the
//                        large-window extension is refused
//   pq_brotli_dictionary hands the decoder RFC 7932 Appendix A's 122,784
//                        bytes (the caller keeps them alive)
//   pq_delta_binary_packed   DELTA_BINARY_PACKED values into int64
//   pq_delta_byte_array      DELTA_BYTE_ARRAY's prefixes and suffixes
//                            joined into one buffer
//   pq_crc32c            CRC-32C (Castagnoli, reflected 0x82F63B78), the
//                        checksum of OCDBT's manifests and nodes
//                        (io/ocdbt.py), continued from a previous value

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// -- errors and output ---------------------------------------------------------

enum Code : long long { kTruncated = -1, kCorrupt = -2, kTooLarge = -3, kRefused = -4 };

struct Error {
  long long code;
};

thread_local char g_message[256];

[[noreturn]] void fail(long long code, const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(g_message, sizeof g_message, fmt, ap);
  va_end(ap);
  throw Error{code};
}

template <class F>
long long guarded(F fn) {
  g_message[0] = 0;
  try {
    return fn();
  } catch (const Error& e) {
    return e.code;
  } catch (...) {
    std::snprintf(g_message, sizeof g_message, "out of memory");
    return kCorrupt;
  }
}

struct Out {
  uint8_t* dst;
  size_t cap;
  size_t pos = 0;

  void need(size_t n) const {
    if (n > cap - pos)
      fail(kTooLarge, "output larger than the %zu bytes the page header says", cap);
  }
  void put(uint8_t b) {
    need(1);
    dst[pos++] = b;
  }
  void append(const uint8_t* s, size_t n) {
    need(n);
    if (n) std::memcpy(dst + pos, s, n);
    pos += n;
  }
  void fill(uint8_t b, size_t n) {
    need(n);
    if (n) std::memset(dst + pos, b, n);
    pos += n;
  }
  // n bytes from dist bytes back; the source may not reach before floor
  void back_ref(size_t dist, size_t n, size_t floor) {
    if (dist == 0 || dist > pos - floor)
      fail(kCorrupt, "a match %zu bytes back, %zu written", dist, pos - floor);
    need(n);
    uint8_t* o = dst + pos;
    const uint8_t* s = o - dist;
    if (dist >= n) {
      std::memcpy(o, s, n);
    } else {                      // a repeated pattern: the source stays s, the span doubles
      size_t done = 0, span = dist;
      while (done < n) {
        size_t k = n - done < span ? n - done : span;
        std::memcpy(o + done, s, k);
        done += k;
        span += k;
      }
    }
    pos += n;
  }
};

inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}
inline uint32_t be32(const uint8_t* p) {
  return uint32_t(p[3]) | uint32_t(p[2]) << 8 | uint32_t(p[1]) << 16 | uint32_t(p[0]) << 24;
}
inline int high_bit(uint32_t v) { return 31 - __builtin_clz(v); }   // v > 0

// -- SNAPPY --------------------------------------------------------------------

long long snappy(const uint8_t* src, size_t n, Out& out) {
  size_t i = 0;
  uint64_t want = 0;
  for (int shift = 0;; shift += 7) {
    if (i >= n) fail(kTruncated, "the block ends inside its length");
    if (shift > 28) fail(kCorrupt, "the length varint is too long");
    uint8_t b = src[i++];
    want |= uint64_t(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
  }
  if (want > out.cap) fail(kTooLarge, "the block says %llu bytes, the page header %zu",
                           (unsigned long long)want, out.cap);
  while (i < n) {
    uint8_t tag = src[i++];
    size_t len, off;
    switch (tag & 3) {
      case 0: {                                  // literal
        len = tag >> 2;
        if (len >= 60) {
          size_t nb = len - 59;
          if (n - i < nb) fail(kTruncated, "the block ends inside a literal length");
          len = 0;
          for (size_t k = 0; k < nb; k++) len |= size_t(src[i + k]) << (8 * k);
          i += nb;
        }
        len += 1;
        if (n - i < len) fail(kTruncated, "a literal of %zu bytes runs past the block", len);
        out.append(src + i, len);
        i += len;
        continue;
      }
      case 1:
        if (n - i < 1) fail(kTruncated, "the block ends inside a copy");
        len = ((tag >> 2) & 7) + 4;
        off = size_t(tag >> 5) << 8 | src[i];
        i += 1;
        break;
      case 2:
        if (n - i < 2) fail(kTruncated, "the block ends inside a copy");
        len = (tag >> 2) + 1;
        off = size_t(src[i]) | size_t(src[i + 1]) << 8;
        i += 2;
        break;
      default:
        if (n - i < 4) fail(kTruncated, "the block ends inside a copy");
        len = (tag >> 2) + 1;
        off = le32(src + i);
        i += 4;
        break;
    }
    out.back_ref(off, len, 0);
  }
  if (out.pos != want) fail(kCorrupt, "%zu bytes decoded, the block says %llu", out.pos,
                            (unsigned long long)want);
  return (long long)out.pos;
}

// -- LZ4 -------------------------------------------------------------------------

// One raw LZ4 block: sequences of [token][literal length bytes][literals]
// [LE u16 offset][match length bytes]; the last sequence is literals only.
void lz4_block(const uint8_t* src, size_t n, Out& out) {
  size_t i = 0;
  const size_t floor = out.pos;
  for (;;) {
    if (i >= n) fail(kTruncated, "the block ends before its last sequence");
    uint8_t token = src[i++];
    size_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (i >= n) fail(kTruncated, "the block ends inside a literal length");
        b = src[i++];
        lit += b;
      } while (b == 255);
    }
    if (n - i < lit) fail(kTruncated, "a literal run of %zu bytes runs past the block", lit);
    out.append(src + i, lit);
    i += lit;
    if (i == n) return;
    if (n - i < 2) fail(kTruncated, "the block ends inside an offset");
    size_t off = size_t(src[i]) | size_t(src[i + 1]) << 8;
    i += 2;
    size_t ml = token & 15;
    if (ml == 15) {
      uint8_t b;
      do {
        if (i >= n) fail(kTruncated, "the block ends inside a match length");
        b = src[i++];
        ml += b;
      } while (b == 255);
    }
    out.back_ref(off, ml + 4, floor);
  }
}

// Arrow's Lz4HadoopCodec::TryDecompressHadoop: -1 where the page is not
// Hadoop-framed.
long long lz4_hadoop_frames(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  size_t i = 0, total = 0;
  while (n - i >= 8) {
    uint32_t dsize = be32(src + i), csize = be32(src + i + 4);
    i += 8;
    if (n - i < csize || cap - total < dsize) return -1;
    Out o{dst + total, cap - total};
    try {
      lz4_block(src + i, csize, o);
    } catch (const Error&) {
      return -1;
    }
    if (o.pos != dsize) return -1;
    i += csize;
    total += dsize;
  }
  return i == n ? (long long)total : -1;
}

// -- ZSTD (RFC 8878) -------------------------------------------------------------

constexpr size_t kZstdBlockMax = 128 * 1024;

// Forward bit reader, least significant bit first (FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  uint32_t read(int k) {
    uint32_t v = 0;
    for (int j = 0; j < k; j++, bit++) {
      if ((bit >> 3) >= n) fail(kTruncated, "a table description runs past its section");
      v |= uint32_t(p[bit >> 3] >> (bit & 7) & 1) << j;
    }
    return v;
  }
};

// Backward bit reader of FSE and Huffman bitstreams: the stream is read from
// its last byte's end mark (the highest set bit) towards its first bit; bits
// wanted below the first read as 0 and leave `bit` negative.
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t bit = 0;

  void init(const uint8_t* p_, size_t n_) {
    p = p_;
    n = n_;
    if (n == 0) fail(kCorrupt, "an empty bitstream");
    if (p[n - 1] == 0) fail(kCorrupt, "a bitstream without its end mark");
    bit = int64_t(n - 1) * 8 + high_bit(p[n - 1]);
  }
  uint64_t load(int64_t start, int k) const {     // bits [start, start + k), inside the stream
    size_t b = size_t(start >> 3);
    int sh = int(start & 7);
    uint64_t v = 0;
    if (b + 8 <= n) {
      std::memcpy(&v, p + b, 8);
    } else {
      for (size_t j = 0; b + j < n && j < 8; j++) v |= uint64_t(p[b + j]) << (8 * j);
    }
    return (v >> sh) & ((uint64_t(1) << k) - 1);
  }
  uint32_t peek(int k) const {                    // k <= 32
    if (k == 0) return 0;
    int64_t start = bit - k;
    if (start >= 0) return uint32_t(load(start, k));
    if (bit <= 0) return 0;
    return uint32_t(load(0, int(bit)) << (-start));
  }
  uint32_t read(int k) {
    uint32_t v = peek(k);
    bit -= k;
    return v;
  }
};

struct Fse {
  int log = -1;                   // accuracy log; -1: no table
  std::vector<uint8_t> sym, bits;
  std::vector<uint16_t> base;
};

void fse_build(Fse& t, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  t.log = log;
  t.sym.assign(size, 0);
  t.bits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint16_t> next(nsym, 0);
  int high = size;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == -1) {
      t.sym[--high] = uint8_t(s);
      next[s] = 1;
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int k = 0; k < norm[s]; k++) {
      t.sym[pos] = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail(kCorrupt, "an FSE distribution that does not fill its table");
  for (int i = 0; i < size; i++) {
    uint16_t x = next[t.sym[i]]++;
    t.bits[i] = uint8_t(log - high_bit(x));
    t.base[i] = uint16_t((x << t.bits[i]) - size);
  }
}

// An FSE table description (RFC 8878 4.1.1); returns its bytes.
size_t fse_read(Fse& t, const uint8_t* p, size_t n, int max_log, int max_sym) {
  FwdBits br{p, n};
  int log = int(br.read(4)) + 5;
  if (log > max_log) fail(kCorrupt, "an FSE accuracy log of %d (at most %d)", log, max_log);
  int16_t norm[256];
  int remaining = 1 << log, s = 0;
  while (remaining > 0) {
    if (s > max_sym) fail(kCorrupt, "an FSE distribution past symbol %d", max_sym);
    int nb = high_bit(uint32_t(remaining + 1)) + 1;
    uint32_t val = br.read(nb);
    uint32_t lower = (1u << (nb - 1)) - 1;
    uint32_t threshold = (1u << nb) - 1 - uint32_t(remaining + 1);
    if ((val & lower) < threshold) {
      br.bit -= 1;
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[s++] = int16_t(proba);
    if (proba == 0) {
      for (;;) {
        uint32_t rep = br.read(2);
        for (uint32_t k = 0; k < rep; k++) {
          if (s > max_sym) fail(kCorrupt, "an FSE distribution past symbol %d", max_sym);
          norm[s++] = 0;
        }
        if (rep != 3) break;
      }
    }
  }
  if (remaining != 0) fail(kCorrupt, "an FSE distribution that overflows its table");
  fse_build(t, norm, s, log);
  return (br.bit + 7) >> 3;
}

void fse_rle(Fse& t, uint8_t sym) {
  t.log = 0;
  t.sym.assign(1, sym);
  t.bits.assign(1, 0);
  t.base.assign(1, 0);
}

// Literal lengths, match lengths and offsets: predefined distributions,
// largest symbol, largest accuracy log
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,   10,  11,
                              12, 13, 14, 15, 16, 18, 20, 22, 24, 28,  32,  40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Huf {
  int max_bits = 0;               // 0: no table yet
  std::vector<uint8_t> sym, bits;
};

// The Huffman tree description of a compressed literals section
// (RFC 8878 4.2.1); returns its bytes.
size_t huf_read(Huf& h, const uint8_t* p, size_t n) {
  if (n < 1) fail(kTruncated, "the literals section ends before its Huffman tree");
  uint8_t w[256] = {0};
  int nw = 0;
  size_t used;
  uint8_t hb = p[0];
  if (hb >= 128) {                               // 4-bit weights, two a byte
    nw = hb - 127;
    used = 1 + (size_t(nw) + 1) / 2;
    if (used > n) fail(kTruncated, "the Huffman weights run past the literals section");
    for (int i = 0; i < nw; i++) w[i] = i & 1 ? p[1 + i / 2] & 15 : p[1 + i / 2] >> 4;
  } else {                                       // FSE-compressed weights
    used = 1 + size_t(hb);
    if (used > n) fail(kTruncated, "the Huffman weights run past the literals section");
    Fse t;
    size_t tb = fse_read(t, p + 1, hb, 6, 12);
    if (tb >= hb) fail(kCorrupt, "no Huffman weights after their FSE table");
    BackBits br;
    br.init(p + 1 + tb, hb - tb);
    uint32_t s1 = br.read(t.log), s2 = br.read(t.log);
    for (;;) {
      if (nw >= 255) fail(kCorrupt, "more than 255 Huffman weights");
      w[nw++] = t.sym[s1];
      s1 = t.base[s1] + br.read(t.bits[s1]);
      if (br.bit < 0) {
        w[nw++] = t.sym[s2];
        break;
      }
      if (nw >= 255) fail(kCorrupt, "more than 255 Huffman weights");
      w[nw++] = t.sym[s2];
      s2 = t.base[s2] + br.read(t.bits[s2]);
      if (br.bit < 0) {
        if (nw >= 255) fail(kCorrupt, "more than 255 Huffman weights");
        w[nw++] = t.sym[s1];
        break;
      }
    }
  }
  uint32_t sum = 0;
  for (int i = 0; i < nw; i++) {
    if (w[i] > 11) fail(kCorrupt, "a Huffman weight of %d", w[i]);
    if (w[i]) sum += 1u << (w[i] - 1);
  }
  if (sum == 0) fail(kCorrupt, "Huffman weights that are all 0");
  int max_bits = high_bit(sum) + 1;
  uint32_t left = (1u << max_bits) - sum;
  if (left & (left - 1)) fail(kCorrupt, "Huffman weights that leave no power of 2");
  if (max_bits > 11) fail(kCorrupt, "a Huffman code longer than 11 bits");
  w[nw++] = uint8_t(high_bit(left) + 1);
  int rank[13] = {0};
  uint8_t bits[256];
  for (int i = 0; i < nw; i++) {
    bits[i] = w[i] ? uint8_t(max_bits + 1 - w[i]) : 0;
    rank[bits[i]]++;
  }
  const int size = 1 << max_bits;
  h.max_bits = max_bits;
  h.sym.assign(size, 0);
  h.bits.assign(size, 0);
  int start[13];
  start[max_bits] = 0;
  for (int b = max_bits; b >= 1; b--) {
    start[b - 1] = start[b] + rank[b] * (1 << (max_bits - b));
    for (int k = start[b]; k < start[b - 1]; k++) h.bits[k] = uint8_t(b);
  }
  if (start[0] != size) fail(kCorrupt, "Huffman weights that do not fill the code");
  for (int i = 0; i < nw; i++) {
    if (!bits[i]) continue;
    int len = 1 << (max_bits - bits[i]);
    std::memset(h.sym.data() + start[bits[i]], i, size_t(len));
    start[bits[i]] += len;
  }
  return used;
}

void huf_stream(const Huf& h, const uint8_t* p, size_t n, uint8_t* out, size_t count) {
  BackBits br;
  br.init(p, n);
  for (size_t i = 0; i < count; i++) {
    uint32_t k = br.peek(h.max_bits);
    out[i] = h.sym[k];
    br.bit -= h.bits[k];
  }
  if (br.bit != 0) fail(kCorrupt, "a Huffman stream that does not end with its literals");
}

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                 P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                 P5 = 2870177450012600261ULL;
  auto round = [&](uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; };
  auto rd64 = [](const uint8_t* q) {
    uint64_t v;
    std::memcpy(&v, q, 8);
    return v;
  };
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (end - p >= 32) {
      v1 = round(v1, rd64(p));
      v2 = round(v2, rd64(p + 8));
      v3 = round(v3, rd64(p + 16));
      v4 = round(v4, rd64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ round(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += n;
  while (end - p >= 8) {
    h = rotl(h ^ round(0, rd64(p)), 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) h = rotl(h ^ (*p++ * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

struct Zstd {
  explicit Zstd(Out& o) : out(o) {}
  Out& out;
  size_t frame_start = 0;
  uint32_t rep[3] = {1, 4, 8};
  Huf huf;
  Fse ll, of, ml;                // the last tables, for the repeat mode
  std::vector<uint8_t> lit = std::vector<uint8_t>(kZstdBlockMax);

  static const Fse& predefined(int which) {
    static const Fse tables[3] = {
        [] { Fse t; fse_build(t, kLLDefault, 36, 6); return t; }(),
        [] { Fse t; fse_build(t, kOFDefault, 29, 5); return t; }(),
        [] { Fse t; fse_build(t, kMLDefault, 53, 6); return t; }()};
    return tables[which];
  }

  // Literals section; returns its bytes, sets lits / n_lits
  size_t literals(const uint8_t* p, size_t n, const uint8_t*& lits, size_t& n_lits) {
    if (n < 1) fail(kTruncated, "a block ends before its literals");
    int type = p[0] & 3, sf = (p[0] >> 2) & 3;
    if (type < 2) {                              // raw or RLE
      size_t hs, regen;
      if ((sf & 1) == 0) {
        hs = 1;
        regen = p[0] >> 3;
      } else if (sf == 1) {
        hs = 2;
        if (n < 2) fail(kTruncated, "a literals header runs past its block");
        regen = (p[0] >> 4) + (size_t(p[1]) << 4);
      } else {
        hs = 3;
        if (n < 3) fail(kTruncated, "a literals header runs past its block");
        regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      }
      if (regen > kZstdBlockMax) fail(kCorrupt, "%zu literals in one block", regen);
      n_lits = regen;
      if (type == 0) {
        if (n - hs < regen) fail(kTruncated, "raw literals run past their block");
        lits = p + hs;
        return hs + regen;
      }
      if (n - hs < 1) fail(kTruncated, "RLE literals run past their block");
      std::memset(lit.data(), p[hs], regen);
      lits = lit.data();
      return hs + 1;
    }
    size_t hs = sf < 2 ? 3 : sf == 2 ? 4 : 5;
    if (n < hs) fail(kTruncated, "a literals header runs past its block");
    uint64_t lhc = 0;
    for (size_t k = 0; k < hs; k++) lhc |= uint64_t(p[k]) << (8 * k);
    size_t regen, csize;
    if (hs == 3) {
      regen = (lhc >> 4) & 0x3FF;
      csize = (lhc >> 14) & 0x3FF;
    } else if (hs == 4) {
      regen = (lhc >> 4) & 0x3FFF;
      csize = (lhc >> 18) & 0x3FFF;
    } else {
      regen = (lhc >> 4) & 0x3FFFF;
      csize = (lhc >> 22) & 0x3FFFF;
    }
    if (regen > kZstdBlockMax) fail(kCorrupt, "%zu literals in one block", regen);
    if (n - hs < csize) fail(kTruncated, "compressed literals run past their block");
    const uint8_t* q = p + hs;
    size_t qn = csize;
    if (type == 2) {
      size_t tb = huf_read(huf, q, qn);
      q += tb;
      qn -= tb;
    } else if (!huf.max_bits) {
      fail(kCorrupt, "treeless literals before any Huffman tree");
    }
    if (sf == 0) {
      huf_stream(huf, q, qn, lit.data(), regen);
    } else {
      if (qn < 6) fail(kTruncated, "a literals jump table runs past its block");
      size_t s1 = q[0] | size_t(q[1]) << 8, s2 = q[2] | size_t(q[3]) << 8,
             s3 = q[4] | size_t(q[5]) << 8;
      if (s1 + s2 + s3 > qn - 6) fail(kCorrupt, "literal streams larger than their section");
      size_t s4 = qn - 6 - s1 - s2 - s3, seg = (regen + 3) / 4;
      if (3 * seg > regen) fail(kCorrupt, "%zu literals in four streams", regen);
      const uint8_t* r = q + 6;
      huf_stream(huf, r, s1, lit.data(), seg);
      huf_stream(huf, r + s1, s2, lit.data() + seg, seg);
      huf_stream(huf, r + s1 + s2, s3, lit.data() + 2 * seg, seg);
      huf_stream(huf, r + s1 + s2 + s3, s4, lit.data() + 3 * seg, regen - 3 * seg);
    }
    lits = lit.data();
    n_lits = regen;
    return hs + csize;
  }

  // A table of the sequences section by its mode; returns its bytes
  size_t table(int mode, Fse& t, int which, const uint8_t* p, size_t n, int max_log,
               int max_sym, const char* name) {
    switch (mode) {
      case 0:
        t = predefined(which);
        return 0;
      case 1:
        if (n < 1) fail(kTruncated, "the %s RLE symbol runs past its block", name);
        if (p[0] > max_sym) fail(kCorrupt, "an RLE %s symbol of %d", name, p[0]);
        fse_rle(t, p[0]);
        return 1;
      case 2:
        return fse_read(t, p, n, max_log, max_sym);
      default:
        if (t.log < 0) fail(kCorrupt, "a repeated %s table before any table", name);
        return 0;
    }
  }

  void block(const uint8_t* p, size_t n) {
    const uint8_t* lits;
    size_t n_lits;
    size_t i = literals(p, n, lits, n_lits);
    if (i >= n) fail(kTruncated, "a block ends before its sequences");
    size_t nseq = p[i++];
    if (nseq >= 128) {
      if (nseq < 255) {
        if (i >= n) fail(kTruncated, "a block ends inside its sequence count");
        nseq = ((nseq - 128) << 8) + p[i++];
      } else {
        if (n - i < 2) fail(kTruncated, "a block ends inside its sequence count");
        nseq = p[i] + (size_t(p[i + 1]) << 8) + 0x7F00;
        i += 2;
      }
    }
    if (nseq == 0) {
      if (i != n) fail(kCorrupt, "bytes after a block's literals without sequences");
      out.append(lits, n_lits);
      return;
    }
    if (i >= n) fail(kTruncated, "a block ends before its compression modes");
    uint8_t modes = p[i++];
    if (modes & 3) fail(kCorrupt, "reserved bits set in the compression modes");
    i += table(modes >> 6, ll, 0, p + i, n - i, 9, 35, "literal length");
    i += table((modes >> 4) & 3, of, 1, p + i, n - i, 8, 31, "offset");
    i += table((modes >> 2) & 3, ml, 2, p + i, n - i, 9, 52, "match length");
    if (i > n) fail(kTruncated, "the sequence tables run past their block");
    BackBits br;
    br.init(p + i, n - i);
    uint32_t sl = br.read(ll.log), so = br.read(of.log), sm = br.read(ml.log);
    size_t li = 0;
    for (size_t s = 0; s < nseq; s++) {
      int ofc = of.sym[so], llc = ll.sym[sl], mlc = ml.sym[sm];
      uint32_t ofv = (1u << ofc) + br.read(ofc);
      size_t mlen = kMLBase[mlc] + br.read(kMLBits[mlc]);
      size_t llen = kLLBase[llc] + br.read(kLLBits[llc]);
      uint32_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        int idx = int(ofv) - 1 + (llen == 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx == 3 ? rep[0] - 1 : rep[idx];
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        }
      }
      if (s + 1 < nseq) {
        sl = ll.base[sl] + br.read(ll.bits[sl]);
        sm = ml.base[sm] + br.read(ml.bits[sm]);
        so = of.base[so] + br.read(of.bits[so]);
      }
      if (br.bit < 0) fail(kCorrupt, "a sequence bitstream that runs out");
      if (n_lits - li < llen) fail(kCorrupt, "sequences that use more literals than the block has");
      out.append(lits + li, llen);
      li += llen;
      out.back_ref(offset, mlen, frame_start);
    }
    if (br.bit != 0) fail(kCorrupt, "a sequence bitstream that does not end with its sequences");
    out.append(lits + li, n_lits - li);
  }

  // One frame from p (after its magic); returns the bytes read
  size_t frame(const uint8_t* p, size_t n) {
    if (n < 1) fail(kTruncated, "a frame ends inside its header");
    uint8_t fhd = p[0];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
    if (fhd & 8) fail(kCorrupt, "the reserved bit of a frame header is set");
    size_t did_size = did_flag == 3 ? 4 : did_flag;
    size_t fcs_size = fcs_flag == 0 ? size_t(single) : size_t(1) << fcs_flag;
    size_t hs = 1 + (single ? 0 : 1) + did_size + fcs_size;
    if (n < hs) fail(kTruncated, "a frame ends inside its header");
    size_t i = 1 + (single ? 0 : 1);
    uint32_t did = 0;
    for (size_t k = 0; k < did_size; k++) did |= uint32_t(p[i + k]) << (8 * k);
    if (did)
      fail(kRefused, "a frame names dictionary ID %u; frames with a dictionary are not read", did);
    i += did_size;
    uint64_t fcs = 0;
    for (size_t k = 0; k < fcs_size; k++) fcs |= uint64_t(p[i + k]) << (8 * k);
    if (fcs_size == 2) fcs += 256;
    i += fcs_size;
    frame_start = out.pos;
    rep[0] = 1;
    rep[1] = 4;
    rep[2] = 8;
    huf.max_bits = 0;
    ll.log = of.log = ml.log = -1;
    for (;;) {
      if (n - i < 3) fail(kTruncated, "a frame ends inside a block header");
      uint32_t bh = p[i] | uint32_t(p[i + 1]) << 8 | uint32_t(p[i + 2]) << 16;
      i += 3;
      size_t bsize = bh >> 3;
      int type = (bh >> 1) & 3;
      if (bsize > kZstdBlockMax) fail(kCorrupt, "a block of %zu bytes", bsize);
      if (type == 0) {
        if (n - i < bsize) fail(kTruncated, "a raw block runs past the input");
        out.append(p + i, bsize);
        i += bsize;
      } else if (type == 1) {
        if (n - i < 1) fail(kTruncated, "an RLE block runs past the input");
        out.fill(p[i], bsize);
        i += 1;
      } else if (type == 2) {
        if (n - i < bsize) fail(kTruncated, "a compressed block runs past the input");
        block(p + i, bsize);
        i += bsize;
      } else {
        fail(kCorrupt, "a block of the reserved type 3");
      }
      if (bh & 1) break;
    }
    if (fcs_size && out.pos - frame_start != fcs)
      fail(kCorrupt, "a frame of %zu bytes says it holds %llu", out.pos - frame_start,
           (unsigned long long)fcs);
    if (checksum) {
      if (n - i < 4) fail(kTruncated, "a frame ends inside its checksum");
      uint32_t want = le32(p + i);
      uint32_t got = uint32_t(xxh64(out.dst + frame_start, out.pos - frame_start));
      if (got != want) fail(kCorrupt, "content checksum %08x, the frame says %08x", got, want);
      i += 4;
    }
    return i;
  }
};

long long zstd(const uint8_t* src, size_t n, Out& out) {
  if (n == 0) fail(kTruncated, "no frame");
  Zstd z(out);
  size_t i = 0;
  while (i < n) {
    if (n - i < 4) fail(kTruncated, "the input ends inside a frame magic");
    uint32_t magic = le32(src + i);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
      if (n - i < 8) fail(kTruncated, "a skippable frame ends inside its header");
      uint32_t size = le32(src + i + 4);
      if (n - i - 8 < size) fail(kTruncated, "a skippable frame runs past the input");
      i += 8 + size;
    } else if (magic == 0xFD2FB528u) {
      i += 4;
      i += z.frame(src + i, n - i);
    } else {
      fail(kCorrupt, "unknown frame magic %08x", magic);
    }
  }
  return (long long)out.pos;
}

// -- Brotli (RFC 7932) -----------------------------------------------------------

const uint8_t* g_dictionary = nullptr;
constexpr size_t kDictionarySize = 122784;
// RFC 7932 section 8: NDBITS and DOFFSET by word length
const uint8_t kSizeBitsByLength[25] = {0, 0, 0, 0, 10, 10, 11, 11, 10, 10, 10, 10, 10,
                                       9, 9, 8, 7, 7, 8, 7, 7, 6, 6, 5, 5};
const uint32_t kOffsetsByLength[25] = {0,     0,      0,      0,      0,      4096,  9216,
                                       21504, 35840,  44032,  53248,  63488,  74752, 87040,
                                       93696, 100864, 104704, 106752, 108928, 113536, 115968,
                                       118528, 119872, 121280, 122016};

enum Transform : uint8_t {
  kIdentity = 0, kOmitLast1, kOmitLast2, kOmitLast3, kOmitLast4, kOmitLast5, kOmitLast6,
  kOmitLast7, kOmitLast8, kOmitLast9, kUpperFirst, kUpperAll, kOmitFirst1, kOmitFirst2,
  kOmitFirst3, kOmitFirst4, kOmitFirst5, kOmitFirst6, kOmitFirst7, kOmitFirst8, kOmitFirst9
};

struct WordTransform {
  const char* prefix;
  Transform type;
  const char* suffix;
};

// RFC 7932 Appendix B, in transform ID order
const WordTransform kTransforms[121] = {
    {"", kIdentity, ""}, {"", kIdentity, " "}, {" ", kIdentity, " "},
    {"", kOmitFirst1, ""}, {"", kUpperFirst, " "}, {"", kIdentity, " the "},
    {" ", kIdentity, ""}, {"s ", kIdentity, " "}, {"", kIdentity, " of "},
    {"", kUpperFirst, ""}, {"", kIdentity, " and "}, {"", kOmitFirst2, ""},
    {"", kOmitLast1, ""}, {", ", kIdentity, " "}, {"", kIdentity, ", "},
    {" ", kUpperFirst, " "}, {"", kIdentity, " in "}, {"", kIdentity, " to "},
    {"e ", kIdentity, " "}, {"", kIdentity, "\""}, {"", kIdentity, "."},
    {"", kIdentity, "\">"}, {"", kIdentity, "\n"}, {"", kOmitLast3, ""},
    {"", kIdentity, "]"}, {"", kIdentity, " for "}, {"", kOmitFirst3, ""},
    {"", kOmitLast2, ""}, {"", kIdentity, " a "}, {"", kIdentity, " that "},
    {" ", kUpperFirst, ""}, {"", kIdentity, ". "}, {".", kIdentity, ""},
    {" ", kIdentity, ", "}, {"", kOmitFirst4, ""}, {"", kIdentity, " with "},
    {"", kIdentity, "'"}, {"", kIdentity, " from "}, {"", kIdentity, " by "},
    {"", kOmitFirst5, ""}, {"", kOmitFirst6, ""}, {" the ", kIdentity, ""},
    {"", kOmitLast4, ""}, {"", kIdentity, ". The "}, {"", kUpperAll, ""},
    {"", kIdentity, " on "}, {"", kIdentity, " as "}, {"", kIdentity, " is "},
    {"", kOmitLast7, ""}, {"", kOmitLast1, "ing "}, {"", kIdentity, "\n\t"},
    {"", kIdentity, ":"}, {" ", kIdentity, ". "}, {"", kIdentity, "ed "},
    {"", kOmitFirst9, ""}, {"", kOmitFirst7, ""}, {"", kOmitLast6, ""},
    {"", kIdentity, "("}, {"", kUpperFirst, ", "}, {"", kOmitLast8, ""},
    {"", kIdentity, " at "}, {"", kIdentity, "ly "}, {" the ", kIdentity, " of "},
    {"", kOmitLast5, ""}, {"", kOmitLast9, ""}, {" ", kUpperFirst, ", "},
    {"", kUpperFirst, "\""}, {".", kIdentity, "("}, {"", kUpperAll, " "},
    {"", kUpperFirst, "\">"}, {"", kIdentity, "=\""}, {" ", kIdentity, "."},
    {".com/", kIdentity, ""}, {" the ", kIdentity, " of the "}, {"", kUpperFirst, "'"},
    {"", kIdentity, ". This "}, {"", kIdentity, ","}, {".", kIdentity, " "},
    {"", kUpperFirst, "("}, {"", kUpperFirst, "."}, {"", kIdentity, " not "},
    {" ", kIdentity, "=\""}, {"", kIdentity, "er "}, {" ", kUpperAll, " "},
    {"", kIdentity, "al "}, {" ", kUpperAll, ""}, {"", kIdentity, "='"},
    {"", kUpperAll, "\""}, {"", kUpperFirst, ". "}, {" ", kIdentity, "("},
    {"", kIdentity, "ful "}, {" ", kUpperFirst, ". "}, {"", kIdentity, "ive "},
    {"", kIdentity, "less "}, {"", kUpperAll, "'"}, {"", kIdentity, "est "},
    {" ", kUpperFirst, "."}, {"", kUpperAll, "\">"}, {" ", kIdentity, "='"},
    {"", kUpperFirst, ","}, {"", kIdentity, "ize "}, {"", kUpperAll, "."},
    {"\xc2\xa0", kIdentity, ""}, {" ", kIdentity, ","}, {"", kUpperFirst, "=\""},
    {"", kUpperAll, "=\""}, {"", kIdentity, "ous "}, {"", kUpperAll, ", "},
    {"", kUpperFirst, "='"}, {" ", kUpperFirst, ","}, {" ", kUpperAll, "=\""},
    {" ", kUpperAll, ", "}, {"", kUpperAll, ","}, {"", kUpperAll, "("},
    {"", kUpperAll, ". "}, {" ", kUpperAll, "."}, {"", kUpperAll, "='"},
    {" ", kUpperAll, ". "}, {" ", kUpperFirst, "=\""}, {" ", kUpperAll, "='"},
    {" ", kUpperFirst, "='"}
};

// RFC 7932 section 7.1: the literal context lookup tables
const uint8_t kLut0[256] = {
     0,  0,  0,  0,  0,  0,  0,  0,  0,  4,  4,  0,  0,  4,  0,  0,
     0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
     8, 12, 16, 12, 12, 20, 12, 16, 24, 28, 12, 12, 32, 12, 36, 12,
    44, 44, 44, 44, 44, 44, 44, 44, 44, 44, 32, 32, 24, 40, 28, 12,
    12, 48, 52, 52, 52, 48, 52, 52, 52, 48, 52, 52, 52, 52, 52, 48,
    52, 52, 52, 52, 52, 48, 52, 52, 52, 52, 52, 24, 12, 28, 12, 12,
    12, 56, 60, 60, 60, 56, 60, 60, 60, 56, 60, 60, 60, 60, 60, 56,
    60, 60, 60, 60, 60, 56, 60, 60, 60, 60, 60, 24, 12, 28, 12,  0,
     0,  1,  0,  1,  0,  1,  0,  1,  0,  1,  0,  1,  0,  1,  0,  1,
     0,  1,  0,  1,  0,  1,  0,  1,  0,  1,  0,  1,  0,  1,  0,  1,
     0,  1,  0,  1,  0,  1,  0,  1,  0,  1,  0,  1,  0,  1,  0,  1,
     0,  1,  0,  1,  0,  1,  0,  1,  0,  1,  0,  1,  0,  1,  0,  1,
     2,  3,  2,  3,  2,  3,  2,  3,  2,  3,  2,  3,  2,  3,  2,  3,
     2,  3,  2,  3,  2,  3,  2,  3,  2,  3,  2,  3,  2,  3,  2,  3,
     2,  3,  2,  3,  2,  3,  2,  3,  2,  3,  2,  3,  2,  3,  2,  3,
     2,  3,  2,  3,  2,  3,  2,  3,  2,  3,  2,  3,  2,  3,  2,  3};
const uint8_t kLut1[256] = {
     0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
     0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
     0,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,
     2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  1,  1,  1,  1,  1,  1,
     1,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,
     2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  1,  1,  1,  1,  1,
     1,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,
     3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  1,  1,  1,  1,  0,
     0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
     0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
     0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
     0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
     0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
     0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
     2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,
     2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2};

inline uint8_t lut2(uint8_t b) {
  return b == 0 ? 0 : b < 16 ? 1 : b < 64 ? 2 : b < 128 ? 3 : b < 192 ? 4 : b < 240 ? 5
       : b < 255 ? 6 : 7;
}

const uint32_t kInsBase[24] = {0,  1,  2,  3,  4,   5,   6,   8,   10,   14,   18,   26,
                               34, 50, 66, 98, 130, 194, 322, 578, 1090, 2114, 6210, 22594};
const uint8_t kInsExtra[24] = {0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3,
                               4, 4, 5, 5, 6, 7, 8, 9, 10, 12, 14, 24};
const uint32_t kCopyBase[24] = {2,  3,  4,  5,  6,   7,   8,   9,   10,  12,   14,   18,
                                22, 30, 38, 54, 70, 102, 134, 198, 326, 582, 1094, 2118};
const uint8_t kCopyExtra[24] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2,
                                3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 24};
const uint8_t kInsertRange[9] = {0, 0, 8, 8, 0, 16, 8, 16, 16};
const uint8_t kCopyRange[9] = {0, 8, 0, 8, 16, 0, 16, 8, 16};
const uint32_t kBlockBase[26] = {1,   5,   9,   13,  17,  25,   33,   41,   49,
                                 65,  81,  97,  113, 145, 177,  209,  241,  305,
                                 369, 497, 753, 1265, 2289, 4337, 8433, 16625};
const uint8_t kBlockExtra[26] = {2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5,
                                 5, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 24};

// Forward bit reader, least significant bit first, over a 64-bit window;
// bits past the input read as 0 and are caught by `check`.
struct BrBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;                // next byte to load
  uint64_t buf = 0;
  int cnt = 0;

  void fill() {
    while (cnt <= 56) {
      uint64_t b = pos < n ? p[pos] : 0;
      buf |= b << cnt;
      cnt += 8;
      pos++;
    }
  }
  size_t consumed() const { return pos * 8 - size_t(cnt); }
  uint32_t peek(int k) {
    if (cnt < k) fill();
    return uint32_t(buf & ((uint64_t(1) << k) - 1));
  }
  void skip(int k) {
    buf >>= k;
    cnt -= k;
    if (consumed() > n * 8) fail(kTruncated, "the stream ends early");
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  void align() {                 // to a byte boundary over zero bits
    int pad = int((8 - consumed() % 8) % 8);
    if (read(pad)) fail(kCorrupt, "nonzero padding bits");
  }
  size_t byte_pos() const { return consumed() / 8; }   // after align()
  void seek(size_t byte) {
    pos = byte;
    buf = 0;
    cnt = 0;
  }
};

// A prefix code: codes of up to 8 bits through one table lookup, longer
// ones walked canonically
struct Prefix {
  bool single = false;
  uint16_t single_sym = 0;
  uint16_t fast[256];            // sym << 4 | length (1..8); 0: a longer code
  uint16_t count[16];
  std::vector<uint16_t> syms;    // symbols in canonical order

  void build(const uint8_t* lens, int n) {
    std::memset(count, 0, sizeof count);
    std::memset(fast, 0, sizeof fast);
    for (int s = 0; s < n; s++) count[lens[s]]++;
    count[0] = 0;
    uint16_t offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; l++) offs[l + 1] = uint16_t(offs[l] + count[l]);
    syms.assign(size_t(offs[15] + count[15]), 0);
    uint32_t next[16];
    uint32_t code = 0;
    for (int l = 1; l < 16; l++) {
      code = (code + (l > 1 ? count[l - 1] : 0)) << (l > 1 ? 1 : 0);
      next[l] = code;
    }
    for (int s = 0; s < n; s++) {
      int l = lens[s];
      if (!l) continue;
      syms[offs[l]++] = uint16_t(s);
      uint32_t c = next[l]++;
      if (l <= 8) {
        uint32_t rev = 0;
        for (int b = 0; b < l; b++) rev |= ((c >> b) & 1) << (l - 1 - b);
        for (uint32_t k = rev; k < 256; k += 1u << l) fast[k] = uint16_t(s << 4 | l);
      }
    }
  }
  void build_single(uint16_t s) {
    single = true;
    single_sym = s;
  }
  uint32_t decode(BrBits& br) const {
    if (single) return single_sym;
    uint32_t v = br.peek(15);
    uint16_t e = fast[v & 255];
    if (e & 15) {
      br.skip(e & 15);
      return e >> 4;
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; l++) {
      code |= (v >> (l - 1)) & 1;
      int c = count[l];
      if (code - first < c) {
        br.skip(l);
        return syms[size_t(index + code - first)];
      }
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    fail(kCorrupt, "an incomplete prefix code");
  }
};

int alphabet_bits(int size) {
  int b = 0;
  while ((1 << b) < size) b++;
  return b;
}

// RFC 7932 section 3.4 (simple) and 3.5 (complex)
void read_prefix(BrBits& br, int asize, Prefix& h) {
  uint32_t hskip = br.read(2);
  std::vector<uint8_t> lens(size_t(asize), 0);
  if (hskip == 1) {
    int nsym = int(br.read(2)) + 1, bits = alphabet_bits(asize);
    uint16_t s[4];
    for (int k = 0; k < nsym; k++) {
      s[k] = uint16_t(br.read(bits));
      if (s[k] >= asize) fail(kCorrupt, "a simple prefix code symbol %d of %d", s[k], asize);
      for (int j = 0; j < k; j++)
        if (s[j] == s[k]) fail(kCorrupt, "a simple prefix code that repeats a symbol");
    }
    if (nsym == 1) {
      h.build_single(s[0]);
      return;
    }
    static const uint8_t kLens[5][4] = {{0}, {0}, {1, 1}, {1, 2, 2}, {2, 2, 2, 2}};
    const uint8_t* l = kLens[nsym];
    static const uint8_t kTree1[4] = {1, 2, 3, 3};
    if (nsym == 4 && br.read(1)) l = kTree1;
    for (int k = 0; k < nsym; k++) lens[s[k]] = l[k];
    h.build(lens.data(), asize);
    return;
  }
  static const uint8_t kOrder[18] = {1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15};
  static const uint8_t kClLen[16] = {2, 2, 2, 3, 2, 2, 2, 4, 2, 2, 2, 3, 2, 2, 2, 4};
  static const uint8_t kClVal[16] = {0, 4, 3, 2, 0, 4, 3, 1, 0, 4, 3, 2, 0, 4, 3, 5};
  uint8_t cl[18] = {0};
  int space = 32, num = 0, last = 0;
  for (uint32_t k = hskip; k < 18; k++) {
    uint32_t v = br.peek(4);
    br.skip(kClLen[v]);
    uint8_t len = kClVal[v];
    cl[kOrder[k]] = len;
    if (len) {
      space -= 32 >> len;
      num++;
      last = kOrder[k];
      if (space <= 0) break;
    }
  }
  if (!(num == 1 || space == 0)) fail(kCorrupt, "an invalid code length code");
  Prefix clc;
  if (num == 1)
    clc.build_single(uint16_t(last));
  else
    clc.build(cl, 18);
  int sym = 0, prev = 8, repeat = 0, repeat_len = 0;
  space = 32768;
  while (sym < asize && space > 0) {
    uint32_t p = clc.decode(br);
    if (p < 16) {
      lens[size_t(sym++)] = uint8_t(p);
      repeat = 0;
      if (p) {
        prev = int(p);
        space -= 32768 >> p;
      }
    } else {
      int extra = p == 16 ? 2 : 3, len = p == 16 ? prev : 0;
      if (repeat_len != len) {
        repeat = 0;
        repeat_len = len;
      }
      int old = repeat;
      if (repeat > 0) repeat = (repeat - 2) << extra;
      repeat += int(br.read(extra)) + 3;
      int delta = repeat - old;
      if (sym + delta > asize) fail(kCorrupt, "code lengths past the alphabet");
      for (int k = 0; k < delta; k++) lens[size_t(sym++)] = uint8_t(repeat_len);
      if (repeat_len) space -= delta << (15 - repeat_len);
    }
  }
  if (space != 0) fail(kCorrupt, "code lengths that do not make a complete prefix code");
  h.build(lens.data(), asize);
}

uint32_t var_len_uint8(BrBits& br) {
  if (!br.read(1)) return 0;
  uint32_t n = br.read(3);
  if (n == 0) return 1;
  return (1u << n) + br.read(int(n));
}

struct BlockCategory {
  uint32_t ntypes = 1, type = 0, prev = 1, count = 1u << 24;
  Prefix type_code, count_code;

  uint32_t block_count(BrBits& br) {
    uint32_t c = count_code.decode(br);
    return kBlockBase[c] + br.read(kBlockExtra[c]);
  }
  void init(BrBits& br) {
    ntypes = var_len_uint8(br) + 1;
    type = 0;
    prev = 1;
    count = 1u << 24;
    if (ntypes >= 2) {
      read_prefix(br, int(ntypes) + 2, type_code);
      read_prefix(br, 26, count_code);
      count = block_count(br);
    }
  }
  void next(BrBits& br) {        // one more item of this category
    if (count == 0) {
      if (ntypes < 2) {
        count = 1u << 24;
      } else {
        uint32_t code = type_code.decode(br);
        uint32_t t = code == 0 ? prev : code == 1 ? (type + 1) % ntypes : code - 2;
        prev = type;
        type = t;
        count = block_count(br);
      }
    }
    count--;
  }
};

void read_context_map(BrBits& br, size_t size, uint32_t ntrees, std::vector<uint8_t>& map) {
  map.assign(size, 0);
  if (ntrees < 2) return;
  uint32_t rlemax = br.read(1) ? br.read(4) + 1 : 0;
  Prefix h;
  read_prefix(br, int(ntrees + rlemax), h);
  for (size_t i = 0; i < size;) {
    uint32_t s = h.decode(br);
    if (s == 0) {
      map[i++] = 0;
    } else if (s <= rlemax) {
      size_t reps = (size_t(1) << s) + br.read(int(s));
      if (reps > size - i) fail(kCorrupt, "a context map run past its end");
      i += reps;                 // already 0
    } else {
      map[i++] = uint8_t(s - rlemax);
    }
  }
  if (br.read(1)) {              // inverse move-to-front
    uint8_t mtf[256];
    for (int k = 0; k < 256; k++) mtf[k] = uint8_t(k);
    for (size_t i = 0; i < size; i++) {
      uint8_t idx = map[i], v = mtf[idx];
      map[i] = v;
      std::memmove(mtf + 1, mtf, idx);
      mtf[0] = v;
    }
  }
}

// The dictionary word of `len` bytes at `index`, transformed; returns its
// length (at most 37)
size_t dictionary_word(size_t len, uint32_t index, uint32_t tid, uint8_t* dst) {
  const uint8_t* word = g_dictionary + kOffsetsByLength[len] + size_t(index) * len;
  const WordTransform& t = kTransforms[tid];
  size_t o = 0;
  for (const char* c = t.prefix; *c; c++) dst[o++] = uint8_t(*c);
  int wlen = int(len), skip = 0;
  if (t.type >= kOmitLast1 && t.type <= kOmitLast9) wlen -= t.type - kIdentity;
  if (t.type >= kOmitFirst1) {
    skip = t.type - kOmitFirst1 + 1;
    wlen -= skip;
  }
  if (wlen < 0) wlen = 0;
  uint8_t w[32];
  std::memcpy(w, word + skip, size_t(wlen));
  std::memset(w + wlen, 0, 4);
  auto upper = [&](int k) {      // RFC 7932 section 8's uppercase of the character at k
    if (w[k] < 0xC0) {
      if (w[k] >= 'a' && w[k] <= 'z') w[k] ^= 32;
      return 1;
    }
    if (w[k] < 0xE0) {
      w[k + 1] ^= 32;
      return 2;
    }
    w[k + 2] ^= 5;
    return 3;
  };
  if (t.type == kUpperFirst && wlen > 0) {
    upper(0);
  } else if (t.type == kUpperAll) {
    for (int k = 0; k < wlen;) k += upper(k);
  }
  std::memcpy(dst + o, w, size_t(wlen));
  o += size_t(wlen);
  for (const char* c = t.suffix; *c; c++) dst[o++] = uint8_t(*c);
  return o;
}

struct Brotli {
  BrBits br;
  Out& out;
  size_t window = 0;
  int rb[4] = {16, 15, 11, 4};   // the last distances; rb[(idx - 1) & 3] is the last
  unsigned rb_idx = 0;

  void compressed(size_t mlen) {
    BlockCategory cat[3];        // literals, insert-and-copy, distances
    for (auto& c : cat) c.init(br);
    uint32_t npostfix = br.read(2), ndirect = br.read(4) << npostfix;
    std::vector<uint8_t> modes(cat[0].ntypes);
    for (auto& m : modes) m = uint8_t(br.read(2));
    std::vector<uint8_t> cmap_l, cmap_d;
    uint32_t ntrees_l = var_len_uint8(br) + 1;
    read_context_map(br, 64 * size_t(cat[0].ntypes), ntrees_l, cmap_l);
    uint32_t ntrees_d = var_len_uint8(br) + 1;
    read_context_map(br, 4 * size_t(cat[2].ntypes), ntrees_d, cmap_d);
    std::vector<Prefix> lit(ntrees_l), cmd(cat[1].ntypes), dist(ntrees_d);
    for (auto& h : lit) read_prefix(br, 256, h);
    for (auto& h : cmd) read_prefix(br, 704, h);
    const int dist_size = int(16 + ndirect + (48u << npostfix));
    for (auto& h : dist) read_prefix(br, dist_size, h);
    const uint32_t postfix_mask = (1u << npostfix) - 1;

    size_t remaining = mlen;
    while (remaining > 0) {
      cat[1].next(br);
      uint32_t code = cmd[cat[1].type].decode(br);
      uint32_t cell = code >> 6;
      bool implicit = cell < 2;
      uint32_t r = implicit ? cell : cell - 2;
      uint32_t ic = kInsertRange[r] + ((code >> 3) & 7), cc = kCopyRange[r] + (code & 7);
      size_t ilen = kInsBase[ic] + br.read(kInsExtra[ic]);
      size_t clen = kCopyBase[cc] + br.read(kCopyExtra[cc]);
      if (ilen > remaining) fail(kCorrupt, "an insert past the end of its meta-block");
      for (size_t k = 0; k < ilen; k++) {
        cat[0].next(br);
        uint8_t p1 = out.pos > 0 ? out.dst[out.pos - 1] : 0;
        uint8_t p2 = out.pos > 1 ? out.dst[out.pos - 2] : 0;
        uint32_t ctx;
        switch (modes[cat[0].type]) {
          case 0: ctx = p1 & 0x3F; break;
          case 1: ctx = p1 >> 2; break;
          case 2: ctx = kLut0[p1] | kLut1[p2]; break;
          default: ctx = uint32_t(lut2(p1)) << 3 | lut2(p2); break;
        }
        out.put(uint8_t(lit[cmap_l[cat[0].type * 64 + ctx]].decode(br)));
      }
      remaining -= ilen;
      if (remaining == 0) break;
      int64_t distance;
      uint32_t dcode = 0;
      if (!implicit) {
        cat[2].next(br);
        uint32_t cid = clen > 4 ? 3 : uint32_t(clen - 2);
        dcode = dist[cmap_d[cat[2].type * 4 + cid]].decode(br);
      }
      if (dcode == 0) {
        rb_idx--;
        distance = rb[rb_idx & 3];
      } else if (dcode < 16) {
        static const int kIndex[16] = {0, 1, 2, 3, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1};
        static const int kDelta[16] = {0, 0, 0, 0, -1, 1, -2, 2, -3, 3, -1, 1, -2, 2, -3, 3};
        distance = int64_t(rb[(rb_idx - 1 - kIndex[dcode]) & 3]) + kDelta[dcode];
        if (distance <= 0) fail(kCorrupt, "a distance of %lld", (long long)distance);
      } else if (dcode < 16 + ndirect) {
        distance = dcode - 15;
      } else {
        uint32_t d = dcode - ndirect - 16;
        uint32_t nbits = 1 + (d >> (npostfix + 1));
        uint32_t hcode = d >> npostfix, lcode = d & postfix_mask;
        int64_t offset = (int64_t(2 + (hcode & 1)) << nbits) - 4;
        distance = ((offset + br.read(int(nbits))) << npostfix) + lcode + ndirect + 1;
      }
      size_t max_distance = out.pos < window ? out.pos : window;
      if (size_t(distance) > max_distance) {
        if (clen < 4 || clen > 24) fail(kCorrupt, "a distance of %lld past the window",
                                        (long long)distance);
        if (!g_dictionary)
          fail(kRefused, "a dictionary reference, and no static dictionary is loaded");
        uint64_t word_id = uint64_t(distance) - max_distance - 1;
        int nb = kSizeBitsByLength[clen];
        uint64_t index = word_id & ((uint64_t(1) << nb) - 1), tid = word_id >> nb;
        if (tid >= 121) fail(kCorrupt, "dictionary transform %llu", (unsigned long long)tid);
        uint8_t word[48];
        size_t wl = dictionary_word(clen, uint32_t(index), uint32_t(tid), word);
        if (wl > remaining) fail(kCorrupt, "a dictionary word past the end of its meta-block");
        out.append(word, wl);
        remaining -= wl;
      } else {
        if (clen > remaining) fail(kCorrupt, "a copy past the end of its meta-block");
        out.back_ref(size_t(distance), clen, 0);
        remaining -= clen;
        rb[rb_idx & 3] = int(distance);
        rb_idx++;
      }
    }
  }

  long long run() {
    // the window (section 9.1)
    int wbits = 16;
    if (br.read(1)) {
      uint32_t n = br.read(3);
      if (n) {
        wbits = 17 + int(n);
      } else {
        n = br.read(3);
        if (n == 1) fail(kRefused, "the large-window extension");
        wbits = n ? 8 + int(n) : 17;
      }
    }
    window = (size_t(1) << wbits) - 16;
    for (;;) {
      bool last = br.read(1);
      if (last && br.read(1)) break;             // ISLASTEMPTY
      uint32_t nib = br.read(2);
      if (nib == 3) {                            // metadata
        if (br.read(1)) fail(kCorrupt, "the reserved bit of a metadata block is set");
        uint32_t nbytes = br.read(2);
        size_t skip = 0;
        for (uint32_t k = 0; k < nbytes; k++) {
          uint32_t b = br.read(8);
          if (k + 1 == nbytes && nbytes > 1 && b == 0) fail(kCorrupt, "a padded metadata length");
          skip |= size_t(b) << (8 * k);
        }
        if (nbytes) skip += 1;
        br.align();
        size_t at = br.byte_pos();
        if (br.n - at < skip) fail(kTruncated, "metadata runs past the stream");
        br.seek(at + skip);
        if (last) break;
        continue;
      }
      nib += 4;
      size_t mlen = 0;
      for (uint32_t k = 0; k < nib; k++) {
        uint32_t v = br.read(4);
        if (k + 1 == nib && nib > 4 && v == 0) fail(kCorrupt, "a padded meta-block length");
        mlen |= size_t(v) << (4 * k);
      }
      mlen += 1;
      if (!last && br.read(1)) {                 // ISUNCOMPRESSED
        br.align();
        size_t at = br.byte_pos();
        if (br.n - at < mlen) fail(kTruncated, "an uncompressed meta-block runs past the stream");
        out.append(br.p + at, mlen);
        br.seek(at + mlen);
        continue;
      }
      compressed(mlen);
      if (last) break;
    }
    br.align();
    if (br.byte_pos() != br.n) fail(kCorrupt, "%zu bytes after the last meta-block",
                                    br.n - br.byte_pos());
    return (long long)out.pos;
  }
};

}  // namespace

extern "C" {

int pq_last_error(char* buf, int n) {
  if (n <= 0) return 0;
  std::snprintf(buf, size_t(n), "%s", g_message);
  return int(std::strlen(buf));
}

long long pq_snappy(const uint8_t* src, long long n, uint8_t* dst, long long cap) {
  return guarded([&] {
    Out out{dst, size_t(cap)};
    return snappy(src, size_t(n), out);
  });
}

long long pq_lz4_raw(const uint8_t* src, long long n, uint8_t* dst, long long cap) {
  return guarded([&] {
    Out out{dst, size_t(cap)};
    lz4_block(src, size_t(n), out);
    return (long long)out.pos;
  });
}

long long pq_lz4_hadoop(const uint8_t* src, long long n, uint8_t* dst, long long cap) {
  return guarded([&] {
    long long got = lz4_hadoop_frames(src, size_t(n), dst, size_t(cap));
    if (got >= 0) return got;
    Out out{dst, size_t(cap)};
    lz4_block(src, size_t(n), out);
    return (long long)out.pos;
  });
}

long long pq_zstd(const uint8_t* src, long long n, uint8_t* dst, long long cap) {
  return guarded([&] {
    Out out{dst, size_t(cap)};
    return zstd(src, size_t(n), out);
  });
}

int pq_brotli_dictionary(const uint8_t* data, long long n) {
  if (size_t(n) != kDictionarySize) return -1;
  g_dictionary = data;
  return 0;
}

long long pq_brotli(const uint8_t* src, long long n, uint8_t* dst, long long cap) {
  return guarded([&] {
    Out out{dst, size_t(cap)};
    Brotli b{BrBits{src, size_t(n)}, out};
    return b.run();
  });
}

// DELTA_BINARY_PACKED: `count` values into out (int64; width 32 wraps as
// INT32 does); *consumed gets the bytes read. Returns count or a code.
long long pq_delta_binary_packed(const uint8_t* src, long long n, long long count, int width,
                                 long long* out, long long* consumed) {
  return guarded([&] {
    size_t i = 0, len = size_t(n);
    auto uvarint = [&]() {
      uint64_t v = 0;
      for (int shift = 0;; shift += 7) {
        if (i >= len) fail(kTruncated, "the page ends inside a varint");
        if (shift > 63) fail(kCorrupt, "a varint longer than 10 bytes");
        uint8_t b = src[i++];
        v |= uint64_t(b & 0x7F) << shift;
        if (!(b & 0x80)) return v;
      }
    };
    auto zigzag = [&]() {
      uint64_t v = uvarint();
      return (v >> 1) ^ (0 - (v & 1));
    };
    uint64_t block = uvarint(), nmb = uvarint(), total = uvarint();
    uint64_t value = zigzag();
    if (block == 0 || block % 128 || block > (1u << 20) || nmb == 0 || block % nmb ||
        (block / nmb) % 32)
      fail(kCorrupt, "a block of %llu values in %llu miniblocks", (unsigned long long)block,
           (unsigned long long)nmb);
    if (total != uint64_t(count))
      fail(kCorrupt, "the header says %llu values, the page %lld", (unsigned long long)total,
           count);
    const size_t per = size_t(block / nmb);
    auto store = [&](long long k) {
      out[k] = width == 32 ? (long long)int32_t(uint32_t(value)) : (long long)value;
    };
    long long k = 0;
    if (count > 0) store(k++);
    while (k < count) {
      uint64_t min_delta = zigzag();
      if (len - i < nmb) fail(kTruncated, "the page ends inside miniblock widths");
      const uint8_t* widths = src + i;
      i += nmb;
      for (uint64_t m = 0; m < nmb && k < count; m++) {
        int w = widths[m];
        if (w > width) fail(kCorrupt, "a miniblock of %d-bit deltas", w);
        size_t nbytes = per * size_t(w) / 8;
        if (len - i < nbytes) fail(kTruncated, "the page ends inside a miniblock");
        const uint8_t* mb = src + i;
        for (size_t j = 0; j < per && k < count; j++) {
          uint64_t d = 0;
          if (w) {
            size_t bit = j * size_t(w), b = bit >> 3;
            int sh = int(bit & 7), nb = (sh + w + 7) >> 3;
            unsigned __int128 acc = 0;
            for (int q = 0; q < nb; q++) acc |= (unsigned __int128)mb[b + size_t(q)] << (8 * q);
            d = uint64_t(acc >> sh);
            if (w < 64) d &= (uint64_t(1) << w) - 1;
          }
          value += min_delta + d;
          store(k++);
        }
        i += nbytes;
      }
    }
    *consumed = (long long)i;
    return count;
  });
}

// DELTA_BYTE_ARRAY: value k is the first prefix[k] bytes of value k - 1 and
// then suffix_len[k] bytes of `suffixes`, all joined into out. Returns the
// bytes written or a code.
long long pq_delta_byte_array(const long long* prefix, const long long* suffix_len,
                              const uint8_t* suffixes, long long n_suffixes, long long count,
                              uint8_t* out, long long cap) {
  return guarded([&] {
    size_t pos = 0, spos = 0, prev = 0, prev_len = 0;
    for (long long k = 0; k < count; k++) {
      long long p = prefix[k], s = suffix_len[k];
      if (p < 0 || s < 0 || size_t(p) > prev_len)
        fail(kCorrupt, "value %lld: a prefix of %lld bytes after a value of %zu", k, p, prev_len);
      if (size_t(s) > size_t(n_suffixes) - spos) fail(kTruncated, "suffixes run past the page");
      if (size_t(p) + size_t(s) > size_t(cap) - pos) fail(kTooLarge, "values past their buffer");
      if (p) std::memmove(out + pos, out + prev, size_t(p));
      if (s) std::memcpy(out + pos + p, suffixes + spos, size_t(s));
      prev = pos;
      prev_len = size_t(p + s);
      pos += prev_len;
      spos += size_t(s);
    }
    return (long long)pos;
  });
}

// CRC-32C, slicing by 8 (tables built once, on first use)
uint32_t pq_crc32c(const uint8_t* src, long long n, uint32_t crc) {
  static uint32_t table[8][256];
  static bool ready = [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
      table[0][i] = c;
    }
    for (int t = 1; t < 8; ++t)
      for (int i = 0; i < 256; ++i)
        table[t][i] = (table[t - 1][i] >> 8) ^ table[0][table[t - 1][i] & 0xFF];
    return true;
  }();
  (void)ready;
  crc = ~crc;
  size_t i = 0, len = n > 0 ? size_t(n) : 0;
  for (; i + 8 <= len; i += 8) {
    uint32_t lo = crc ^ (uint32_t(src[i]) | uint32_t(src[i + 1]) << 8 |
                         uint32_t(src[i + 2]) << 16 | uint32_t(src[i + 3]) << 24);
    crc = table[7][lo & 0xFF] ^ table[6][(lo >> 8) & 0xFF] ^ table[5][(lo >> 16) & 0xFF] ^
          table[4][lo >> 24] ^ table[3][src[i + 4]] ^ table[2][src[i + 5]] ^
          table[1][src[i + 6]] ^ table[0][src[i + 7]];
  }
  for (; i < len; ++i) crc = (crc >> 8) ^ table[0][(crc ^ src[i]) & 0xFF];
  return ~crc;
}

}  // extern "C"
