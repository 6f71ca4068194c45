// A coefficient-level JPEG writer and transcoder for test files, in the
// spirit of jpegtran: it reads a baseline (or extended sequential) Huffman
// JPEG to its quantised DCT coefficients and writes the same coefficients
// again, sequential or progressive under a chosen scan script, with
// Huffman tables optimised for each scan. The coefficients, quantisation
// tables, sampling factors and APPn segments (JFIF, Adobe) pass through
// unchanged, so the written file decodes to the pixels the input decodes
// to. It also writes coefficients made elsewhere (any sampling factors, 1,
// 3 or 4 components), which is how tools/make_jpeg_fixtures.py makes the
// files Pillow cannot write.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -pthread -o libjpeg_transcode.so jpeg_transcode.cpp
// (tools/make_jpeg_fixtures.py's ``transcoder()`` does this at first use).
//
// Scan scripts (``script``):
//   0  sequential: one interleaved scan (one a component for 1 component)
//   1  libjpeg's jpeg_simple_progression (the YCbCr script for 3
//      components, the all-purpose one otherwise): every coefficient
//      refined to full precision, as Pillow's progressive files are
//   2  unrefined: DC, AC 1-5 with Al 1 never refined, AC 6-63 in full
//   3  DC only for the first nine AC coefficients: DC, then AC 10-63
//   4  spectral selection only, one DC scan a component (non-interleaved),
//      AC 1-2, 3-9, 10-63 per component
// ``restart``: a restart marker every that many MCUs (0: none).

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

[[noreturn]] void fail(const std::string& m) { throw std::runtime_error(m); }

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Comp {
  int id, h, v, tq;
  int wib, hib, bw, bh;
  std::vector<int16_t> coef;  // bh * bw blocks, natural order
  int16_t* block(int r, int c) { return &coef[(static_cast<size_t>(r) * bw + c) * 64]; }
};

struct Image {
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  uint16_t qt[4][64];           // natural order
  bool qt_used[4] = {false, false, false, false};
  std::vector<uint8_t> app;     // APPn / COM segments to copy
  std::vector<Comp> comps;

  void layout() {
    hmax = vmax = 1;
    for (auto& c : comps) {
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (comps.size() == 1) comps[0].h = comps[0].v = hmax = vmax = 1;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      const int dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      const int dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      c.wib = (dw + 7) / 8;
      c.hib = (dh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
  }
};

// ---- reading a sequential Huffman JPEG -------------------------------------

struct Huff {
  bool defined = false;
  int maxcode[18], valptr[17], mincode[17];
  uint8_t vals[256];
  uint16_t fast[512];                // 9-bit lookahead: length << 8 | symbol (0: longer)
  void build(const uint8_t* bits, const uint8_t* v, int n) {
    std::memcpy(vals, v, n);
    std::memset(fast, 0, sizeof(fast));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      valptr[len] = k;
      mincode[len] = code;
      for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code)
        if (len <= 9)
          for (int j = 0; j < (1 << (9 - len)); ++j)
            fast[(code << (9 - len)) | j] = static_cast<uint16_t>(len << 8 | vals[k]);
      maxcode[len] = bits[len - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Reader {
  const uint8_t* d;
  int64_t n, pos;                    // next byte (at a marker: its 0xFF, never passed)
  uint64_t acc = 0;
  int bits = 0;
  void fill() {
    while (bits <= 56) {
      uint8_t b = 0;
      if (pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          if (pos + 1 < n && d[pos + 1] == 0) {
            pos += 2;
          } else {
            b = 0;                   // a marker: feed zeros
          }
        } else {
          ++pos;
        }
      }
      acc = acc << 8 | b;
      bits += 8;
    }
  }
  int get(int s) {
    if (s == 0) return 0;
    if (bits < s) fill();
    bits -= s;
    return static_cast<int>((acc >> bits) & ((1u << s) - 1));
  }
  int decode(const Huff& h) {
    if (bits < 16) fill();
    const uint32_t look = static_cast<uint32_t>(acc >> (bits - 16)) & 0xFFFF;
    const uint16_t f = h.fast[look >> 7];
    if (f) {
      bits -= f >> 8;
      return f & 0xFF;
    }
    int len = 10;
    int code = static_cast<int>(look >> 6);
    while (len <= 16 && code > h.maxcode[len]) {
      ++len;
      code = static_cast<int>(look >> (16 - len));
    }
    if (len > 16) fail("bad Huffman code");
    bits -= len;
    return h.vals[h.valptr[len] + code - h.mincode[len]];
  }
  static int extend(int v, int s) { return s && v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }
};

Image read_sequential(const uint8_t* d, int64_t n) {
  Image im;
  Huff dc[4], ac[4];
  int restart = 0;
  bool sof = false;
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
  int64_t pos = 2;
  for (;;) {
    while (pos < n && d[pos] != 0xFF) ++pos;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) fail("no EOI marker");
    const int m = d[pos++];
    if (m == 0xD9) break;
    if (m >= 0xD0 && m <= 0xD7) continue;
    const int64_t len = (d[pos] << 8) | d[pos + 1];
    const int64_t end = pos + len;
    const uint8_t* p = d + pos + 2;
    if (m == 0xC0 || m == 0xC1) {
      im.height = (p[1] << 8) | p[2];
      im.width = (p[3] << 8) | p[4];
      const int nc = p[5];
      for (int i = 0; i < nc; ++i)
        im.comps.push_back({p[6 + 3 * i], p[7 + 3 * i] >> 4, p[7 + 3 * i] & 15, p[8 + 3 * i],
                            0, 0, 0, 0, {}});
      im.layout();
      sof = true;
    } else if (m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      fail("the transcoder reads sequential Huffman JPEG only");
    } else if (m == 0xDB) {
      while (p < d + end) {
        const int t = p[0] & 15, prec = p[0] >> 4;
        ++p;
        for (int i = 0; i < 64; ++i) {
          im.qt[t][kNatural[i]] = prec ? static_cast<uint16_t>((p[0] << 8) | p[1]) : p[0];
          p += prec ? 2 : 1;
        }
      }
    } else if (m == 0xC4) {
      while (p < d + end) {
        const int cls = p[0] >> 4, t = p[0] & 15;
        int count = 0;
        for (int i = 0; i < 16; ++i) count += p[1 + i];
        (cls ? ac : dc)[t].build(p + 1, p + 17, count);
        p += 17 + count;
      }
    } else if (m == 0xDD) {
      restart = (p[0] << 8) | p[1];
    } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
      im.app.insert(im.app.end(), d + pos - 2, d + end);
    } else if (m == 0xDA) {
      if (!sof) fail("scan before the frame header");
      const int ns = p[0];
      std::vector<int> ci(ns), td(ns), ta(ns);
      for (int i = 0; i < ns; ++i) {
        for (size_t k = 0; k < im.comps.size(); ++k)
          if (im.comps[k].id == p[1 + 2 * i]) ci[i] = static_cast<int>(k);
        td[i] = p[2 + 2 * i] >> 4;
        ta[i] = p[2 + 2 * i] & 15;
      }
      Reader r{d, n, end};
      int mx = im.mcux, my = im.mcuy;
      if (ns == 1) {
        mx = im.comps[ci[0]].wib;
        my = im.comps[ci[0]].hib;
      }
      int last[4] = {0, 0, 0, 0};
      for (int64_t mcu = 0; mcu < static_cast<int64_t>(mx) * my; ++mcu) {
        if (restart && mcu && mcu % restart == 0) {   // skip to past the RSTn
          int64_t q = r.pos;
          while (q + 1 < n && !(d[q] == 0xFF && d[q + 1] >= 0xD0 && d[q + 1] <= 0xD7)) ++q;
          r = Reader{d, n, q + 2};
          std::memset(last, 0, sizeof(last));
        }
        const int x = static_cast<int>(mcu % mx), y = static_cast<int>(mcu / mx);
        for (int i = 0; i < ns; ++i) {
          Comp& c = im.comps[ci[i]];
          const int bv = ns == 1 ? 1 : c.v, bh = ns == 1 ? 1 : c.h;
          for (int by = 0; by < bv; ++by)
            for (int bx = 0; bx < bh; ++bx) {
              int16_t* blk = ns == 1 ? c.block(y, x) : c.block(y * c.v + by, x * c.h + bx);
              int s = r.decode(dc[td[i]]);
              last[i] += Reader::extend(r.get(s), s);
              blk[0] = static_cast<int16_t>(last[i]);
              for (int k = 1; k < 64; ++k) {
                const int rs = r.decode(ac[ta[i]]);
                s = rs & 15;
                if (!s) {
                  if ((rs >> 4) != 15) break;
                  k += 15;
                  continue;
                }
                k += rs >> 4;
                if (k > 63) fail("corrupt AC data");
                blk[kNatural[k]] = static_cast<int16_t>(Reader::extend(r.get(s), s));
              }
            }
        }
      }
      pos = r.pos;
      continue;
    }
    pos = end;
  }
  for (auto& c : im.comps) im.qt_used[c.tq] = true;
  return im;
}

// ---- writing ---------------------------------------------------------------

struct Scan {
  std::vector<int> comps;
  int ss, se, ah, al;
};

void fill_scans(std::vector<Scan>& s, int nc, int ss, int se, int ah, int al) {
  for (int c = 0; c < nc; ++c) s.push_back({{c}, ss, se, ah, al});
}

void fill_dc(std::vector<Scan>& s, int nc, int ah, int al) {
  std::vector<int> all(nc);
  for (int c = 0; c < nc; ++c) all[c] = c;
  s.push_back({all, 0, 0, ah, al});
}

std::vector<Scan> script_scans(int script, int nc) {
  std::vector<Scan> s;
  switch (script) {
    case 0:
      if (nc == 1) {
        s.push_back({{0}, 0, 63, 0, 0});
      } else {
        fill_dc(s, nc, 0, 0);
        s.back().se = 63;      // one sequential interleaved scan
      }
      break;
    case 1:                    // jcparam.c jpeg_simple_progression
      if (nc == 3) {
        fill_dc(s, nc, 0, 1);
        s.push_back({{0}, 1, 5, 0, 2});
        s.push_back({{2}, 1, 63, 0, 1});
        s.push_back({{1}, 1, 63, 0, 1});
        s.push_back({{0}, 6, 63, 0, 2});
        s.push_back({{0}, 1, 63, 2, 1});
        fill_dc(s, nc, 1, 0);
        s.push_back({{2}, 1, 63, 1, 0});
        s.push_back({{1}, 1, 63, 1, 0});
        s.push_back({{0}, 1, 63, 1, 0});
      } else {
        fill_dc(s, nc, 0, 1);
        fill_scans(s, nc, 1, 5, 0, 2);
        fill_scans(s, nc, 6, 63, 0, 2);
        fill_scans(s, nc, 1, 63, 2, 1);
        fill_dc(s, nc, 1, 0);
        fill_scans(s, nc, 1, 63, 1, 0);
      }
      break;
    case 2:
      fill_dc(s, nc, 0, 0);
      fill_scans(s, nc, 1, 5, 0, 1);
      fill_scans(s, nc, 6, 63, 0, 0);
      break;
    case 3:
      fill_dc(s, nc, 0, 0);
      fill_scans(s, nc, 10, 63, 0, 0);
      break;
    case 4:
      for (int c = 0; c < nc; ++c) s.push_back({{c}, 0, 0, 0, 0});
      fill_scans(s, nc, 1, 2, 0, 0);
      fill_scans(s, nc, 3, 9, 0, 0);
      fill_scans(s, nc, 10, 63, 0, 0);
      break;
    default:
      fail("unknown scan script " + std::to_string(script));
  }
  return s;
}

// Code lengths of an optimal prefix code limited to 16 bits (ITU T.81
// Annex K.2), as (bits[16], vals) of a DHT segment. A reserved symbol of
// frequency 1 keeps the all-ones code unused.
void optimal_table(const int64_t* freq_in, uint8_t* bits, std::vector<uint8_t>& vals) {
  std::vector<int64_t> freq(freq_in, freq_in + 256);
  freq.push_back(1);                         // symbol 256: reserved
  std::vector<int> size(257, 0), others(257, -1);
  for (;;) {
    int c1 = -1, c2 = -1;
    int64_t v1 = INT64_MAX, v2 = INT64_MAX;
    for (int i = 0; i <= 256; ++i) {
      if (freq[i] && freq[i] <= v1) {
        v2 = v1;
        c2 = c1;
        v1 = freq[i];
        c1 = i;
      } else if (freq[i] && freq[i] <= v2) {
        v2 = freq[i];
        c2 = i;
      }
    }
    if (c2 < 0) break;
    freq[c1] += freq[c2];
    freq[c2] = 0;
    ++size[c1];
    while (others[c1] >= 0) {
      c1 = others[c1];
      ++size[c1];
    }
    others[c1] = c2;
    ++size[c2];
    while (others[c2] >= 0) {
      c2 = others[c2];
      ++size[c2];
    }
  }
  int count[33] = {0};
  for (int i = 0; i <= 256; ++i)
    if (size[i]) {
      if (size[i] > 32) fail("Huffman code too long");
      ++count[size[i]];
    }
  for (int i = 32; i > 16; --i)
    while (count[i] > 0) {
      int j = i - 2;
      while (count[j] == 0) --j;
      count[i] -= 2;
      ++count[i - 1];
      count[j + 1] += 2;
      --count[j];
    }
  int i = 16;
  while (count[i] == 0) --i;
  --count[i];                                // drop the reserved code
  for (int k = 0; k < 16; ++k) bits[k] = static_cast<uint8_t>(count[k + 1]);
  vals.clear();
  for (int len = 1; len <= 32; ++len)
    for (int s = 0; s < 256; ++s)
      if (size[s] == len) vals.push_back(static_cast<uint8_t>(s));
}

struct Writer {
  std::vector<uint8_t>& out;
  bool counting = true;
  int64_t freq[2][256];                      // DC, AC symbol counts
  uint16_t code[2][256];
  uint8_t len[2][256];
  uint64_t acc = 0;
  int nacc = 0;
  int eobrun = 0;
  std::vector<uint8_t> be;                   // buffered correction bits

  explicit Writer(std::vector<uint8_t>& o) : out(o) { std::memset(freq, 0, sizeof(freq)); }

  void put_bits(uint32_t v, int n) {
    if (counting || n == 0) return;
    acc = (acc << n) | (v & ((1u << n) - 1));
    nacc += n;
    while (nacc >= 8) {
      nacc -= 8;
      const uint8_t b = static_cast<uint8_t>(acc >> nacc);
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
    }
  }
  void flush() {
    if (nacc > 0) put_bits(0x7F, 8 - nacc);
    acc = 0;
    nacc = 0;
  }
  void symbol(int t, int s) {
    if (counting) {
      ++freq[t][s];
      return;
    }
    if (!len[t][s]) fail("symbol without a code");
    put_bits(code[t][s], len[t][s]);
  }
  void buffered() {
    if (!counting)
      for (uint8_t b : be) put_bits(b, 1);
    be.clear();
  }
  void emit_eobrun() {
    if (eobrun > 0) {
      int nb = 0;
      for (int t = eobrun; t >>= 1;) ++nb;
      symbol(1, nb << 4);
      put_bits(static_cast<uint32_t>(eobrun), nb);
      eobrun = 0;
      buffered();
    }
  }
  static int nbits(int v) { return v ? 32 - __builtin_clz(static_cast<unsigned>(v)) : 0; }

  void dc_first(int16_t* blk, int al, int& last, bool sequential) {
    const int v = blk[0] >> al;              // arithmetic shift, as IRIGHT_SHIFT
    int diff = v - last;
    last = v;
    int t2 = diff;
    if (diff < 0) {
      diff = -diff;
      --t2;
    }
    const int nb = nbits(diff);
    symbol(0, nb);
    put_bits(static_cast<uint32_t>(t2), nb);
    if (sequential) ac_sequential(blk);
  }
  void ac_sequential(const int16_t* blk) {
    int r = 0;
    for (int k = 1; k < 64; ++k) {
      int v = blk[kNatural[k]];
      if (!v) {
        ++r;
        continue;
      }
      while (r > 15) {
        symbol(1, 0xF0);
        r -= 16;
      }
      int v2 = v;
      if (v < 0) {
        v = -v;
        --v2;
      }
      const int nb = nbits(v);
      symbol(1, (r << 4) + nb);
      put_bits(static_cast<uint32_t>(v2), nb);
      r = 0;
    }
    if (r > 0) symbol(1, 0);
  }
  void ac_first(const int16_t* blk, int ss, int se, int al) {
    int r = 0;
    for (int k = ss; k <= se; ++k) {
      int v = blk[kNatural[k]];
      if (!v) {
        ++r;
        continue;
      }
      int v2;
      if (v < 0) {
        v = -v >> al;
        v2 = ~v;
      } else {
        v >>= al;
        v2 = v;
      }
      if (!v) {
        ++r;
        continue;
      }
      emit_eobrun();
      while (r > 15) {
        symbol(1, 0xF0);
        r -= 16;
      }
      const int nb = nbits(v);
      symbol(1, (r << 4) + nb);
      put_bits(static_cast<uint32_t>(v2), nb);
      r = 0;
    }
    if (r > 0) {
      ++eobrun;
      if (eobrun == 0x7FFF) emit_eobrun();
    }
  }
  void ac_refine(const int16_t* blk, int ss, int se, int al) {
    int absv[64], eob = 0;
    for (int k = ss; k <= se; ++k) {
      int v = blk[kNatural[k]];
      absv[k] = (v < 0 ? -v : v) >> al;
      if (absv[k] == 1) eob = k;
    }
    int r = 0, nbr = 0;
    uint8_t br[64];                    // this block's correction bits not yet sent
    for (int k = ss; k <= se; ++k) {
      const int v = absv[k];
      if (!v) {
        ++r;
        continue;
      }
      while (r > 15 && k <= eob) {
        emit_eobrun();
        symbol(1, 0xF0);
        r -= 16;
        buffered();
        for (int i = 0; i < nbr; ++i) put_bits(br[i], 1);
        nbr = 0;
      }
      if (v > 1) {
        br[nbr++] = static_cast<uint8_t>(v & 1);
        continue;
      }
      emit_eobrun();
      symbol(1, (r << 4) + 1);
      put_bits(blk[kNatural[k]] < 0 ? 0 : 1, 1);
      buffered();
      for (int i = 0; i < nbr; ++i) put_bits(br[i], 1);
      nbr = 0;
      r = 0;
    }
    if (r > 0 || nbr > 0) {
      ++eobrun;
      be.insert(be.end(), br, br + nbr);
      if (eobrun == 0x7FFF || be.size() > 937) emit_eobrun();
    }
  }
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v));
}

// One scan's DHT, SOS and entropy-coded data, appended to ``out``: a pass
// counting the symbols for optimal tables, then the pass that writes.
void write_scan(Image& im, const Scan& sc, bool progressive, int restart,
                std::vector<uint8_t>& out) {
  const int ns = static_cast<int>(sc.comps.size());
  const bool dc = sc.ss == 0, refine = sc.ah != 0;
  int mx = im.mcux, my = im.mcuy;
  if (ns == 1) {
    mx = im.comps[sc.comps[0]].wib;
    my = im.comps[sc.comps[0]].hib;
  }
  Writer w(out);
  for (int pass = 0; pass < 2; ++pass) {
    w.counting = pass == 0;
    if (pass == 1) {                        // the tables, then the scan header
      for (int t = 0; t < 2; ++t) {
        if ((t == 0 && !(dc && !refine)) || (t == 1 && dc && progressive)) continue;
        uint8_t bits[16];
        std::vector<uint8_t> vals;
        optimal_table(w.freq[t], bits, vals);
        std::memset(w.len[t], 0, sizeof(w.len[t]));
        int code = 0, k = 0;
        for (int l = 1; l <= 16; ++l, code <<= 1)
          for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
            w.code[t][vals[k]] = static_cast<uint16_t>(code);
            w.len[t][vals[k]] = static_cast<uint8_t>(l);
          }
        out.push_back(0xFF);
        out.push_back(0xC4);
        put16(out, 3 + 16 + static_cast<int>(vals.size()));
        out.push_back(static_cast<uint8_t>(t << 4));
        out.insert(out.end(), bits, bits + 16);
        out.insert(out.end(), vals.begin(), vals.end());
      }
      out.push_back(0xFF);
      out.push_back(0xDA);
      put16(out, 6 + 2 * ns);
      out.push_back(static_cast<uint8_t>(ns));
      for (int ci : sc.comps) {
        out.push_back(static_cast<uint8_t>(im.comps[ci].id));
        out.push_back(0x00);
      }
      out.push_back(static_cast<uint8_t>(sc.ss));
      out.push_back(static_cast<uint8_t>(sc.se));
      out.push_back(static_cast<uint8_t>((sc.ah << 4) | sc.al));
    }
    int last[4] = {0, 0, 0, 0};
    int rst = 0;
    w.eobrun = 0;
    w.be.clear();
    for (int64_t mcu = 0; mcu < static_cast<int64_t>(mx) * my; ++mcu) {
      if (restart && mcu && mcu % restart == 0) {
        w.emit_eobrun();
        w.flush();
        if (!w.counting) {
          out.push_back(0xFF);
          out.push_back(static_cast<uint8_t>(0xD0 + rst));
        }
        rst = (rst + 1) & 7;
        std::memset(last, 0, sizeof(last));
      }
      const int x = static_cast<int>(mcu % mx), y = static_cast<int>(mcu / mx);
      for (int i = 0; i < ns; ++i) {
        Comp& c = im.comps[sc.comps[i]];
        const int bv = ns == 1 ? 1 : c.v, bh = ns == 1 ? 1 : c.h;
        for (int by = 0; by < bv; ++by)
          for (int bx = 0; bx < bh; ++bx) {
            int16_t* blk = ns == 1 ? c.block(y, x) : c.block(y * c.v + by, x * c.h + bx);
            if (!progressive)
              w.dc_first(blk, 0, last[i], true);
            else if (dc && !refine)
              w.dc_first(blk, sc.al, last[i], false);
            else if (dc)
              w.put_bits((blk[0] >> sc.al) & 1, 1);
            else if (!refine)
              w.ac_first(blk, sc.ss, sc.se, sc.al);
            else
              w.ac_refine(blk, sc.ss, sc.se, sc.al);
          }
      }
    }
    w.emit_eobrun();
    w.flush();
  }
}

// ---- arithmetic coding (ITU T.81 Annex D, as libjpeg's jcarith.c codes) ----

// Table D.2 packed as libjpeg's jaricom.c packs it: Qe << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the
// fixed bin of probability 0.5.
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
// The QM coder of one scan: bytes go straight to ``out`` (it stuffs its
// own zeros after 0xFF).
struct ArithWriter {
  std::vector<uint8_t>& out;
  int64_t c = 0, a = 0x10000, sc = 0, zc = 0;   // stacked 0xFF / pending 0x00 bytes
  int ct = 11, buffer = -1;
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed = 113;
  int last_dc[4] = {0, 0, 0, 0}, context[4] = {0, 0, 0, 0};

  explicit ArithWriter(std::vector<uint8_t>& o) : out(o) {}

  void start() {
    c = 0;
    a = 0x10000;
    sc = zc = 0;
    ct = 11;
    buffer = -1;
  }
  void zeros() {
    for (; zc; --zc) out.push_back(0x00);
  }
  void stacked() {
    if (sc) {
      zeros();
      for (; sc; --sc) {
        out.push_back(0xFF);
        out.push_back(0x00);
      }
    }
  }
  void put_buffer(int b) {
    zeros();
    out.push_back(static_cast<uint8_t>(b));
    if (b == 0xFF) out.push_back(0x00);
  }

  void encode(uint8_t* st, int val) {
    const int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    a -= qe;
    if (val != (sv >> 7)) {              // the less probable symbol
      if (a >= qe) {
        c += a;
        a = qe;
      }
      *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
    } else {
      if (a >= 0x8000) return;
      if (a < qe) {
        c += a;
        a = qe;
      }
      *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
    }
    do {                                 // renormalisation and output (D.1.6)
      a <<= 1;
      c <<= 1;
      if (--ct == 0) {
        const int64_t temp = c >> 19;
        if (temp > 0xFF) {               // a carry over the stacked 0xFF bytes
          if (buffer >= 0) put_buffer(buffer + 1);
          zc += sc;
          sc = 0;
          buffer = static_cast<int>(temp & 0xFF);
        } else if (temp == 0xFF) {
          ++sc;
        } else {
          if (buffer == 0) {
            ++zc;
          } else if (buffer >= 0) {
            put_buffer(buffer);
          }
          stacked();
          buffer = static_cast<int>(temp & 0xFF);
        }
        c &= 0x7FFFF;
        ct += 8;
      }
    } while (a < 0x8000);
  }

  // Termination (D.1.8): the shortest tail that stays inside the interval
  void finish() {
    int64_t temp = (a - 1 + c) & 0xFFFF0000LL;
    c = temp < c ? temp + 0x8000 : temp;
    c <<= ct;
    if (c & 0xF8000000LL) {
      if (buffer >= 0) put_buffer(buffer + 1);
      zc += sc;
      sc = 0;
    } else {
      if (buffer == 0) {
        ++zc;
      } else if (buffer >= 0) {
        put_buffer(buffer);
      }
      stacked();
    }
    if (c & 0x7FFF800LL) {
      zeros();
      const int b1 = static_cast<int>((c >> 19) & 0xFF);
      out.push_back(static_cast<uint8_t>(b1));
      if (b1 == 0xFF) out.push_back(0x00);
      if (c & 0x7F800LL) {
        const int b2 = static_cast<int>((c >> 11) & 0xFF);
        out.push_back(static_cast<uint8_t>(b2));
        if (b2 == 0xFF) out.push_back(0x00);
      }
    }
  }

  // The magnitude category and bits of v - 1 > 0 after the sign (F.8, F.9):
  // ``st`` the first magnitude bin, ``x2`` the bins from the second on
  void magnitude(uint8_t* st, uint8_t* x2, int v, bool ac) {
    int m = 0;
    if (v -= 1) {
      encode(st, 1);
      m = 1;
      int v2 = v;
      if (ac) {
        if (v2 >>= 1) {
          encode(st, 1);
          m <<= 1;
          st = x2;
          while (v2 >>= 1) {
            encode(st, 1);
            m <<= 1;
            ++st;
          }
        }
      } else {
        st = x2;
        while (v2 >>= 1) {
          encode(st, 1);
          m <<= 1;
          ++st;
        }
      }
    }
    encode(st, 0);
    mag_ = m;
    st_ = st;
    v_ = v;
  }
  void bits() {
    uint8_t* st = st_ + 14;
    for (int m = mag_; m >>= 1;) encode(st, (m & v_) ? 1 : 0);
  }
  int mag_ = 0, v_ = 0;
  uint8_t* st_ = nullptr;

  // a DC difference (F.1.4.1) of component i in table tbl; L, U its DAC
  void dc(int i, int tbl, int value, int L, int U) {
    uint8_t* st = dc_stats[tbl] + context[i];
    int v = value - last_dc[i];
    if (v == 0) {
      encode(st, 0);
      context[i] = 0;
      return;
    }
    last_dc[i] = value;
    encode(st, 1);
    if (v > 0) {
      encode(st + 1, 0);
      st += 2;
      context[i] = 4;
    } else {
      v = -v;
      encode(st + 1, 1);
      st += 3;
      context[i] = 8;
    }
    magnitude(st, dc_stats[tbl] + 20, v, false);
    if (mag_ < ((1 << L) >> 1))
      context[i] = 0;
    else if (mag_ > ((1 << U) >> 1))
      context[i] += 8;
    bits();
  }

  // AC coefficients ss..se of a block, each divided by 2^al (F.1.4.2)
  void ac(const int16_t* blk, int tbl, int ss, int se, int al, int K) {
    auto shifted = [&](int k) {
      const int v = blk[kNatural[k]];
      return v >= 0 ? v >> al : -((-v) >> al);
    };
    int ke = se;
    while (ke > 0 && shifted(ke) == 0) --ke;
    int k = ss;
    for (; k <= ke; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      encode(st, 0);                   // not the end of the block
      int v;
      while ((v = shifted(k)) == 0) {
        encode(st + 1, 0);
        st += 3;
        ++k;
      }
      encode(st + 1, 1);
      encode(&fixed, v < 0 ? 1 : 0);
      if (v < 0) v = -v;
      magnitude(st + 2, ac_stats[tbl] + (k <= K ? 189 : 217), v, true);
      bits();
    }
    if (k <= se) encode(ac_stats[tbl] + 3 * (k - 1), 1);
  }

  // An AC refinement scan's bits of a block (G.1.3.3)
  void ac_refine(const int16_t* blk, int tbl, int ss, int se, int ah, int al) {
    auto mag = [&](int k, int shift) {
      const int v = blk[kNatural[k]];
      return (v >= 0 ? v : -v) >> shift;
    };
    int ke = se;
    while (ke > 0 && mag(ke, al) == 0) --ke;
    int kex = ke;
    while (kex > 0 && mag(kex, ah) == 0) --kex;
    int k = ss;
    for (; k <= ke; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex) encode(st, 0);
      for (;;) {
        const int v = mag(k, al);
        if (v) {
          if (v >> 1) {
            encode(st + 2, v & 1);
          } else {
            encode(st + 1, 1);
            encode(&fixed, blk[kNatural[k]] < 0 ? 1 : 0);
          }
          break;
        }
        encode(st + 1, 0);
        st += 3;
        ++k;
      }
    }
    if (k <= se) encode(ac_stats[tbl] + 3 * (k - 1), 1);
  }
};

// One scan's DAC, SOS and arithmetic-coded data, appended to ``out``.
// Component 0 takes statistics tables 0, the others 1; dac holds (L, U, Kx)
// of table 0, then of table 1.
void write_scan_arith(Image& im, const Scan& sc, bool progressive, int restart,
                      const int32_t* dac, std::vector<uint8_t>& out) {
  const int ns = static_cast<int>(sc.comps.size());
  const bool dc = sc.ss == 0, refine = sc.ah != 0;
  int mx = im.mcux, my = im.mcuy;
  if (ns == 1) {
    mx = im.comps[sc.comps[0]].wib;
    my = im.comps[sc.comps[0]].hib;
  }
  auto table = [&](int i) { return sc.comps[i] == 0 ? 0 : 1; };
  std::vector<uint8_t> conditioning;          // DAC, as libjpeg's emit_dac writes it
  for (int t = 0; t < 2; ++t) {
    bool dc_used = false, ac_used = false;
    for (int i = 0; i < ns; ++i)
      if (table(i) == t) {
        dc_used |= dc && !refine;
        ac_used |= sc.se != 0;
      }
    if (dc_used) {
      conditioning.push_back(static_cast<uint8_t>(t));
      conditioning.push_back(static_cast<uint8_t>(dac[3 * t] + (dac[3 * t + 1] << 4)));
    }
    if (ac_used) {
      conditioning.push_back(static_cast<uint8_t>(t + 16));
      conditioning.push_back(static_cast<uint8_t>(dac[3 * t + 2]));
    }
  }
  if (!conditioning.empty()) {
    out.push_back(0xFF);
    out.push_back(0xCC);
    put16(out, 2 + static_cast<int>(conditioning.size()));
    out.insert(out.end(), conditioning.begin(), conditioning.end());
  }
  out.push_back(0xFF);
  out.push_back(0xDA);
  put16(out, 6 + 2 * ns);
  out.push_back(static_cast<uint8_t>(ns));
  for (int i = 0; i < ns; ++i) {
    out.push_back(static_cast<uint8_t>(im.comps[sc.comps[i]].id));
    out.push_back(static_cast<uint8_t>(table(i) * 0x11));
  }
  out.push_back(static_cast<uint8_t>(sc.ss));
  out.push_back(static_cast<uint8_t>(sc.se));
  out.push_back(static_cast<uint8_t>((sc.ah << 4) | sc.al));
  // each restart interval starts afresh: its bytes are coded apart, on
  // threads, and joined with the RSTn markers between them
  const int64_t total = static_cast<int64_t>(mx) * my;
  const int64_t every = restart ? restart : total;
  const int64_t intervals = (total + every - 1) / every;
  std::vector<std::vector<uint8_t>> parts(intervals);
  auto code = [&](int64_t k) {
    ArithWriter w(parts[k]);
    std::memset(w.dc_stats, 0, sizeof(w.dc_stats));
    std::memset(w.ac_stats, 0, sizeof(w.ac_stats));
    for (int64_t mcu = k * every; mcu < std::min(total, (k + 1) * every); ++mcu) {
      const int x = static_cast<int>(mcu % mx), y = static_cast<int>(mcu / mx);
      for (int i = 0; i < ns; ++i) {
        Comp& c = im.comps[sc.comps[i]];
        const int t = table(i);
        const int bv = ns == 1 ? 1 : c.v, bh = ns == 1 ? 1 : c.h;
        for (int by = 0; by < bv; ++by)
          for (int bx = 0; bx < bh; ++bx) {
            const int16_t* blk = ns == 1 ? c.block(y, x) : c.block(y * c.v + by, x * c.h + bx);
            if (!progressive) {
              w.dc(i, t, blk[0], dac[3 * t], dac[3 * t + 1]);
              w.ac(blk, t, 1, 63, 0, dac[3 * t + 2]);
            } else if (dc && !refine) {     // an arithmetic right shift of the DC
              w.dc(i, t, blk[0] >> sc.al, dac[3 * t], dac[3 * t + 1]);
            } else if (dc) {
              w.encode(&w.fixed, (blk[0] >> sc.al) & 1);
            } else if (!refine) {
              w.ac(blk, t, sc.ss, sc.se, sc.al, dac[3 * t + 2]);
            } else {
              w.ac_refine(blk, t, sc.ss, sc.se, sc.ah, sc.al);
            }
          }
      }
    }
    w.finish();
  };
  std::atomic<int64_t> next(0);
  auto work = [&]() {
    for (int64_t k; (k = next.fetch_add(1)) < intervals;) code(k);
  };
  const int64_t n_threads = std::min<int64_t>(
      intervals, std::max(1u, std::thread::hardware_concurrency()));
  std::vector<std::thread> threads;
  for (int64_t t = 1; t < n_threads; ++t) threads.emplace_back(work);
  work();
  for (auto& t : threads) t.join();
  for (int64_t k = 0; k < intervals; ++k) {
    if (k) {
      out.push_back(0xFF);
      out.push_back(static_cast<uint8_t>(0xD0 + ((k - 1) & 7)));
    }
    out.insert(out.end(), parts[k].begin(), parts[k].end());
  }
}

// ---- lossless (SOF3) -------------------------------------------------------

// (h, w, nc) 8-bit samples as a lossless Huffman JPEG (T.81 Annex H, as
// libjpeg-turbo 3 reads it): predictor psv (1-7), point transform pt, a
// restart marker every restart_rows rows (0: none; prediction starts over
// after each), one interleaved scan or one scan a component, one optimal
// table. app is copied after SOI.
void write_lossless(const uint8_t* px, int h, int w, int nc, const int32_t* ids, int psv,
                    int pt, int restart_rows, bool interleaved, const uint8_t* app,
                    int64_t app_n, std::vector<uint8_t>& out) {
  if (psv < 1 || psv > 7 || pt < 0 || pt > 7) fail("lossless: predictor 1-7, Pt 0-7");
  if (static_cast<int64_t>(restart_rows) * w > 65535) fail("lossless: restart interval too long");
  std::vector<std::vector<int>> scans;
  if (interleaved) {
    scans.emplace_back();
    for (int c = 0; c < nc; ++c) scans.back().push_back(c);
  } else {
    for (int c = 0; c < nc; ++c) scans.push_back({c});
  }
  auto sample = [&](int y, int x, int c) { return px[(static_cast<int64_t>(y) * w + x) * nc + c] >> pt; };
  // each scan's differences in coding order, then symbol counts
  std::vector<std::vector<int>> diffs(scans.size());
  int64_t freq[256] = {0};
  for (size_t s = 0; s < scans.size(); ++s)
    for (int y = 0; y < h; ++y) {
      const bool first = restart_rows ? y % restart_rows == 0 : y == 0;
      for (int x = 0; x < w; ++x)
        for (int c : scans[s]) {
          int p;
          if (first) {
            p = x ? sample(y, x - 1, c) : 1 << (7 - pt);
          } else if (x == 0) {
            p = sample(y - 1, 0, c);
          } else {
            const int ra = sample(y, x - 1, c), rb = sample(y - 1, x, c), rc = sample(y - 1, x - 1, c);
            switch (psv) {
              case 1: p = ra; break;
              case 2: p = rb; break;
              case 3: p = rc; break;
              case 4: p = ra + rb - rc; break;
              case 5: p = ra + ((rb - rc) >> 1); break;
              case 6: p = rb + ((ra - rc) >> 1); break;
              default: p = (ra + rb) >> 1; break;
            }
          }
          const int d = sample(y, x, c) - p;
          diffs[s].push_back(d);
          ++freq[d ? 32 - __builtin_clz(static_cast<unsigned>(d < 0 ? -d : d)) : 0];
        }
    }
  uint8_t bits[16];
  std::vector<uint8_t> vals;
  optimal_table(freq, bits, vals);
  uint16_t code[17] = {0};
  uint8_t len[17] = {0};
  for (int l = 1, k = 0, cd = 0; l <= 16; ++l, cd <<= 1)
    for (int i = 0; i < bits[l - 1]; ++i, ++k, ++cd) {
      code[vals[k]] = static_cast<uint16_t>(cd);
      len[vals[k]] = static_cast<uint8_t>(l);
    }
  out = {0xFF, 0xD8};
  out.insert(out.end(), app, app + app_n);
  out.push_back(0xFF);
  out.push_back(0xC3);
  put16(out, 8 + 3 * nc);
  out.push_back(8);
  put16(out, h);
  put16(out, w);
  out.push_back(static_cast<uint8_t>(nc));
  for (int c = 0; c < nc; ++c) {
    out.push_back(static_cast<uint8_t>(ids[c]));
    out.push_back(0x11);
    out.push_back(0);
  }
  out.push_back(0xFF);
  out.push_back(0xC4);
  put16(out, 3 + 16 + static_cast<int>(vals.size()));
  out.push_back(0x00);
  out.insert(out.end(), bits, bits + 16);
  out.insert(out.end(), vals.begin(), vals.end());
  if (restart_rows) {
    out.push_back(0xFF);
    out.push_back(0xDD);
    put16(out, 4);
    put16(out, restart_rows * w);
  }
  for (size_t s = 0; s < scans.size(); ++s) {
    const int ns = static_cast<int>(scans[s].size());
    out.push_back(0xFF);
    out.push_back(0xDA);
    put16(out, 6 + 2 * ns);
    out.push_back(static_cast<uint8_t>(ns));
    for (int c : scans[s]) {
      out.push_back(static_cast<uint8_t>(ids[c]));
      out.push_back(0x00);
    }
    out.push_back(static_cast<uint8_t>(psv));
    out.push_back(0);
    out.push_back(static_cast<uint8_t>(pt));
    uint32_t acc = 0;
    int n = 0;
    auto put = [&](uint32_t v, int nb) {
      for (int i = nb - 1; i >= 0; --i) {
        acc = (acc << 1) | ((v >> i) & 1);
        if (++n == 8) {
          out.push_back(static_cast<uint8_t>(acc));
          if ((acc & 0xFF) == 0xFF) out.push_back(0x00);
          acc = 0;
          n = 0;
        }
      }
    };
    auto flush = [&]() {
      while (n) put(1, 1);
    };
    const int64_t per_row = static_cast<int64_t>(w) * ns;
    int rst = 0;
    for (size_t i = 0; i < diffs[s].size(); ++i) {
      if (restart_rows && i && i % (per_row * restart_rows) == 0) {
        flush();
        out.push_back(0xFF);
        out.push_back(static_cast<uint8_t>(0xD0 + rst));
        rst = (rst + 1) & 7;
      }
      const int d = diffs[s][i];
      const int mag = d < 0 ? -d : d;
      const int sz = mag ? 32 - __builtin_clz(static_cast<unsigned>(mag)) : 0;
      put(code[sz], len[sz]);
      if (sz) put(static_cast<uint32_t>(d > 0 ? d : d - 1) & ((1u << sz) - 1), sz);
    }
    flush();
  }
  out.push_back(0xFF);
  out.push_back(0xD9);
}

// The whole file: Huffman-coded (dac null) or arithmetic-coded under dac's
// conditioning (as write_scan_arith)
void write_image(Image& im, int script, int restart, const int32_t* dac,
                 std::vector<uint8_t>& out) {
  const int nc = static_cast<int>(im.comps.size());
  const bool progressive = script != 0;
  out = {0xFF, 0xD8};
  out.insert(out.end(), im.app.begin(), im.app.end());
  for (int t = 0; t < 4; ++t) {
    if (!im.qt_used[t]) continue;
    bool wide = false;
    for (int i = 0; i < 64; ++i) wide |= im.qt[t][i] > 255;
    out.push_back(0xFF);
    out.push_back(0xDB);
    put16(out, 3 + 64 * (wide ? 2 : 1));
    out.push_back(static_cast<uint8_t>((wide ? 0x10 : 0) | t));
    for (int i = 0; i < 64; ++i) {
      if (wide) out.push_back(static_cast<uint8_t>(im.qt[t][kNatural[i]] >> 8));
      out.push_back(static_cast<uint8_t>(im.qt[t][kNatural[i]]));
    }
  }
  out.push_back(0xFF);
  bool wide_tables = false;
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 64 && im.qt_used[t]; ++i) wide_tables |= im.qt[t][i] > 255;
  if (dac)
    out.push_back(progressive ? 0xCA : 0xC9);
  else
    out.push_back(progressive ? 0xC2 : wide_tables ? 0xC1 : 0xC0);
  put16(out, 8 + 3 * nc);
  out.push_back(8);
  put16(out, im.height);
  put16(out, im.width);
  out.push_back(static_cast<uint8_t>(nc));
  for (auto& c : im.comps) {
    out.push_back(static_cast<uint8_t>(c.id));
    out.push_back(static_cast<uint8_t>((c.h << 4) | c.v));
    out.push_back(static_cast<uint8_t>(c.tq));
  }
  if (restart) {
    out.push_back(0xFF);
    out.push_back(0xDD);
    put16(out, 4);
    put16(out, restart);
  }
  const std::vector<Scan> scans = script_scans(script, nc);
  std::vector<std::vector<uint8_t>> parts(scans.size());
  std::vector<std::string> errors(scans.size());
  std::atomic<size_t> next(0);
  auto work = [&]() {                      // the scans are independent: one a task
    for (size_t i; (i = next.fetch_add(1)) < scans.size();) {
      try {
        if (dac)
          write_scan_arith(im, scans[i], progressive, restart, dac, parts[i]);
        else
          write_scan(im, scans[i], progressive, restart, parts[i]);
      } catch (const std::exception& e) {
        errors[i] = e.what();
      }
    }
  };
  const size_t n_threads = std::min<size_t>(scans.size(),
                                            std::max(1u, std::thread::hardware_concurrency()));
  std::vector<std::thread> threads;
  for (size_t t = 1; t < n_threads; ++t) threads.emplace_back(work);
  work();
  for (auto& t : threads) t.join();
  for (size_t i = 0; i < scans.size(); ++i) {
    if (!errors[i].empty()) fail(errors[i]);
    out.insert(out.end(), parts[i].begin(), parts[i].end());
  }
  out.push_back(0xFF);
  out.push_back(0xD9);
}

uint8_t* give(const std::vector<uint8_t>& v, int64_t* n) {
  uint8_t* p = static_cast<uint8_t*>(std::malloc(v.size()));
  if (!p) fail("out of memory");
  std::memcpy(p, v.data(), v.size());
  *n = static_cast<int64_t>(v.size());
  return p;
}

void set_error(char* err, int errlen, const char* msg) {
  std::snprintf(err, static_cast<size_t>(errlen), "%s", msg);
}

}  // namespace

extern "C" {

// Rewrite a sequential Huffman JPEG under ``script`` with ``restart``,
// arithmetic-coded under ``dac`` (L, U, Kx of tables 0 and 1) unless null.
int jt_transcode(const uint8_t* data, int64_t n, int script, int restart, const int32_t* dac,
                 uint8_t** out, int64_t* out_n, char* err, int errlen) {
  try {
    Image im = read_sequential(data, n);
    std::vector<uint8_t> bytes;
    write_image(im, script, restart, dac, bytes);
    *out = give(bytes, out_n);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Write coefficients: nc components with ids, h, v, tq; coefs[c] points at
// component c's (bh, bw, 64) int16 blocks in natural order (bh, bw the
// MCU-padded block counts of the frame); qt (4, 64) natural order, used[t]
// nonzero for the tables the components name; app: APPn segments copied
// after SOI.
int jt_write(int width, int height, int nc, const int32_t* ids, const int32_t* h,
             const int32_t* v, const int32_t* tq, const int16_t* const* coefs,
             const uint16_t* qt, const int32_t* used, const uint8_t* app, int64_t app_n,
             int script, int restart, const int32_t* dac, uint8_t** out, int64_t* out_n,
             char* err, int errlen) {
  try {
    Image im;
    im.width = width;
    im.height = height;
    for (int c = 0; c < nc; ++c) im.comps.push_back({ids[c], h[c], v[c], tq[c], 0, 0, 0, 0, {}});
    im.layout();
    for (int c = 0; c < nc; ++c)
      std::memcpy(im.comps[c].coef.data(), coefs[c], im.comps[c].coef.size() * 2);
    for (int t = 0; t < 4; ++t) {
      std::memcpy(im.qt[t], qt + 64 * t, 128);
      im.qt_used[t] = used[t] != 0;
    }
    im.app.assign(app, app + app_n);
    std::vector<uint8_t> bytes;
    write_image(im, script, restart, dac, bytes);
    *out = give(bytes, out_n);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// A lossless JPEG of (h, w, nc) samples (write_lossless).
int jt_write_lossless(const uint8_t* px, int h, int w, int nc, const int32_t* ids, int psv,
                      int pt, int restart_rows, int interleaved, const uint8_t* app,
                      int64_t app_n, uint8_t** out, int64_t* out_n, char* err, int errlen) {
  try {
    std::vector<uint8_t> bytes;
    write_lossless(px, h, w, nc, ids, psv, pt, restart_rows, interleaved != 0, app, app_n,
                   bytes);
    *out = give(bytes, out_n);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

void jt_free(uint8_t* p) { std::free(p); }

}  // extern "C"
