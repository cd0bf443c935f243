// Zstandard frames (RFC 8878) for the port's tensor wire: a decoder of the
// whole frame format and a compact encoder.
//
// - zstd_decompress reads the first frame of its input as
//   ``zstandard.ZstdDecompressor().decompress`` does (``utils/zstd.py``
//   parses the header and sizes the output first): raw, RLE and compressed
//   blocks; raw, RLE, Huffman (1 or 4 streams, FSE-coded or direct
//   weights) and treeless literals; predefined, RLE, FSE-compressed and
//   repeat sequence tables; the three repeat offsets; overlapping match
//   copies; the XXH64 content checksum. Every read and write is bounds
//   checked: corrupt or truncated input is refused, never overrun.
// - zstd_compress writes one single-segment frame with the content size
//   and no checksum. Each block of at most 128 KiB is the smallest of raw,
//   RLE and compressed; a compressed block carries Huffman literals
//   (length-limited canonical codes, FSE-coded weights, or the previous
//   block's table) and the sequences of a greedy hash-chain matcher with
//   predefined, RLE, FSE-compressed or repeated tables. On tensors almost
//   all of zstd's gain is the Huffman-coded literals, so this matches
//   libzstd level 3's ratio on them without its match finders.
//
// The C ABI takes caller-owned buffers and returns a byte count, or a
// negative code with a message in ``err``: -2 a corrupt or truncated frame,
// -3 a frame that needs a dictionary, -4 an output buffer too small.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kCorrupt = -2;
constexpr int kDictionary = -3;
constexpr int kTooSmall = -4;

struct ZError {
  int code;
  std::string msg;
};

[[noreturn]] void corrupt(const char* m) { throw ZError{kCorrupt, m}; }

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr int kBlockMax = 128 * 1024;

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t rd32(const uint8_t* p) { return rd24(p) | (uint32_t(p[3]) << 24); }
inline uint64_t rd64(const uint8_t* p) { return rd32(p) | (uint64_t(rd32(p + 4)) << 32); }

// ------------------------------------------------------------------ XXH64

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------ bit readers

// A backward bitstream (Huffman and FSE streams): the last byte holds a
// 1-bit end mark above the first bits read; reading goes from there down
// to bit 0. ``pos`` counts the bits left and goes negative when a reader
// asks for more than there are (the FSE weight decoder's end test).
struct BackBits {
  const uint8_t* p;
  int64_t n;
  int64_t pos;

  BackBits(const uint8_t* src, int64_t len) : p(src), n(len) {
    if (len < 1 || src[len - 1] == 0) corrupt("bitstream without an end mark");
    pos = (len - 1) * 8 + highbit(src[len - 1]);
  }

  uint64_t word(int64_t byte) const {  // 8 bytes from ``byte``, zeros past the end
    if (byte + 8 <= n) {
      uint64_t w;
      std::memcpy(&w, p + byte, 8);
      return w;
    }
    uint64_t w = 0;
    for (int64_t i = byte; i < n; ++i) w |= uint64_t(p[i]) << (8 * (i - byte));
    return w;
  }

  // the next ``k`` (<= 56) bits, zeros below bit 0
  uint64_t peek(int k) const {
    if (k == 0) return 0;
    int64_t s = pos - k;
    if (s >= 0) return (word(s >> 3) >> (s & 7)) & ((uint64_t(1) << k) - 1);
    if (pos <= 0) return 0;
    return (word(0) & ((uint64_t(1) << pos) - 1)) << (-s);
  }

  uint64_t read(int k) {
    uint64_t v = peek(k);
    pos -= k;
    return v;
  }
};

// ------------------------------------------------------------------- FSE

struct FseEntry {
  uint16_t base;   // next state = base + read(bits)
  uint8_t symbol;
  uint8_t bits;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

// normalized counts -> decoding table (RFC 8878 4.1.1)
void build_fse(FseTable& out, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  out.log = log;
  out.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(nsym);
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      out.t[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      out.t[pos].symbol = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) corrupt("FSE table spread does not close");
  for (int u = 0; u < size; ++u) {
    const int s = out.t[u].symbol;
    const uint32_t ns = next[s]++;
    const int bits = log - highbit(ns);
    out.t[u].bits = uint8_t(bits);
    out.t[u].base = uint16_t((ns << bits) - size);
  }
}

void build_rle(FseTable& out, int symbol) {
  out.log = 0;
  out.t.assign(1, FseEntry{0, uint8_t(symbol), 0});
}

// an FSE table description (RFC 8878 4.1.1), read forward; returns the
// bytes it took
size_t read_ncount(int16_t* norm, int* nsym, int max_symbol, int max_log, const uint8_t* src,
                   size_t len, int* log_out) {
  if (len < 1) corrupt("truncated FSE table description");
  size_t bitpos = 0;
  auto bits = [&](int k) -> uint32_t {  // peek k (<= 25) bits, zeros past the end
    uint32_t v = 0;
    size_t byte = bitpos >> 3;
    for (int i = 0; i < 4 && byte + i < len; ++i) v |= uint32_t(src[byte + i]) << (8 * i);
    return (v >> (bitpos & 7)) & ((1u << k) - 1);
  };
  const int log = int(bits(4)) + 5;
  bitpos += 4;
  if (log > max_log) corrupt("FSE accuracy log too large");
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, s = 0;
  bool prev0 = false;
  while (remaining > 1) {
    if (prev0) {
      for (;;) {
        const int rep = int(bits(2));
        bitpos += 2;
        for (int i = 0; i < rep; ++i) {
          if (s > max_symbol) corrupt("FSE table description has too many symbols");
          norm[s++] = 0;
        }
        if (rep != 3) break;
      }
    }
    if (s > max_symbol) corrupt("FSE table description has too many symbols");
    const int max = 2 * threshold - 1 - remaining;
    int count;
    if (int(bits(nbits - 1)) < max) {
      count = int(bits(nbits - 1));
      bitpos += nbits - 1;
    } else {
      count = int(bits(nbits));
      if (count >= threshold) count -= max;
      bitpos += nbits;
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm[s++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
    if ((bitpos + 7) / 8 > len) corrupt("truncated FSE table description");
  }
  if (remaining != 1) corrupt("FSE table description does not sum to its size");
  *nsym = s;
  *log_out = log;
  return (bitpos + 7) / 8;
}

// --------------------------------------------------------------- Huffman

struct HufTable {
  int maxbits = 0;
  std::vector<uint8_t> sym, len;  // indexed by the next maxbits bits
};

// the tree description at ``src``; returns the bytes it took
size_t read_huffman(HufTable& h, const uint8_t* src, size_t len) {
  if (len < 1) corrupt("truncated Huffman tree description");
  uint8_t w[256];
  int nw = 0;
  const int hb = src[0];
  size_t used;
  if (hb >= 128) {
    nw = hb - 127;
    used = 1 + (nw + 1) / 2;
    if (used > len) corrupt("truncated Huffman weights");
    for (int i = 0; i < nw; ++i) w[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
  } else {
    used = 1 + size_t(hb);
    if (used > len || hb == 0) corrupt("truncated Huffman weights");
    int16_t norm[16];
    int nsym = 0, log = 0;
    const size_t nc = read_ncount(norm, &nsym, 12, 6, src + 1, hb, &log);
    if (nc >= size_t(hb)) corrupt("Huffman weights without a bitstream");
    FseTable t;
    build_fse(t, norm, nsym, log);
    BackBits br(src + 1 + nc, hb - int64_t(nc));
    uint32_t s1 = uint32_t(br.read(log)), s2 = uint32_t(br.read(log));
    // two interleaved states; the stream ends when a state update reads
    // past its start, and the other state gives the last weight
    for (;;) {
      if (nw > 253) corrupt("too many Huffman weights");
      const FseEntry& e1 = t.t[s1];
      w[nw++] = e1.symbol;
      s1 = e1.base + uint32_t(br.read(e1.bits));
      if (br.pos < 0) {
        w[nw++] = t.t[s2].symbol;
        break;
      }
      if (nw > 253) corrupt("too many Huffman weights");
      const FseEntry& e2 = t.t[s2];
      w[nw++] = e2.symbol;
      s2 = e2.base + uint32_t(br.read(e2.bits));
      if (br.pos < 0) {
        w[nw++] = t.t[s1].symbol;
        break;
      }
    }
  }
  uint32_t total = 0;
  int rank1 = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 12) corrupt("Huffman weight above 12");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) corrupt("Huffman weights all zero");
  const int maxbits = highbit(total) + 1;
  if (maxbits > 12) corrupt("Huffman code longer than 12 bits");
  const uint32_t rest = (1u << maxbits) - total;
  if (rest == 0 || (rest & (rest - 1))) corrupt("Huffman weights do not close the code");
  w[nw++] = uint8_t(highbit(rest) + 1);
  for (int i = 0; i < nw; ++i) rank1 += w[i] == 1;
  if (rank1 < 2 || (rank1 & 1)) corrupt("Huffman code with an odd count of longest codes");
  h.maxbits = maxbits;
  h.sym.assign(size_t(1) << maxbits, 0);
  h.len.assign(size_t(1) << maxbits, 0);
  uint32_t pos = 0;
  for (int wt = 1; wt <= maxbits; ++wt) {
    for (int s = 0; s < nw; ++s) {
      if (w[s] != wt) continue;
      const uint32_t span = 1u << (wt - 1);
      std::memset(&h.sym[pos], s, span);
      std::memset(&h.len[pos], maxbits + 1 - wt, span);
      pos += span;
    }
  }
  return used;
}

// one symbol of ``br`` while 64 bits remain: one load of the 8 bytes below
// ``pos``
inline uint8_t huff_fast(const HufTable& h, BackBits& br, const uint8_t* src) {
  const int64_t e = (br.pos + 7) >> 3;
  uint64_t w;
  std::memcpy(&w, src + e - 8, 8);
  const uint32_t v = uint32_t((w >> (br.pos - h.maxbits - (e - 8) * 8)) &
                              ((uint64_t(1) << h.maxbits) - 1));
  br.pos -= h.len[v];
  return h.sym[v];
}

// the symbols [i, n) of a stream, which must end exactly at its start
void huff_finish(const HufTable& h, BackBits& br, uint8_t* out, int64_t i, int64_t n) {
  for (; i < n && br.pos >= 64; ++i) out[i] = huff_fast(h, br, br.p);
  for (; i < n; ++i) {
    const uint32_t v = uint32_t(br.peek(h.maxbits));
    out[i] = h.sym[v];
    br.pos -= h.len[v];
  }
  if (br.pos != 0) corrupt("Huffman stream not consumed exactly");
}

// four streams in step (their decodes do not depend on each other), then
// each one's tail
void huff_four(const HufTable& h, const uint8_t* const src[4], const int64_t len[4],
               uint8_t* const out[4], const int64_t n[4]) {
  BackBits br[4] = {BackBits(src[0], len[0]), BackBits(src[1], len[1]),
                    BackBits(src[2], len[2]), BackBits(src[3], len[3])};
  const int64_t common = std::min(std::min(n[0], n[1]), std::min(n[2], n[3]));
  int64_t i = 0;
  for (; i < common; ++i) {
    if (br[0].pos < 64 || br[1].pos < 64 || br[2].pos < 64 || br[3].pos < 64) break;
    for (int k = 0; k < 4; ++k) out[k][i] = huff_fast(h, br[k], src[k]);
  }
  for (int k = 0; k < 4; ++k) huff_finish(h, br[k], out[k], i, n[k]);
}

// ------------------------------------------------------------- sequences

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1,  1,  1,  1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1,  1,  1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
constexpr int kLLMax = 35, kMLMax = 52, kOFMax = 31;

// the decoder's state carried from block to block within a frame
struct FrameState {
  HufTable huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint32_t rep[3] = {1, 4, 8};
};

const FseTable& predefined(int which) {
  static FseTable ll, of, ml;
  static bool built = [] {
    build_fse(ll, kLLDefault, 36, 6);
    build_fse(ml, kMLDefault, 53, 6);
    build_fse(of, kOFDefault, 29, 5);
    return true;
  }();
  (void)built;
  return which == 0 ? ll : which == 1 ? of : ml;
}

// one of the three table descriptions of a sequences section
size_t read_table(FseTable& t, bool& have, int mode, int which, int max_symbol, int max_log,
                  const uint8_t* src, size_t len) {
  switch (mode) {
    case 0:
      t = predefined(which);
      have = true;
      return 0;
    case 1:
      if (len < 1) corrupt("truncated RLE sequence table");
      if (src[0] > max_symbol) corrupt("RLE sequence code out of range");
      build_rle(t, src[0]);
      have = true;
      return 1;
    case 2: {
      int16_t norm[64];
      int nsym = 0, log = 0;
      const size_t used = read_ncount(norm, &nsym, max_symbol, max_log, src, len, &log);
      build_fse(t, norm, nsym, log);
      have = true;
      return used;
    }
    default:
      if (!have) corrupt("repeated sequence table with none before it");
      return 0;
  }
}

// ------------------------------------------------------------- one block

struct Out {
  uint8_t* base;
  int64_t cap;
  int64_t n = 0;
};

void decode_literals(FrameState& fs, const uint8_t* src, size_t len, std::vector<uint8_t>& lit,
                     size_t* used) {
  if (len < 1) corrupt("empty compressed block");
  const int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
  if (type < 2) {  // raw or RLE
    size_t hsize, size;
    if (fmt == 0 || fmt == 2) {
      hsize = 1;
      size = src[0] >> 3;
    } else if (fmt == 1) {
      if (len < 2) corrupt("truncated literals header");
      hsize = 2;
      size = rd16(src) >> 4;
    } else {
      if (len < 3) corrupt("truncated literals header");
      hsize = 3;
      size = rd24(src) >> 4;
    }
    if (size > size_t(kBlockMax)) corrupt("literals larger than a block");
    if (type == 0) {
      if (hsize + size > len) corrupt("truncated raw literals");
      lit.assign(src + hsize, src + hsize + size);
      *used = hsize + size;
    } else {
      if (hsize + 1 > len) corrupt("truncated RLE literals");
      lit.assign(size, src[hsize]);
      *used = hsize + 1;
    }
    return;
  }
  size_t hsize, regen, csize;
  bool single = fmt == 0;
  if (fmt < 2) {
    if (len < 3) corrupt("truncated literals header");
    const uint32_t v = rd24(src);
    hsize = 3;
    regen = (v >> 4) & 0x3FF;
    csize = (v >> 14) & 0x3FF;
  } else if (fmt == 2) {
    if (len < 4) corrupt("truncated literals header");
    const uint32_t v = rd32(src);
    hsize = 4;
    regen = (v >> 4) & 0x3FFF;
    csize = v >> 18;
  } else {
    if (len < 5) corrupt("truncated literals header");
    const uint64_t v = rd32(src) | (uint64_t(src[4]) << 32);
    hsize = 5;
    regen = (v >> 4) & 0x3FFFF;
    csize = (v >> 22) & 0x3FFFF;
  }
  if (regen > size_t(kBlockMax)) corrupt("literals larger than a block");
  if (hsize + csize > len) corrupt("truncated compressed literals");
  const uint8_t* p = src + hsize;
  size_t left = csize;
  if (type == 2) {
    const size_t t = read_huffman(fs.huf, p, left);
    fs.have_huf = true;
    p += t;
    left -= t;
  } else if (!fs.have_huf) {
    corrupt("treeless literals with no table before them");
  }
  lit.resize(regen);
  if (single) {
    BackBits br(p, int64_t(left));
    huff_finish(fs.huf, br, lit.data(), 0, int64_t(regen));
  } else {
    if (regen < 6 || left < 10) corrupt("four literal streams too short");
    const size_t s1 = rd16(p), s2 = rd16(p + 2), s3 = rd16(p + 4);
    if (6 + s1 + s2 + s3 > left) corrupt("literal jump table past its section");
    const size_t s4 = left - 6 - s1 - s2 - s3;
    const size_t q = (regen + 3) / 4;
    const uint8_t* d = p + 6;
    const uint8_t* const srcs[4] = {d, d + s1, d + s1 + s2, d + s1 + s2 + s3};
    const int64_t lens[4] = {int64_t(s1), int64_t(s2), int64_t(s3), int64_t(s4)};
    uint8_t* const outs[4] = {lit.data(), lit.data() + q, lit.data() + 2 * q, lit.data() + 3 * q};
    const int64_t ns[4] = {int64_t(q), int64_t(q), int64_t(q), int64_t(regen - 3 * q)};
    huff_four(fs.huf, srcs, lens, outs, ns);
  }
  *used = hsize + csize;
}

inline void copy_match(uint8_t* dst, int64_t pos, uint32_t off, uint32_t len) {
  uint8_t* d = dst + pos;
  const uint8_t* s = d - off;
  if (off >= len) {
    std::memcpy(d, s, len);
  } else {
    for (uint32_t i = 0; i < len; ++i) d[i] = s[i];  // overlapping: byte by byte
  }
}

void decode_block(FrameState& fs, const uint8_t* src, size_t len, Out& out) {
  std::vector<uint8_t> lit;
  size_t used = 0;
  decode_literals(fs, src, len, lit, &used);
  const uint8_t* p = src + used;
  size_t left = len - used;
  const int64_t block_start = out.n;
  if (left < 1) corrupt("compressed block without a sequences section");
  uint32_t nseq = p[0];
  size_t h = 1;
  if (nseq >= 128) {
    if (nseq < 255) {
      if (left < 2) corrupt("truncated sequences header");
      nseq = ((nseq - 128) << 8) + p[1];
      h = 2;
    } else {
      if (left < 3) corrupt("truncated sequences header");
      nseq = rd16(p + 1) + 0x7F00;
      h = 3;
    }
  }
  p += h;
  left -= h;
  size_t litpos = 0;
  if (nseq > 0) {
    if (left < 1) corrupt("truncated sequences header");
    const int modes = p[0];
    if (modes & 3) corrupt("reserved bits set in the sequence modes");
    p += 1;
    left -= 1;
    size_t t = read_table(fs.ll, fs.have_ll, modes >> 6, 0, kLLMax, 9, p, left);
    p += t, left -= t;
    t = read_table(fs.of, fs.have_of, (modes >> 4) & 3, 1, kOFMax, 8, p, left);
    p += t, left -= t;
    t = read_table(fs.ml, fs.have_ml, (modes >> 2) & 3, 2, kMLMax, 9, p, left);
    p += t, left -= t;
    BackBits br(p, int64_t(left));
    uint32_t sll = uint32_t(br.read(fs.ll.log));
    uint32_t sof = uint32_t(br.read(fs.of.log));
    uint32_t sml = uint32_t(br.read(fs.ml.log));
    for (uint32_t i = 0; i < nseq; ++i) {
      const int llc = fs.ll.t[sll].symbol, ofc = fs.of.t[sof].symbol,
                mlc = fs.ml.t[sml].symbol;
      if (llc > kLLMax || mlc > kMLMax || ofc > kOFMax) corrupt("sequence code out of range");
      const uint32_t offbase = (1u << ofc) + uint32_t(br.read(ofc));
      const uint32_t ml = kMLBase[mlc] + uint32_t(br.read(kMLBits[mlc]));
      const uint32_t ll = kLLBase[llc] + uint32_t(br.read(kLLBits[llc]));
      if (br.pos < 0) corrupt("sequences bitstream overrun");
      uint32_t off;
      uint32_t* rep = fs.rep;
      if (offbase > 3) {
        off = offbase - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      } else {
        const uint32_t idx = offbase - (ll == 0 ? 0 : 1);  // 0..3 into rep, 3 = rep0 - 1
        if (idx == 0) {
          off = rep[0];
        } else {
          off = idx == 3 ? rep[0] - 1 : rep[idx];
          if (off == 0) corrupt("repeat offset of 0");
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = off;
        }
      }
      if (ll > lit.size() - litpos) corrupt("sequence takes more literals than the block has");
      if (int64_t(ll) + ml > out.cap - out.n) corrupt("frame larger than its content size");
      std::memcpy(out.base + out.n, lit.data() + litpos, ll);
      litpos += ll;
      out.n += ll;
      if (off > out.n) corrupt("match offset before the start of the frame");
      copy_match(out.base, out.n, off, ml);
      out.n += ml;
      if (out.n - block_start > kBlockMax) corrupt("block larger than 128 KiB");
      if (i + 1 < nseq) {
        const FseEntry& el = fs.ll.t[sll];
        sll = el.base + uint32_t(br.read(el.bits));
        const FseEntry& em = fs.ml.t[sml];
        sml = em.base + uint32_t(br.read(em.bits));
        const FseEntry& eo = fs.of.t[sof];
        sof = eo.base + uint32_t(br.read(eo.bits));
        if (br.pos < 0) corrupt("sequences bitstream overrun");
      }
    }
    if (br.pos != 0) corrupt("sequences bitstream not consumed exactly");
  } else if (left != 0) {
    corrupt("bytes after a sequences section without sequences");
  }
  const size_t rest = lit.size() - litpos;
  if (int64_t(rest) > out.cap - out.n) corrupt("frame larger than its content size");
  std::memcpy(out.base + out.n, lit.data() + litpos, rest);
  out.n += rest;
  if (out.n - block_start > kBlockMax) corrupt("block larger than 128 KiB");
}

// ------------------------------------------------------------- one frame

struct Header {
  int64_t size = -1;   // content size, -1 when absent
  uint64_t window = 0;
  uint32_t dict = 0;
  bool checksum = false;
  size_t len = 0;      // header bytes, magic included
  bool skippable = false;
};

Header read_header(const uint8_t* src, size_t len) {
  Header h;
  if (len < 4) corrupt("too short for a frame header");
  const uint32_t magic = rd32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (len < 8) corrupt("truncated skippable frame header");
    h.skippable = true;
    h.size = rd32(src + 4);
    h.len = 8;
    return h;
  }
  if (magic != kMagic) corrupt("not a zstd frame");
  if (len < 5) corrupt("truncated frame header");
  const int fhd = src[4];
  const int fcs_flag = fhd >> 6, dict_flag = fhd & 3;
  const bool single = (fhd >> 5) & 1;
  if (fhd & 8) corrupt("reserved bit set in the frame header");
  h.checksum = (fhd >> 2) & 1;
  static const int kDictBytes[4] = {0, 1, 2, 4};
  static const int kFcsBytes[4] = {0, 2, 4, 8};
  const int fcs_bytes = fcs_flag == 0 && single ? 1 : kFcsBytes[fcs_flag];
  size_t need = 5 + (single ? 0 : 1) + kDictBytes[dict_flag] + fcs_bytes;
  if (len < need) corrupt("truncated frame header");
  size_t p = 5;
  if (!single) {
    const int wd = src[p++];
    const int wlog = 10 + (wd >> 3);
    if (wlog > 31) corrupt("window too large");
    const uint64_t base = uint64_t(1) << wlog;
    h.window = base + (base / 8) * (wd & 7);
  }
  for (int i = 0; i < kDictBytes[dict_flag]; ++i) h.dict |= uint32_t(src[p++]) << (8 * i);
  if (fcs_bytes == 1) h.size = src[p];
  else if (fcs_bytes == 2) h.size = int64_t(rd16(src + p)) + 256;
  else if (fcs_bytes == 4) h.size = rd32(src + p);
  else if (fcs_bytes == 8) {
    const uint64_t v = rd64(src + p);
    if (v > uint64_t(INT64_MAX)) corrupt("content size out of range");
    h.size = int64_t(v);
  }
  if (single) h.window = uint64_t(h.size);
  h.len = need;
  return h;
}

int64_t decompress_frame(const uint8_t* src, size_t len, uint8_t* dst, int64_t cap) {
  const Header h = read_header(src, len);
  if (h.skippable) corrupt("a skippable frame holds no content");
  if (h.dict) throw ZError{kDictionary, "frame needs a dictionary"};
  if (h.size < 0) corrupt("could not determine content size in frame header");
  if (h.size > cap) throw ZError{kTooSmall, "output buffer smaller than the content size"};
  FrameState fs;
  Out out{dst, h.size};
  // A compressed block may neither hold nor restore more than the block
  // maximum, min(window, 128 KiB), as libzstd refuses (libzstd restores up
  // to 64 bytes and the literals past it where its output buffer has room;
  // no encoder writes that). Raw and RLE blocks are bounded by the content
  // size alone: libzstd's one-shot decoder, the JAX reader's, takes them
  // at any size.
  const int64_t block_max = int64_t(std::min<uint64_t>(h.window, kBlockMax));
  size_t p = h.len;
  for (;;) {
    if (len - p < 3) corrupt("truncated block header");
    const uint32_t bh = rd24(src + p);
    p += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) corrupt("reserved block type");
    if (type == 1) {
      if (len - p < 1) corrupt("truncated RLE block");
      if (int64_t(size) > out.cap - out.n) corrupt("frame larger than its content size");
      std::memset(out.base + out.n, src[p], size);
      out.n += int64_t(size);
      p += 1;
    } else {
      if (len - p < size) corrupt("truncated block");
      if (type == 0) {
        if (int64_t(size) > out.cap - out.n) corrupt("frame larger than its content size");
        std::memcpy(out.base + out.n, src + p, size);
        out.n += int64_t(size);
      } else {
        if (int64_t(size) > block_max) corrupt("block larger than its maximum");
        const int64_t start = out.n;
        decode_block(fs, src + p, size, out);
        if (out.n - start > block_max) corrupt("block restores more than its maximum");
      }
      p += size;
    }
    if (last) break;
  }
  if (out.n != h.size) corrupt("frame shorter than its content size");
  if (h.checksum) {
    if (len - p < 4) corrupt("truncated checksum");
    if (uint32_t(xxh64(dst, size_t(out.n))) != rd32(src + p))
      corrupt("restored data does not match its checksum");
  }
  return out.n;
}

// =================================================================== encoder

// A forward bit writer for backward streams: bits go in LSB first; close()
// adds the end mark the reader starts from.
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int n = 0;

  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}

  void add(uint64_t v, int k) {  // k <= 32
    acc |= (v & ((uint64_t(1) << k) - 1)) << n;
    n += k;
    while (n >= 8) {
      out.push_back(uint8_t(acc));
      acc >>= 8;
      n -= 8;
    }
  }
  void close() {
    add(1, 1);
    if (n > 0) out.push_back(uint8_t(acc));
    acc = 0;
    n = 0;
  }
};

// --------------------------------------------------------- FSE encoding

struct FseEnc {
  int log = 0;
  std::vector<uint16_t> states;        // tableSize + position, by cumulated symbol
  std::vector<int32_t> find;           // deltaFindState per symbol
  std::vector<uint32_t> delta_bits;    // deltaNbBits per symbol
};

void build_fse_enc(FseEnc& e, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log, mask = size - 1;
  e.log = log;
  std::vector<uint8_t> table(size);
  std::vector<int> cumul(nsym + 1);
  int high = size - 1;
  cumul[0] = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      cumul[s + 1] = cumul[s] + 1;
      table[high--] = uint8_t(s);
    } else {
      cumul[s + 1] = cumul[s] + norm[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      table[pos] = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  e.states.assign(size, 0);
  for (int u = 0; u < size; ++u) e.states[cumul[table[u]]++] = uint16_t(size + u);
  e.find.assign(nsym, 0);
  e.delta_bits.assign(nsym, 0);
  int total = 0;
  for (int s = 0; s < nsym; ++s) {
    const int c = norm[s];
    if (c == 0) {
      e.delta_bits[s] = ((uint32_t(log) + 1) << 16) - uint32_t(size);
    } else if (c == -1 || c == 1) {
      e.delta_bits[s] = (uint32_t(log) << 16) - uint32_t(size);
      e.find[s] = total - 1;
      total += 1;
    } else {
      const uint32_t max_out = uint32_t(log - highbit(uint32_t(c - 1)));
      e.delta_bits[s] = (max_out << 16) - (uint32_t(c) << max_out);
      e.find[s] = total - c;
      total += c;
    }
  }
}

struct FseState {
  uint32_t value;
};

FseState fse_init(const FseEnc& e, int s) {
  const uint32_t nb = (e.delta_bits[s] + (1u << 15)) >> 16;
  const uint32_t v = (nb << 16) - e.delta_bits[s];
  return FseState{e.states[(v >> nb) + e.find[s]]};
}

void fse_encode(BitWriter& bw, const FseEnc& e, FseState& st, int s) {
  const uint32_t nb = (st.value + e.delta_bits[s]) >> 16;
  bw.add(st.value, int(nb));
  st.value = e.states[(st.value >> nb) + e.find[s]];
}

void fse_flush(BitWriter& bw, const FseEnc& e, const FseState& st) { bw.add(st.value, e.log); }

// counts -> normalized counts summing to 1 << log, every present symbol >= 1
void normalize(const uint32_t* count, int nsym, uint32_t total, int log, int16_t* norm) {
  const int size = 1 << log;
  int sum = 0, largest = -1;
  for (int s = 0; s < nsym; ++s) {
    if (!count[s]) {
      norm[s] = 0;
      continue;
    }
    int v = int((uint64_t(count[s]) * size + total / 2) / total);
    if (v < 1) v = 1;
    norm[s] = int16_t(v);
    sum += v;
    if (largest < 0 || count[s] > count[largest]) largest = s;
  }
  while (sum != size) {  // take the difference from the largest counts
    int best = -1;
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] <= 0 || (sum > size && norm[s] == 1)) continue;
      if (best < 0 || norm[s] > norm[best]) best = s;
    }
    if (best < 0) best = largest;
    const int d = sum > size ? -1 : 1;
    norm[best] = int16_t(norm[best] + d);
    sum += d;
  }
}

// the table description of ``norm`` (RFC 8878 4.1.1), appended to ``out``
void write_ncount(std::vector<uint8_t>& out, const int16_t* norm, int nsym, int log) {
  uint64_t acc = uint64_t(log - 5);
  int n = 4;
  auto add = [&](uint32_t v, int k) {
    acc |= uint64_t(v) << n;
    n += k;
    while (n >= 8) {
      out.push_back(uint8_t(acc));
      acc >>= 8;
      n -= 8;
    }
  };
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, s = 0;
  bool prev0 = false;
  while (remaining > 1 && s < nsym) {
    if (prev0) {
      int start = s;
      while (s < nsym && norm[s] == 0) ++s;
      while (s >= start + 3) {
        start += 3;
        add(3, 2);
      }
      add(uint32_t(s - start), 2);
    }
    const int c = norm[s++];
    const int max = 2 * threshold - 1 - remaining;
    uint32_t v = uint32_t(c + 1);
    if (int(v) >= threshold) v += uint32_t(max);
    add(v, int(v) < max ? nbits - 1 : nbits);
    remaining -= c < 0 ? -c : c;
    prev0 = c == 0;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
  }
  if (n > 0) out.push_back(uint8_t(acc));
}

int optimal_log(int max_log, size_t n, int max_symbol) {
  int log = max_log;
  const int from_src = n > 1 ? highbit(uint32_t(n - 1)) - 2 : 0;
  if (from_src < log) log = from_src;
  const int min_bits = std::min(highbit(uint32_t(std::max<size_t>(n, 1))) + 1,
                                highbit(uint32_t(std::max(max_symbol, 1))) + 2);
  if (min_bits > log) log = min_bits;
  return std::max(5, std::min(log, max_log));
}

// fractional-bit cost of coding ``count`` with ``norm`` (-1 = 1), or a huge
// number where a present symbol has no state
double table_cost(const uint32_t* count, int nsym, const int16_t* norm, int norm_nsym, int log) {
  double bits = 0;
  for (int s = 0; s < nsym; ++s) {
    if (!count[s]) continue;
    const int p = s < norm_nsym ? (norm[s] == -1 ? 1 : norm[s]) : 0;
    if (p <= 0) return 1e18;
    bits += count[s] * (log - __builtin_log2(double(p)));
  }
  return bits;
}

// ------------------------------------------------------ Huffman encoding

struct HufCode {
  int maxbits = 0;
  uint16_t code[256];
  uint8_t len[256];  // 0 = absent
};

// code lengths for ``count`` limited to 11 bits: a Huffman tree, then
// JPEG's bit-count adjustment (ITU T.81 K.3), which keeps the code complete
bool huff_lengths(const uint32_t* count, uint8_t* len) {
  struct Node {
    uint64_t w;
    int l, r, sym;
  };
  std::vector<Node> nodes;
  std::vector<int> leaves;
  for (int s = 0; s < 256; ++s) {
    len[s] = 0;
    if (count[s]) {
      nodes.push_back(Node{count[s], -1, -1, s});
      leaves.push_back(int(nodes.size()) - 1);
    }
  }
  if (leaves.size() < 2) return false;
  std::sort(leaves.begin(), leaves.end(), [&](int a, int b) {
    return nodes[a].w != nodes[b].w ? nodes[a].w < nodes[b].w : nodes[a].sym < nodes[b].sym;
  });
  std::vector<int> q2;
  size_t i1 = 0, i2 = 0;
  auto pop = [&]() {
    if (i1 < leaves.size() && (i2 >= q2.size() || nodes[leaves[i1]].w <= nodes[q2[i2]].w))
      return leaves[i1++];
    return q2[i2++];
  };
  while ((leaves.size() - i1) + (q2.size() - i2) > 1) {
    const int a = pop(), b = pop();
    nodes.push_back(Node{nodes[a].w + nodes[b].w, a, b, -1});
    q2.push_back(int(nodes.size()) - 1);
  }
  int bl_count[64] = {0};
  std::vector<std::pair<int, int>> stack{{q2.empty() ? leaves[0] : q2.back(), 0}};
  std::vector<int> depth(256, 0);
  while (!stack.empty()) {
    auto [id, d] = stack.back();
    stack.pop_back();
    if (nodes[id].sym >= 0) {
      depth[nodes[id].sym] = d;
      bl_count[d]++;
    } else {
      stack.push_back({nodes[id].l, d + 1});
      stack.push_back({nodes[id].r, d + 1});
    }
  }
  constexpr int kLimit = 11;
  for (int i = 63; i > kLimit; --i) {
    while (bl_count[i] > 0) {
      int j = i - 2;
      while (bl_count[j] == 0) --j;
      bl_count[i] -= 2;
      bl_count[i - 1] += 1;
      bl_count[j + 1] += 2;
      bl_count[j] -= 1;
    }
  }
  // the shortest codes to the most frequent symbols
  std::vector<int> order(leaves.size());
  for (size_t i = 0; i < leaves.size(); ++i) order[i] = nodes[leaves[i]].sym;
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    return count[a] != count[b] ? count[a] > count[b] : a < b;
  });
  size_t k = 0;
  for (int l = 1; l <= kLimit; ++l)
    for (int c = 0; c < bl_count[l]; ++c) len[order[k++]] = uint8_t(l);
  return true;
}

// canonical codes as the decoder assigns them from weights
void assign_codes(HufCode& h) {
  int maxbits = 0;
  for (int s = 0; s < 256; ++s) maxbits = std::max(maxbits, int(h.len[s]));
  h.maxbits = maxbits;
  uint32_t pos = 0;
  for (int wt = 1; wt <= maxbits; ++wt) {
    const int l = maxbits + 1 - wt;
    for (int s = 0; s < 256; ++s) {
      if (h.len[s] != l) continue;
      h.code[s] = uint16_t(pos >> (wt - 1));
      pos += 1u << (wt - 1);
    }
  }
}

// the tree description of ``h`` (direct or FSE-coded weights); false where
// neither fits
bool write_huffman_desc(std::vector<uint8_t>& out, const HufCode& h) {
  int last = 255;
  while (last > 0 && !h.len[last]) --last;
  const int nw = last;  // weights of symbols 0..last-1; the last is implied
  uint8_t w[256];
  for (int s = 0; s < nw; ++s) w[s] = h.len[s] ? uint8_t(h.maxbits + 1 - h.len[s]) : 0;
  std::vector<uint8_t> fse;
  uint32_t wcount[13] = {0};
  int distinct = 0, maxw = 0;
  for (int s = 0; s < nw; ++s) {
    distinct += wcount[w[s]]++ == 0;
    maxw = std::max(maxw, int(w[s]));
  }
  if (nw >= 2 && distinct >= 2) {
    const int log = optimal_log(6, size_t(nw), maxw);
    int16_t norm[13];
    normalize(wcount, maxw + 1, uint32_t(nw), log, norm);
    std::vector<uint8_t> body;
    write_ncount(body, norm, maxw + 1, log);
    FseEnc e;
    build_fse_enc(e, norm, maxw + 1, log);
    BitWriter bw(body);
    FseState s1, s2;
    int i = nw;
    if (nw & 1) {
      s1 = fse_init(e, w[--i]);
      s2 = fse_init(e, w[--i]);
      fse_encode(bw, e, s1, w[--i]);
    } else {
      s2 = fse_init(e, w[--i]);
      s1 = fse_init(e, w[--i]);
    }
    while (i > 0) {
      fse_encode(bw, e, s2, w[--i]);
      fse_encode(bw, e, s1, w[--i]);
    }
    fse_flush(bw, e, s2);
    fse_flush(bw, e, s1);
    bw.close();
    if (body.size() < 128) fse.swap(body);
  }
  const size_t direct = nw <= 128 ? 1 + size_t(nw + 1) / 2 : SIZE_MAX;
  if (fse.empty() && direct == SIZE_MAX) return false;
  if (!fse.empty() && 1 + fse.size() <= direct) {
    out.push_back(uint8_t(fse.size()));
    out.insert(out.end(), fse.begin(), fse.end());
  } else {
    out.push_back(uint8_t(127 + nw));
    for (int s = 0; s < nw; s += 2) out.push_back(uint8_t((w[s] << 4) | (s + 1 < nw ? w[s + 1] : 0)));
  }
  return true;
}

void huff_encode_stream(std::vector<uint8_t>& out, const HufCode& h, const uint8_t* src, size_t n) {
  const size_t at = out.size();
  out.resize(at + n * size_t(h.maxbits) / 8 + 16);
  uint8_t* p = out.data() + at;
  uint64_t acc = 0;
  int bits = 0;
  auto flush = [&]() {  // whole bytes out; 8 bytes of slack stay behind ``p``
    std::memcpy(p, &acc, 8);
    const int nb = bits >> 3;
    p += nb;
    acc = nb ? acc >> (8 * nb) : acc;
    bits &= 7;
  };
  size_t i = n;
  for (; i >= 4; i -= 4) {  // 4 codes of at most 11 bits between flushes
    for (int k = 1; k <= 4; ++k) {
      acc |= uint64_t(h.code[src[i - k]]) << bits;
      bits += h.len[src[i - k]];
    }
    flush();
  }
  while (i-- > 0) {
    acc |= uint64_t(h.code[src[i]]) << bits;
    bits += h.len[src[i]];
  }
  acc |= uint64_t(1) << bits;  // the end mark
  bits += 1;
  flush();
  if (bits) *p++ = uint8_t(acc);
  out.resize(size_t(p - out.data()));
}

// the encoder's state carried from block to block within a frame
struct EncState {
  HufCode huf;
  bool have_huf = false;
  uint32_t rep[3] = {1, 4, 8};
  // the previous block's sequence tables, for the repeat mode
  int16_t norm[3][64];
  int nsym[3] = {0, 0, 0};
  int log[3] = {0, 0, 0};
  int mode[3] = {-1, -1, -1};   // what the decoder holds: -1 nothing, else 0..2
  int rle[3] = {0, 0, 0};
};

void literals_header(std::vector<uint8_t>& out, int type, size_t regen, size_t csize, bool single) {
  if (type < 2) {
    if (regen < 32) {
      out.push_back(uint8_t(type | (regen << 3)));
    } else if (regen < 4096) {
      out.push_back(uint8_t(type | (1 << 2) | ((regen & 15) << 4)));
      out.push_back(uint8_t(regen >> 4));
    } else {
      out.push_back(uint8_t(type | (3 << 2) | ((regen & 15) << 4)));
      out.push_back(uint8_t(regen >> 4));
      out.push_back(uint8_t(regen >> 12));
    }
    return;
  }
  const size_t m = std::max(regen, csize);
  int fmt, bytes, bits;
  if (m < 1024) fmt = single ? 0 : 1, bytes = 3, bits = 10;
  else if (m < 16384) fmt = 2, bytes = 4, bits = 14;
  else fmt = 3, bytes = 5, bits = 18;
  const uint64_t v = uint64_t(type) | (uint64_t(fmt) << 2) | (uint64_t(regen) << 4) |
                     (uint64_t(csize) << (4 + bits));
  for (int i = 0; i < bytes; ++i) out.push_back(uint8_t(v >> (8 * i)));
}

// Huffman streams of ``lit`` under ``h``: jump table and 4 streams, or 1
void huff_streams(std::vector<uint8_t>& out, const HufCode& h, const uint8_t* lit, size_t n,
                  bool single) {
  if (single) {
    huff_encode_stream(out, h, lit, n);
    return;
  }
  const size_t q = (n + 3) / 4;
  const size_t at = out.size();
  out.resize(at + 6);
  size_t sizes[3];
  for (int i = 0; i < 4; ++i) {
    const size_t from = out.size();
    huff_encode_stream(out, h, lit + i * q, i < 3 ? q : n - 3 * q);
    if (i < 3) sizes[i] = out.size() - from;
  }
  for (int i = 0; i < 3; ++i) {
    if (sizes[i] > 0xFFFF) return;  // cannot happen within one block
    out[at + 2 * i] = uint8_t(sizes[i]);
    out[at + 2 * i + 1] = uint8_t(sizes[i] >> 8);
  }
}

void write_literals(std::vector<uint8_t>& out, EncState& st, const uint8_t* lit, size_t n) {
  auto raw = [&]() {
    literals_header(out, 0, n, 0, true);
    out.insert(out.end(), lit, lit + n);
  };
  if (n == 0) return raw();
  uint32_t count[256] = {0};
  for (size_t i = 0; i < n; ++i) count[lit[i]]++;
  if (count[lit[0]] == n) {
    literals_header(out, 1, n, 0, true);
    out.push_back(lit[0]);
    return;
  }
  if (n < 64) return raw();
  const bool single = n < 256;
  const size_t streams = single ? 1 : 10;  // end marks, and the jump table
  // a new table, or the previous one where it codes every symbol here:
  // whichever is smaller by the bits it would write
  HufCode code;
  std::vector<uint8_t> desc;
  size_t fresh = SIZE_MAX, kept = SIZE_MAX;
  if (huff_lengths(count, code.len)) {
    assign_codes(code);
    if (write_huffman_desc(desc, code)) {
      uint64_t bits = 0;
      for (int s = 0; s < 256; ++s) bits += uint64_t(count[s]) * code.len[s];
      fresh = desc.size() + bits / 8 + streams;
    }
  }
  if (st.have_huf) {
    uint64_t bits = 0;
    for (int s = 0; s < 256 && kept != 0; ++s) {
      if (count[s] && !st.huf.len[s]) kept = 0;
      bits += uint64_t(count[s]) * st.huf.len[s];
    }
    kept = kept == 0 ? SIZE_MAX : bits / 8 + streams;
  }
  if (std::min(fresh, kept) >= n) return raw();
  const bool reuse = kept < fresh;
  std::vector<uint8_t> body;
  if (!reuse) body.swap(desc);
  huff_streams(body, reuse ? st.huf : code, lit, n, single);
  if (body.size() + 5 >= n) return raw();
  literals_header(out, reuse ? 3 : 2, n, body.size(), single);
  out.insert(out.end(), body.begin(), body.end());
  if (!reuse) {
    st.huf = code;
    st.have_huf = true;
  }
}

struct Seq {
  uint32_t ll, ml, offbase;
};

inline int ll_code(uint32_t ll) {
  static const uint8_t kCode[64] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12,
                                    13, 14, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20,
                                    20, 20, 21, 21, 21, 21, 22, 22, 22, 22, 22, 22, 22,
                                    22, 23, 23, 23, 23, 23, 23, 23, 23, 24, 24, 24, 24,
                                    24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24};
  return ll > 63 ? highbit(ll) + 19 : kCode[ll];
}

inline int ml_code(uint32_t ml) {  // ml >= 3
  static const uint8_t kCode[128] = {
      0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
      22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 32, 33, 33, 34, 34, 35, 35, 36, 36, 36, 36,
      37, 37, 37, 37, 38, 38, 38, 38, 38, 38, 38, 38, 39, 39, 39, 39, 39, 39, 39, 39, 40, 40,
      40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 41, 41, 41, 41, 41, 41, 41, 41,
      41, 41, 41, 41, 41, 41, 41, 41, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42,
      42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42};
  const uint32_t m = ml - 3;
  return m > 127 ? highbit(m) + 36 : kCode[m];
}

// the sequences section of ``seqs`` appended to ``out``
void write_sequences(std::vector<uint8_t>& out, EncState& st, const std::vector<Seq>& seqs) {
  const size_t n = seqs.size();
  if (n < 128) {
    out.push_back(uint8_t(n));
  } else if (n < 0x7F00) {
    out.push_back(uint8_t((n >> 8) + 128));
    out.push_back(uint8_t(n));
  } else {
    out.push_back(255);
    out.push_back(uint8_t(n - 0x7F00));
    out.push_back(uint8_t((n - 0x7F00) >> 8));
  }
  if (n == 0) return;
  std::vector<uint8_t> codes[3];  // ll, of, ml
  for (int k = 0; k < 3; ++k) codes[k].resize(n);
  uint32_t count[3][64] = {{0}};
  for (size_t i = 0; i < n; ++i) {
    codes[0][i] = uint8_t(ll_code(seqs[i].ll));
    codes[1][i] = uint8_t(highbit(seqs[i].offbase));
    codes[2][i] = uint8_t(ml_code(seqs[i].ml));
    for (int k = 0; k < 3; ++k) count[k][codes[k][i]]++;
  }
  static const int kMaxSym[3] = {kLLMax, kOFMax, kMLMax};
  static const int kMaxLog[3] = {9, 8, 9};
  static const int16_t* kDefault[3] = {kLLDefault, kOFDefault, kMLDefault};
  static const int kDefaultN[3] = {36, 29, 53}, kDefaultLog[3] = {6, 5, 6};
  const size_t modes_at = out.size();
  out.push_back(0);
  int modes = 0;
  FseEnc enc[3];
  bool rle[3] = {false, false, false};
  for (int k = 0; k < 3; ++k) {
    int maxs = 0, distinct = 0;
    for (int s = 0; s <= kMaxSym[k]; ++s)
      if (count[k][s]) maxs = s, distinct++;
    // candidates: predefined, RLE, FSE-compressed, repeat
    double best = table_cost(count[k], maxs + 1, kDefault[k], kDefaultN[k], kDefaultLog[k]);
    int mode = 0;
    if (distinct == 1) {
      best = 8;
      mode = 1;
    }
    int16_t norm[64];
    std::vector<uint8_t> desc;
    const int log = optimal_log(kMaxLog[k], n, maxs);
    if (distinct > 1) {
      normalize(count[k], maxs + 1, uint32_t(n), log, norm);
      write_ncount(desc, norm, maxs + 1, log);
      const double c = 8.0 * desc.size() + table_cost(count[k], maxs + 1, norm, maxs + 1, log);
      if (c < best) best = c, mode = 2;
    }
    if (st.mode[k] >= 0) {
      double c;
      if (st.mode[k] == 1) c = distinct == 1 && count[k][st.rle[k]] ? 0 : 1e18;
      else c = table_cost(count[k], maxs + 1, st.norm[k], st.nsym[k], st.log[k]);
      if (c < best) best = c, mode = 3;
    }
    int held = mode == 3 ? st.mode[k] : mode;
    if (mode == 1) {
      out.push_back(uint8_t(maxs));
      st.rle[k] = maxs;
    } else if (mode == 2) {
      out.insert(out.end(), desc.begin(), desc.end());
      std::memcpy(st.norm[k], norm, sizeof(int16_t) * (maxs + 1));
      st.nsym[k] = maxs + 1;
      st.log[k] = log;
    } else if (mode == 0) {
      std::memcpy(st.norm[k], kDefault[k], sizeof(int16_t) * kDefaultN[k]);
      st.nsym[k] = kDefaultN[k];
      st.log[k] = kDefaultLog[k];
    }
    st.mode[k] = held;
    rle[k] = held == 1;
    if (!rle[k]) build_fse_enc(enc[k], st.norm[k], st.nsym[k], st.log[k]);
    modes |= mode << (6 - 2 * k);
  }
  out[modes_at] = uint8_t(modes);
  BitWriter bw(out);
  FseState s[3] = {{0}, {0}, {0}};
  const size_t last = n - 1;
  for (int k : {2, 1, 0})
    if (!rle[k]) s[k] = fse_init(enc[k], codes[k][last]);
  auto extra = [&](size_t i) {
    const Seq& q = seqs[i];
    const int llc = codes[0][i], ofc = codes[1][i], mlc = codes[2][i];
    bw.add(q.ll - kLLBase[llc], kLLBits[llc]);
    bw.add(q.ml - kMLBase[mlc], kMLBits[mlc]);
    bw.add(q.offbase - (1u << ofc), ofc);
  };
  extra(last);
  for (size_t i = last; i-- > 0;) {
    for (int k : {1, 2, 0})
      if (!rle[k]) fse_encode(bw, enc[k], s[k], codes[k][i]);
    extra(i);
  }
  for (int k : {2, 1, 0})
    if (!rle[k]) fse_flush(bw, enc[k], s[k]);
  bw.close();
}

// ------------------------------------------------------------ the matcher

// kDepth: candidates tried a position (libzstd level 3's ratio on tensors)
constexpr int kHashLog = 17, kChainLog = 16, kMinMatch = 5, kDepth = 2;
constexpr uint32_t kMaxOffset = 1u << 22;

struct Matcher {
  const uint8_t* base;
  int hash_log, chain_mask;
  std::vector<int32_t> head, chain;

  // tables sized to the input (at most kHashLog / kChainLog bits), so a
  // small frame does not pay for clearing the large ones
  Matcher(const uint8_t* b, int64_t n)
      : base(b),
        hash_log(std::max(8, std::min(kHashLog, highbit(uint32_t(std::max<int64_t>(
                                          std::min<int64_t>(n, 1 << 30), 1))) + 1))),
        chain_mask((1 << std::min(kChainLog, hash_log)) - 1),
        head(size_t(1) << hash_log, -1),
        chain(size_t(chain_mask) + 1, -1) {}

  uint32_t hash(const uint8_t* p) const {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return uint32_t(((v << 24) * 889523592379ull) >> (64 - hash_log));  // 5 bytes
  }
  // the newest earlier position with the hash of ``pos``, before ``pos``
  // takes its place (positions are inserted where the parse looks and
  // inside the matches it takes, not where it steps over literals)
  int32_t insert(int64_t pos) {
    const uint32_t h = hash(base + pos);
    const int32_t prev = head[h];
    chain[pos & chain_mask] = prev;
    head[h] = int32_t(pos);
    return prev;
  }
};

inline uint32_t match_len(const uint8_t* a, const uint8_t* b, const uint8_t* end) {
  const uint8_t* s = a;
  while (a + 8 <= end) {
    uint64_t x, y;
    std::memcpy(&x, a, 8);
    std::memcpy(&y, b, 8);
    if (x != y) return uint32_t(a - s) + (__builtin_ctzll(x ^ y) >> 3);
    a += 8;
    b += 8;
  }
  while (a < end && *a == *b) ++a, ++b;
  return uint32_t(a - s);
}

// the offset code of a match at ``off`` after ``ll`` literals, and the
// repeat offsets the decoder holds after it
uint32_t offbase_for(uint32_t* rep, uint32_t off, uint32_t ll) {
  uint32_t ob;
  if (ll > 0) ob = off == rep[0] ? 1 : off == rep[1] ? 2 : off == rep[2] ? 3 : off + 3;
  else ob = off == rep[1] ? 1 : off == rep[2] ? 2 : off == rep[0] - 1 ? 3 : off + 3;
  if (ob > 3) {
    rep[2] = rep[1];
    rep[1] = rep[0];
    rep[0] = off;
  } else {
    const uint32_t idx = ob - (ll == 0 ? 0 : 1);
    if (idx != 0) {
      const uint32_t v = idx == 3 ? rep[0] - 1 : rep[idx];
      if (idx != 1) rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = v;
    }
  }
  return ob;
}

// greedy parse of [start, end): the sequences, and the literals they leave
void parse(Matcher& m, EncState& st, int64_t start, int64_t end,
           std::vector<Seq>& seqs, std::vector<uint8_t>& lit) {
  const uint8_t* b = m.base;
  int64_t ip = start, anchor = start;
  uint32_t rep[3] = {st.rep[0], st.rep[1], st.rep[2]};
  const int64_t limit = end - 8;  // the hash reads 8 bytes
  // what each byte costs as a literal here (its order-0 code length in
  // this block, in bits): a match is taken only where the literals it
  // saves cost more than its sequence (its offset's bits, and about 8 for
  // the three codes)
  float lit_bits[256];
  {
    uint32_t count[256] = {0};
    for (int64_t i = start; i < end; ++i) count[b[i]]++;
    const double n = double(end - start);
    for (int c = 0; c < 256; ++c)
      lit_bits[c] = count[c] ? float(-__builtin_log2(count[c] / n)) : 8.0f;
  }
  auto worth = [&](uint32_t len, uint32_t off) {
    const double cost = (off == rep[0] ? 2.0 : double(highbit(off + 3))) + 8.0;
    double saved = 0;
    for (uint32_t k = 0; k < len && saved <= cost; ++k) saved += lit_bits[b[ip + k]];
    return saved > cost;
  };
  while (ip < limit) {
    uint32_t best_len = 0, best_off = 0;
    // the last offset first: runs of zeros and strided repeats
    if (ip - anchor > 0 && int64_t(rep[0]) <= ip) {
      const uint32_t l = match_len(b + ip, b + ip - rep[0], b + end);
      if (l >= 4 && worth(l, rep[0])) best_len = l, best_off = rep[0];
    }
    if (best_len < 32) {
      int32_t cand = m.insert(ip);
      for (int d = 0; d < kDepth && cand >= 0; ++d) {
        const uint32_t off = uint32_t(ip - cand);
        if (off > kMaxOffset) break;
        const uint32_t l = match_len(b + ip, b + cand, b + end);
        if (l >= kMinMatch && l > best_len && worth(l, off)) best_len = l, best_off = off;
        const int32_t nxt = m.chain[cand & m.chain_mask];
        if (nxt >= cand) break;
        cand = nxt;
      }
    }
    if (best_len == 0) {
      ip += ((ip - anchor) >> 8) + 1;  // step faster through data that does not match
      continue;
    }
    // extend backwards over literals that also match
    while (ip > anchor && int64_t(best_off) < ip && b[ip - 1] == b[ip - 1 - best_off]) {
      --ip;
      ++best_len;
    }
    const uint32_t ll = uint32_t(ip - anchor);
    lit.insert(lit.end(), b + anchor, b + ip);
    seqs.push_back(Seq{ll, best_len, offbase_for(rep, best_off, ll)});
    for (int64_t p = ip + 1; p < ip + best_len && p < limit; ++p) m.insert(p);
    ip += best_len;
    anchor = ip;
  }
  lit.insert(lit.end(), b + anchor, b + end);
  std::memcpy(st.rep, rep, sizeof rep);
}

void put_block_header(std::vector<uint8_t>& out, bool last, int type, size_t size) {
  const uint32_t v = uint32_t(last) | (uint32_t(type) << 1) | (uint32_t(size) << 3);
  out.push_back(uint8_t(v));
  out.push_back(uint8_t(v >> 8));
  out.push_back(uint8_t(v >> 16));
}

void compress_frame(const uint8_t* src, int64_t n, std::vector<uint8_t>& out) {
  out.clear();
  for (int i = 0; i < 4; ++i) out.push_back(uint8_t(kMagic >> (8 * i)));
  // single segment, content size in the fewest bytes
  if (n < 256) {
    out.push_back(0x20);
    out.push_back(uint8_t(n));
  } else if (n < 65536 + 256) {
    out.push_back(0x60);
    const uint32_t v = uint32_t(n - 256);
    out.push_back(uint8_t(v));
    out.push_back(uint8_t(v >> 8));
  } else if (n <= 0xFFFFFFFFll) {
    out.push_back(0xA0);
    for (int i = 0; i < 4; ++i) out.push_back(uint8_t(uint64_t(n) >> (8 * i)));
  } else {
    out.push_back(0xE0);
    for (int i = 0; i < 8; ++i) out.push_back(uint8_t(uint64_t(n) >> (8 * i)));
  }
  if (n == 0) {
    put_block_header(out, true, 0, 0);
    return;
  }
  Matcher m(src, n);
  EncState st;
  std::vector<Seq> seqs;
  std::vector<uint8_t> lit, body;
  for (int64_t at = 0; at < n; at += kBlockMax) {
    const int64_t end = std::min<int64_t>(n, at + kBlockMax);
    const size_t size = size_t(end - at);
    const bool last = end == n;
    bool same = true;
    for (size_t i = 1; i < size && same; ++i) same = src[at + i] == src[at];
    if (same && size > 1) {
      put_block_header(out, last, 1, size);
      out.push_back(src[at]);
      continue;
    }
    // compress into ``body`` on a copy of the state; keep it only if smaller
    EncState trial = st;
    seqs.clear();
    lit.clear();
    body.clear();
    if (end <= INT32_MAX) {
      parse(m, trial, at, end, seqs, lit);
    } else {
      lit.assign(src + at, src + end);  // the tables hold 31-bit positions
    }
    write_literals(body, trial, lit.data(), lit.size());
    write_sequences(body, trial, seqs);
    if (body.size() < size) {
      put_block_header(out, last, 2, body.size());
      out.insert(out.end(), body.begin(), body.end());
      st = trial;
    } else {
      put_block_header(out, last, 0, size);
      out.insert(out.end(), src + at, src + end);
      // the decoder's repeat offsets move only with compressed blocks;
      // its tables likewise stay as they were
    }
  }
}

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// the first frame of ``src`` into ``dst`` (``cap`` bytes, at least the
// frame's content size); the bytes written, or a negative code
int64_t zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, char* err,
                        int errlen) {
  try {
    return decompress_frame(src, size_t(n), dst, cap);
  } catch (const ZError& e) {
    set_err(err, errlen, e.msg);
    return e.code;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
    return kCorrupt;
  }
}

// a bound on the size of zstd_compress's frame for ``n`` bytes
int64_t zstd_compress_bound(int64_t n) { return n + (n >> 7) + 64; }

// one frame of ``src`` into ``dst`` (``cap`` >= zstd_compress_bound(n));
// the frame's size, or a negative code
int64_t zstd_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, char* err,
                      int errlen) {
  try {
    std::vector<uint8_t> out;
    out.reserve(size_t(zstd_compress_bound(n)));
    compress_frame(src, n, out);
    if (int64_t(out.size()) > cap) throw ZError{kTooSmall, "output buffer too small"};
    std::memcpy(dst, out.data(), out.size());
    return int64_t(out.size());
  } catch (const ZError& e) {
    set_err(err, errlen, e.msg);
    return e.code;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
    return kCorrupt;
  }
}

}  // extern "C"
