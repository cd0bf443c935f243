// Host image codecs of the port: a baseline and progressive JPEG decoder,
// Pillow's bicubic resize, and the PNG row unfilter.
//
// Each function matches a reference bit for bit and has a plain numpy
// version beside it in ``utils/`` that the tests hold it to:
//
// - jpeg_decode_rgb: libjpeg-turbo's default decompression path as Pillow
//   drives it (``utils/jpeg.py``): the islow IDCT (jidctint.c) with its
//   range limit, fancy upsampling (jdsample.c h2v1 / h2v2 / h1v2, box
//   upsampling where libjpeg takes it), and the fixed-point YCbCr->RGB
//   tables (jdcolor.c). Grey is repeated to three channels.
// - resize_bicubic_rgb: Pillow's Resample.c BICUBIC (a = -0.5) for RGB u8,
//   22-bit fixed-point coefficients, horizontal pass first over only the
//   rows the vertical pass reads (``utils/resize.py``).
// - png_unfilter: the five PNG row filters (``utils/png.py``).
//
// The C ABI takes caller-owned buffers (numpy arrays over ctypes) and
// returns 0, or a negative code with a message in ``err``:
// -1 a JPEG this decoder does not take, -2 a corrupt or truncated file.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <string>
#include <vector>

namespace {

constexpr int kUnsupported = -1;
constexpr int kCorrupt = -2;

struct CodecError {
  int code;
  std::string msg;
};

[[noreturn]] void unsupported(const std::string& m) { throw CodecError{kUnsupported, m}; }
[[noreturn]] void corrupt(const std::string& m) { throw CodecError{kCorrupt, m}; }

// zigzag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Pillow's decompression-bomb error threshold (2 * MAX_IMAGE_PIXELS)
constexpr int64_t kMaxPixels = 178956970;

struct Huffman {
  bool defined = false;
  uint8_t fast_len[512];   // 9-bit lookahead: code length (0 = slow path)
  uint8_t fast_val[512];
  int32_t maxcode[18];     // largest code of each length, -1 if none
  int32_t valoffset[17];   // value index = code + valoffset[len]
  uint8_t vals[256];
};

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals, int nvals) {
  std::memset(h.fast_len, 0, sizeof(h.fast_len));
  std::memcpy(h.vals, vals, nvals);
  int32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    h.valoffset[len] = k - code;
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      // refuse a table that breaks the Kraft inequality before a code of
      // len bits can index past the lookahead tables
      if (code >= (1 << len)) corrupt("bogus Huffman table");
      if (len <= 9) {
        int shift = 9 - len;
        for (int j = 0; j < (1 << shift); ++j) {
          h.fast_len[(code << shift) | j] = static_cast<uint8_t>(len);
          h.fast_val[(code << shift) | j] = vals[k];
        }
      }
    }
    if (code >= (1 << len)) corrupt("bogus Huffman table");  // no all-ones code
    h.maxcode[len] = counts[len - 1] ? code - 1 : -1;
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  h.defined = true;
}

struct FreeDeleter {
  void operator()(void* p) const { std::free(p); }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // blocks the component's own samples need
  int stride_blocks = 0;       // blocks a row in storage (MCU-padded)
  int rows_blocks = 0;
  int width = 0, height = 0;   // downsampled size in samples
  bool quant_latched = false;
  int32_t quant[64];           // natural order
  // a file of several scans only: rows_blocks * stride_blocks * 64,
  // natural order, calloc'd so pages no scan reaches stay untouched
  std::unique_ptr<int16_t[], FreeDeleter> coefs;
  std::unique_ptr<uint8_t[]> plane;  // the IDCT's samples, pstride * bh * 8
  int pstride = 0;
  int coef_bits[64];           // libjpeg's progression state, zigzag order
  int dc_pred = 0;
  int dc_tbl = 0, ac_tbl = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}

  size_t pos() const { return pos_; }

  uint32_t peek(int k) {
    if (nbits_ < k) fill();
    return static_cast<uint32_t>(acc_ >> (64 - k));
  }
  void skip(int k) {
    acc_ <<= k;
    nbits_ -= k;
    if (nbits_ < zero_bits_) corrupt("entropy data runs past its segment");
  }
  uint32_t bits(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  int receive_extend(int s) {
    if (s == 0) return 0;
    if (s > 16) corrupt("bad coefficient size");
    int v = static_cast<int>(bits(s));
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
  int decode(const Huffman& h) {
    uint32_t look = peek(9);
    int len = h.fast_len[look];
    if (len) {
      skip(len);
      return h.fast_val[look];
    }
    uint32_t code16 = peek(16);
    for (len = 10; len <= 16; ++len) {
      int32_t code = static_cast<int32_t>(code16 >> (16 - len));
      if (code <= h.maxcode[len]) {
        int idx = code + h.valoffset[len];
        if (idx < 0 || idx > 255) corrupt("bad Huffman code");
        skip(len);
        return h.vals[idx];
      }
    }
    corrupt("bad Huffman code");
  }
  // end of an entropy-coded segment: drop the padding bits, stand at the
  // marker that follows
  void reset() {
    acc_ = 0;
    nbits_ = 0;
    zero_bits_ = 0;
    at_marker_ = false;
  }

 private:
  void fill() {
    while (nbits_ <= 56) {
      uint32_t byte = 0;
      if (!at_marker_ && pos_ < n_) {
        byte = d_[pos_];
        if (byte == 0xFF) {
          if (pos_ + 1 < n_ && d_[pos_ + 1] == 0x00) {
            pos_ += 2;
          } else {
            at_marker_ = true;
            byte = 0;
          }
        } else {
          ++pos_;
        }
      } else {
        at_marker_ = true;
      }
      if (at_marker_) zero_bits_ += 8;
      acc_ |= static_cast<uint64_t>(byte) << (56 - nbits_);
      nbits_ += 8;
    }
  }

  const uint8_t* d_;
  size_t n_;
  size_t pos_;
  uint64_t acc_ = 0;
  int nbits_ = 0;
  int zero_bits_ = 0;  // bits made up past a marker: consuming one is a fault
  bool at_marker_ = false;
};

// -- the islow IDCT (libjpeg-turbo jidctint.c) -------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// the post-IDCT range limit: (x & 1023) through libjpeg's table, level
// shift included
uint8_t g_idct_limit[1024];

void init_idct_limit() {
  for (int t = 0; t < 1024; ++t) {
    int v;
    if (t < 128) v = t + 128;
    else if (t < 512) v = 255;
    else if (t < 896) v = 0;
    else v = t - 896;
    g_idct_limit[t] = static_cast<uint8_t>(v);
  }
}

void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int32_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = int(int64_t(ip[0]) * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    wp[0] = int(descale(tmp10 + tmp3, n));
    wp[56] = int(descale(tmp10 - tmp3, n));
    wp[8] = int(descale(tmp11 + tmp2, n));
    wp[48] = int(descale(tmp11 - tmp2, n));
    wp[16] = int(descale(tmp12 + tmp1, n));
    wp[40] = int(descale(tmp12 - tmp1, n));
    wp[24] = int(descale(tmp13 + tmp0, n));
    wp[32] = int(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t dc = g_idct_limit[int(descale(wp[0], kPass1Bits + 3)) & 1023];
      std::memset(op, dc, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    op[0] = g_idct_limit[int(descale(tmp10 + tmp3, n)) & 1023];
    op[7] = g_idct_limit[int(descale(tmp10 - tmp3, n)) & 1023];
    op[1] = g_idct_limit[int(descale(tmp11 + tmp2, n)) & 1023];
    op[6] = g_idct_limit[int(descale(tmp11 - tmp2, n)) & 1023];
    op[2] = g_idct_limit[int(descale(tmp12 + tmp1, n)) & 1023];
    op[5] = g_idct_limit[int(descale(tmp12 - tmp1, n)) & 1023];
    op[3] = g_idct_limit[int(descale(tmp13 + tmp0, n)) & 1023];
    op[4] = g_idct_limit[int(descale(tmp13 - tmp0, n)) & 1023];
  }
}

// -- YCbCr -> RGB (libjpeg-turbo jdcolor.c build_ycc_rgb_table) --------------

int32_t g_cr_r[256], g_cb_b[256];
int64_t g_cr_g[256], g_cb_g[256];

void init_color_tables() {
  const int kScale = 16;
  const int64_t half = int64_t(1) << (kScale - 1);
  auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
  for (int i = 0, x = -128; i < 256; ++i, ++x) {
    g_cr_r[i] = int32_t((fix(1.40200) * x + half) >> kScale);
    g_cb_b[i] = int32_t((fix(1.77200) * x + half) >> kScale);
    g_cr_g[i] = -fix(0.71414) * x;
    g_cb_g[i] = -fix(0.34414) * x + half;
  }
}

struct Tables {
  Tables() {
    init_idct_limit();
    init_color_tables();
  }
};
const Tables g_tables;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// -- the decoder --------------------------------------------------------------

class JpegDecoder {
 public:
  JpegDecoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  void read_header();
  void decode(uint8_t* out);

  int width = 0, height = 0, ncomp = 0;

 private:
  uint16_t u16(size_t at) const {
    if (at + 2 > n_) corrupt("truncated file");
    return static_cast<uint16_t>((d_[at] << 8) | d_[at + 1]);
  }
  int next_marker();
  void read_sof(int marker, size_t at, int len);
  void read_dqt(size_t at, int len);
  void read_dht(size_t at, int len);
  void read_sos(size_t at, int len);
  int64_t scan_blocks() const;
  void decode_scan(BitReader& br);
  void decode_block_baseline(BitReader& br, Component& c, int16_t* blk);
  void decode_dc_first(BitReader& br, Component& c, int16_t* blk);
  void decode_dc_refine(BitReader& br, int16_t* blk);
  void decode_ac_first(BitReader& br, Component& c, int16_t* blk);
  void decode_ac_refine(BitReader& br, Component& c, int16_t* blk);
  void output(uint8_t* out);
  static void alloc_plane(Component& c);

  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  bool seen_sof_ = false, progressive_ = false;
  // libjpeg's !has_multiple_scans: a sequential file whose first scan holds
  // every component is decoded block by block straight into the planes
  bool single_scan_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0;
  int32_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  Component comp_[4];
  // the current scan
  int ns_ = 0, scomp_[4] = {0, 0, 0, 0}, ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  int eobrun_ = 0;
};

int JpegDecoder::next_marker() {
  // skip to the next 0xFF <code>, over fill bytes
  while (pos_ < n_) {
    if (d_[pos_] != 0xFF) {
      ++pos_;
      continue;
    }
    size_t p = pos_ + 1;
    while (p < n_ && d_[p] == 0xFF) ++p;
    if (p >= n_) break;
    if (d_[p] == 0x00) {  // a stuffed byte: not a marker
      pos_ = p + 1;
      continue;
    }
    pos_ = p + 1;
    return d_[p];
  }
  corrupt("truncated file: no EOI marker");
}

void JpegDecoder::read_header() {
  if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) corrupt("not a JPEG file (no SOI marker)");
  pos_ = 2;
  for (;;) {
    int m = next_marker();
    if (m == 0xD8) corrupt("a second SOI marker");
    if (m == 0xD9) corrupt("EOI before the first scan");
    if (m >= 0xD0 && m <= 0xD7) continue;
    if (m == 0x01) continue;  // TEM
    int len = u16(pos_);
    if (len < 2 || pos_ + len > n_) corrupt("truncated marker segment");
    size_t at = pos_ + 2;
    int body = len - 2;
    pos_ += len;
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2:
        read_sof(m, at, body);
        break;
      case 0xC3: unsupported("lossless JPEG (SOF3)");
      case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
        unsupported("hierarchical (differential) JPEG");
      case 0xC9: case 0xCA: case 0xCB: unsupported("arithmetic-coded JPEG");
      case 0xCC: unsupported("arithmetic-coded JPEG (DAC marker)");
      case 0xDE: unsupported("hierarchical JPEG (DHP marker)");
      case 0xC4: read_dht(at, body); break;
      case 0xDB: read_dqt(at, body); break;
      case 0xDD:
        if (body < 2) corrupt("short DRI segment");
        restart_interval_ = u16(at);
        break;
      case 0xE0:
        if (body >= 14 && std::memcmp(d_ + at, "JFIF\0", 5) == 0) jfif_ = true;
        break;
      case 0xEE:
        if (body >= 12 && std::memcmp(d_ + at, "Adobe", 5) == 0) {
          adobe_ = true;
          adobe_transform_ = d_[at + 11];
        }
        break;
      case 0xDA:
        if (!seen_sof_) corrupt("SOS before SOF");
        read_sos(at, body);
        // every block of the first scan takes at least one bit: refuse a
        // file too short for its declared size before any image buffer
        if (scan_blocks() > 8 * int64_t(n_ - pos_))
          corrupt("truncated file: too little entropy data for the image size");
        return;
      default:
        break;  // APPn, COM, DNL and the rest carry nothing we read
    }
  }
}

void JpegDecoder::read_sof(int marker, size_t at, int len) {
  if (seen_sof_) corrupt("a second SOF marker");
  if (len < 6) corrupt("short SOF segment");
  int precision = d_[at];
  height = u16(at + 1);
  width = u16(at + 3);
  ncomp = d_[at + 5];
  if (precision != 8) unsupported(std::to_string(precision) + "-bit JPEG");
  if (ncomp == 4) unsupported("4-component (CMYK / YCCK) JPEG");
  if (ncomp != 1 && ncomp != 3) unsupported(std::to_string(ncomp) + "-component JPEG");
  if (height == 0) unsupported("JPEG whose height comes in a DNL marker");
  if (width == 0) corrupt("zero image width");
  if (int64_t(width) * height > kMaxPixels) unsupported("JPEG larger than 178956970 pixels");
  if (len < 6 + 3 * ncomp) corrupt("short SOF segment");
  progressive_ = marker == 0xC2;
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp_[i];
    c.id = d_[at + 6 + 3 * i];
    c.h = d_[at + 7 + 3 * i] >> 4;
    c.v = d_[at + 7 + 3 * i] & 15;
    c.tq = d_[at + 8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) corrupt("bad sampling factors");
    if (c.tq > 3) corrupt("bad quantisation table number");
    hmax_ = std::max(hmax_, c.h);
    vmax_ = std::max(vmax_, c.v);
  }
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp_[i];
    if (hmax_ % c.h || vmax_ % c.v) unsupported("JPEG with fractional sampling factors");
  }
  mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
  mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp_[i];
    c.width = int((int64_t(width) * c.h + hmax_ - 1) / hmax_);
    c.height = int((int64_t(height) * c.v + vmax_ - 1) / vmax_);
    c.bw = (c.width + 7) / 8;
    c.bh = (c.height + 7) / 8;
    c.stride_blocks = mcux_ * c.h;
    c.rows_blocks = mcuy_ * c.v;
    for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
  }
  seen_sof_ = true;
}

void JpegDecoder::read_dqt(size_t at, int len) {
  size_t end = at + len;
  while (at < end) {
    int pq = d_[at] >> 4, tq = d_[at] & 15;
    if (tq > 3 || pq > 1) corrupt("bad DQT table");
    ++at;
    size_t need = pq ? 128 : 64;
    if (at + need > end) corrupt("short DQT segment");
    for (int k = 0; k < 64; ++k) {
      int v = pq ? (d_[at + 2 * k] << 8) | d_[at + 2 * k + 1] : d_[at + k];
      qt_[tq][kNatural[k]] = v;
    }
    qt_defined_[tq] = true;
    at += need;
  }
}

void JpegDecoder::read_dht(size_t at, int len) {
  size_t end = at + len;
  while (at < end) {
    if (at + 17 > end) corrupt("short DHT segment");
    int tc = d_[at] >> 4, th = d_[at] & 15;
    if (tc > 1 || th > 3) corrupt("bad DHT table");
    const uint8_t* counts = d_ + at + 1;
    int total = 0;
    for (int i = 0; i < 16; ++i) total += counts[i];
    if (total > 256 || at + 17 + total > end) corrupt("bad DHT table");
    build_huffman(tc ? ac_[th] : dc_[th], counts, d_ + at + 17, total);
    at += 17 + total;
  }
}

void JpegDecoder::read_sos(size_t at, int len) {
  if (len < 1) corrupt("short SOS segment");
  ns_ = d_[at];
  if (ns_ < 1 || ns_ > 4 || len < 4 + 2 * ns_) corrupt("bad SOS segment");
  for (int i = 0; i < ns_; ++i) {
    int cid = d_[at + 1 + 2 * i], tables = d_[at + 2 + 2 * i];
    int ci = -1;
    for (int j = 0; j < ncomp; ++j)
      if (comp_[j].id == cid) ci = j;
    if (ci < 0) corrupt("SOS names an unknown component");
    for (int j = 0; j < i; ++j)
      if (scomp_[j] == ci) corrupt("SOS names a component twice");
    scomp_[i] = ci;
    comp_[ci].dc_tbl = tables >> 4;
    comp_[ci].ac_tbl = tables & 15;
    if (comp_[ci].dc_tbl > 3 || comp_[ci].ac_tbl > 3) corrupt("bad Huffman table number");
  }
  size_t p = at + 1 + 2 * ns_;
  ss_ = d_[p];
  se_ = d_[p + 1];
  ah_ = d_[p + 2] >> 4;
  al_ = d_[p + 2] & 15;
  if (progressive_) {
    bool bad = ss_ == 0 ? se_ != 0 : (se_ < ss_ || se_ > 63 || ns_ != 1);
    if (bad || ah_ > 13 || al_ > 13) corrupt("bad progressive scan parameters");
  } else {
    ss_ = 0;
    se_ = 63;  // libjpeg ignores them in a sequential file
    ah_ = al_ = 0;
  }
  for (int i = 0; i < ns_; ++i) {
    Component& c = comp_[scomp_[i]];
    // libjpeg latches a component's quantisation table at its first scan
    if (!c.quant_latched) {
      if (!qt_defined_[c.tq]) corrupt("a scan uses an undefined quantisation table");
      std::memcpy(c.quant, qt_[c.tq], sizeof(c.quant));
      c.quant_latched = true;
    }
    bool need_dc = !progressive_ || (ss_ == 0 && ah_ == 0);
    bool need_ac = !progressive_ || ss_ > 0;
    if ((need_dc && !dc_[c.dc_tbl].defined) || (need_ac && !ac_[c.ac_tbl].defined))
      corrupt("a scan uses an undefined Huffman table");
    if (progressive_) {
      // libjpeg warns of a bogus progression and goes on; this decoder refuses
      for (int k = ss_; k <= se_; ++k) {
        if (ah_ != std::max(c.coef_bits[k], 0)) corrupt("bogus progression");
        c.coef_bits[k] = al_;
      }
    }
  }
  if (progressive_ && ss_ > 0 && comp_[scomp_[0]].coef_bits[0] < 0)
    corrupt("AC scan before the DC scan");
}

int64_t JpegDecoder::scan_blocks() const {
  if (ns_ == 1) return int64_t(comp_[scomp_[0]].bw) * comp_[scomp_[0]].bh;
  int64_t per_mcu = 0;
  for (int i = 0; i < ns_; ++i) per_mcu += comp_[scomp_[i]].h * comp_[scomp_[i]].v;
  return int64_t(mcux_) * mcuy_ * per_mcu;
}

void JpegDecoder::alloc_plane(Component& c) {
  c.pstride = c.bw * 8;
  c.plane.reset(new uint8_t[size_t(c.pstride) * c.bh * 8]);
}

void JpegDecoder::decode_block_baseline(BitReader& br, Component& c, int16_t* blk) {
  int t = br.decode(dc_[c.dc_tbl]);
  c.dc_pred += br.receive_extend(t);
  blk[0] = static_cast<int16_t>(c.dc_pred);
  const Huffman& ac = ac_[c.ac_tbl];
  for (int k = 1; k < 64; ++k) {
    int rs = br.decode(ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      if (k > 63) corrupt("coefficient index past 63");
      blk[kNatural[k]] = static_cast<int16_t>(br.receive_extend(s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

void JpegDecoder::decode_dc_first(BitReader& br, Component& c, int16_t* blk) {
  int t = br.decode(dc_[c.dc_tbl]);
  c.dc_pred += br.receive_extend(t);
  blk[0] = static_cast<int16_t>(c.dc_pred * (1 << al_));
}

void JpegDecoder::decode_dc_refine(BitReader& br, int16_t* blk) {
  if (br.bits(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al_));
}

void JpegDecoder::decode_ac_first(BitReader& br, Component& c, int16_t* blk) {
  if (eobrun_ > 0) {
    --eobrun_;
    return;
  }
  const Huffman& ac = ac_[c.ac_tbl];
  for (int k = ss_; k <= se_; ++k) {
    int rs = br.decode(ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      if (k > 63) corrupt("coefficient index past 63");
      blk[kNatural[k]] = static_cast<int16_t>(br.receive_extend(s) * (1 << al_));
    } else if (r == 15) {
      k += 15;
    } else {
      eobrun_ = 1 << r;
      if (r) eobrun_ += static_cast<int>(br.bits(r));
      --eobrun_;
      break;
    }
  }
}

void JpegDecoder::decode_ac_refine(BitReader& br, Component& c, int16_t* blk) {
  const int p1 = 1 << al_, m1 = -1 * (1 << al_);
  const Huffman& ac = ac_[c.ac_tbl];
  int k = ss_;
  auto correct = [&](int16_t& coef) {
    if (br.bits(1) && (coef & p1) == 0) coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
  };
  if (eobrun_ == 0) {
    for (; k <= se_; ++k) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = br.bits(1) ? p1 : m1;  // a newly nonzero coefficient is +-1 << Al
      } else if (r != 15) {
        eobrun_ = 1 << r;
        if (r) eobrun_ += static_cast<int>(br.bits(r));
        break;
      }
      // advance over nonzero coefficients (correcting them) and r zeros
      do {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) {
          correct(coef);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se_);
      if (s) {
        if (k > se_) corrupt("coefficient index past the band");
        blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se_; ++k) {
      int16_t& coef = blk[kNatural[k]];
      if (coef != 0) correct(coef);
    }
    --eobrun_;
  }
}

void JpegDecoder::decode_scan(BitReader& br) {
  for (int i = 0; i < ns_; ++i) comp_[scomp_[i]].dc_pred = 0;
  eobrun_ = 0;
  int expected_rst = 0;
  int todo = restart_interval_;
  auto restart = [&]() {
    // the bits left in this segment are padding; the marker must be RSTn
    br.reset();
    size_t p = br.pos();
    while (p < n_ && d_[p] == 0xFF && p + 1 < n_ && d_[p + 1] == 0xFF) ++p;
    if (p + 1 >= n_ || d_[p] != 0xFF || d_[p + 1] != 0xD0 + expected_rst)
      corrupt("missing restart marker");
    expected_rst = (expected_rst + 1) & 7;
    br = BitReader(d_, n_, p + 2);
    for (int i = 0; i < ns_; ++i) comp_[scomp_[i]].dc_pred = 0;
    eobrun_ = 0;
    todo = restart_interval_;
  };
  int16_t one[64];
  auto block = [&](Component& c, int bx, int by) {
    if (single_scan_) {
      // decode and IDCT at once; an MCU's padding blocks are decoded only
      std::memset(one, 0, sizeof(one));
      decode_block_baseline(br, c, one);
      if (bx < c.bw && by < c.bh)
        idct_islow(one, c.quant, &c.plane[size_t(by) * 8 * c.pstride + bx * 8], c.pstride);
      return;
    }
    int16_t* blk = &c.coefs[(size_t(by) * c.stride_blocks + bx) * 64];
    if (!progressive_) decode_block_baseline(br, c, blk);
    else if (ss_ == 0 && ah_ == 0) decode_dc_first(br, c, blk);
    else if (ss_ == 0) decode_dc_refine(br, blk);
    else if (ah_ == 0) decode_ac_first(br, c, blk);
    else decode_ac_refine(br, c, blk);
  };
  if (ns_ == 1) {
    Component& c = comp_[scomp_[0]];
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx) {
        if (restart_interval_) {
          if (todo == 0) restart();
          --todo;
        }
        block(c, bx, by);
      }
  } else {
    for (int my = 0; my < mcuy_; ++my)
      for (int mx = 0; mx < mcux_; ++mx) {
        if (restart_interval_) {
          if (todo == 0) restart();
          --todo;
        }
        for (int i = 0; i < ns_; ++i) {
          Component& c = comp_[scomp_[i]];
          for (int v = 0; v < c.v; ++v)
            for (int h = 0; h < c.h; ++h) block(c, mx * c.h + h, my * c.v + v);
        }
      }
  }
}

void JpegDecoder::decode(uint8_t* out) {
  // read_header() stopped after the first SOS
  single_scan_ = !progressive_ && ns_ == ncomp;
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp_[i];
    if (single_scan_) {
      alloc_plane(c);
      continue;
    }
    c.coefs.reset(static_cast<int16_t*>(
        std::calloc(size_t(c.stride_blocks) * c.rows_blocks * 64, sizeof(int16_t))));
    if (!c.coefs) throw std::bad_alloc();
  }
  for (;;) {
    BitReader br(d_, n_, pos_);
    decode_scan(br);
    pos_ = br.pos();
    // the next marker after the scan's entropy data
    bool more_scans = false;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m >= 0xD0 && m <= 0xD7) continue;  // a stray RSTn
      if (m == 0x01) continue;
      int len = u16(pos_);
      if (len < 2 || pos_ + len > n_) corrupt("truncated marker segment");
      size_t at = pos_ + 2;
      int body = len - 2;
      pos_ += len;
      if (m == 0xDA) {
        if (single_scan_) corrupt("a second scan after a scan of every component");
        read_sos(at, body);
        more_scans = true;
        break;
      }
      if (m == 0xC4) read_dht(at, body);
      else if (m == 0xDB) read_dqt(at, body);
      else if (m == 0xDD) {
        if (body < 2) corrupt("short DRI segment");
        restart_interval_ = u16(at);
      } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        corrupt("a second SOF marker");
      }
    }
    if (!more_scans) break;
  }
  if (progressive_) {
    // libjpeg block-smooths a progressive image whose coefficients 1..9
    // are not all complete; this decoder does not
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp_[i];
      if (c.coef_bits[0] < 0) corrupt("a component has no DC scan");
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0)
          unsupported("progressive JPEG whose scans leave low coefficients incomplete");
    }
  } else {
    for (int i = 0; i < ncomp; ++i)
      if (!comp_[i].quant_latched) corrupt("a component is in no scan");
  }
  output(out);
}

void JpegDecoder::output(uint8_t* out) {
  // a file of several scans: IDCT every block the component's own samples
  // need into a plane
  for (int i = 0; i < ncomp && !single_scan_; ++i) {
    Component& c = comp_[i];
    alloc_plane(c);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(&c.coefs[(size_t(by) * c.stride_blocks + bx) * 64], c.quant,
                   &c.plane[size_t(by) * 8 * c.pstride + bx * 8], c.pstride);
    c.coefs.reset();
  }
  const int W = width, H = height;
  if (ncomp == 1) {
    for (int y = 0; y < H; ++y) {
      const uint8_t* row = &comp_[0].plane[size_t(y) * comp_[0].pstride];
      uint8_t* o = out + size_t(y) * W * 3;
      for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[x];
    }
    return;
  }
  // libjpeg's guess of the colour space (jdapimin.c default_decompress_parms)
  bool ycc = true;
  if (jfif_) ycc = true;
  else if (adobe_) ycc = adobe_transform_ != 0;
  else if (comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66) ycc = false;
  // upsample each component's rows to full width, then convert
  std::vector<uint8_t> full[3];
  std::vector<int> colsum;
  for (int i = 0; i < 3; ++i) full[i].assign(W + 2, 0);
  for (int y = 0; y < H; ++y) {
    for (int i = 0; i < 3; ++i) {
      const Component& c = comp_[i];
      const int hr = hmax_ / c.h, vr = vmax_ / c.v;
      const int cw = c.width, chh = c.height;
      const uint8_t* plane = c.plane.get();
      const int ps = c.pstride;
      uint8_t* o = full[i].data();
      const bool fancy_h = hr == 2 && cw > 2;
      if (hr == 1 && vr == 1) {
        std::memcpy(o, plane + size_t(y) * ps, W);
      } else if (vr == 2 && (hr == 1 || fancy_h)) {
        // h1v2 / h2v2 fancy: the nearer input row weighs 3, the other 1
        const int iy = y >> 1;
        int ny = (y & 1) ? iy + 1 : iy - 1;
        if (ny < 0) ny = 0;
        if (ny > chh - 1) ny = chh - 1;
        const uint8_t* r0 = plane + size_t(iy) * ps;
        const uint8_t* r1 = plane + size_t(ny) * ps;
        if (hr == 1) {
          const int bias = (y & 1) ? 2 : 1;
          for (int x = 0; x < W; ++x) o[x] = uint8_t((3 * r0[x] + r1[x] + bias) >> 2);
        } else {
          colsum.resize(cw);
          for (int x = 0; x < cw; ++x) colsum[x] = 3 * r0[x] + r1[x];
          for (int x = 0; x < cw; ++x) {
            const int cs = colsum[x];
            const int left = colsum[x > 0 ? x - 1 : 0];
            const int right = colsum[x < cw - 1 ? x + 1 : cw - 1];
            o[2 * x] = uint8_t((3 * cs + left + 8) >> 4);
            o[2 * x + 1] = uint8_t((3 * cs + right + 7) >> 4);
          }
        }
      } else if (vr == 1 && fancy_h) {
        // h2v1 fancy
        const uint8_t* r = plane + size_t(y) * ps;
        for (int x = 0; x < cw; ++x) {
          const int v3 = 3 * r[x];
          const int left = r[x > 0 ? x - 1 : 0];
          const int right = r[x < cw - 1 ? x + 1 : cw - 1];
          o[2 * x] = uint8_t((v3 + left + 1) >> 2);
          o[2 * x + 1] = uint8_t((v3 + right + 2) >> 2);
        }
      } else {
        // box (integral-factor) upsampling
        const uint8_t* r = plane + size_t(y / vr) * ps;
        for (int x = 0; x < W; ++x) o[x] = r[x / hr];
      }
    }
    uint8_t* o = out + size_t(y) * W * 3;
    const uint8_t *p0 = full[0].data(), *p1 = full[1].data(), *p2 = full[2].data();
    if (ycc) {
      for (int x = 0; x < W; ++x) {
        const int yy = p0[x], cb = p1[x], cr = p2[x];
        o[3 * x] = clamp255(yy + g_cr_r[cr]);
        o[3 * x + 1] = clamp255(yy + int((g_cb_g[cb] + g_cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(yy + g_cb_b[cb]);
      }
    } else {
      for (int x = 0; x < W; ++x) {
        o[3 * x] = p0[x];
        o[3 * x + 1] = p1[x];
        o[3 * x + 2] = p2[x];
      }
    }
  }
}

void set_err(char* err, int errlen, const std::string& m) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", m.c_str());
}

// -- Pillow's bicubic resample (libImaging/Resample.c) ------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;

double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

// Pillow's precompute_coeffs + normalize_coeffs_8bpc
int precompute_coeffs(int in_size, float in0, float in1, int out_size,
                      std::vector<int>& bounds, std::vector<int32_t>& kk) {
  const double support_base = 2.0;
  double filterscale, scale;
  filterscale = scale = double(in1 - in0) / out_size;
  if (filterscale < 1.0) filterscale = 1.0;
  const double support = support_base * filterscale;
  const int ksize = int(std::ceil(support)) * 2 + 1;
  std::vector<double> k(size_t(out_size) * ksize, 0.0);
  bounds.assign(size_t(out_size) * 2, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* kp = &k[size_t(xx) * ksize];
    for (int x = 0; x < xmax; ++x) {
      const double w = bicubic_filter((x + xmin - center + 0.5) * ss);
      kp[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) kp[x] /= ww;
    bounds[size_t(xx) * 2] = xmin;
    bounds[size_t(xx) * 2 + 1] = xmax;
  }
  kk.resize(k.size());
  for (size_t i = 0; i < k.size(); ++i)
    kk[i] = k[i] < 0 ? int32_t(-0.5 + k[i] * (1 << kPrecisionBits))
                     : int32_t(0.5 + k[i] * (1 << kPrecisionBits));
  return ksize;
}

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return uint8_t(in >> kPrecisionBits);
}

}  // namespace

extern "C" {

// the header's width, height and component count
int jpeg_info(const uint8_t* data, int64_t n, int32_t* width, int32_t* height, int32_t* ncomp,
              char* err, int errlen) {
  try {
    JpegDecoder dec(data, size_t(n));
    dec.read_header();
    *width = dec.width;
    *height = dec.height;
    *ncomp = dec.ncomp;
    return 0;
  } catch (const CodecError& e) {
    set_err(err, errlen, e.msg);
    return e.code;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
    return kUnsupported;
  }
}

// decode into out[height][width][3] (out_size bytes)
int jpeg_decode_rgb(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size, char* err,
                    int errlen) {
  try {
    JpegDecoder dec(data, size_t(n));
    dec.read_header();
    if (int64_t(dec.width) * dec.height * 3 != out_size) {
      set_err(err, errlen, "output buffer of the wrong size");
      return kCorrupt;
    }
    dec.decode(out);
    return 0;
  } catch (const CodecError& e) {
    set_err(err, errlen, e.msg);
    return e.code;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
    return kUnsupported;
  }
}

// Image.resize((ow, oh)) with BICUBIC on RGB u8: in[h][w][3] -> out[oh][ow][3]
int resize_bicubic_rgb(const uint8_t* in, int32_t h, int32_t w, uint8_t* out, int32_t oh,
                       int32_t ow) {
  if (h < 1 || w < 1 || oh < 1 || ow < 1) return kCorrupt;
  try {
    std::vector<int> bh, bv;
    std::vector<int32_t> kh, kv;
    const int ksh = precompute_coeffs(w, 0.0f, float(w), ow, bh, kh);
    const int ksv = precompute_coeffs(h, 0.0f, float(h), oh, bv, kv);
    const bool need_h = ow != w, need_v = oh != h;
    const int y_first = bv[0];
    const int y_last = bv[size_t(oh) * 2 - 2] + bv[size_t(oh) * 2 - 1];
    std::vector<uint8_t> tmp;
    const uint8_t* src = in;
    int src_w = w;
    if (need_h) {
      // only the rows the vertical pass reads
      const int rows = y_last - y_first;
      for (int i = 0; i < oh; ++i) bv[size_t(i) * 2] -= y_first;
      uint8_t* dst = out;
      if (need_v) {
        tmp.resize(size_t(rows) * ow * 3);
        dst = tmp.data();
      }
      for (int yy = 0; yy < rows; ++yy) {
        const uint8_t* row = in + size_t(yy + y_first) * w * 3;
        uint8_t* o = dst + size_t(yy) * ow * 3;
        for (int xx = 0; xx < ow; ++xx) {
          const int xmin = bh[size_t(xx) * 2], xmax = bh[size_t(xx) * 2 + 1];
          const int32_t* k = &kh[size_t(xx) * ksh];
          int32_t s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
          const uint8_t* p = row + size_t(xmin) * 3;
          for (int x = 0; x < xmax; ++x) {
            s0 += p[3 * x] * k[x];
            s1 += p[3 * x + 1] * k[x];
            s2 += p[3 * x + 2] * k[x];
          }
          o[3 * xx] = clip8(s0);
          o[3 * xx + 1] = clip8(s1);
          o[3 * xx + 2] = clip8(s2);
        }
      }
      if (!need_v) return 0;
      src = tmp.data();
      src_w = ow;
    }
    if (need_v) {
      std::vector<int32_t> acc(size_t(src_w) * 3);
      for (int yy = 0; yy < oh; ++yy) {
        const int ymin = bv[size_t(yy) * 2], ymax = bv[size_t(yy) * 2 + 1];
        const int32_t* k = &kv[size_t(yy) * ksv];
        std::fill(acc.begin(), acc.end(), int32_t(1) << (kPrecisionBits - 1));
        for (int y = 0; y < ymax; ++y) {
          const uint8_t* row = src + size_t(y + ymin) * src_w * 3;
          const int32_t ky = k[y];
          for (size_t x = 0; x < acc.size(); ++x) acc[x] += row[x] * ky;
        }
        uint8_t* o = out + size_t(yy) * ow * 3;
        for (size_t x = 0; x < acc.size(); ++x) o[x] = clip8(acc[x]);
      }
      return 0;
    }
    std::memcpy(out, in, size_t(h) * w * 3);
    return 0;
  } catch (const std::bad_alloc&) {
    return kUnsupported;
  }
}

// undo the PNG row filters: raw[h][1 + stride] -> out[h][stride]; -2 on an
// unknown filter type
int png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int32_t bpp, uint8_t* out) {
  std::vector<uint8_t> zero(size_t(stride), 0);
  const uint8_t* prev = zero.data();
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* line = raw + y * (stride + 1);
    const int f = line[0];
    ++line;
    uint8_t* o = out + y * stride;
    switch (f) {
      case 0:
        std::memcpy(o, line, size_t(stride));
        break;
      case 1:
        for (int64_t x = 0; x < stride; ++x)
          o[x] = uint8_t(line[x] + (x >= bpp ? o[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < stride; ++x) o[x] = uint8_t(line[x] + prev[x]);
        break;
      case 3:
        for (int64_t x = 0; x < stride; ++x)
          o[x] = uint8_t(line[x] + (((x >= bpp ? o[x - bpp] : 0) + prev[x]) >> 1));
        break;
      case 4:
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? o[x - bpp] : 0, b = prev[x], c = x >= bpp ? prev[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[x] = uint8_t(line[x] + pred);
        }
        break;
      default:
        return kCorrupt;
    }
    prev = o;
  }
  return 0;
}

}  // extern "C"
