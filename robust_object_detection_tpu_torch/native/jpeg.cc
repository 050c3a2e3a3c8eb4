// Host JPEG codec of the port: a decoder and a baseline encoder, written from
// ITU-T T.81 and the IJG algorithms, for 8-bit samples.
//
// Decoder: baseline and extended sequential Huffman (SOF0, SOF1) and
// progressive Huffman (SOF2: DC first / refine, AC first / refine, EOB
// runs), restart intervals, 8- and 16-bit quantisation tables, one or three
// components. Its output equals libjpeg-turbo's with the library's defaults
// (the integer "islow" IDCT, fancy upsampling, the fixed-point YCbCr->RGB
// tables), which is what Pillow's Image.open(p).convert("RGB") and
// cv2.imread(p) return:
//   * dequantisation and the islow IDCT (CONST_BITS 13, PASS1_BITS 2) with
//     the 16-bit products and saturating packs of the library's x86 SIMD
//     path, which agree with jidctint.c wherever its range limit does not
//     wrap;
//   * upsampling: triangle filters for h2v1, h2v2 (when the downsampled
//     width is above 2) and h1v2, with their alternating biases, the edge
//     columns and rows replicated; box replication for any other integral
//     factor;
//   * a single component is grey, replicated to RGB; three are YCbCr,
//     unless an Adobe APP14 marker with transform 0 (and no JFIF APP0)
//     says RGB, or their ids are 'R', 'G', 'B'.
// Arithmetic coding, lossless and hierarchical frames, 12-bit samples, two
// or four components (CMYK / YCCK), a progressive file whose scans leave a
// low AC coefficient unrefined (the library would smooth its blocks), and a
// truncated or corrupt entropy-coded segment raise, naming the cause.
//
// Encoder: (H, W, 3) RGB -> the bytes of libjpeg-turbo's baseline output at
// its defaults for a quality (Pillow's Image.fromarray(img).save(p,
// quality=q)): the JFIF 1.01 APP0, jcparam.c's quality scaling of the
// Annex K tables with force_baseline, jccolor.c's RGB->YCbCr, 4:2:0 with
// jcsample.c's h2v2 downsampling (bias 1, 2, 1, 2, ...), the right and
// bottom edges replicated, the islow FDCT (jfdctint.c), the reciprocal
// quantisation of jcdctmgr.c, dummy blocks carrying the DC of the block
// before them, the Annex K Huffman tables, and the final byte padded with
// one-bits.
//
// C ABI (ctypes; the GIL is released during each call):
//   rod_jpeg_probe(data, len, &w, &h, &comps, &progressive, err, errlen)
//   rod_jpeg_decode(data, len, out, w, h, err, errlen)   out: h*w*3 bytes
//   rod_jpeg_encode_bound(w, h)
//   rod_jpeg_encode(rgb, w, h, quality, out, cap, &written, err, errlen)
// Each returns 0 on success, else a non-zero status with a message in err.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Error(msg); }

// zigzag position -> natural (row-major) position
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ── islow IDCT / FDCT constants (CONST_BITS 13) ─────────────────────────
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) {
  return (x + (int32_t(1) << (n - 1))) >> n;
}

inline int16_t sat16(int32_t x) {
  return int16_t(std::min<int32_t>(32767, std::max<int32_t>(-32768, x)));
}

inline uint8_t sat_sample(int32_t x) {   // x centred on 0
  return uint8_t(std::min<int32_t>(127, std::max<int32_t>(-128, x)) + 128);
}

// One 8x8 block: coefficients in natural order, the component's table in
// natural order -> 8 rows of `stride` samples at out.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                ptrdiff_t stride) {
  int16_t ws[64];
  for (int c = 0; c < 8; c++) {
    int32_t in[8];
    for (int r = 0; r < 8; r++)   // the SIMD path's 16-bit products
      in[r] = int16_t(uint16_t(int32_t(coef[r * 8 + c]) * int32_t(q[r * 8 + c])));
    int32_t z2 = in[2], z3 = in[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0];
    z3 = in[4];
    int32_t tmp0 = (z2 + z3) * (int32_t(1) << CONST_BITS);
    int32_t tmp1 = (z2 - z3) * (int32_t(1) << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[7];
    tmp1 = in[5];
    tmp2 = in[3];
    tmp3 = in[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
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
    constexpr int s = CONST_BITS - PASS1_BITS;
    ws[0 * 8 + c] = sat16(descale(tmp10 + tmp3, s));
    ws[7 * 8 + c] = sat16(descale(tmp10 - tmp3, s));
    ws[1 * 8 + c] = sat16(descale(tmp11 + tmp2, s));
    ws[6 * 8 + c] = sat16(descale(tmp11 - tmp2, s));
    ws[2 * 8 + c] = sat16(descale(tmp12 + tmp1, s));
    ws[5 * 8 + c] = sat16(descale(tmp12 - tmp1, s));
    ws[3 * 8 + c] = sat16(descale(tmp13 + tmp0, s));
    ws[4 * 8 + c] = sat16(descale(tmp13 - tmp0, s));
  }
  for (int r = 0; r < 8; r++) {
    const int16_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (int32_t(w[0]) + w[4]) * (int32_t(1) << CONST_BITS);
    int32_t tmp1 = (int32_t(w[0]) - w[4]) * (int32_t(1) << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
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
    constexpr int s = CONST_BITS + PASS1_BITS + 3;
    o[0] = sat_sample(descale(tmp10 + tmp3, s));
    o[7] = sat_sample(descale(tmp10 - tmp3, s));
    o[1] = sat_sample(descale(tmp11 + tmp2, s));
    o[6] = sat_sample(descale(tmp11 - tmp2, s));
    o[2] = sat_sample(descale(tmp12 + tmp1, s));
    o[5] = sat_sample(descale(tmp12 - tmp1, s));
    o[3] = sat_sample(descale(tmp13 + tmp0, s));
    o[4] = sat_sample(descale(tmp13 - tmp0, s));
  }
}

// jfdctint.c on samples already centred (sample - 128), in place; the
// output is scaled up by 8.
void fdct_islow(int16_t* d) {
  for (int r = 0; r < 8; r++) {
    int16_t* p = d + r * 8;
    int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int32_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int32_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int16_t((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = int16_t((tmp10 - tmp11) * (1 << PASS1_BITS));
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    constexpr int s = CONST_BITS - PASS1_BITS;
    p[2] = int16_t(descale(z1 + tmp13 * FIX_0_765366865, s));
    p[6] = int16_t(descale(z1 + tmp12 * -FIX_1_847759065, s));
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
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
    p[7] = int16_t(descale(tmp4 + z1 + z3, s));
    p[5] = int16_t(descale(tmp5 + z2 + z4, s));
    p[3] = int16_t(descale(tmp6 + z2 + z3, s));
    p[1] = int16_t(descale(tmp7 + z1 + z4, s));
  }
  for (int c = 0; c < 8; c++) {
    int16_t* p = d + c;
    int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int32_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int32_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int16_t(descale(tmp10 + tmp11, PASS1_BITS));
    p[32] = int16_t(descale(tmp10 - tmp11, PASS1_BITS));
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    constexpr int s = CONST_BITS + PASS1_BITS;
    p[16] = int16_t(descale(z1 + tmp13 * FIX_0_765366865, s));
    p[48] = int16_t(descale(z1 + tmp12 * -FIX_1_847759065, s));
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
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
    p[56] = int16_t(descale(tmp4 + z1 + z3, s));
    p[40] = int16_t(descale(tmp5 + z2 + z4, s));
    p[24] = int16_t(descale(tmp6 + z2 + z3, s));
    p[8] = int16_t(descale(tmp7 + z1 + z4, s));
  }
}

// ── Decoder ─────────────────────────────────────────────────────────────

struct HuffDec {
  bool defined = false;
  bool dc = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint8_t look_len[512];   // 9-bit lookahead: code length, 0 if longer
  uint8_t look_sym[512];
};

void build_huff(HuffDec& t, const uint8_t* bits, const uint8_t* vals,
                int n, bool dc) {
  uint8_t size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l - 1]; i++) size[p++] = uint8_t(l);
  size[p] = 0;
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (uint32_t(1) << si)) fail("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l - 1]) {
      t.valoffset[l] = p - int32_t(code_of[p]);
      p += bits[l - 1];
      t.maxcode[l] = int32_t(code_of[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  std::memset(t.look_len, 0, sizeof t.look_len);
  std::memset(t.look_sym, 0, sizeof t.look_sym);
  for (int i = 0; i < n; i++) {
    if (dc && vals[i] > 15) fail("bad Huffman table (DC symbol above 15)");
    t.vals[i] = vals[i];
    int l = size[i];
    if (l <= 9) {
      uint32_t lo = code_of[i] << (9 - l), hi = lo + (1u << (9 - l));
      for (uint32_t k = lo; k < hi; k++) {
        t.look_len[k] = uint8_t(l);
        t.look_sym[k] = vals[i];
      }
    }
  }
  t.dc = dc;
  t.defined = true;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  int pad = 0;            // zero bits appended past a marker or the end
  bool marker = false;    // p rests on the 0xFF of the marker that ended it

  void reset(const uint8_t* at) {
    p = at;
    acc = 0;
    nbits = 0;
    pad = 0;
    marker = false;
  }
  void fill() {
    while (nbits <= 56) {
      uint32_t b = 0;
      if (!marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) q++;
          if (q < end && *q == 0) {
            p = q + 1;
          } else {
            marker = true;     // leave p at the marker's 0xFF
            b = 0;
            pad += 8;
          }
        } else {
          p++;
        }
      } else {
        pad += 8;
      }
      acc |= uint64_t(b) << (56 - nbits);
      nbits += 8;
    }
  }
  inline uint32_t bits(int n) {   // n in 1..16
    if (nbits < n) fill();
    uint32_t v = uint32_t(acc >> (64 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }
  inline int bit() { return int(bits(1)); }
  bool overrun() const { return nbits < pad; }
  // the position after the entropy-coded data: the next marker's 0xFF
  const uint8_t* next_marker() {
    if (!marker) {
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0 && p[1] != 0xFF)) {
        p++;
      }
      if (p + 1 >= end) p = end;
    }
    return p;
  }
};

inline int decode_sym(BitReader& br, const HuffDec& t) {
  if (br.nbits < 16) br.fill();
  uint32_t look = uint32_t(br.acc >> (64 - 9));
  int len = t.look_len[look];
  if (len) {
    br.acc <<= len;
    br.nbits -= len;
    return t.look_sym[look];
  }
  int l = 10;
  int32_t code = int32_t(br.acc >> (64 - l));
  while (l <= 16 && code > t.maxcode[l]) {
    l++;
    code = int32_t(br.acc >> (64 - l));
  }
  if (l > 16) fail("corrupt entropy-coded data (bad Huffman code)");
  br.acc <<= l;
  br.nbits -= l;
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (-(1 << s) + 1) : v;
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int wib = 0, hib = 0;     // blocks holding image samples
  int bw = 0, bh = 0;       // blocks stored (whole MCUs)
  int dw = 0, dh = 0;       // downsampled width and height
  uint16_t q[64];           // latched at the component's first scan
  bool latched = false;
  std::vector<int16_t> coef;
  int coef_bits[64];
  int dc_tbl = 0, ac_tbl = 0;
  int last_dc = 0;
};

struct Decoder {
  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {}
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffDec dc_tables[4], ac_tables[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  bool have_frame = false, progressive = false;
  int width = 0, height = 0, ncomp = 0, maxh = 1, maxv = 1;
  int mcux = 0, mcuy = 0;
  Comp comp[4];
  int scans = 0;

  uint8_t byte() {
    if (pos >= len) fail("truncated JPEG (ends inside a marker segment)");
    return data[pos++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  // the next marker code; bytes before its 0xFF are skipped, as the
  // library skips them
  int next_marker() {
    for (;;) {
      if (pos >= len) fail("truncated JPEG (no EOI marker)");
      if (data[pos] != 0xFF) {
        pos++;
        continue;
      }
      while (pos < len && data[pos] == 0xFF) pos++;
      if (pos >= len) fail("truncated JPEG (no EOI marker)");
      int m = data[pos++];
      if (m != 0) return m;
    }
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int b = byte(), pq = b >> 4, tq = b & 15;
      if (tq > 3) fail("DQT table id above 3");
      if (pq > 1) fail("DQT precision above 16 bits");
      for (int k = 0; k < 64; k++) {
        int v = pq ? u16() : byte();
        qt[tq][kNatural[k]] = uint16_t(v);
      }
      qt_defined[tq] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      int b = byte(), tc = b >> 4, th = b & 15;
      if (tc > 1 || th > 3) fail("DHT table class or id out of range");
      uint8_t bits[16], vals[256];
      int n = 0;
      for (int i = 0; i < 16; i++) {
        bits[i] = byte();
        n += bits[i];
      }
      if (n > 256 || pos + size_t(n) > end) fail("bad Huffman table");
      for (int i = 0; i < n; i++) vals[i] = byte();
      build_huff(tc ? ac_tables[th] : dc_tables[th], bits, vals, n, tc == 0);
    }
  }

  void read_sof(int marker, size_t end) {
    if (have_frame) fail("more than one frame (SOF marker)");
    int precision = byte();
    if (precision != 8) {
      fail(std::to_string(precision) +
           "-bit precision is not supported; only 8-bit");
    }
    height = u16();
    width = u16();
    ncomp = byte();
    if (height == 0) fail("frame height 0 (DNL) is not supported");
    if (width == 0) fail("frame width 0");
    if (ncomp == 4) {
      fail("four components (CMYK / YCCK) are not supported; only grey "
           "and three-component images");
    }
    if (ncomp != 1 && ncomp != 3) {
      fail(std::to_string(ncomp) + " components are not supported; only "
           "1 or 3");
    }
    if (end - pos != size_t(3 * ncomp)) fail("bad SOF segment length");
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) {
        fail("sampling factor outside 1..4");
      }
      if (c.tq > 3) fail("quantisation table id above 3");
      maxh = std::max(maxh, c.h);
      maxv = std::max(maxv, c.v);
    }
    progressive = marker == 0xC2;
    mcux = (width + 8 * maxh - 1) / (8 * maxh);
    mcuy = (height + 8 * maxv - 1) / (8 * maxv);
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.wib = int((int64_t(width) * c.h + 8 * maxh - 1) / (8 * maxh));
      c.hib = int((int64_t(height) * c.v + 8 * maxv - 1) / (8 * maxv));
      c.dw = int((int64_t(width) * c.h + maxh - 1) / maxh);
      c.dh = int((int64_t(height) * c.v + maxv - 1) / maxv);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    have_frame = true;
  }

  void read_app(int marker, size_t end) {
    size_t n = end - pos;
    const uint8_t* s = data + pos;
    if (marker == 0xE0 && n >= 14 && std::memcmp(s, "JFIF\0", 5) == 0) {
      saw_jfif = true;
    }
    if (marker == 0xEE && n >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = s[11];
    }
    pos = end;
  }

  void read_sos(size_t end) {
    if (!have_frame) fail("SOS before the frame header");
    int ns = byte();
    if (ns < 1 || ns > 4 || end - pos != size_t(2 * ns + 3)) {
      fail("bad SOS segment");
    }
    Comp* sc[4];
    for (int i = 0; i < ns; i++) {
      int id = byte(), td = byte();
      Comp* c = nullptr;
      for (int j = 0; j < ncomp; j++) {
        if (comp[j].id == id) c = &comp[j];
      }
      if (!c) fail("SOS names a component the frame lacks");
      for (int j = 0; j < i; j++) {
        if (sc[j] == c) fail("SOS names a component twice");
      }
      c->dc_tbl = td >> 4;
      c->ac_tbl = td & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3) fail("Huffman table id above 3");
      sc[i] = c;
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = a >> 4, al = a & 15;
    if (progressive) {
      bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad) {
        fail("bad progressive scan parameters (Ss " + std::to_string(ss) +
             ", Se " + std::to_string(se) + ", Ah " + std::to_string(ah) +
             ", Al " + std::to_string(al) + ")");
      }
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    int blocks = 0;
    for (int i = 0; i < ns; i++) blocks += ns == 1 ? 1 : sc[i]->h * sc[i]->v;
    if (blocks > 10) fail("more than 10 blocks in an MCU");
    for (int i = 0; i < ns; i++) {
      Comp& c = *sc[i];
      if (!c.latched) {
        if (!qt_defined[c.tq]) fail("a component's quantisation table is "
                                    "not defined");
        std::memcpy(c.q, qt[c.tq], sizeof c.q);
        c.latched = true;
      }
      bool need_dc = ss == 0 && ah == 0;
      bool need_ac = se > 0;
      if (need_dc && !dc_tables[c.dc_tbl].defined) {
        fail("scan uses an undefined DC Huffman table");
      }
      if (need_ac && !ac_tables[c.ac_tbl].defined) {
        fail("scan uses an undefined AC Huffman table");
      }
      for (int k = ss; k <= se; k++) c.coef_bits[k] = al;
      c.last_dc = 0;
    }
    pos = end;
    decode_scan(sc, ns, ss, se, ah, al);
    scans++;
  }

  void decode_scan(Comp** sc, int ns, int ss, int se, int ah, int al) {
    BitReader br;
    br.end = data + len;
    br.reset(data + pos);
    int nx, ny;
    if (ns == 1) {
      nx = sc[0]->wib;
      ny = sc[0]->hib;
    } else {
      nx = mcux;
      ny = mcuy;
    }
    int eobrun = 0;
    int restarts_left = restart_interval;
    int next_rst = 0;
    int64_t total = int64_t(nx) * ny, done = 0;
    for (int my = 0; my < ny; my++) {
      for (int mx = 0; mx < nx; mx++) {
        if (restart_interval && restarts_left == 0) {
          const uint8_t* m = br.next_marker();
          if (m + 1 >= data + len) fail("truncated JPEG (missing RST marker)");
          if (m[1] != 0xD0 + next_rst) {
            fail("corrupt entropy-coded data (expected RST" +
                 std::to_string(next_rst) + ")");
          }
          br.reset(m + 2);
          next_rst = (next_rst + 1) & 7;
          restarts_left = restart_interval;
          eobrun = 0;
          for (int i = 0; i < ns; i++) sc[i]->last_dc = 0;
        }
        for (int i = 0; i < ns; i++) {
          Comp& c = *sc[i];
          int bh = ns == 1 ? 1 : c.v, bwid = ns == 1 ? 1 : c.h;
          for (int y = 0; y < bh; y++) {
            for (int x = 0; x < bwid; x++) {
              int by = ns == 1 ? my : my * c.v + y;
              int bx = ns == 1 ? mx : mx * c.h + x;
              int16_t* blk = c.coef.data() + (size_t(by) * c.bw + bx) * 64;
              if (!progressive) {
                decode_sequential(br, c, blk);
              } else if (ss == 0) {
                if (ah == 0) {
                  int s = decode_sym(br, dc_tables[c.dc_tbl]);
                  int d = s ? extend(int(br.bits(s)), s) : 0;
                  c.last_dc += d;
                  blk[0] = int16_t(uint16_t(c.last_dc) << al);
                } else if (br.bit()) {
                  blk[0] = int16_t(blk[0] | (1 << al));
                }
              } else if (ah == 0) {
                decode_ac_first(br, c, blk, ss, se, al, eobrun);
              } else {
                decode_ac_refine(br, c, blk, ss, se, al, eobrun);
              }
            }
          }
        }
        if (br.overrun()) {
          fail("truncated or corrupt entropy-coded data (ran past its end "
               "at MCU " + std::to_string(done) + " of " +
               std::to_string(total) + ")");
        }
        done++;
        if (restart_interval) restarts_left--;
      }
    }
    pos = size_t(br.next_marker() - data);
  }

  void decode_sequential(BitReader& br, Comp& c, int16_t* blk) {
    int s = decode_sym(br, dc_tables[c.dc_tbl]);
    int d = s ? extend(int(br.bits(s)), s) : 0;
    c.last_dc += d;
    blk[0] = int16_t(c.last_dc);
    const HuffDec& ac = ac_tables[c.ac_tbl];
    for (int k = 1; k < 64; k++) {
      int rs = decode_sym(br, ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt entropy-coded data (run past the block)");
        blk[kNatural[k]] = int16_t(extend(int(br.bits(s)), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_ac_first(BitReader& br, Comp& c, int16_t* blk, int ss, int se,
                       int al, int& eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const HuffDec& ac = ac_tables[c.ac_tbl];
    for (int k = ss; k <= se; k++) {
      int rs = decode_sym(br, ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) fail("corrupt entropy-coded data (run past the band)");
        int v = extend(int(br.bits(s)), s);
        blk[kNatural[k]] = int16_t(uint16_t(v) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += int(br.bits(r));
        eobrun--;
        break;
      }
    }
  }

  void decode_ac_refine(BitReader& br, Comp& c, int16_t* blk, int ss, int se,
                        int al, int& eobrun) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    const HuffDec& ac = ac_tables[c.ac_tbl];
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = decode_sym(br, ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt entropy-coded data (refinement size)");
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += int(br.bits(r));
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.bit() && (*coef & p1) == 0) {
              *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) {
          if (k > se) fail("corrupt entropy-coded data (run past the band)");
          blk[kNatural[k]] = int16_t(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.bit() && (*coef & p1) == 0) {
          *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
        }
      }
      eobrun--;
    }
  }

  void parse() {
    if (len < 2 || data[0] != 0xFF || data[1] != 0xD8) {
      fail("not a JPEG file (no SOI marker)");
    }
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;                       // EOI
      if (m == 0xD8) fail("SOI marker inside the file");
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      int n = u16();
      if (n < 2 || pos + size_t(n - 2) > len) {
        fail("truncated JPEG (a marker segment runs past the end)");
      }
      size_t end = pos + size_t(n - 2);
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(m, end);
          break;
        case 0xC3:
          fail("lossless JPEG (SOF3) is not supported");
        case 0xC5: case 0xC6: case 0xC7:
          fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
               ") is not supported");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          fail("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) +
               ") is not supported");
        case 0xCC:
          fail("arithmetic-coded JPEG (DAC marker) is not supported");
        case 0xC4:
          read_dht(end);
          break;
        case 0xDB:
          read_dqt(end);
          break;
        case 0xDD:
          if (n != 4) fail("bad DRI segment");
          restart_interval = u16();
          break;
        case 0xDA:
          read_sos(end);
          continue;                                // pos is past the scan
        case 0xDE: case 0xDF:
          fail("hierarchical JPEG (DHP / EXP marker) is not supported");
        default:
          if ((m >= 0xE0 && m <= 0xEF)) {
            read_app(m, end);
          } else if (m == 0xFE || m == 0xDC) {
            // COM, DNL: skipped
          } else {
            char hex[8];
            std::snprintf(hex, sizeof hex, "0x%02X", m);
            fail(std::string("unsupported JPEG marker ") + hex);
          }
          break;
      }
      pos = end;
    }
    if (!have_frame) fail("JPEG without a frame (no SOF marker)");
    if (scans == 0) fail("JPEG without a scan (no SOS marker)");
    if (progressive) {          // jdcoefct.c's smoothing_ok
      bool dc_known = true, unrefined = false;
      for (int i = 0; i < ncomp; i++) {
        const Comp& c = comp[i];
        dc_known = dc_known && c.coef_bits[0] >= 0;
        for (int k = 1; k < 10; k++) unrefined |= c.coef_bits[k] != 0;
      }
      if (dc_known && unrefined) {
        fail("progressive JPEG whose scans leave low AC coefficients "
             "unrefined (the library would smooth its blocks) is not "
             "supported");
      }
    }
  }

  // samples of one component: dh x dw, from its IDCT'd blocks
  std::vector<uint8_t> component_plane(const Comp& c) const {
    int pw = c.bw * 8;
    std::vector<uint8_t> plane(size_t(c.hib) * 8 * pw);
    static const uint16_t ones[64] = {0};
    const uint16_t* q = c.latched ? c.q : ones;
    for (int by = 0; by < c.hib; by++) {
      for (int bx = 0; bx < c.wib; bx++) {
        idct_islow(c.coef.data() + (size_t(by) * c.bw + bx) * 64, q,
                   plane.data() + size_t(by) * 8 * pw + bx * 8, pw);
      }
    }
    return plane;
  }

  // component i upsampled to (at least) height x width: rows of `ow`
  std::vector<uint8_t> upsampled(int i, int& ow) const {
    const Comp& c = comp[i];
    if (maxh % c.h || maxv % c.v) {
      fail("fractional sampling factors are not supported");
    }
    int rh = maxh / c.h, rv = maxv / c.v;
    int pw = c.bw * 8;
    std::vector<uint8_t> plane = component_plane(c);
    auto in = [&](int y) {        // a row, the bottom edge replicated
      return plane.data() + size_t(std::min(std::max(y, 0), c.dh - 1)) * pw;
    };
    ow = c.dw * rh;
    int oh = c.dh * rv;
    std::vector<uint8_t> out(size_t(oh) * ow);
    int dw = c.dw;
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < oh; y++) std::memcpy(&out[size_t(y) * ow], in(y), dw);
    } else if (rh == 2 && rv == 1 && dw > 2) {
      for (int y = 0; y < oh; y++) {
        const uint8_t* s = in(y);
        uint8_t* o = &out[size_t(y) * ow];
        o[0] = s[0];
        o[1] = uint8_t((s[0] * 3 + s[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; x++) {
          int v = s[x] * 3;
          o[2 * x] = uint8_t((v + s[x - 1] + 1) >> 2);
          o[2 * x + 1] = uint8_t((v + s[x + 1] + 2) >> 2);
        }
        o[2 * dw - 2] = uint8_t((s[dw - 1] * 3 + s[dw - 2] + 1) >> 2);
        o[2 * dw - 1] = s[dw - 1];
      }
    } else if (rh == 1 && rv == 2) {
      for (int y = 0; y < oh; y++) {
        const uint8_t* s0 = in(y >> 1);
        const uint8_t* s1 = in((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
        int bias = (y & 1) ? 2 : 1;
        uint8_t* o = &out[size_t(y) * ow];
        for (int x = 0; x < dw; x++) {
          o[x] = uint8_t((s0[x] * 3 + s1[x] + bias) >> 2);
        }
      }
    } else if (rh == 2 && rv == 2 && dw > 2) {
      for (int y = 0; y < oh; y++) {
        const uint8_t* s0 = in(y >> 1);
        const uint8_t* s1 = in((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
        uint8_t* o = &out[size_t(y) * ow];
        int last = s0[0] * 3 + s1[0];
        int cur = last;
        int next = s0[1] * 3 + s1[1];
        o[0] = uint8_t((cur * 4 + 8) >> 4);
        o[1] = uint8_t((cur * 3 + next + 7) >> 4);
        last = cur;
        cur = next;
        for (int x = 1; x < dw - 1; x++) {
          next = s0[x + 1] * 3 + s1[x + 1];
          o[2 * x] = uint8_t((cur * 3 + last + 8) >> 4);
          o[2 * x + 1] = uint8_t((cur * 3 + next + 7) >> 4);
          last = cur;
          cur = next;
        }
        o[2 * dw - 2] = uint8_t((cur * 3 + last + 8) >> 4);
        o[2 * dw - 1] = uint8_t((cur * 4 + 7) >> 4);
      }
    } else {                      // box replication (int_upsample)
      for (int y = 0; y < oh; y++) {
        const uint8_t* s = in(y / rv);
        uint8_t* o = &out[size_t(y) * ow];
        for (int x = 0; x < dw; x++) {
          std::memset(o + x * rh, s[x], rh);
        }
      }
    }
    return out;
  }

  void output(uint8_t* rgb) const {
    if (ncomp == 1) {
      int ow;
      std::vector<uint8_t> g = upsampled(0, ow);
      for (int y = 0; y < height; y++) {
        const uint8_t* s = &g[size_t(y) * ow];
        uint8_t* o = rgb + size_t(y) * width * 3;
        for (int x = 0; x < width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = s[x];
      }
      return;
    }
    int w0, w1, w2;
    std::vector<uint8_t> p0 = upsampled(0, w0), p1 = upsampled(1, w1),
                         p2 = upsampled(2, w2);
    bool rgb_space;
    if (saw_jfif) {
      rgb_space = false;
    } else if (saw_adobe) {
      rgb_space = adobe_transform == 0;
    } else {
      rgb_space = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
    }
    if (rgb_space) {
      for (int y = 0; y < height; y++) {
        uint8_t* o = rgb + size_t(y) * width * 3;
        for (int x = 0; x < width; x++) {
          o[3 * x] = p0[size_t(y) * w0 + x];
          o[3 * x + 1] = p1[size_t(y) * w1 + x];
          o[3 * x + 2] = p2[size_t(y) * w2 + x];
        }
      }
      return;
    }
    // jdcolor.c: SCALEBITS 16, FIX(x) = x * 65536 + 0.5
    static int cr_r[256], cb_b[256];
    static int64_t cr_g[256], cb_g[256];
    static bool init = [] {
      for (int i = 0; i < 256; i++) {
        int64_t x = i - 128;
        cr_r[i] = int((int64_t(91881) * x + 32768) >> 16);
        cb_b[i] = int((int64_t(116130) * x + 32768) >> 16);
        cr_g[i] = -int64_t(46802) * x;
        cb_g[i] = -int64_t(22554) * x + 32768;
      }
      return true;
    }();
    (void)init;
    for (int y = 0; y < height; y++) {
      const uint8_t* Y = &p0[size_t(y) * w0];
      const uint8_t* Cb = &p1[size_t(y) * w1];
      const uint8_t* Cr = &p2[size_t(y) * w2];
      uint8_t* o = rgb + size_t(y) * width * 3;
      for (int x = 0; x < width; x++) {
        int yy = Y[x], cb = Cb[x], cr = Cr[x];
        int r = yy + cr_r[cr];
        int g = yy + int((cb_g[cb] + cr_g[cr]) >> 16);
        int b = yy + cb_b[cb];
        o[3 * x] = uint8_t(std::min(255, std::max(0, r)));
        o[3 * x + 1] = uint8_t(std::min(255, std::max(0, g)));
        o[3 * x + 2] = uint8_t(std::min(255, std::max(0, b)));
      }
    }
  }
};

// ── Encoder ─────────────────────────────────────────────────────────────

// Annex K.1, natural order
const uint8_t kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3: code counts by length, then the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffEnc {
  uint16_t code[256];
  uint8_t size[256];
};

void build_enc(HuffEnc& t, const uint8_t* bits, const uint8_t* vals) {
  std::memset(t.size, 0, sizeof t.size);
  uint32_t code = 0;
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < bits[l - 1]; i++, p++) {
      t.code[vals[p]] = uint16_t(code++);
      t.size[vals[p]] = uint8_t(l);
    }
    code <<= 1;
  }
}

// jcdctmgr.c's reciprocal division by 8 * quantval (16-bit DCTELEM)
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);      // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r};
}

struct BitWriter {
  uint8_t* out;
  size_t cap, n = 0;
  uint64_t acc = 0;       // the last `nbits` bits are pending
  int nbits = 0;

  inline void put_byte(uint8_t b) {
    if (n >= cap) fail("encoder output buffer too small");
    out[n++] = b;
  }
  inline void put(uint32_t code, int size) {   // size <= 31
    acc = (acc << size) | (code & ((uint32_t(1) << size) - 1));
    nbits += size;
    if (nbits >= 32) emit32();
  }
  // the oldest 32 pending bits as 4 bytes, each 0xFF followed by a 0x00
  void emit32() {
    if (n + 8 > cap) fail("encoder output buffer too small");
    uint32_t w = uint32_t(acc >> (nbits - 32));
    nbits -= 32;
    uint32_t inv = ~w;    // a zero byte of inv is a 0xFF byte of w
    if (((inv - 0x01010101u) & ~inv & 0x80808080u) == 0) {
      out[n] = uint8_t(w >> 24);
      out[n + 1] = uint8_t(w >> 16);
      out[n + 2] = uint8_t(w >> 8);
      out[n + 3] = uint8_t(w);
      n += 4;
      return;
    }
    for (int sh = 24; sh >= 0; sh -= 8) {
      uint8_t b = uint8_t(w >> sh);
      out[n++] = b;
      if (b == 0xFF) out[n++] = 0;
    }
  }
  // the pending bits, the last byte padded with one-bits
  void finish() {
    if (nbits % 8) put(0x7F, 8 - nbits % 8);
    while (nbits >= 8) {
      uint8_t b = uint8_t(acc >> (nbits - 8));
      nbits -= 8;
      put_byte(b);
      if (b == 0xFF) put_byte(0);
    }
  }
};

// a Huffman code and the value's low `nbits` bits, in one put
inline void put_coded(BitWriter& bw, const HuffEnc& t, int sym, int value,
                      int nbits) {
  uint32_t v = uint32_t(value) & ((uint32_t(1) << nbits) - 1);
  bw.put((uint32_t(t.code[sym]) << nbits) | v, t.size[sym] + nbits);
}

void encode_block(BitWriter& bw, const int16_t* q, int& last_dc,
                  const HuffEnc& dc, const HuffEnc& ac) {
  int temp = q[0] - last_dc, temp2 = temp;
  last_dc = q[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = temp ? 32 - __builtin_clz(uint32_t(temp)) : 0;
  put_coded(bw, dc, nbits, temp2, nbits);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    int v = q[kNatural[k]];
    if (v == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp = temp2 = v;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = 32 - __builtin_clz(uint32_t(temp));
    put_coded(bw, ac, (r << 4) + nbits, temp2, nbits);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

int quality_scale(int quality) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  return quality < 50 ? 5000 / quality : 200 - quality * 2;
}

void scaled_table(const uint8_t* basic, int scale, uint16_t* out) {
  for (int i = 0; i < 64; i++) {
    long t = (long(basic[i]) * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 32767) t = 32767;
    if (t > 255) t = 255;                     // force_baseline
    out[i] = uint16_t(t);
  }
}

size_t encode_bound(int w, int h) {
  size_t mcus = size_t((w + 15) / 16) * size_t((h + 15) / 16);
  // a block at most 27 + 63 * 26 bits, each byte possibly stuffed
  return 1024 + mcus * 6 * 420;
}

size_t encode(const uint8_t* rgb, int w, int h, int quality, uint8_t* out,
              size_t cap) {
  if (w < 1 || h < 1 || w > 65535 || h > 65535) {
    fail("image size " + std::to_string(w) + "x" + std::to_string(h) +
         " outside 1..65535");
  }
  uint16_t qtab[2][64];
  int scale = quality_scale(quality);
  scaled_table(kStdLuma, scale, qtab[0]);
  scaled_table(kStdChroma, scale, qtab[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; t++) {
    for (int i = 0; i < 64; i++) div[t][i] = reciprocal(uint32_t(qtab[t][i]) << 3);
  }
  HuffEnc dc[2], ac[2];
  build_enc(dc[0], kDcLumaBits, kDcVals);
  build_enc(dc[1], kDcChromaBits, kDcVals);
  build_enc(ac[0], kAcLumaBits, kAcLumaVals);
  build_enc(ac[1], kAcChromaBits, kAcChromaVals);

  BitWriter bw{out, cap};
  auto raw = [&](std::initializer_list<int> bytes) {
    for (int b : bytes) bw.put_byte(uint8_t(b));
  };
  raw({0xFF, 0xD8});
  raw({0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  for (int t = 0; t < 2; t++) {
    raw({0xFF, 0xDB, 0, 67, t});
    for (int k = 0; k < 64; k++) bw.put_byte(uint8_t(qtab[t][kNatural[k]]));
  }
  raw({0xFF, 0xC0, 0, 17, 8, h >> 8, h & 255, w >> 8, w & 255, 3,
       1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
  const uint8_t* bits_of[4] = {kDcLumaBits, kAcLumaBits, kDcChromaBits,
                               kAcChromaBits};
  const uint8_t* vals_of[4] = {kDcVals, kAcLumaVals, kDcVals, kAcChromaVals};
  const int class_id[4] = {0x00, 0x10, 0x01, 0x11};
  for (int t = 0; t < 4; t++) {
    int n = 0;
    for (int i = 0; i < 16; i++) n += bits_of[t][i];
    raw({0xFF, 0xC4, (n + 19) >> 8, (n + 19) & 255, class_id[t]});
    for (int i = 0; i < 16; i++) bw.put_byte(bits_of[t][i]);
    for (int i = 0; i < n; i++) bw.put_byte(vals_of[t][i]);
  }
  raw({0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});

  // jccolor.c: SCALEBITS 16; Cb / Cr with 0.5 - epsilon rounding
  static int32_t tab[8][256];
  static bool init = [] {
    for (int i = 0; i < 256; i++) {
      tab[0][i] = 19595 * i;                       // FIX(0.29900)
      tab[1][i] = 38470 * i;                       // FIX(0.58700)
      tab[2][i] = 7471 * i + 32768;                // FIX(0.11400) + 1/2
      tab[3][i] = -11059 * i;                      // -FIX(0.16874)
      tab[4][i] = -21709 * i;                      // -FIX(0.33126)
      tab[5][i] = 32768 * i + (128 << 16) + 32767; // FIX(0.5) + offsets
      tab[6][i] = -27439 * i;                      // -FIX(0.41869)
      tab[7][i] = -5329 * i;                       // -FIX(0.08131)
    }
    return true;
  }();
  (void)init;
  int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  // full-resolution planes, the right and bottom edges replicated up to
  // whole MCUs
  int pw = mcux * 16, ph = mcuy * 16;
  std::vector<uint8_t> plane[3];
  for (auto& p : plane) p.resize(size_t(pw) * ph);
  for (int y = 0; y < ph; y++) {
    size_t row = size_t(y) * pw;
    if (y >= h) {
      for (auto& p : plane) {
        std::memcpy(&p[row], &p[size_t(h - 1) * pw], pw);
      }
      continue;
    }
    const uint8_t* px = rgb + size_t(y) * w * 3;
    uint8_t *p0 = &plane[0][row], *p1 = &plane[1][row], *p2 = &plane[2][row];
    for (int x = 0; x < w; x++, px += 3) {
      int r = px[0], g = px[1], b = px[2];
      p0[x] = uint8_t((tab[0][r] + tab[1][g] + tab[2][b]) >> 16);
      p1[x] = uint8_t((tab[3][r] + tab[4][g] + tab[5][b]) >> 16);
      p2[x] = uint8_t((tab[5][r] + tab[6][g] + tab[7][b]) >> 16);
    }
    std::memset(p0 + w, p0[w - 1], pw - w);
    std::memset(p1 + w, p1[w - 1], pw - w);
    std::memset(p2 + w, p2[w - 1], pw - w);
  }
  // h2v2 downsampling of the rows of the image (odd heights: the last row
  // twice); rows past them repeat the last downsampled row
  int cw = mcux * 8, chh = mcuy * 8, real_rows = (h + 1) / 2;
  std::vector<uint8_t> chroma[2];
  for (int c = 0; c < 2; c++) {
    chroma[c].resize(size_t(cw) * chh);
    const std::vector<uint8_t>& src = plane[c + 1];
    for (int y = 0; y < chh; y++) {
      uint8_t* o = &chroma[c][size_t(y) * cw];
      if (y >= real_rows) {
        std::memcpy(o, &chroma[c][size_t(real_rows - 1) * cw], cw);
        continue;
      }
      const uint8_t* r0 = &src[size_t(2 * y) * pw];
      const uint8_t* r1 = &src[size_t(std::min(2 * y + 1, h - 1)) * pw];
      int bias = 1;
      for (int x = 0; x < cw; x++) {
        o[x] = uint8_t((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] +
                        bias) >> 2);
        bias ^= 3;
      }
    }
  }

  int wib = (w + 7) / 8, hib = (h + 7) / 8;   // luma blocks with samples
  int last_dc[3] = {0, 0, 0};
  int16_t blk[4][64], work[64];
  auto dct_quant = [&](const uint8_t* src, size_t stride, const Divisor* d,
                       int16_t* q) {
    for (int r = 0; r < 8; r++) {
      for (int c = 0; c < 8; c++) work[r * 8 + c] = int16_t(src[r * stride + c] - 128);
    }
    fdct_islow(work);
    for (int i = 0; i < 64; i++) {
      int t = work[i];
      bool neg = t < 0;
      uint32_t a = uint32_t(neg ? -t : t);
      uint32_t v = (a + d[i].corr) * d[i].recip >> d[i].shift;
      q[i] = int16_t(neg ? -int32_t(v & 0xFFFF) : int32_t(v & 0xFFFF));
    }
  };
  for (int my = 0; my < mcuy; my++) {
    for (int mx = 0; mx < mcux; mx++) {
      for (int y = 0; y < 2; y++) {
        for (int x = 0; x < 2; x++) {
          int by = my * 2 + y, bx = mx * 2 + x, b = y * 2 + x;
          if (by >= hib) {             // a dummy row: the DC of the block before
            std::memset(blk[b], 0, sizeof blk[b]);
            blk[b][0] = blk[b - 1][0];
          } else if (bx >= wib) {      // a dummy column: the DC to its left
            std::memset(blk[b], 0, sizeof blk[b]);
            blk[b][0] = blk[b - 1][0];
          } else {
            dct_quant(&plane[0][size_t(by) * 8 * pw + size_t(bx) * 8], pw,
                      div[0], blk[b]);
          }
        }
      }
      for (int b = 0; b < 4; b++) encode_block(bw, blk[b], last_dc[0], dc[0], ac[0]);
      for (int c = 0; c < 2; c++) {
        dct_quant(&chroma[c][size_t(my) * 8 * cw + size_t(mx) * 8], cw, div[1],
                  blk[0]);
        encode_block(bw, blk[0], last_dc[c + 1], dc[1], ac[1]);
      }
    }
  }
  bw.finish();
  raw({0xFF, 0xD9});
  return bw.n;
}

int report(const std::exception& e, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, e.what(), size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
  return 1;
}

}  // namespace

extern "C" {

int rod_jpeg_probe(const uint8_t* data, size_t len, int* w, int* h,
                   int* comps, int* progressive, char* err, int errlen) {
  try {
    if (len < 2 || data[0] != 0xFF || data[1] != 0xD8) {
      fail("not a JPEG file (no SOI marker)");
    }
    Decoder d(data, len);
    d.pos = 2;
    for (;;) {
      int m = d.next_marker();
      if (m == 0xD9) break;
      if ((m >= 0xD0 && m <= 0xD8) || m == 0x01) continue;
      int n = d.u16();
      if (n < 2) fail("bad marker segment length");
      bool sof = m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                 m != 0xCC;
      if (sof) {
        if (n < 8) fail("truncated SOF segment");
        d.byte();
        *h = d.u16();
        *w = d.u16();
        *comps = d.byte();
        *progressive = (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE);
        return 0;
      }
      d.pos += size_t(n - 2);
    }
    fail("JPEG without a SOFn marker");
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

int rod_jpeg_decode(const uint8_t* data, size_t len, uint8_t* out, int w,
                    int h, char* err, int errlen) {
  try {
    Decoder d(data, len);
    d.parse();
    if (d.width != w || d.height != h) {
      fail("frame size " + std::to_string(d.width) + "x" +
           std::to_string(d.height) + " differs from the probe's");
    }
    d.output(out);
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

size_t rod_jpeg_encode_bound(int w, int h) { return encode_bound(w, h); }

int rod_jpeg_encode(const uint8_t* rgb, int w, int h, int quality,
                    uint8_t* out, size_t cap, size_t* written, char* err,
                    int errlen) {
  try {
    *written = encode(rgb, w, h, quality, out, cap);
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

}  // extern "C"
