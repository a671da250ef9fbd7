// JPEG decoder and encoder for the host, behind a plain C interface.
//
// The decoder gives the pixels libjpeg-turbo (with its SIMD code, as cv2.imread
// runs it) gives at its default settings: ISLOW integer IDCT, its output
// saturated to 0..255 (the C code's range-limit table wraps instead, which
// differs only for coefficients no encoder writes), "fancy" triangle
// upsampling, the fixed-point YCbCr->RGB tables, output as BGR (grey repeated
// three times) and the APP1 Exif orientation applied. Baseline, extended
// (8-bit Huffman) and progressive files with 1 or 3 components, any integral
// sampling factors, restart intervals and cut files: the missing data reads as
// zero bits, the MCUs after it as zeros, and a progressive image whose low
// coefficients did not all arrive gets libjpeg's block smoothing. A file cut
// inside a marker segment after its first scan is refused, as libjpeg refuses
// it. Arithmetic coding, 12-bit samples, lossless and hierarchical files and
// 4-component (CMYK/YCCK) files are refused.
//
// The encoder gives the bytes libjpeg-turbo's compressor gives with
// jpeg_set_defaults + jpeg_set_quality(q, TRUE) (cv2.imencode's defaults):
// JFIF APP0, Annex K tables scaled by quality, baseline, 4:2:0 for colour,
// one component for grey, ISLOW forward DCT, standard Huffman tables.
//
// Integer arithmetic throughout, so the bytes do not depend on the compiler.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { kOk = 0, kCorrupt = 1, kUnsupported = 2 };

struct Fail {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) { throw Fail{code, msg}; }

// zigzag index -> natural index; entries past 63 catch runs that overshoot the block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---- standard tables (ITU T.81 Annex K) ----

const int kStdLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ---- fixed-point constants of jidctint.c / jfdctint.c / jdcolor.c / jccolor.c ----

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373,
                  F1_175 = 9633, F1_501 = 12299, F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;
constexpr int kScaleBits = 16;
constexpr int64_t kOneHalf = int64_t(1) << (kScaleBits - 1);
constexpr int64_t fix16(double x) { return int64_t(x * (1 << kScaleBits) + 0.5); }

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

struct Tables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  int64_t rgb_ycc[8 * 256];
  Tables() {
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((fix16(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = (int)((fix16(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = (-fix16(0.71414)) * x;
      cb_g[i] = (-fix16(0.34414)) * x + kOneHalf;
    }
    const int64_t cbcr_offset = int64_t(128) << kScaleBits;
    for (int i = 0; i < 256; i++) {
      rgb_ycc[i + 0 * 256] = fix16(0.29900) * i;
      rgb_ycc[i + 1 * 256] = fix16(0.58700) * i;
      rgb_ycc[i + 2 * 256] = fix16(0.11400) * i + kOneHalf;
      rgb_ycc[i + 3 * 256] = (-fix16(0.16874)) * i;
      rgb_ycc[i + 4 * 256] = (-fix16(0.33126)) * i;
      rgb_ycc[i + 5 * 256] = fix16(0.50000) * i + cbcr_offset + kOneHalf - 1;  // B->Cb and R->Cr
      rgb_ycc[i + 6 * 256] = (-fix16(0.41869)) * i;
      rgb_ycc[i + 7 * 256] = (-fix16(0.08131)) * i;
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// ============================== decoder ==============================

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t look_len[512];  // 9-bit lookahead: code length (0 when longer), symbol
  uint8_t look_sym[512];

  // get_dht: the table as the file gives it; derived when a scan uses it
  void set(const uint8_t* b, const uint8_t* v) {
    int count = 0;
    for (int l = 1; l <= 16; l++) count += b[l];
    if (count > 256) fail(kCorrupt, "bad Huffman table");
    memcpy(bits, b, 17);
    memset(vals, 0, sizeof vals);
    memcpy(vals, v, count);
    defined = true;
  }

  // jpeg_make_d_derived_tbl
  void derive(bool dc) {
    int count = 0;
    for (int l = 1; l <= 16; l++) count += bits[l];
    if (dc)
      for (int i = 0; i < count; i++)
        if (vals[i] > 15) fail(kCorrupt, "bad Huffman table");
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) fail(kCorrupt, "bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    memset(look_len, 0, sizeof look_len);
    p = 0;
    for (int l = 1; l <= 9; l++) {
      for (int i = 0; i < bits[l]; i++, p++) {
        int lookbits = huffcode[p] << (9 - l);
        for (int ctr = 1 << (9 - l); ctr > 0; ctr--, lookbits++) {
          look_len[lookbits] = (uint8_t)l;
          look_sym[lookbits] = vals[p];
        }
      }
    }
  }
};

// The entropy-coded bytes as libjpeg's stdio source delivers them: the file, then
// an endless fake EOI (FF D9 ...) past its end. A marker stops the bit reader; bits
// asked for after it read as zeros and set ``insufficient``.
struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  int marker = 0;
  bool insufficient = false;

  int byte() {
    if (pos < n) return d[pos++];
    int r = ((pos - n) & 1) ? 0xD9 : 0xFF;
    pos++;
    return r;
  }
  void fill() {
    while (nbits <= 48 && !marker) {
      int c = byte();
      if (c == 0xFF) {
        do c = byte(); while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          marker = c;
          break;
        }
      }
      acc = (acc << 8) | (uint64_t)c;
      nbits += 8;
    }
  }
  int get(int s) {
    if (s == 0) return 0;
    if (nbits < s) {
      fill();
      if (nbits < s) {
        insufficient = true;
        acc <<= (s - nbits);
        nbits = s;
      }
    }
    nbits -= s;
    return (int)((acc >> nbits) & ((1u << s) - 1));
  }
  int decode(const HuffTable& t) {
    int code, l;
    if (nbits < 9) fill();
    if (nbits >= 9) {
      int look = (int)((acc >> (nbits - 9)) & 511);
      if (t.look_len[look]) {
        nbits -= t.look_len[look];
        return t.look_sym[look];
      }
      code = get(9);
      l = 9;
    } else {
      code = get(1);
      l = 1;
    }
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      l++;
    }
    if (l > 16) return 0;  // corrupt data: libjpeg fakes a zero
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  void discard() {
    acc = 0;
    nbits = 0;
  }
  // next_marker(): skip to the next FF xx with xx neither 00 nor FF
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int wib = 0, hib = 0;  // width and height in blocks
  int bw = 0, bh = 0;    // allocated blocks (MCU-padded)
  int dsw = 0, dsh = 0;  // downsampled width and height
  int dc_tbl = 0, ac_tbl = 0;
  int last_dc = 0;
  bool latched = false;
  int quant[64];
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;  // wib*8 x hib*8 after the IDCT
  int16_t* block(int bx, int by) { return &coef[((size_t)by * bw + bx) * 64]; }
};

uint16_t rd16(const uint8_t* p, bool le) { return le ? (uint16_t)(p[0] | p[1] << 8) : (uint16_t)(p[0] << 8 | p[1]); }
uint32_t rd32(const uint8_t* p, bool le) {
  return le ? (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24
            : (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | (uint32_t)p[3];
}

// OpenCV's ExifReader on the first APP1 segment: skip 6 bytes ("Exif\0\0"), read the TIFF
// header and IFD0; the first Orientation entry's 16-bit value, or 1.
int exif_orientation(const uint8_t* d, size_t n) {
  if (n <= 6) return 1;
  d += 6;
  n -= 6;
  if (n < 2 || d[0] != d[1] || (d[0] != 'I' && d[0] != 'M')) return 1;
  bool le = d[0] == 'I';
  if (n < 8 || rd16(d + 2, le) != 0x2A) return 1;
  uint64_t off = rd32(d + 4, le);
  if (off + 2 > n) return 1;
  int count = rd16(d + off, le);
  off += 2;
  for (int i = 0; i < count; i++, off += 12) {
    if (off + 2 > n) return 1;
    if (rd16(d + off, le) == 0x0112) {
      if (off + 10 > n) return 1;
      return rd16(d + off + 8, le);
    }
  }
  return 1;
}

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  bool progressive = false;
  int height = 0, width = 0, ncomp = 0;
  int maxh = 1, maxv = 1;
  int mcux = 0, mcuy = 0;  // MCUs per row and MCU rows of an interleaved scan
  Component comp[4];
  int quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  bool have_app1 = false;
  bool frame = false;
  int scans = 0;
  // progression status (jdphuff.c): the Al of the last scan of each coefficient (zigzag order,
  // -1 before any), the same before the component's latest scan, and the last iMCU row of the
  // latest scan that began with data left (jdcoefct.c last_good_iMCU_row)
  int coef_bits[4][64];
  int prev_bits[4][64];
  int last_good_row = 0;
  BitReader br;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  // a byte of the file, past its end the fake EOI (FF D9 ...) of libjpeg's stdio source: a marker
  // segment cut by the end of the file reads on into it, as libjpeg reads it
  int u8() {
    int c = pos < n ? d[pos] : (((pos - n) & 1) ? 0xD9 : 0xFF);
    pos++;
    return c;
  }
  int u16() {
    int a = u8();
    return a << 8 | u8();
  }
  int next_marker() {
    // libjpeg's next_marker: skip non-FF bytes, FF fill and stuffed FF 00
    for (;;) {
      int c = u8();
      while (c != 0xFF) c = u8();
      do c = u8(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // Read markers up to the first SOS (header only) or through EOI (whole image).
  void read_header() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail(kCorrupt, "not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xDA) {
        if (!frame) fail(kCorrupt, "SOS before SOF");
        pos -= 2;
        return;
      }
      handle_marker(m);
    }
  }

  void handle_marker(int m) {
    if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) return;
    if (m == 0xD9) fail(kCorrupt, "JPEG file has no image (EOI before SOS)");
    int len = u16();
    if (len < 2) fail(kCorrupt, "bad JPEG marker length");
    size_t body = len - 2;
    std::vector<uint8_t> cut;
    const uint8_t* p = d + (pos < n ? pos : n);
    if (pos + body > n) {
      size_t at = pos;
      for (size_t i = 0; i < body; i++) cut.push_back((uint8_t)u8());
      pos = at;
      p = cut.data();
    }
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2:
        read_sof(m, p, body);
        break;
      case 0xC3: fail(kUnsupported, "lossless JPEG (SOF3) is not supported");
      case 0xC5: case 0xC6: case 0xC7:
        fail(kUnsupported, "hierarchical JPEG (SOF5-SOF7) is not supported");
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        fail(kUnsupported, "arithmetic-coded JPEG (SOF9-SOF15) is not supported");
      case 0xC4:
        read_dht(p, body);
        break;
      case 0xCC: fail(kUnsupported, "arithmetic-coded JPEG (DAC marker) is not supported");
      case 0xDB:
        read_dqt(p, body);
        break;
      case 0xDD:
        if (body < 2) fail(kCorrupt, "bad DRI marker");
        restart_interval = p[0] << 8 | p[1];
        break;
      case 0xE0:
        if (body >= 14 && memcmp(p, "JFIF\0", 5) == 0) jfif = true;
        break;
      case 0xE1:
        if (!have_app1) {
          have_app1 = true;
          orientation = exif_orientation(p, body);
        }
        break;
      case 0xEE:
        if (body >= 12 && memcmp(p, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = p[11];
        }
        break;
      default:
        break;
    }
    pos += body;
  }

  void read_sof(int m, const uint8_t* p, size_t body) {
    if (frame) fail(kCorrupt, "JPEG file has two SOF markers");
    if (body < 6) fail(kCorrupt, "bad SOF marker");
    int precision = p[0];
    height = p[1] << 8 | p[2];
    width = p[3] << 8 | p[4];
    ncomp = p[5];
    if (precision != 8) fail(kUnsupported, std::to_string(precision) + "-bit JPEG is not supported (8-bit only)");
    if (ncomp == 4) fail(kUnsupported, "4-component (CMYK/YCCK) JPEG is not supported");
    if (ncomp != 1 && ncomp != 3) fail(kUnsupported, std::to_string(ncomp) + "-component JPEG is not supported");
    if (height <= 0 || width <= 0) fail(kCorrupt, "JPEG image has an empty size (or a DNL marker)");
    if (body < 6 + 3 * (size_t)ncomp) fail(kCorrupt, "bad SOF marker");
    progressive = m == 0xC2;
    maxh = maxv = 1;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = p[6 + 3 * i];
      c.h = p[7 + 3 * i] >> 4;
      c.v = p[7 + 3 * i] & 15;
      c.tq = p[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail(kCorrupt, "bad SOF component");
      maxh = c.h > maxh ? c.h : maxh;
      maxv = c.v > maxv ? c.v : maxv;
    }
    mcux = (width + 8 * maxh - 1) / (8 * maxh);
    mcuy = (height + 8 * maxv - 1) / (8 * maxv);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.wib = (int)(((int64_t)width * c.h + 8 * maxh - 1) / (8 * maxh));
      c.hib = (int)(((int64_t)height * c.v + 8 * maxv - 1) / (8 * maxv));
      c.dsw = (int)(((int64_t)width * c.h + maxh - 1) / maxh);
      c.dsh = (int)(((int64_t)height * c.v + maxv - 1) / maxv);
      if (ncomp == 1) {  // libjpeg's coefficient array: rounded up to the sampling factors
        c.bw = (c.wib + c.h - 1) / c.h * c.h;
        c.bh = (c.hib + c.v - 1) / c.v * c.v;
      } else {
        c.bw = mcux * c.h;
        c.bh = mcuy * c.v;
      }
    }
    frame = true;
  }

  void read_dqt(const uint8_t* p, size_t body) {
    size_t i = 0;
    while (i < body) {
      int pq = p[i] >> 4, tq = p[i] & 15;
      i++;
      if (tq > 3) fail(kCorrupt, "bad DQT marker");
      size_t need = pq ? 128 : 64;
      if (i + need > body) fail(kCorrupt, "bad DQT marker");
      for (int k = 0; k < 64; k++) {
        int q = pq ? (p[i + 2 * k] << 8 | p[i + 2 * k + 1]) : p[i + k];
        quant[tq][kNatural[k]] = q;
      }
      quant_defined[tq] = true;
      i += need;
    }
  }

  void read_dht(const uint8_t* p, size_t body) {
    size_t i = 0;
    while (i < body) {
      if (i + 17 > body) fail(kCorrupt, "bad DHT marker");
      int tc = p[i] >> 4, th = p[i] & 15;
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int l = 1; l <= 16; l++) {
        bits[l] = p[i + l];
        count += bits[l];
      }
      i += 17;
      if (count > 256 || i + count > body || th > 3 || tc > 1) fail(kCorrupt, "bad DHT marker");
      (tc ? ac[th] : dc[th]).set(bits, p + i);
      i += count;
    }
  }

  // jdapimin.c default_decompress_parms: is a 3-component file RGB rather than YCbCr?
  bool is_rgb() const {
    if (ncomp != 3) return false;
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }

  int out_h() const { return orientation >= 5 && orientation <= 8 ? width : height; }
  int out_w() const { return orientation >= 5 && orientation <= 8 ? height : width; }

  // ---------- entropy decoding ----------

  struct Scan {
    int ncomp = 0;
    int ci[4];
    int ss = 0, se = 63, ah = 0, al = 0;
  };

  void decode_image() {
    read_header();  // stops at the first SOS
    for (int i = 0; i < ncomp; i++) {
      comp[i].coef.assign((size_t)comp[i].bw * comp[i].bh * 64, 0);
      for (int k = 0; k < 64; k++) coef_bits[i][k] = -1, prev_bits[i][k] = 0;
    }
    pos += 2;
    int m = 0xDA;
    // markers from the first SOS on; a file that ends reads as EOI
    for (;;) {
      if (m == 0xD9) return;
      if (m == 0xDA) {
        read_scan_and_decode();
        m = br.marker ? br.marker : next_marker();
        continue;
      }
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) fail(kCorrupt, "JPEG file has two SOF markers");
      if (!(m == 0x01 || (m >= 0xD0 && m <= 0xD7))) handle_marker(m);
      m = next_marker();
    }
  }

  // a scan's table, derived as its scan starts; a sequential file without tables (motion-JPEG)
  // gets the standard ones (jdhuff.c std_huff_tables)
  void derive(HuffTable* set, int id, bool dcclass) {
    if (id > 3) fail(kCorrupt, "JPEG scan names a Huffman table past 3");
    HuffTable& t = set[id];
    if (!t.defined) {
      if (progressive) fail(kCorrupt, "JPEG scan uses an undefined Huffman table");
      if (id == 0) t.set(dcclass ? kDcLumaBits : kAcLumaBits, dcclass ? kDcVals : kAcLumaVals);
      else if (id == 1) t.set(dcclass ? kDcChromaBits : kAcChromaBits, dcclass ? kDcVals : kAcChromaVals);
      else fail(kCorrupt, "JPEG scan uses an undefined Huffman table");
    }
    t.derive(dcclass);
  }

  void read_scan_and_decode() {
    int len = u16();
    Scan s;
    s.ncomp = u8();
    if (s.ncomp < 1 || s.ncomp > 4 || len != 6 + 2 * s.ncomp) fail(kCorrupt, "bad SOS marker");
    for (int i = 0; i < s.ncomp; i++) {
      int id = u8(), tbl = u8();
      int found = -1;
      for (int k = 0; k < ncomp; k++)
        if (comp[k].id == id) found = k;
      if (found < 0) fail(kCorrupt, "SOS names an unknown component");
      s.ci[i] = found;
      comp[found].dc_tbl = tbl >> 4;
      comp[found].ac_tbl = tbl & 15;
    }
    s.ss = u8();
    s.se = u8();
    int a = u8();
    s.ah = a >> 4;
    s.al = a & 15;
    if (progressive) {
      bool bad = s.ss > s.se || s.se > 63 || s.al > 13 || (s.ah && s.ah != s.al + 1);
      if (s.ss == 0 ? s.se != 0 : s.ncomp != 1) bad = true;
      if (bad) fail(kCorrupt, "bad progressive scan parameters");
    } else {
      s.ss = 0;
      s.se = 63;
      s.ah = s.al = 0;
    }
    if (progressive) {  // start_pass_phuff_decoder's progression status
      for (int i = 0; i < s.ncomp; i++) {
        int* cur = coef_bits[s.ci[i]];
        int* prev = prev_bits[s.ci[i]];
        for (int k = s.ss < 1 ? s.ss : 1; k <= (s.se > 9 ? s.se : 9); k++) prev[k] = scans > 0 ? cur[k] : 0;
        for (int k = s.ss; k <= s.se; k++) cur[k] = s.al;
      }
    }
    for (int i = 0; i < s.ncomp; i++) {
      Component& c = comp[s.ci[i]];
      if (!c.latched) {
        if (!quant_defined[c.tq]) fail(kCorrupt, "JPEG component uses an undefined quantization table");
        memcpy(c.quant, quant[c.tq], sizeof c.quant);
        c.latched = true;
      }
      c.last_dc = 0;
      if (s.ss == 0 && s.ah == 0) derive(dc, c.dc_tbl, true);
      if (s.se > 0) derive(ac, c.ac_tbl, false);
    }
    decode_scan(s);
    scans++;
  }

  void decode_scan(const Scan& s) {
    br = BitReader();
    br.d = d;
    br.n = n;
    br.pos = pos;
    int next_rst = 0;
    int restarts_to_go = restart_interval;
    unsigned eobrun = 0;
    int units_x, units_y;
    if (s.ncomp == 1) {
      units_x = comp[s.ci[0]].wib;
      units_y = comp[s.ci[0]].hib;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    for (int my = 0; my < units_y; my++) {
      for (int mx = 0; mx < units_x; mx++) {
        if (!br.insufficient) last_good_row = s.ncomp == 1 ? my / comp[s.ci[0]].v : my;
        if (restart_interval) {
          if (restarts_to_go == 0) {
            process_restart(next_rst);
            next_rst = (next_rst + 1) & 7;
            for (int i = 0; i < s.ncomp; i++) comp[s.ci[i]].last_dc = 0;
            eobrun = 0;
            restarts_to_go = restart_interval;
            if (br.marker == 0) br.insufficient = false;
          }
        }
        bool skip = br.insufficient;
        if (s.ncomp == 1) {
          Component& c = comp[s.ci[0]];
          decode_block(s, c, c.block(mx, my), eobrun, skip);
        } else {
          for (int i = 0; i < s.ncomp; i++) {
            Component& c = comp[s.ci[i]];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++)
                decode_block(s, c, c.block(mx * c.h + h, my * c.v + v), eobrun, skip);
          }
        }
        if (restart_interval) restarts_to_go--;
      }
    }
    // the scan's end: the marker that stopped the bit reader (br.marker), or the next
    // one from where it stopped reading
    pos = br.pos;
  }

  void process_restart(int expected) {
    br.discard();
    if (br.marker == 0) br.marker = br.next_marker();
    int desired = expected;
    if (br.marker == 0xD0 + desired) {
      br.marker = 0;
      return;
    }
    // jpeg_resync_to_restart
    for (;;) {
      int m = br.marker, action;
      if (m < 0xC0) action = 2;
      else if (m < 0xD0 || m > 0xD7) action = 3;
      else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) action = 3;
      else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) action = 2;
      else action = 1;
      if (action == 1) {
        br.marker = 0;
        return;
      }
      if (action == 3) return;
      br.marker = br.next_marker();
    }
  }

  void decode_block(const Scan& s, Component& c, int16_t* blk, unsigned& eobrun, bool skip) {
    if (!progressive) {
      if (skip) return;
      const HuffTable& dct = dc[c.dc_tbl];
      const HuffTable& act = ac[c.ac_tbl];
      int t = br.decode(dct);
      int diff = 0;
      if (t) diff = extend(br.get(t), t);
      c.last_dc += diff;
      blk[0] = (int16_t)c.last_dc;
      for (int k = 1; k < 64; k++) {
        int rs = br.decode(act);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          blk[kNatural[k]] = (int16_t)extend(br.get(sz), sz);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (s.ss == 0) {
      if (s.ah == 0) {  // DC first
        if (skip) return;
        int t = br.decode(dc[c.dc_tbl]);
        int diff = 0;
        if (t) diff = extend(br.get(t), t);
        c.last_dc += diff;
        blk[0] = (int16_t)(int)((unsigned)c.last_dc << s.al);
      } else {  // DC refine (libjpeg reads even after the data ran out)
        if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << s.al));
      }
      return;
    }
    if (skip) return;
    const HuffTable& act = ac[c.ac_tbl];
    if (s.ah == 0) {  // AC first
      if (eobrun > 0) {
        eobrun--;
        return;
      }
      for (int k = s.ss; k <= s.se; k++) {
        int rs = br.decode(act);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          int v = extend(br.get(sz), sz);
          blk[kNatural[k]] = (int16_t)(int)((unsigned)v << s.al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1u << r;
          if (r) eobrun += br.get(r);
          eobrun--;
          break;
        }
      }
      return;
    }
    // AC refine
    int p1 = 1 << s.al, m1 = -1 * (1 << s.al);
    int k = s.ss;
    if (eobrun == 0) {
      for (; k <= s.se; k++) {
        int rs = br.decode(act);
        int r = rs >> 4, sz = rs & 15;
        int val = 0;
        if (sz) {
          val = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1u << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* co = blk + kNatural[k];
          if (*co != 0) {
            if (br.get(1)) {
              if ((*co & p1) == 0) *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= s.se);
        if (val) blk[kNatural[k]] = (int16_t)val;
      }
    }
    if (eobrun > 0) {
      for (; k <= s.se; k++) {
        int16_t* co = blk + kNatural[k];
        if (*co != 0) {
          if (br.get(1)) {
            if ((*co & p1) == 0) *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
          }
        }
      }
      eobrun--;
    }
  }

  // ---------- IDCT (jidctint.c jpeg_idct_islow) ----------

  static void idct_islow(const int16_t* in, const int* q, uint8_t* out, int stride) {
    int ws[64];
    for (int col = 0; col < 8; col++) {
      const int16_t* ip = in + col;
      const int* qp = q + col;
      int* wp = ws + col;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
          ip[56] == 0) {
        int dcval = (int)((int64_t)ip[0] * qp[0] * (1 << kPass1Bits));
        for (int r = 0; r < 8; r++) wp[8 * r] = dcval;
        continue;
      }
      int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0_541;
      int64_t tmp2 = z1 + z3 * (-F1_847);
      int64_t tmp3 = z1 + z2 * F0_765;
      z2 = (int64_t)ip[0] * qp[0];
      z3 = (int64_t)ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
      int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = (int64_t)ip[56] * qp[56];
      tmp1 = (int64_t)ip[40] * qp[40];
      tmp2 = (int64_t)ip[24] * qp[24];
      tmp3 = (int64_t)ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = kConstBits - kPass1Bits;
      wp[0] = (int)descale(tmp10 + tmp3, sh);
      wp[56] = (int)descale(tmp10 - tmp3, sh);
      wp[8] = (int)descale(tmp11 + tmp2, sh);
      wp[48] = (int)descale(tmp11 - tmp2, sh);
      wp[16] = (int)descale(tmp12 + tmp1, sh);
      wp[40] = (int)descale(tmp12 - tmp1, sh);
      wp[24] = (int)descale(tmp13 + tmp0, sh);
      wp[32] = (int)descale(tmp13 - tmp0, sh);
    }
    for (int row = 0; row < 8; row++) {
      const int* wp = ws + 8 * row;
      uint8_t* op = out + (size_t)row * stride;
      if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
        uint8_t v = clamp255((int)descale(wp[0], kPass1Bits + 3) + 128);
        for (int i = 0; i < 8; i++) op[i] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0_541;
      int64_t tmp2 = z1 + z3 * (-F1_847);
      int64_t tmp3 = z1 + z2 * F0_765;
      int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << kConstBits);
      int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << kConstBits);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = kConstBits + kPass1Bits + 3;
      op[0] = clamp255((int)descale(tmp10 + tmp3, sh) + 128);
      op[7] = clamp255((int)descale(tmp10 - tmp3, sh) + 128);
      op[1] = clamp255((int)descale(tmp11 + tmp2, sh) + 128);
      op[6] = clamp255((int)descale(tmp11 - tmp2, sh) + 128);
      op[2] = clamp255((int)descale(tmp12 + tmp1, sh) + 128);
      op[5] = clamp255((int)descale(tmp12 - tmp1, sh) + 128);
      op[3] = clamp255((int)descale(tmp13 + tmp0, sh) + 128);
      op[4] = clamp255((int)descale(tmp13 - tmp0, sh) + 128);
    }
  }

  // jdcoefct.c smoothing_ok: the progression status latched for the output pass (cur, and prev
  // for the iMCU rows after the one the data ran out in); true where block smoothing applies
  bool smoothing_ok(int cur[][10], int prev[][10]) const {
    if (!progressive) return false;
    bool useful = false;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    for (int i = 0; i < ncomp; i++) {
      const Component& c = comp[i];
      if (!c.latched) return false;
      for (int k = 0; k < 10; k++)
        if (c.quant[kPos[k]] == 0) return false;
      if (coef_bits[i][0] < 0) return false;
      cur[i][0] = coef_bits[i][0];
      for (int k = 1; k < 10; k++) {
        prev[i][k] = scans > 1 ? prev_bits[i][k] : -1;
        cur[i][k] = coef_bits[i][k];
        if (coef_bits[i][k] != 0) useful = true;
      }
    }
    return useful;
  }

  // one estimate of jdcoefct.c decompress_smooth_data: applied where the coefficient is still
  // zero and not known to be exact (Al != 0), clamped below the first bit not yet received
  static void estimate(int16_t* ws, int pos, int al, int64_t num, int64_t q) {
    if (al == 0 || ws[pos] != 0) return;
    int pred;
    if (num >= 0) {
      pred = (int)(((q << 7) + num) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = (int)(((q << 7) - num) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    ws[pos] = (int16_t)pred;
  }

  // block smoothing of a progressive image whose low coefficients are not all exact (a file cut
  // before its last scans): libjpeg-turbo's 5x5 window of DC values around each block
  void idct_smoothed(int ci, const int* cur, const int* prev) {
    Component& c = comp[ci];
    size_t pw = (size_t)c.wib * 8;
    const int T = mcuy;
    const int64_t Q00 = c.quant[0], Q01 = c.quant[1], Q10 = c.quant[8], Q20 = c.quant[16], Q11 = c.quant[9],
                  Q02 = c.quant[2], Q03 = c.quant[3], Q12 = c.quant[10], Q21 = c.quant[17], Q30 = c.quant[24];
    int16_t ws[64];
    for (int r = 0; r < T; r++) {
      int block_rows = r < T - 1 ? c.v : (c.hib % c.v ? c.hib % c.v : c.v);
      const int* bits = r > last_good_row ? prev : cur;
      bool change_dc = true;
      for (int k = 1; k < 10; k++) change_dc = change_dc && bits[k] == -1;
      int image_block_rows = block_rows * T;  // libjpeg's own count, kept as it is
      for (int b = 0; b < block_rows; b++) {
        int ibr = r * block_rows + b, row = r * c.v + b;
        int rows[5];
        rows[2] = row;
        rows[1] = ibr > 0 ? row - 1 : row;
        rows[0] = ibr > 1 ? row - 2 : rows[1];
        rows[3] = ibr < image_block_rows - 1 ? row + 1 : row;
        rows[4] = ibr < image_block_rows - 2 ? row + 2 : rows[3];
        for (int bx = 0; bx < c.wib; bx++) {
          int64_t D[26];  // D[1..25]: DC01..DC25, row by row
          for (int i = 0; i < 5; i++)
            for (int j = 0; j < 5; j++) {
              int x = bx - 2 + j;
              x = x < 0 ? 0 : x > c.wib - 1 ? c.wib - 1 : x;
              D[1 + 5 * i + j] = c.block(x, rows[i])[0];
            }
          memcpy(ws, c.block(bx, row), sizeof ws);
          int64_t n;
          n = change_dc ? (-D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] + 3 * D[10] - 3 * D[11] +
                           38 * D[12] - 38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17] - 13 * D[19] + 3 * D[20] -
                           D[21] - D[22] + D[24] + D[25])
                        : (-7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]);
          estimate(ws, 1, bits[1], Q00 * n, Q01);
          n = change_dc ? (-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] + 38 * D[8] +
                           13 * D[9] - D[10] + D[16] - 13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] + D[21] +
                           3 * D[22] + 3 * D[23] + 3 * D[24] + D[25])
                        : (-7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]);
          estimate(ws, 8, bits[2], Q00 * n, Q10);
          n = change_dc ? (D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] - 5 * D[14] + 2 * D[17] +
                           7 * D[18] + 2 * D[19] + D[23])
                        : (-D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]);
          estimate(ws, 16, bits[3], Q00 * n, Q20);
          n = change_dc ? (-D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] - D[25])
                        : (D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] - D[24] + D[4] - D[6] +
                           10 * D[7] - 10 * D[9]);
          estimate(ws, 9, bits[4], Q00 * n, Q11);
          n = change_dc ? (2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] + 7 * D[14] + D[15] +
                           2 * D[17] - 5 * D[18] + 2 * D[19])
                        : (-D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]);
          estimate(ws, 2, bits[5], Q00 * n, Q02);
          if (change_dc) {
            estimate(ws, 3, bits[6], Q00 * (D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]), Q03);
            estimate(ws, 10, bits[7], Q00 * (D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]), Q12);
            estimate(ws, 17, bits[8], Q00 * (D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]), Q21);
            estimate(ws, 24, bits[9], Q00 * (D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]), Q30);
            int64_t num = Q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] + 6 * D[7] +
                                 42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] + 42 * D[12] + 152 * D[13] +
                                 42 * D[14] - 8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] -
                                 6 * D[20] - 2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25]);
            int pred = num >= 0 ? (int)(((Q00 << 7) + num) / (Q00 << 8)) : -(int)(((Q00 << 7) - num) / (Q00 << 8));
            ws[0] = (int16_t)pred;
          }
          if (row < c.hib) idct_islow(ws, c.quant, &c.plane[(size_t)row * 8 * pw + bx * 8], (int)pw);
        }
      }
    }
  }

  void idct_all() {
    int cur[4][10], prev[4][10];
    bool smooth = smoothing_ok(cur, prev);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (!c.latched) {  // a component no scan carried: libjpeg's output is mid-grey
        if (quant_defined[c.tq]) memcpy(c.quant, quant[c.tq], sizeof c.quant);
        else for (int k = 0; k < 64; k++) c.quant[k] = 1;
      }
      size_t pw = (size_t)c.wib * 8;
      c.plane.assign(pw * c.hib * 8, 0);
      if (smooth) {
        idct_smoothed(i, cur[i], prev[i]);
        continue;
      }
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++)
          idct_islow(c.block(bx, by), c.quant, &c.plane[(size_t)by * 8 * pw + bx * 8], (int)pw);
    }
  }

  // ---------- upsampling (jdsample.c) ----------

  enum Method { kFull, kH2V1Fancy, kH1V2Fancy, kH2V2Fancy, kInt };

  Method method(const Component& c, int& hx, int& vx) const {
    hx = maxh / c.h;
    vx = maxv / c.v;
    if (c.h == maxh && c.v == maxv) return kFull;
    if (c.h * 2 == maxh && c.v == maxv && c.dsw > 2) return kH2V1Fancy;
    if (c.h == maxh && c.v * 2 == maxv) return kH1V2Fancy;
    if (c.h * 2 == maxh && c.v * 2 == maxv && c.dsw > 2) return kH2V2Fancy;
    if (maxh % c.h || maxv % c.v) fail(kUnsupported, "JPEG with fractional sampling factors is not supported");
    return kInt;
  }

  // one full-size row y of component c into out[0 .. width)
  void upsample_row(const Component& c, Method m, int hx, int vx, int y, uint8_t* out, int* colsum) const {
    size_t pw = (size_t)c.wib * 8;
    const uint8_t* plane = c.plane.data();
    int W = width;
    switch (m) {
      case kFull:
        memcpy(out, plane + (size_t)y * pw, W);
        return;
      case kInt: {
        const uint8_t* row = plane + (size_t)(y / vx) * pw;
        for (int x = 0; x < W; x++) out[x] = row[x / hx];
        return;
      }
      case kH2V1Fancy: {
        const uint8_t* in = plane + (size_t)y * pw;
        int n = c.dsw;
        for (int i = 0; i < n; i++) {
          int cur = in[i] * 3;
          int prev = in[i > 0 ? i - 1 : 0], next = in[i + 1 < n ? i + 1 : n - 1];
          int x = 2 * i;
          if (x < W) out[x] = (uint8_t)((cur + prev + 1) >> 2);
          if (x + 1 < W) out[x + 1] = (uint8_t)((cur + next + 2) >> 2);
        }
        return;
      }
      case kH1V2Fancy: {
        int r = y >> 1;
        int far = (y & 1) ? (r + 1 < c.dsh ? r + 1 : c.dsh - 1) : (r > 0 ? r - 1 : 0);
        int bias = (y & 1) ? 2 : 1;
        const uint8_t* a = plane + (size_t)r * pw;
        const uint8_t* b = plane + (size_t)far * pw;
        for (int x = 0; x < W; x++) out[x] = (uint8_t)((a[x] * 3 + b[x] + bias) >> 2);
        return;
      }
      case kH2V2Fancy: {
        int r = y >> 1;
        int far = (y & 1) ? (r + 1 < c.dsh ? r + 1 : c.dsh - 1) : (r > 0 ? r - 1 : 0);
        const uint8_t* a = plane + (size_t)r * pw;
        const uint8_t* b = plane + (size_t)far * pw;
        int n = c.dsw;
        for (int i = 0; i < n; i++) colsum[i] = a[i] * 3 + b[i];
        for (int i = 0; i < n; i++) {
          int cur = colsum[i] * 3;
          int prev = colsum[i > 0 ? i - 1 : 0], next = colsum[i + 1 < n ? i + 1 : n - 1];
          int x = 2 * i;
          if (x < W) out[x] = (uint8_t)((cur + prev + 8) >> 4);
          if (x + 1 < W) out[x + 1] = (uint8_t)((cur + next + 7) >> 4);
        }
        return;
      }
    }
  }

  void write_bgr(uint8_t* dst) {
    const Tables& t = tables();
    int H = height, W = width;
    Method m[3];
    int hx[3], vx[3];
    for (int i = 0; i < ncomp; i++) m[i] = method(comp[i], hx[i], vx[i]);
    std::vector<uint8_t> rows((size_t)ncomp * W);
    std::vector<int> colsum((size_t)W + 8);
    bool rgb = is_rgb();
    for (int y = 0; y < H; y++) {
      for (int i = 0; i < ncomp; i++) upsample_row(comp[i], m[i], hx[i], vx[i], y, &rows[(size_t)i * W], colsum.data());
      int64_t base, step;
      switch (orientation) {
        case 2: base = (int64_t)y * W + W - 1; step = -1; break;
        case 3: base = (int64_t)(H - 1 - y) * W + W - 1; step = -1; break;
        case 4: base = (int64_t)(H - 1 - y) * W; step = 1; break;
        case 5: base = y; step = H; break;
        case 6: base = H - 1 - y; step = H; break;
        case 7: base = (int64_t)(W - 1) * H + H - 1 - y; step = -H; break;
        case 8: base = (int64_t)(W - 1) * H + y; step = -H; break;
        default: base = (int64_t)y * W; step = 1; break;
      }
      uint8_t* o = dst + base * 3;
      const int64_t st = step * 3;
      const uint8_t* r0 = rows.data();
      if (ncomp == 1) {
        for (int x = 0; x < W; x++, o += st) o[0] = o[1] = o[2] = r0[x];
      } else if (rgb) {
        const uint8_t* r1 = r0 + W;
        const uint8_t* r2 = r1 + W;
        for (int x = 0; x < W; x++, o += st) {
          o[0] = r2[x];
          o[1] = r1[x];
          o[2] = r0[x];
        }
      } else {
        const uint8_t* cb = r0 + W;
        const uint8_t* cr = cb + W;
        for (int x = 0; x < W; x++, o += st) {
          int yy = r0[x], b = cb[x], r = cr[x];
          o[2] = clamp255(yy + t.cr_r[r]);
          o[1] = clamp255(yy + (int)((t.cb_g[b] + t.cr_g[r]) >> kScaleBits));
          o[0] = clamp255(yy + t.cb_b[b]);
        }
      }
    }
  }
};

// ============================== encoder ==============================

struct CodeTable {
  uint32_t code[256];
  uint8_t size[256];
  void set(const uint8_t* bits, const uint8_t* vals) {
    memset(size, 0, sizeof size);
    int huffsize[257], huffcode[257], p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int last = p, c = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = c++;
      c <<= 1;
      si++;
    }
    for (p = 0; p < last; p++) {
      code[vals[p]] = (uint32_t)huffcode[p];
      size[vals[p]] = (uint8_t)huffsize[p];
    }
  }
};

struct Out {
  std::vector<uint8_t> bytes;
  uint64_t acc = 0;
  int nbits = 0;
  void marker(int m) {
    bytes.push_back(0xFF);
    bytes.push_back((uint8_t)m);
  }
  void u16(int v) {
    bytes.push_back((uint8_t)(v >> 8));
    bytes.push_back((uint8_t)v);
  }
  void put(uint32_t code, int len) {
    acc = (acc << len) | (code & ((1u << len) - 1));
    nbits += len;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> (nbits - 8));
      bytes.push_back(b);
      if (b == 0xFF) bytes.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits) put(0x7F, 8 - nbits);
    acc = 0;
    nbits = 0;
  }
};

// jcdctmgr.c compute_reciprocal with a 16-bit DCTELEM (libjpeg-turbo's SIMD builds)
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(unsigned divisor) {
  Divisor r;  // divisor >= 8 here (a quantizer times 8), so never the identity case
  int b = 0;
  while ((1u << (b + 1)) <= divisor) b++;  // flss(divisor) - 1
  int rr = 16 + b;
  uint64_t fq = (uint64_t(1) << rr) / divisor, fr = (uint64_t(1) << rr) % divisor;
  unsigned c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    rr--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  r.recip = (uint32_t)fq;
  r.corr = c;
  r.shift = rr;
  return r;
}

void fdct_islow(int* data) {
  int* p = data;
  for (int row = 0; row < 8; row++, p += 8) {
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int)((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = (int)((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0_541;
    p[2] = (int)descale(z1 + tmp13 * F0_765, kConstBits - kPass1Bits);
    p[6] = (int)descale(z1 + tmp12 * (-F1_847), kConstBits - kPass1Bits);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp4 *= F0_298;
    tmp5 *= F2_053;
    tmp6 *= F3_072;
    tmp7 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    p[7] = (int)descale(tmp4 + z1 + z3, kConstBits - kPass1Bits);
    p[5] = (int)descale(tmp5 + z2 + z4, kConstBits - kPass1Bits);
    p[3] = (int)descale(tmp6 + z2 + z3, kConstBits - kPass1Bits);
    p[1] = (int)descale(tmp7 + z1 + z4, kConstBits - kPass1Bits);
  }
  p = data;
  for (int col = 0; col < 8; col++, p++) {
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int)descale(tmp10 + tmp11, kPass1Bits);
    p[32] = (int)descale(tmp10 - tmp11, kPass1Bits);
    int64_t z1 = (tmp12 + tmp13) * F0_541;
    p[16] = (int)descale(z1 + tmp13 * F0_765, kConstBits + kPass1Bits);
    p[48] = (int)descale(z1 + tmp12 * (-F1_847), kConstBits + kPass1Bits);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp4 *= F0_298;
    tmp5 *= F2_053;
    tmp6 *= F3_072;
    tmp7 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    p[56] = (int)descale(tmp4 + z1 + z3, kConstBits + kPass1Bits);
    p[40] = (int)descale(tmp5 + z2 + z4, kConstBits + kPass1Bits);
    p[24] = (int)descale(tmp6 + z2 + z3, kConstBits + kPass1Bits);
    p[8] = (int)descale(tmp7 + z1 + z4, kConstBits + kPass1Bits);
  }
}

struct Encoder {
  int H, W, channels, quality;
  int qt[2][64];      // natural order
  Divisor div[2][64];
  CodeTable dcc[2], acc[2];

  void set_quant() {
    int q = quality <= 0 ? 1 : quality > 100 ? 100 : quality;
    int scale = q < 50 ? 5000 / q : 200 - q * 2;
    for (int t = 0; t < 2; t++) {
      const int* base = t ? kStdChromaQuant : kStdLumaQuant;
      for (int i = 0; i < 64; i++) {
        long v = ((long)base[i] * scale + 50L) / 100L;
        if (v <= 0) v = 1;
        if (v > 32767) v = 32767;
        if (v > 255) v = 255;  // force_baseline
        qt[t][i] = (int)v;
        div[t][i] = reciprocal((unsigned)v << 3);
      }
    }
  }

  // one 8x8 block of a plane (already edge-padded) -> quantized coefficients, natural order
  void block(const uint8_t* plane, size_t stride, int bx, int by, int t, int* out) const {
    int data[64];
    for (int r = 0; r < 8; r++) {
      const uint8_t* row = plane + (size_t)(by * 8 + r) * stride + bx * 8;
      for (int c = 0; c < 8; c++) data[8 * r + c] = (int)row[c] - 128;
    }
    fdct_islow(data);
    for (int i = 0; i < 64; i++) {
      int v = data[i];
      const Divisor& dv = div[t][i];
      uint64_t mag = (uint64_t)(v < 0 ? -v : v);
      uint64_t prod = (mag + dv.corr) * dv.recip;
      int qv = (int)(prod >> dv.shift);
      out[i] = v < 0 ? -qv : qv;
    }
  }

  void emit_block(Out& o, const int* blk, int& last_dc, int t) const {
    int temp = blk[0] - last_dc;
    last_dc = blk[0];
    int temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    int nb = 0;
    while (temp) {
      nb++;
      temp >>= 1;
    }
    o.put(dcc[t].code[nb], dcc[t].size[nb]);
    if (nb) o.put((uint32_t)temp2 & ((1u << nb) - 1), nb);
    int r = 0;
    for (int k = 1; k < 64; k++) {
      int v = blk[kNatural[k]];
      if (v == 0) {
        r++;
        continue;
      }
      while (r > 15) {
        o.put(acc[t].code[0xF0], acc[t].size[0xF0]);
        r -= 16;
      }
      int v2 = v;
      if (v < 0) {
        v = -v;
        v2--;
      }
      nb = 1;
      while (v >>= 1) nb++;
      int sym = (r << 4) + nb;
      o.put(acc[t].code[sym], acc[t].size[sym]);
      o.put((uint32_t)v2 & ((1u << nb) - 1), nb);
      r = 0;
    }
    if (r > 0) o.put(acc[t].code[0], acc[t].size[0]);
  }

  void headers(Out& o) const {
    o.marker(0xD8);
    static const uint8_t jfif[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    o.bytes.insert(o.bytes.end(), jfif, jfif + sizeof jfif);
    int ntab = channels == 3 ? 2 : 1;
    for (int t = 0; t < ntab; t++) {
      o.marker(0xDB);
      o.u16(67);
      o.bytes.push_back((uint8_t)t);
      for (int k = 0; k < 64; k++) o.bytes.push_back((uint8_t)qt[t][kNatural[k]]);
    }
    o.marker(0xC0);
    o.u16(8 + 3 * channels);
    o.bytes.push_back(8);
    o.u16(H);
    o.u16(W);
    o.bytes.push_back((uint8_t)channels);
    for (int c = 0; c < channels; c++) {
      o.bytes.push_back((uint8_t)(c + 1));
      o.bytes.push_back(channels == 3 && c == 0 ? 0x22 : 0x11);
      o.bytes.push_back(c == 0 ? 0 : 1);
    }
    auto dht = [&](int cls, int id, const uint8_t* bits, const uint8_t* vals) {
      int count = 0;
      for (int l = 1; l <= 16; l++) count += bits[l];
      o.marker(0xC4);
      o.u16(2 + 1 + 16 + count);
      o.bytes.push_back((uint8_t)(cls << 4 | id));
      o.bytes.insert(o.bytes.end(), bits + 1, bits + 17);
      o.bytes.insert(o.bytes.end(), vals, vals + count);
    };
    dht(0, 0, kDcLumaBits, kDcVals);
    dht(1, 0, kAcLumaBits, kAcLumaVals);
    if (channels == 3) {
      dht(0, 1, kDcChromaBits, kDcVals);
      dht(1, 1, kAcChromaBits, kAcChromaVals);
    }
    o.marker(0xDA);
    o.u16(6 + 2 * channels);
    o.bytes.push_back((uint8_t)channels);
    for (int c = 0; c < channels; c++) {
      o.bytes.push_back((uint8_t)(c + 1));
      o.bytes.push_back(c == 0 ? 0x00 : 0x11);
    }
    o.bytes.push_back(0);
    o.bytes.push_back(63);
    o.bytes.push_back(0);
  }

  std::vector<uint8_t> encode(const uint8_t* img) {
    set_quant();
    dcc[0].set(kDcLumaBits, kDcVals);
    acc[0].set(kAcLumaBits, kAcLumaVals);
    dcc[1].set(kDcChromaBits, kDcVals);
    acc[1].set(kAcChromaBits, kAcChromaVals);
    Out o;
    o.bytes.reserve((size_t)H * W * channels / 4 + 1024);
    headers(o);
    int blk[64];
    if (channels == 1) {
      int wib = (W + 7) / 8, hib = (H + 7) / 8;
      size_t pw = (size_t)wib * 8;
      std::vector<uint8_t> plane(pw * hib * 8);
      for (int y = 0; y < hib * 8; y++) {
        const uint8_t* src = img + (size_t)(y < H ? y : H - 1) * W;
        uint8_t* dst = &plane[(size_t)y * pw];
        memcpy(dst, src, W);
        for (size_t x = W; x < pw; x++) dst[x] = src[W - 1];
      }
      int last = 0;
      for (int by = 0; by < hib; by++)
        for (int bx = 0; bx < wib; bx++) {
          block(plane.data(), pw, bx, by, 0, blk);
          emit_block(o, blk, last, 0);
        }
    } else {
      encode_420(o, img);
    }
    o.flush();
    o.marker(0xD9);
    return std::move(o.bytes);
  }

  void encode_420(Out& o, const uint8_t* img) {
    const Tables& t = tables();
    int ywib = (W + 7) / 8, yhib = (H + 7) / 8;  // luma blocks
    int cwib = (W + 15) / 16, chib = (H + 15) / 16;  // chroma blocks
    int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
    // luma plane padded to the MCU grid; chroma at full size padded to 2 x chroma blocks
    size_t yw = (size_t)mcux * 16, yh = (size_t)mcuy * 16;
    size_t fw = (size_t)cwib * 16, fh = (size_t)(H + 1) / 2 * 2;
    std::vector<uint8_t> Y(yw * yh), cbf(fw * fh), crf(fw * fh);
    for (int y = 0; y < H; y++) {
      const uint8_t* src = img + (size_t)y * W * 3;
      uint8_t* py = &Y[(size_t)y * yw];
      uint8_t* pb = &cbf[(size_t)y * fw];
      uint8_t* pr = &crf[(size_t)y * fw];
      for (int x = 0; x < W; x++) {
        int b = src[3 * x], g = src[3 * x + 1], r = src[3 * x + 2];
        py[x] = (uint8_t)((t.rgb_ycc[r] + t.rgb_ycc[g + 256] + t.rgb_ycc[b + 512]) >> kScaleBits);
        pb[x] = (uint8_t)((t.rgb_ycc[r + 768] + t.rgb_ycc[g + 1024] + t.rgb_ycc[b + 1280]) >> kScaleBits);
        pr[x] = (uint8_t)((t.rgb_ycc[r + 1280] + t.rgb_ycc[g + 1536] + t.rgb_ycc[b + 1792]) >> kScaleBits);
      }
      for (size_t x = W; x < yw; x++) py[x] = py[W - 1];
      for (size_t x = W; x < fw; x++) {
        pb[x] = pb[W - 1];
        pr[x] = pr[W - 1];
      }
    }
    for (size_t y = H; y < yh; y++) memcpy(&Y[y * yw], &Y[(size_t)(H - 1) * yw], yw);
    if (fh > (size_t)H) {
      memcpy(&cbf[(size_t)H * fw], &cbf[(size_t)(H - 1) * fw], fw);
      memcpy(&crf[(size_t)H * fw], &crf[(size_t)(H - 1) * fw], fw);
    }
    // h2v2 downsampling with the alternating 1, 2 bias; rows past the image repeat the last
    size_t cw = (size_t)cwib * 8, ch = (size_t)chib * 8, crows = fh / 2;
    std::vector<uint8_t> CB(cw * ch), CR(cw * ch);
    for (size_t cy = 0; cy < ch; cy++) {
      size_t sy = cy < crows ? cy : crows - 1;
      const uint8_t* b0 = &cbf[2 * sy * fw];
      const uint8_t* b1 = b0 + fw;
      const uint8_t* r0 = &crf[2 * sy * fw];
      const uint8_t* r1 = r0 + fw;
      int bias = 1;
      for (size_t cx = 0; cx < cw; cx++) {
        CB[cy * cw + cx] = (uint8_t)((b0[2 * cx] + b0[2 * cx + 1] + b1[2 * cx] + b1[2 * cx + 1] + bias) >> 2);
        CR[cy * cw + cx] = (uint8_t)((r0[2 * cx] + r0[2 * cx + 1] + r1[2 * cx] + r1[2 * cx + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
    int last[3] = {0, 0, 0};
    int blk[64];
    for (int my = 0; my < mcuy; my++) {
      for (int mx = 0; mx < mcux; mx++) {
        // four luma blocks; those past the luma blocks are dummies (zero AC, DC of the
        // block before them in the MCU)
        int dcs[4];
        for (int v = 0; v < 2; v++) {
          for (int h = 0; h < 2; h++) {
            int bx = mx * 2 + h, by = my * 2 + v, k = v * 2 + h;
            if (by < yhib) {
              if (bx < ywib) {
                block(Y.data(), yw, bx, by, 0, blk);
              } else {
                memset(blk, 0, sizeof blk);
                blk[0] = dcs[k - 1];
              }
            } else {
              memset(blk, 0, sizeof blk);
              blk[0] = dcs[k - 1];
            }
            dcs[k] = blk[0];
            emit_block(o, blk, last[0], 0);
          }
        }
        block(CB.data(), cw, mx, my, 1, blk);
        emit_block(o, blk, last[1], 1);
        block(CR.data(), cw, mx, my, 1, blk);
        emit_block(o, blk, last[2], 1);
      }
    }
  }
};

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    size_t k = msg.size() < (size_t)errlen - 1 ? msg.size() : (size_t)errlen - 1;
    memcpy(err, msg.data(), k);
    err[k] = 0;
  }
}

}  // namespace

extern "C" {

// (h, w) after the Exif orientation and the number of components (1 or 3);
// 0 on success, 1 for a corrupt file, 2 for a kind of JPEG this decoder refuses.
int bsy_jpeg_info(const uint8_t* data, size_t n, int* h, int* w, int* channels, char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.read_header();
    *h = dec.out_h();
    *w = dec.out_w();
    *channels = dec.ncomp;
    return kOk;
  } catch (const Fail& f) {
    set_err(err, errlen, f.msg);
    return f.code;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return kCorrupt;
  }
}

// Decode into out, (h, w, 3) uint8 BGR with h, w as bsy_jpeg_info reports them.
int bsy_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, int h, int w, char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.decode_image();
    if (dec.out_h() != h || dec.out_w() != w) {
      set_err(err, errlen, "output size does not match the JPEG header");
      return kCorrupt;
    }
    dec.idct_all();
    dec.write_bgr(out);
    return kOk;
  } catch (const Fail& f) {
    set_err(err, errlen, f.msg);
    return f.code;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return kCorrupt;
  }
}

// Encode (h, w, 3) BGR or (h, w) grey uint8 pixels; *out is malloc'd, free it with bsy_jpeg_free.
int bsy_jpeg_encode(const uint8_t* img, int h, int w, int channels, int quality, uint8_t** out, size_t* n,
                    char* err, int errlen) {
  try {
    if (h <= 0 || w <= 0 || h > 65535 || w > 65535 || (channels != 1 && channels != 3))
      fail(kUnsupported, "JPEG encodes (h, w, 3) or (h, w) images of 1 to 65535 pixels a side");
    Encoder enc{h, w, channels, quality, {}, {}, {}, {}};
    std::vector<uint8_t> bytes = enc.encode(img);
    *out = (uint8_t*)malloc(bytes.size());
    if (!*out) fail(kCorrupt, "out of memory");
    memcpy(*out, bytes.data(), bytes.size());
    *n = bytes.size();
    return kOk;
  } catch (const Fail& f) {
    set_err(err, errlen, f.msg);
    return f.code;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return kCorrupt;
  }
}

void bsy_jpeg_free(uint8_t* p) { free(p); }

}  // extern "C"
