// Baseline JPEG decoder for camera_linearity_tpu_torch: the frames of an
// MJPG AVI, decoded into interleaved BGR uint8, with no libjpeg.
//
// Three modes.  The first two give the bytes libjpeg-turbo 2.1 gives for
// the same frame:
//   mode 0 (turbo): jpeg_idct_islow (13-bit constants, two pass-1 bits,
//             rounding descales), then fancy (triangle) upsampling of h2v1
//             and h2v2 chroma, then jdcolor's fixed-point YCbCr -> RGB
//             tables;
//   mode 1 (turbo_fast): jpeg_idct_ifast (8-bit AAN multipliers, truncating
//             descales), then jdmerge's merged upsample and colour convert,
//             which is replicated chroma.
// The third gives what cv2.VideoCapture gives for an MJPG frame, FFmpeg 8's
// MJPEG decoder and then swscale to BGR24 on x86-64 (native/jpeg_plain.py's
// docstring has each stage):
//   mode 2 (ffmpeg): the pixel formats FFmpeg reads without upscaling of
//             its own: gray8 (one component, any factors) and yuvj444p,
//             422p, 420p, 411p and 440p; sequential scans, one or several
//             (each block through the IDCT as it is read), or progressive
//             ones (SOF2; dequantized coefficients kept until EOI); the DC
//             predictor on dequantized values; FFmpeg's simple_idct as its
//             SSE2/AVX routine computes it (row pass first, saturated to 16
//             bits); then swscale's BGR24: gray8 replicated, 4:2:0 and
//             4:2:2 of even height by its unscaled SSSE3 path (replicated
//             chroma, truncating pmulhw), 4:4:4 by its full-chroma scaler
//             output (rounding), the rest (4:1:1, 4:4:0, odd heights) by
//             its scaled path with SWS_BICUBIC.  Data FFmpeg meets with an
//             error it conceals returns kUnmatched, and data that ends
//             before the first SOS marker kNoFrame (FFmpeg returns no
//             frame there).
// Input of modes 0 and 1: SOF0/SOF1, 8-bit, three components in one
// interleaved Huffman scan; DQT with 8- and 16-bit tables; DHT, or Annex
// K's standard tables for a slot no DHT defined (MJPEG cameras leave them
// out); DRI with RST0-7; byte stuffing and fill bytes; sampling with
// chroma at full size, halved across (h2v1) or halved both ways (h2v2);
// any width and height.  YCbCr, or RGB where an Adobe APP14 says
// transform 0 or the component IDs are 'R', 'G', 'B' (no JFIF APP0), as
// libjpeg decides.  Anything else returns kUnsupported (kComponents for a
// component count other than three, or in mode 2 other than one or
// three).  Entropy data that ends early decodes as libjpeg's does: zero
// bits past the end, and every later MCU of the segment left at zero.
//
// A fourth entry decodes the JPEG chunks of a TIFF (compression 7) as
// libtiff sets libjpeg up for TIFFReadRGBA*: the JPEGTables stream's
// segments spliced after each chunk's SOI, then mode 0's decode into one
// output form, libjpeg's own channel order: photometric YCbCr converted
// to RGB whatever the markers say, three components as stored (RGB), or
// one component (gray); libtiff's component count and sampling checks
// (the first component sampled as YCbCrSubSampling for YCbCr, 1x1
// otherwise, the rest 1x1) return kSampling or kComponents.
//
// Built as a plain shared library with g++ on first use;
// camera_linearity_tpu_torch.native loads it with ctypes.  The plain
// Python version in native/jpeg_plain.py is what the tests hold it to.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

#include "parallel.h"

namespace {

constexpr int kOk = 0;
constexpr int kCorrupt = -1;      // libjpeg would stop with an error
constexpr int kGeometry = -2;     // not the caller's height and width
constexpr int kComponents = -3;   // not three components (mode 2: not one or three)
constexpr int kUnsupported = -4;  // a mode this decoder does not read
constexpr int kUnmatched = -5;    // ffmpeg mode: an error FFmpeg conceals
constexpr int kNoFrame = -6;      // ffmpeg mode: data ends before the scan
constexpr int kSampling = -8;     // TIFF chunk: sampling libtiff refuses
constexpr int kOutside = -9;      // TIFF chunk: bytes outside the file

// kTiff: mode 0's decode of a TIFF chunk, one component allowed
enum Mode { kTurbo = 0, kTurboFast = 1, kFfmpeg = 2, kTiff = 3 };
// a TIFF chunk's output form (libjpeg's output colour space)
enum TiffForm { kFormYcc = 0, kFormStored = 1, kFormGray = 2 };

constexpr int kEoi = 0xD9;
constexpr int kLook = 9;          // Huffman lookahead bits

// zigzag index -> natural (row-major) index; the 16 extra entries catch a
// corrupt run that steps past the last coefficient, as libjpeg's do
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// AAN scale factors of jddctmgr.c, 14 bits, natural order
constexpr int kAanScales[64] = {
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,
    22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270,
    21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,
    19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315,
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,
    12873, 17855, 16819, 15137, 12873, 10114, 6967,  3552,
    8867,  12299, 11585, 10426, 8867,  6967,  4799,  2446,
    4520,  6270,  5906,  5315,  4520,  3552,  2446,  1247};

// A Huffman table as DHT gives it: counts per length 1..16, symbols.
struct HuffSpec {
    std::uint8_t bits[17];
    std::uint8_t val[256];
    bool defined;
};

// Annex K.3's tables, which libjpeg-turbo puts in slots 0 and 1 when no
// DHT defined them
constexpr std::uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1,
                                         0, 0, 0, 0, 0, 0, 0};
constexpr std::uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1,
                                           1, 1, 0, 0, 0, 0, 0};
constexpr std::uint8_t kDcVal[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr std::uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5,
                                         5, 4, 4, 0, 0, 1, 0x7d};
constexpr std::uint8_t kAcLumVal[162] = {
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
constexpr std::uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7,
                                           5, 4, 4, 0, 1, 2, 0x77};
constexpr std::uint8_t kAcChromVal[162] = {
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

void standard_table(HuffSpec& spec, const std::uint8_t* bits,
                    const std::uint8_t* val, int n) {
    std::memcpy(spec.bits, bits, 17);
    std::memset(spec.val, 0, sizeof(spec.val));
    std::memcpy(spec.val, val, n);
    spec.defined = true;
}

inline int extend(int x, int s) {
    return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x;
}

// A table ready to decode with (jdhuff.c's derived table): a lookahead of
// kLook bits gives (length << 8) | symbol for codes up to kLook bits, 0
// for longer ones, which walk maxcode.
struct Huff {
    std::uint16_t look[1 << kLook];
    std::int32_t maxcode[18];
    std::int32_t valoff[18];
    std::uint8_t val[256];
    // AC tables: a code and its extra bits together within kLook bits, as
    // (value << 16) | (run << 8) | bits taken; 0 for the rest
    std::int32_t fast_ac[1 << kLook];
};

// False for a table libjpeg rejects (JERR_BAD_HUFF_TABLE).
bool derive(const HuffSpec& spec, bool dc, Huff& h) {
    int size[257];
    std::uint32_t code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
        int i = spec.bits[l];
        if (p + i > 256) return false;
        while (i--) size[p++] = l;
    }
    size[p] = 0;
    const int nsym = p;
    std::uint32_t code = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
        while (size[p] == si) code_of[p++] = code++;
        if (code >= (1u << si)) return false;
        code <<= 1;
        ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (spec.bits[l]) {
            h.valoff[l] = p - static_cast<std::int32_t>(code_of[p]);
            p += spec.bits[l];
            h.maxcode[l] = static_cast<std::int32_t>(code_of[p - 1]);
        } else {
            h.maxcode[l] = -1;
        }
    }
    h.valoff[17] = 0;
    h.maxcode[17] = 0xFFFFF;
    std::memset(h.look, 0, sizeof(h.look));
    p = 0;
    for (int l = 1; l <= kLook; ++l) {
        for (int i = 0; i < spec.bits[l]; ++i, ++p) {
            std::uint32_t at = code_of[p] << (kLook - l);
            for (int k = 0; k < (1 << (kLook - l)); ++k)
                h.look[at++] = static_cast<std::uint16_t>((l << 8) | spec.val[p]);
        }
    }
    std::memcpy(h.val, spec.val, sizeof(h.val));
    for (int i = 0; i < (1 << kLook); ++i) {
        const int e = h.look[i], len = e >> 8, rs = e & 0xFF, sz = rs & 15;
        h.fast_ac[i] = 0;
        if (!len || !sz || len + sz > kLook) continue;
        const int bits = (i >> (kLook - len - sz)) & ((1 << sz) - 1);
        h.fast_ac[i] = static_cast<std::int32_t>(
            static_cast<std::uint32_t>(extend(bits, sz)) << 16) |
            ((rs >> 4) << 8) | (len + sz);
    }
    if (dc)
        for (int i = 0; i < nsym; ++i)
            if (spec.val[i] > 15) return false;
    return true;
}

// The byte source, as libjpeg's memory source sees it: past the end it
// reads fake EOI markers, FF D9 FF D9 ...
struct Source {
    const std::uint8_t* data;
    std::size_t n;
    std::size_t pos;
    bool sos = false;  // the header walk has met the first SOS marker

    inline int at(std::size_t i) const {
        return i < n ? data[i] : ((i - n) & 1) ? kEoi : 0xFF;
    }

    // The next marker at or after pos (jdmarker.c's next_marker): skips
    // other bytes, fill 0xFF bytes and stuffed FF 00 pairs.
    int next_marker() {
        for (;;) {
            int c = at(pos++);
            while (c != 0xFF) c = at(pos++);
            do c = at(pos++); while (c == 0xFF);
            if (c != 0) return c;
        }
    }
};

// Entropy-coded bits, MSB first, in the low `nbits` bits of `buf`.  Reading
// stops at a marker (kept in `marker`, as libjpeg's unread_marker); bits
// asked for past it are zeros, and taking one sets `insufficient`.
struct BitReader {
    Source* src;
    std::uint64_t buf = 0;
    int nbits = 0;
    int marker = 0;
    bool insufficient = false;
    bool bad_code = false;  // a code no table holds was read

    void fill() {
        std::size_t pos = src->pos;
        while (nbits <= 56 && !marker) {
            int c = src->at(pos++);
            if (c == 0xFF) {
                do c = src->at(pos++); while (c == 0xFF);
                if (c != 0) {
                    marker = c;
                    break;
                }
                c = 0xFF;
            }
            buf = (buf << 8) | static_cast<std::uint32_t>(c);
            nbits += 8;
        }
        src->pos = pos;
    }

    // k <= 32 bits, zeros past the data; reads no state but the buffer
    inline std::uint32_t peek(int k) {
        if (nbits < k) fill();
        if (nbits >= k)
            return static_cast<std::uint32_t>(buf >> (nbits - k)) & ((1u << k) - 1);
        return static_cast<std::uint32_t>(buf << (k - nbits)) & ((1u << k) - 1);
    }

    inline void skip(int k) {
        if (nbits < k) {
            fill();
            if (nbits < k) {  // past the data: pad with zero bits
                insufficient = true;
                buf <<= 57 - nbits;
                nbits = 57;
            }
        }
        nbits -= k;
    }

    inline int get(int k) {
        const int v = static_cast<int>(peek(k));
        skip(k);
        return v;
    }

    inline int decode(const Huff& h) {
        const int e = h.look[peek(kLook)];
        if (e >> 8) {
            skip(e >> 8);
            return e & 0xFF;
        }
        const std::uint32_t bits = peek(17);
        int l = kLook + 1;
        std::int32_t code = static_cast<std::int32_t>(bits >> (17 - l));
        while (code > h.maxcode[l]) {
            ++l;
            code = static_cast<std::int32_t>(bits >> (17 - l));
        }
        skip(l);
        if (l > 16) {  // a bad code: libjpeg warns, reads a zero
            bad_code = true;
            return 0;
        }
        return h.val[(code + h.valoff[l]) & 0xFF];
    }
};

inline std::uint8_t clamp255(int v) {
    return static_cast<std::uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

// The IDCTs below are libjpeg-turbo's as its x86-64 SIMD code computes
// them (jidctint-avx2, jidctfst-sse2), which is what it runs there: the
// same integer algorithms as jidctint.c and jidctfst.c, held in 16-bit
// lanes.  On valid data nothing leaves those lanes and the C and SIMD
// paths agree; on corrupt or truncated data a sum can wrap (i16) or
// saturate (sat16), and the sample saturates into [0, 255] where the C
// path's range-limit table would wrap.
inline std::int32_t i16(std::int32_t v) { return static_cast<std::int16_t>(v); }
inline std::int32_t sat16(std::int32_t v) {
    return v < -32768 ? -32768 : v > 32767 ? 32767 : v;
}
inline std::uint8_t sample(std::int32_t v) {  // packsswb, then +128
    return static_cast<std::uint8_t>((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
}

// jpeg_idct_islow's 1-D transform of x[0], x[s], ..., x[7s] into o[8],
// before the descale: the pass-1 sums z3 and z4 and the even part's x0 +
// x4 are 16-bit lanes in jidctint-avx2.
template <int s>
inline void islow_1d(const std::int32_t* x, std::int32_t* o) {
    constexpr std::int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433,
                           F0765 = 6270, F0899 = 7373, F1175 = 9633,
                           F1501 = 12299, F1847 = 15137, F1961 = 16069,
                           F2053 = 16819, F2562 = 20995, F3072 = 25172;
    std::int32_t z2 = x[2 * s], z3 = x[6 * s];
    std::int32_t z1 = (z2 + z3) * F0541;
    std::int32_t tmp2 = z1 + z3 * -F1847;
    std::int32_t tmp3 = z1 + z2 * F0765;
    std::int32_t tmp0 = i16(x[0] + x[4 * s]) * (1 << 13);
    std::int32_t tmp1 = i16(x[0] - x[4 * s]) * (1 << 13);
    const std::int32_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    const std::int32_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = x[7 * s];
    tmp1 = x[5 * s];
    tmp2 = x[3 * s];
    tmp3 = x[s];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = i16(tmp0 + tmp2);
    std::int32_t z4 = i16(tmp1 + tmp3);
    const std::int32_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 = z3 * -F1961 + z5;
    z4 = z4 * -F0390 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = t10 + tmp3;
    o[7] = t10 - tmp3;
    o[1] = t11 + tmp2;
    o[6] = t11 - tmp2;
    o[2] = t12 + tmp1;
    o[5] = t12 - tmp1;
    o[3] = t13 + tmp0;
    o[4] = t13 - tmp0;
}

// jpeg_idct_islow: 13-bit constants, two pass-1 bits, rounding descales.
// Pass 1 runs the eight columns side by side (the loop vectorizes), pass
// 2 a row at a time.
void idct_islow(const std::int16_t* in, const std::int16_t* q,
                std::uint8_t* out, std::size_t stride) {
    std::int32_t v[64], ws[64];
    int ac = 0;
    for (int i = 8; i < 64; ++i) ac |= in[i];
    for (int i = 0; i < 64; ++i)  // pmullw
        v[i] = static_cast<std::int16_t>(in[i] * q[i]);
    if (!ac) {  // no AC term in the block: row 0 << PASS1_BITS, in 16 bits
        for (int i = 0; i < 64; ++i) ws[i] = i16(v[i & 7] * 4);
    } else {
        for (int c = 0; c < 8; ++c) {
            std::int32_t o[8];
            islow_1d<8>(v + c, o);
            for (int r = 0; r < 8; ++r) ws[8 * r + c] = sat16((o[r] + 1024) >> 11);
        }
    }
    for (int r = 0; r < 8; ++r) {
        const std::int32_t* w = ws + 8 * r;
        std::uint8_t* row = out + r * stride;
        if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
            std::memset(row, sample((w[0] + 16) >> 5), 8);
            continue;
        }
        std::int32_t o[8];
        islow_1d<1>(w, o);
        for (int k = 0; k < 8; ++k) row[k] = sample((o[k] + (1 << 17)) >> 18);
    }
}

// AAN multiply by an 8-bit constant: pmulhw of (x << 2) and (c << 6)
inline std::int32_t aan(std::int32_t x, std::int32_t c) {
    return (i16(x * 4) * (c * 64)) >> 16;
}

// jpeg_idct_ifast's butterflies over x[0], x[s], ..., x[7s] into y[0],
// y[s], ..., every sum in a 16-bit lane as in jidctfst-sse2
template <int s>
inline void ifast_1d(const std::int32_t* x, std::int32_t* y) {
    constexpr std::int32_t F1082 = 277, F1414 = 362, F1847 = 473,
                           F1613 = 669 - 256;
    std::int32_t tmp10 = i16(x[0] + x[4 * s]), tmp11 = i16(x[0] - x[4 * s]);
    std::int32_t tmp13 = i16(x[2 * s] + x[6 * s]);
    std::int32_t tmp12 = i16(aan(i16(x[2 * s] - x[6 * s]), F1414) - tmp13);
    const std::int32_t tmp0 = i16(tmp10 + tmp13), tmp3 = i16(tmp10 - tmp13);
    const std::int32_t tmp1 = i16(tmp11 + tmp12), tmp2 = i16(tmp11 - tmp12);
    const std::int32_t z13 = i16(x[5 * s] + x[3 * s]), z10 = i16(x[5 * s] - x[3 * s]);
    const std::int32_t z11 = i16(x[s] + x[7 * s]), z12 = i16(x[s] - x[7 * s]);
    const std::int32_t tmp7 = i16(z11 + z13);
    tmp11 = aan(i16(z11 - z13), F1414);
    const std::int32_t z10s = i16(z10 * 4), z12s = i16(z12 * 4);
    const std::int32_t z5 = (i16(z10s + z12s) * (F1847 * 64)) >> 16;
    tmp10 = i16(((z12s * (F1082 * 64)) >> 16) - z5);
    tmp12 = i16(i16(((z10s * (-F1613 * 64)) >> 16) - z10) + z5);
    const std::int32_t tmp6 = i16(tmp12 - tmp7);
    const std::int32_t tmp5 = i16(tmp11 - tmp6);
    const std::int32_t tmp4 = i16(tmp10 + tmp5);
    y[0] = i16(tmp0 + tmp7);
    y[7 * s] = i16(tmp0 - tmp7);
    y[s] = i16(tmp1 + tmp6);
    y[6 * s] = i16(tmp1 - tmp6);
    y[2 * s] = i16(tmp2 + tmp5);
    y[5 * s] = i16(tmp2 - tmp5);
    y[4 * s] = i16(tmp3 + tmp4);
    y[3 * s] = i16(tmp3 - tmp4);
}

// jpeg_idct_ifast: q holds the AAN-scaled multipliers; truncating
// descales.  Pass 1 side by side over the columns, pass 2 by rows.
void idct_ifast(const std::int16_t* in, const std::int16_t* q,
                std::uint8_t* out, std::size_t stride) {
    std::int32_t v[64], ws[64];
    for (int i = 0; i < 64; ++i)  // pmullw
        v[i] = static_cast<std::int16_t>(in[i] * q[i]);
    for (int c = 0; c < 8; ++c) ifast_1d<8>(v + c, ws + c);
    for (int r = 0; r < 8; ++r) {
        const std::int32_t* w = ws + 8 * r;
        std::uint8_t* row = out + r * stride;
        if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
            std::memset(row, sample(w[0] >> 5), 8);
            continue;
        }
        std::int32_t o[8];
        ifast_1d<1>(w, o);
        for (int k = 0; k < 8; ++k) row[k] = sample(o[k] >> 5);
    }
}

struct Component {
    int id, h, v, tq;
    int td = 0, ta = 0;                   // Huffman slots of the scan
    int width = 0, height = 0;            // libjpeg's downsampled size
    std::size_t stride = 0, rows = 0;     // the plane: whole MCUs
    std::uint8_t* plane = nullptr;
    std::int16_t q[64];                   // multipliers of the IDCT
};

struct Header {
    int sof = 0, precision = 0, height = 0, width = 0, ncomp = 0;
    Component comp[3];
    std::uint16_t qt[4][64];
    bool qdef[4] = {false, false, false, false};
    HuffSpec dc[4], ac[4];
    int restart = 0;
    bool jfif = false, adobe = false;
    int transform = 0;
    bool ffmpeg_comment = false;          // a COM FFmpeg reads as a flag
    int nscan = 0;                        // components in the scan
    int scan_order[3];                    // frame index of each scan slot
    int ss = 0, se = 0, ah = 0, al = 0;   // spectral selection, approximation
};

// COM segments that change how FFmpeg's MJPEG decoder reads a frame
// (limited range, flipped or interlaced frames)
constexpr const char* kFfmpegComments[] = {
    "CS=ITU601", "Intel(R) JPEG", "Metasoft MJPEG", "MULTISCOPE II", "AVID"};

inline int be16(const std::uint8_t* p) { return (p[0] << 8) | p[1]; }

// A scan header: each component's frame index and table slots, then Ss,
// Se, Ah and Al.  Modes 0 and 1 read only scans of all three components
// (a TIFF chunk: of all its components).
int read_sos(Header& hd, const std::uint8_t* seg, int body, bool ffmpeg,
             bool tiff) {
    const int n = body >= 1 ? seg[0] : 0;
    if (body != 4 + 2 * n || n < 1 || n > 4) return kCorrupt;
    if (n != (tiff ? hd.ncomp : 3) && !ffmpeg) return kUnsupported;  // one component a scan
    if (n > hd.ncomp) return kCorrupt;
    bool used[3] = {false, false, false};
    for (int i = 0; i < n; ++i) {
        const int id = seg[1 + 2 * i], tabs = seg[2 + 2 * i];
        int c = 0;
        while (c < hd.ncomp && (hd.comp[c].id != id || used[c])) ++c;
        if (c == hd.ncomp) return kCorrupt;
        used[c] = true;
        hd.comp[c].td = tabs >> 4;
        hd.comp[c].ta = tabs & 15;
        hd.scan_order[i] = c;
    }
    hd.nscan = n;
    hd.ss = seg[1 + 2 * n];
    hd.se = seg[2 + 2 * n];
    hd.ah = seg[3 + 2 * n] >> 4;
    hd.al = seg[3 + 2 * n] & 15;
    return kOk;
}

// Reads marker segments into hd, from marker `first` (0: the next one in
// src), up to and including the next SOS (its scan header read, src left
// at the entropy-coded data), or, between the scans of mode 2, up to EOI.
// Returns that marker, or a fault (a negative code).  Segments are read
// through Source::at, so a frame cut inside its headers reads libjpeg's
// fake EOI bytes there as libjpeg does.  Mode 2 also reads progressive
// (SOF2) frames and grayscale.
int walk(Source& src, Header& hd, int mode, bool header, int first = 0) {
    const bool ffmpeg = mode == kFfmpeg;
    std::uint8_t seg[1 << 16];
    for (int m = first ? first : src.next_marker();; m = src.next_marker()) {
        if (m == kEoi || m == 0xD8) {
            if (header) return kCorrupt;
            return m == kEoi ? kEoi : kUnmatched;
        }
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // RSTn, TEM
        const int len = (src.at(src.pos) << 8) | src.at(src.pos + 1);
        const int body = len - 2;
        // APPn and COM are read only as far as libjpeg examines them
        const bool skipped = (m >= 0xE0 && m <= 0xEF) || m == 0xFE;
        const int keep = skipped ? std::min(body, 14) : body;
        for (int i = 0; i < keep; ++i) seg[i] = static_cast<std::uint8_t>(src.at(src.pos + 2 + i));
        if (len >= 2) src.pos += len;
        else src.pos += 2;
        if (m == 0xC0 || m == 0xC1 || (ffmpeg && m == 0xC2)) {
            // baseline, extended sequential; progressive in mode 2
            if (hd.sof || body < 6) return header ? kCorrupt : kUnmatched;
            hd.sof = m;
            hd.precision = seg[0];
            hd.height = be16(seg + 1);
            hd.width = be16(seg + 3);
            hd.ncomp = seg[5];
            if (hd.height <= 0 || hd.width <= 0 || hd.ncomp <= 0 ||
                body != 6 + 3 * hd.ncomp)
                return kCorrupt;
            if (hd.precision != 8) return kUnsupported;
            if (hd.ncomp != 3 && !((ffmpeg || mode == kTiff) && hd.ncomp == 1))
                return kComponents;
            for (int c = 0; c < hd.ncomp; ++c) {
                Component& k = hd.comp[c];
                k.id = seg[6 + 3 * c];
                k.h = seg[7 + 3 * c] >> 4;
                k.v = seg[7 + 3 * c] & 15;
                k.tq = seg[8 + 3 * c];
            }
        } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) {
            // progressive (modes 0 and 1), lossless, hierarchical or
            // arithmetic coding
            return kUnsupported;
        } else if (m == 0xC4) {  // DHT
            int at = 0;
            while (body - at > 16) {
                const int index = seg[at];
                int count = 0;
                for (int i = 1; i <= 16; ++i) count += seg[at + i];
                at += 17;
                if (count > 256 || count > body - at) return kCorrupt;
                const int slot = index & 0x0F;
                if ((index & ~0x10) > 3) return kCorrupt;
                HuffSpec& t = (index & 0x10) ? hd.ac[slot] : hd.dc[slot];
                t.bits[0] = 0;
                std::memcpy(t.bits + 1, seg + at - 16, 16);
                std::memset(t.val, 0, sizeof(t.val));
                std::memcpy(t.val, seg + at, count);
                t.defined = true;
                at += count;
            }
            if (at != body) return kCorrupt;
        } else if (m == 0xDB) {  // DQT
            int at = 0;
            while (at < body) {
                const int prec = seg[at] >> 4, slot = seg[at] & 15;
                ++at;
                if (slot > 3) return kCorrupt;
                if (at + 64 * (prec ? 2 : 1) > body) return kCorrupt;
                for (int i = 0; i < 64; ++i) {
                    hd.qt[slot][kNatural[i]] = static_cast<std::uint16_t>(
                        prec ? be16(seg + at + 2 * i) : seg[at + i]);
                }
                at += 64 * (prec ? 2 : 1);
                hd.qdef[slot] = true;
            }
            if (at != body) return kCorrupt;
        } else if (m == 0xDD) {  // DRI
            if (body != 2) return kCorrupt;
            hd.restart = be16(seg);
        } else if (m == 0xE0) {  // APP0: JFIF says YCbCr
            if (body >= 14 && std::memcmp(seg, "JFIF\0", 5) == 0) hd.jfif = true;
        } else if (m == 0xEE) {  // APP14: Adobe's colour transform
            if (body >= 12 && std::memcmp(seg, "Adobe", 5) == 0) {
                hd.adobe = true;
                hd.transform = seg[11];
            }
        } else if (m == 0xDA) {  // SOS
            src.sos = true;
            if (!hd.sof) return kCorrupt;
            const int rc = read_sos(hd, seg, body, ffmpeg, mode == kTiff);
            return rc == kOk ? m : rc;
        } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xCC ||
                   m == 0xDC) {
            // other APPn, COM, DAC, DNL: skipped
            if (m == 0xFE)
                for (const char* c : kFfmpegComments) {
                    const std::size_t k = std::strlen(c);
                    if (static_cast<std::size_t>(keep) >= k && std::memcmp(seg, c, k) == 0)
                        hd.ffmpeg_comment = true;
                }
        } else {
            return kCorrupt;  // a marker libjpeg does not know
        }
    }
}

// Reads the markers from SOI to the first SOS into hd, leaving src at the
// entropy-coded data.  Returns kOk or the frame's fault.
int read_header(Source& src, Header& hd, int mode) {
    if (src.at(0) != 0xFF || src.at(1) != 0xD8) return kCorrupt;
    src.pos = 2;
    for (auto& t : hd.dc) t.defined = false;
    for (auto& t : hd.ac) t.defined = false;
    const int m = walk(src, hd, mode, true);
    return m == 0xDA ? kOk : m < 0 ? m : kCorrupt;
}

// FFmpeg's simple_idct for 8-bit samples as its x86-64 SSE2/AVX routine
// (ff_simple_idct8_put_*) computes it: W_k = round(cos(k pi / 16) sqrt(2)
// 2^14), W4 one less; the row pass first, each row (sum + 2^10) >> 11
// saturated to 16 bits, or DC << 3 in 16 bits where the row has no AC
// term; then the columns, the rounding (1 << 19) / W4 = 32 added to the DC
// in 16 bits, sum >> 20, clamped to 0..255.  Sums wrap in 32 bits.
constexpr std::uint32_t kW1 = 22725, kW2 = 21407, kW3 = 19266, kW4 = 16383,
                        kW5 = 12873, kW6 = 8867, kW7 = 4520;

// simple_idct's butterflies on eight lanes side by side (the loop
// vectorizes): x[k][lane] the k-th input, a[lane] the DC term (rounding
// included), o[k][lane] the k-th sum before the shift
inline void simple_lanes(const std::int32_t (*x)[8], const std::uint32_t* a,
                         std::int32_t (*o)[8]) {
    for (int l = 0; l < 8; ++l) {
        const std::uint32_t x1 = x[1][l], x2 = x[2][l], x3 = x[3][l], x4 = x[4][l],
                            x5 = x[5][l], x6 = x[6][l], x7 = x[7][l];
        const std::uint32_t a0 = a[l] + kW2 * x2 + kW4 * x4 + kW6 * x6;
        const std::uint32_t a1 = a[l] + kW6 * x2 - kW4 * x4 - kW2 * x6;
        const std::uint32_t a2 = a[l] - kW6 * x2 - kW4 * x4 + kW2 * x6;
        const std::uint32_t a3 = a[l] - kW2 * x2 + kW4 * x4 - kW6 * x6;
        const std::uint32_t b0 = kW1 * x1 + kW3 * x3 + kW5 * x5 + kW7 * x7;
        const std::uint32_t b1 = kW3 * x1 - kW7 * x3 - kW1 * x5 - kW5 * x7;
        const std::uint32_t b2 = kW5 * x1 - kW1 * x3 + kW7 * x5 + kW3 * x7;
        const std::uint32_t b3 = kW7 * x1 - kW5 * x3 + kW3 * x5 - kW1 * x7;
        o[0][l] = static_cast<std::int32_t>(a0 + b0);
        o[1][l] = static_cast<std::int32_t>(a1 + b1);
        o[2][l] = static_cast<std::int32_t>(a2 + b2);
        o[3][l] = static_cast<std::int32_t>(a3 + b3);
        o[4][l] = static_cast<std::int32_t>(a3 - b3);
        o[5][l] = static_cast<std::int32_t>(a2 - b2);
        o[6][l] = static_cast<std::int32_t>(a1 - b1);
        o[7][l] = static_cast<std::int32_t>(a0 - b0);
    }
}

// in[0] is the dequantized DC; the AC terms are multiplied by q here.  The
// row pass runs the eight rows as lanes, the column pass the columns.
void idct_simple(const std::int16_t* in, const std::int16_t* q,
                 std::uint8_t* out, std::size_t stride) {
    std::int32_t x[8][8], o[8][8], y[8][8];
    std::uint32_t a[8];
    int ac = 0;
    for (int i = 1; i < 64; ++i) ac |= static_cast<std::int16_t>(in[i] * q[i]);
    if (!ac) {  // rows 1-7 are zero and row 0 is DC << 3: a flat block
        const std::int32_t d = i16(in[0] * 8);
        const std::uint8_t v = clamp255(
            static_cast<std::int32_t>(kW4 * static_cast<std::uint32_t>(i16(d + 32))) >> 20);
        for (int r = 0; r < 8; ++r) std::memset(out + r * stride, v, 8);
        return;
    }
    for (int r = 0; r < 8; ++r)
        for (int k = 0; k < 8; ++k)
            x[k][r] = static_cast<std::int16_t>(in[8 * r + k] * q[8 * r + k]);
    x[0][0] = in[0];
    for (int r = 0; r < 8; ++r) a[r] = kW4 * static_cast<std::uint32_t>(x[0][r]) + (1u << 10);
    simple_lanes(x, a, o);
    for (int r = 0; r < 8; ++r) {
        const bool ac = x[1][r] | x[2][r] | x[3][r] | x[4][r] | x[5][r] | x[6][r] | x[7][r];
        const std::int32_t d = i16(x[0][r] * 8);
        for (int c = 0; c < 8; ++c) y[r][c] = ac ? sat16(o[c][r] >> 11) : d;
    }
    for (int c = 0; c < 8; ++c) a[c] = kW4 * static_cast<std::uint32_t>(i16(y[0][c] + 32));
    simple_lanes(y, a, o);
    for (int r = 0; r < 8; ++r) {
        std::uint8_t* row = out + r * stride;
        for (int c = 0; c < 8; ++c) row[c] = clamp255(o[r][c] >> 20);
    }
}

// swscale's BT.601 tables for one input range, as ff_yuv2rgb_c_init_tables
// makes them from the inverse coefficients 104597, 132201, 25675, 53279
// (jpeg_plain._sws_range computes them): the SIMD outputs' pmulhw luma
// coefficient and offset, ((y << 3) - yo) * yc >> 16; the chroma
// coefficients with 13 fractional bits (u -> b, u -> g, v -> g, v -> r);
// the C output's with 16 (v -> r, u -> b, u -> g, v -> g), divided by the
// luma scale its lookup table applies; that scale and its offset cy, oy
// (16 fractional bits), which the full-chroma output takes too.
struct SwsRange {
    std::int32_t yc, yo, ub, ug, vg, vr, crv, cbu, cgu, cgv, cy, oy;
};
// full range (yuvj and gray: what FFmpeg's MJPEG decoder gives): the
// chroma scaled by 224/255
constexpr SwsRange kSwsFull = {8192, 0, 14516, -2819, -5850, 11485,
                               91881, 116129, -22552, -46800, 65536, 0};
// limited range (yuv420p, nv12, yuyv422: raw video): the luma scaled by
// 255/219 from 16
constexpr SwsRange kSwsLimited = {9539, 128, 16525, -3209, -6660, 13075,
                                  89830, 113537, -22049, -45756, 76309, 16 << 16};
// limited range under the BT.709 matrix (inverse coefficients 117489,
// 138438, 13975, 34925): the planes of a stream tagged BT.709
constexpr SwsRange kSwsLimited709 = {9539, 128, 17305, -1747, -4366, 14686,
                                     100902, 118894, -12001, -29993, 76309, 16 << 16};

// The C output's luma table (y_table from yoffs: 384 entries in at full
// range, 326 at limited range) at index t, clipped.
inline std::int32_t sws_table(const SwsRange& r, std::int32_t t) {
    const std::int64_t at = r.oy ? 326 : 384;
    const std::int64_t v = ((at + t) * r.cy - (std::int64_t{384} << 16) - r.oy + 0x8000) >> 16;
    return static_cast<std::int32_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

// swscale's initFilter for SWS_BICUBIC (B = 0, C = 0.6), a sample of the
// source and of the output at src_pos and dst_pos 256ths of its pixel (the
// default chroma position: 128, its centre; a chroma sample sited left, as
// FFmpeg's MPEG-4 decoder tags its frames, 64): dst_w rows of `size`
// coefficients summing to `one`, and each row's first source index;
// returns size.  A unit step at the same position is the one-tap
// identity; otherwise each tap is the Keys cubic at its
// distance in 1/2^17 pixels, the sides cut where their weight is below
// 0.002 of the filter's scale, the rows padded to `align` taps, folded
// inside [0, src_w) and rounded with the error carried along the row.
// jpeg_plain.init_filter is the same in Python.
int init_filter(int inc, int src_w, int dst_w, int align, int one,
                std::vector<std::int16_t>& coef, std::vector<std::int32_t>& first,
                int src_pos = 128, int dst_pos = 128) {
    int lg = 0;
    for (int r = src_w / dst_w; r > 1; r >>= 1) ++lg;
    const std::int64_t fone = std::int64_t{1} << (54 - std::min(lg, 8));
    int size;
    std::vector<std::int64_t> filt;
    std::vector<std::int64_t> pos(dst_w);
    if (std::abs(inc - 0x10000) < 10 && src_pos == dst_pos) {
        size = 1;
        filt.assign(dst_w, fone);
        for (int i = 0; i < dst_w; ++i) pos[i] = i;
    } else {
        size = inc <= (1 << 16) ? 5 : 1 + (4 * src_w + dst_w - 1) / dst_w;
        size = std::max(std::min(size, src_w - 2), 1);
        const std::int64_t b = 0, c = static_cast<std::int64_t>(0.6 * (1 << 24));
        const std::int64_t k24 = std::int64_t{1} << 24, k30 = std::int64_t{1} << 30;
        std::int64_t x = ((dst_pos * std::int64_t{inc}) >> 7) -
                         ((src_pos * std::int64_t{0x10000}) >> 7);
        filt.assign(static_cast<std::size_t>(dst_w) * size, 0);
        for (int i = 0; i < dst_w; ++i) {
            std::int64_t xx = (x - (size - 2) * (std::int64_t{1} << 16)) / (1 << 17);
            pos[i] = xx;
            for (int j = 0; j < size; ++j, ++xx) {
                std::int64_t d = std::llabs(xx * (std::int64_t{1} << 17) - x) << 13;
                if (inc > (1 << 16)) d = d * dst_w / src_w;
                std::int64_t coeff = 0;
                if (d < (std::int64_t{1} << 31)) {
                    const std::int64_t dd = (d * d) >> 30, ddd = (dd * d) >> 30;
                    if (d < k30)
                        coeff = (12 * k24 - 9 * b - 6 * c) * ddd +
                                (-18 * k24 + 12 * b + 6 * c) * dd + (6 * k24 - 2 * b) * k30;
                    else
                        coeff = (-b - 6 * c) * ddd + (6 * b + 30 * c) * dd +
                                (-12 * b - 48 * c) * d + (8 * b + 24 * c) * k30;
                }
                filt[static_cast<std::size_t>(i) * size + j] =
                    coeff / ((std::int64_t{1} << 54) / fone);
            }
            x += 2 * std::int64_t{inc};
        }
    }
    const double cut = 0.002 * static_cast<double>(fone);
    int min_size = 0;
    for (int i = dst_w - 1; i >= 0; --i) {
        std::int64_t* row = filt.data() + static_cast<std::size_t>(i) * size;
        std::int64_t acc = 0;
        for (int j = 0; j < size; ++j) {
            acc += std::llabs(row[0]);
            if (static_cast<double>(acc) > cut) break;
            if (i < dst_w - 1 && pos[i] >= pos[i + 1]) break;
            for (int k = 1; k < size; ++k) row[k - 1] = row[k];
            row[size - 1] = 0;
            ++pos[i];
        }
        int n = size;
        acc = 0;
        for (int j = size - 1; j > 0; --j) {
            acc += std::llabs(row[j]);
            if (static_cast<double>(acc) > cut) break;
            --n;
        }
        min_size = std::max(min_size, n);
    }
    if (min_size == 1 && align == 2) align = 1;
    const int ns = (min_size + align - 1) & ~(align - 1);
    std::vector<std::int64_t> f(static_cast<std::size_t>(dst_w) * ns, 0);
    for (int i = 0; i < dst_w; ++i)
        for (int j = 0; j < std::min(ns, size); ++j)
            f[static_cast<std::size_t>(i) * ns + j] = filt[static_cast<std::size_t>(i) * size + j];
    coef.assign(static_cast<std::size_t>(dst_w) * ns, 0);
    first.assign(dst_w, 0);
    for (int i = 0; i < dst_w; ++i) {
        std::int64_t* row = f.data() + static_cast<std::size_t>(i) * ns;
        if (pos[i] < 0) {
            for (int j = 1; j < ns; ++j) {
                const std::int64_t left = std::max<std::int64_t>(j + pos[i], 0);
                row[left] += row[j];
                row[j] = 0;
            }
            pos[i] = 0;
        }
        if (pos[i] + ns > src_w) {
            const std::int64_t shift = pos[i] + std::min(ns - src_w, 0);
            std::int64_t acc = 0;
            for (int j = ns - 1; j >= 0; --j)
                if (pos[i] + j >= src_w) {
                    acc += row[j];
                    row[j] = 0;
                }
            for (int j = ns - 1; j >= 0; --j) row[j] = j < shift ? 0 : row[j - shift];
            pos[i] -= shift;
            row[src_w - 1 - pos[i]] += acc;
        }
        std::int64_t sum = 0;
        for (int j = 0; j < ns; ++j) sum += row[j];
        std::int64_t total = (sum + one / 2) / one;
        if (!total) total = 1;
        std::int64_t err = 0;
        for (int j = 0; j < ns; ++j) {
            const std::int64_t v = row[j] + err;
            const std::int64_t iv = v >= 0 ? (v + (total >> 1)) / total : (v - (total >> 1)) / total;
            coef[static_cast<std::size_t>(i) * ns + j] = static_cast<std::int16_t>(iv);
            err = v - iv * total;
        }
        first[i] = static_cast<std::int32_t>(pos[i]);
    }
    return ns;
}

// A run of outputs [lo, hi) of a horizontal filter that repeat with period
// p: output lo + r + p * k reads from first[lo + r] + step * k with row lo
// + r's coefficients, inside the source.  Integer ratios (4:1:1's and
// 4:4:0's chroma at an even width) give one over nearly the whole row.
struct Phases {
    int p = 0, step = 0, lo = 0, hi = 0;
};

Phases find_phases(const std::vector<std::int16_t>& coef,
                   const std::vector<std::int32_t>& first, int size, int dst_w, int src_w) {
    Phases best;
    for (int p = 1; p <= 2; ++p) {
        int i = p;
        while (i < dst_w) {
            const int a = i - p, step = first[i] - first[a];
            int b = i;
            auto same = [&](int u) {
                return first[u] - first[u - p] == step && first[u] + size <= src_w &&
                       std::memcmp(&coef[static_cast<std::size_t>(u) * size],
                                   &coef[static_cast<std::size_t>(u - p) * size],
                                   sizeof(std::int16_t) * size) == 0;
            };
            while (b < dst_w && same(b)) ++b;
            const int hi = a + (b - a) / p * p;
            if (first[a] + size <= src_w && hi - a > best.hi - best.lo)
                best = Phases{p, step, a, hi};
            i = std::max(b, i + 1);
        }
    }
    return best;
}

// One source row through the horizontal filter: 15-bit samples
// (hScale8To15).  The periodic run goes a phase and a tap at a time over
// contiguous bytes (a run stepping by 2 reads the row split by parity;
// two phases are interleaved afterwards), so the loops vectorize with no
// gather; the rest of the row goes tap by tap.  acc holds dst_w words,
// split src_w + 2 bytes, tmp dst_w + 2 halfwords.
void hscale_row(const std::uint8_t* src, int src_w, std::int16_t* out, int dst_w,
                const std::int16_t* coef, const std::int32_t* first, int size,
                const Phases& ph, std::int32_t* __restrict acc,
                std::uint8_t* __restrict split, std::int16_t* __restrict tmp) {
    auto one = [&](int i) {
        std::int32_t v = 0;
        for (int j = 0; j < size; ++j)
            v += src[std::min(first[i] + j, src_w - 1)] * coef[static_cast<std::size_t>(i) * size + j];
        v >>= 7;
        out[i] = static_cast<std::int16_t>(v > 32767 ? 32767 : v);
    };
    int i = 0;
    if (ph.hi > ph.lo && (ph.step == 1 || ph.step == 2)) {
        for (; i < ph.lo; ++i) one(i);
        const int n = (ph.hi - ph.lo) / ph.p, half = (src_w + 1) / 2;
        if (ph.step == 2) {
            for (int m = 0; m < src_w / 2; ++m) {
                split[m] = src[2 * m];
                split[half + m] = src[2 * m + 1];
            }
            if (src_w & 1) split[half - 1] = src[src_w - 1];
        }
        for (int r = 0; r < ph.p; ++r) {
            const int base = first[ph.lo + r];
            const std::int16_t* c = coef + static_cast<std::size_t>(ph.lo + r) * size;
            for (int k = 0; k < n; ++k) acc[k] = 0;
            for (int j = 0; j < size; ++j) {
                const int at = base + j;
                const std::uint8_t* __restrict sj =
                    ph.step == 1 ? src + at : split + (at & 1 ? half : 0) + at / 2;
                const std::int32_t cj = c[j];
                for (int k = 0; k < n; ++k) acc[k] += sj[k] * cj;
            }
            std::int16_t* __restrict o = ph.p == 1 ? out + ph.lo : tmp + r * n;
            for (int k = 0; k < n; ++k) {
                const std::int32_t v = acc[k] >> 7;
                o[k] = static_cast<std::int16_t>(v > 32767 ? 32767 : v);
            }
        }
        if (ph.p == 2) {  // the two phases interleaved, a pair a word
            const std::int16_t* __restrict t0 = tmp;
            const std::int16_t* __restrict t1 = tmp + n;
            std::int16_t* __restrict o = out + ph.lo;
            for (int k = 0; k < n; ++k) {
                const std::uint32_t w = static_cast<std::uint16_t>(t0[k]) |
                                        static_cast<std::uint32_t>(static_cast<std::uint16_t>(t1[k])) << 16;
                std::memcpy(o + 2 * k, &w, 4);
            }
        }
        i = ph.hi;
    }
    for (; i < dst_w; ++i) one(i);
}

// A halfword view of words written as pairs (read back as int16 lanes).
typedef std::int16_t __attribute__((may_alias)) I16Alias;

// Per-thread planes and row buffers, reused across frames.
struct Scratch {
    std::unique_ptr<std::uint8_t[]> planes;
    std::size_t cap = 0;
    std::vector<std::int32_t> colsum;
    std::vector<std::uint16_t> row[2];   // upsampled chroma, pairs a word
    std::vector<std::uint32_t> packed;   // a row's pixels, B | G << 8 | R << 16
    // mode 2: a progressive frame's dequantized coefficients and each
    // block's last nonzero index; the scaler's filters and rows
    std::vector<std::int16_t> coef;
    std::vector<std::uint8_t> nnz;
    std::vector<std::int16_t> hcoef, vcoef;
    std::vector<std::int32_t> hpos, vpos;
    std::vector<std::int16_t> chroma;    // horizontally scaled Cb, Cr rows
    std::vector<std::int32_t> work[2];   // a row's chroma sums (32 bits)
    std::vector<std::int16_t> half[2];   // a row's chroma (16 bits)
    std::vector<std::uint32_t> pairs[3]; // its terms, each twice a word
    std::vector<std::uint8_t> split;     // a chroma row split by parity
};

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "an upsampled pair and a packed pixel are read back as bytes");

thread_local Scratch tls_scratch;

enum class Upsample { kNone, kReplicate, kH2V1, kH2V2 };

struct Decoder {
    Header hd;
    int mode = kTurbo;
    bool fast = false, rgb = false;
    int form = -1;                 // a TIFF chunk's TiffForm; -1 a video frame
    int ss_h = 1, ss_v = 1;        // a TIFF's YCbCrSubSampling
    int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    Huff dctab[4], actab[4];
    Upsample up[3];
    Scratch* s = nullptr;

    // The output rows [y0, y1) from the planes, as BGR (a TIFF chunk: in
    // libjpeg's order, RGB or the components as stored; gray one byte).
    void convert(std::uint8_t* dst, int y0, int y1) {
        const int W = hd.width;
        std::uint32_t* px = s->packed.data();
        // the byte shifts of the first and last output channel
        const int lo = form >= 0 ? 0 : 16, hi = 16 - lo;
        for (int y = y0; y < y1; ++y) {
            const std::uint8_t* c0 = hd.comp[0].plane + y * hd.comp[0].stride;
            if (hd.ncomp == 1) {
                std::memcpy(dst + static_cast<std::size_t>(y) * W, c0, W);
                continue;
            }
            const std::uint8_t* c1 = chroma_row(1, y, s->row[0].data());
            const std::uint8_t* c2 = chroma_row(2, y, s->row[1].data());
            if (rgb) {
                for (int x = 0; x < W; ++x)
                    px[x] = (c2[x] << hi) | (c1[x] << 8) | (c0[x] << lo);
            } else {
                // jdcolor.c's tables, computed: Cr_r = (FIX(1.402) x +
                // ONE_HALF) >> 16 and so on, x = sample - 128
                for (int x = 0; x < W; ++x) {
                    const int yy = c0[x], cb = c1[x] - 128, cr = c2[x] - 128;
                    const std::uint32_t b = clamp255(yy + ((116130 * cb + 32768) >> 16));
                    const std::uint32_t g = clamp255(
                        yy + ((-22554 * cb - 46802 * cr + 32768) >> 16));
                    const std::uint32_t r = clamp255(yy + ((91881 * cr + 32768) >> 16));
                    px[x] = (b << hi) | (g << 8) | (r << lo);
                }
            }
            store_row(dst, y, px);
        }
    }

    // Row y of dst from px, B | G << 8 | R << 16 a pixel: each pixel as 4
    // bytes, the next overwriting the fourth.
    void store_row(std::uint8_t* dst, int y, const std::uint32_t* px) const {
        const int W = hd.width;
        std::uint8_t* o = dst + static_cast<std::size_t>(y) * W * 3;
        for (int x = 0; x + 1 < W; ++x) std::memcpy(o + 3 * x, px + x, 4);
        for (int k = 0; k < 3; ++k)
            o[3 * (W - 1) + k] = static_cast<std::uint8_t>(px[W - 1] >> (8 * k));
    }

    // Component k's samples for output row y at full width (jdsample.c):
    // an upsampled pair of samples is one 16-bit word of out, which has
    // room for width + 8 words.
    const std::uint8_t* chroma_row(int k, int y, std::uint16_t* out) {
        const Component& cp = hd.comp[k];
        const int n = cp.width;
        auto pair = [](int even, int odd) {
            return static_cast<std::uint16_t>(even | (odd << 8));
        };
        switch (up[k]) {
        case Upsample::kNone:
            return cp.plane + y * cp.stride;
        case Upsample::kReplicate: {
            const std::uint8_t* in = cp.plane + (y / (vmax / cp.v)) * cp.stride;
            if (hmax == cp.h) return in;
            for (int i = 0; i < n; ++i) out[i] = pair(in[i], in[i]);
            break;
        }
        case Upsample::kH2V1: {  // triangle filter across, n > 2
            const std::uint8_t* in = cp.plane + y * cp.stride;
            out[0] = pair(in[0], (3 * in[0] + in[1] + 2) >> 2);
            for (int i = 1; i < n - 1; ++i)
                out[i] = pair((3 * in[i] + in[i - 1] + 1) >> 2,
                              (3 * in[i] + in[i + 1] + 2) >> 2);
            out[n - 1] = pair((3 * in[n - 1] + in[n - 2] + 1) >> 2, in[n - 1]);
            break;
        }
        case Upsample::kH2V2: {  // and down, from the nearer row's neighbour
            const int r = y >> 1;
            const int nr = (y & 1) ? std::min(r + 1, cp.height - 1) : std::max(r - 1, 0);
            const std::uint8_t* in0 = cp.plane + r * cp.stride;
            const std::uint8_t* in1 = cp.plane + nr * cp.stride;
            std::int32_t* cs = s->colsum.data();
            for (int i = 0; i < n; ++i) cs[i] = 3 * in0[i] + in1[i];
            out[0] = pair((4 * cs[0] + 8) >> 4, (3 * cs[0] + cs[1] + 7) >> 4);
            for (int i = 1; i < n - 1; ++i)
                out[i] = pair((3 * cs[i] + cs[i - 1] + 8) >> 4,
                              (3 * cs[i] + cs[i + 1] + 7) >> 4);
            out[n - 1] = pair((3 * cs[n - 1] + cs[n - 2] + 8) >> 4,
                              (4 * cs[n - 1] + 7) >> 4);
            break;
        }
        }
        return reinterpret_cast<const std::uint8_t*>(out);
    }

    int setup() {
        const int nc = hd.ncomp;
        for (int k = 0; k < nc; ++k) {
            const Component& c = hd.comp[k];
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return kCorrupt;
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
        }
        int blocks = 0;
        for (int k = 0; k < nc; ++k) blocks += hd.comp[k].h * hd.comp[k].v;
        if (blocks > 10) return kCorrupt;  // libjpeg's D_MAX_BLOCKS_IN_MCU
        if (form >= 0) {  // libtiff's checks (tif_jpeg.c, JPEGPreDecode)
            if (nc != (form == kFormGray ? 1 : 3)) return kComponents;
            for (int k = 0; k < nc; ++k) {
                const bool sub = k == 0 && form == kFormYcc;
                if (hd.comp[k].h != (sub ? ss_h : 1) || hd.comp[k].v != (sub ? ss_v : 1))
                    return kSampling;
            }
        }
        const Component &c0 = hd.comp[0], &c1 = hd.comp[1], &c2 = hd.comp[2];
        if (nc == 3) {
            // the first component at full size; the other two alike, at
            // full size or halved across or both ways
            if (c0.h != hmax || c0.v != vmax || c1.h != c2.h || c1.v != c2.v ||
                hmax % c1.h || vmax % c1.v)
                return kUnsupported;
            const int hx = hmax / c1.h, vx = vmax / c1.v;
            if (!((hx == 1 && vx == 1) || (hx == 2 && vx == 1) || (hx == 2 && vx == 2)))
                return kUnsupported;
        }
        // libjpeg's colour space guess (jdapimin.c); libtiff sets it for a
        // TIFF chunk
        if (form >= 0) rgb = form == kFormStored;
        else if (hd.jfif) rgb = false;
        else if (hd.adobe) rgb = hd.transform == 0;
        else rgb = c0.id == 'R' && c1.id == 'G' && c2.id == 'B';
        for (int k = 0; k < nc; ++k) {
            Component& c = hd.comp[k];
            if (c.tq > 3 || !hd.qdef[c.tq]) return kCorrupt;
            const std::uint16_t* qt = hd.qt[c.tq];
            for (int i = 0; i < 64; ++i) {
                c.q[i] = fast ? static_cast<std::int16_t>(
                                    (static_cast<std::int64_t>(qt[i]) * kAanScales[i] + (1 << 11)) >> 12)
                              : static_cast<std::int16_t>(qt[i]);
            }
        }
        // missing tables in slots 0 and 1 are Annex K's (jstdhuff.c)
        if (!hd.dc[0].defined) standard_table(hd.dc[0], kDcLumBits, kDcVal, 12);
        if (!hd.ac[0].defined) standard_table(hd.ac[0], kAcLumBits, kAcLumVal, 162);
        if (!hd.dc[1].defined) standard_table(hd.dc[1], kDcChromBits, kDcVal, 12);
        if (!hd.ac[1].defined) standard_table(hd.ac[1], kAcChromBits, kAcChromVal, 162);
        for (int k = 0; k < nc; ++k) {
            const Component& c = hd.comp[k];
            if (c.td > 3 || c.ta > 3 || !hd.dc[c.td].defined || !hd.ac[c.ta].defined)
                return kCorrupt;
            if (!derive(hd.dc[c.td], true, dctab[c.td]) ||
                !derive(hd.ac[c.ta], false, actab[c.ta]))
                return kCorrupt;
        }
        mcux = (hd.width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (hd.height + 8 * vmax - 1) / (8 * vmax);
        for (int k = 0; k < nc; ++k) {
            Component& c = hd.comp[k];
            c.width = static_cast<int>((static_cast<long>(hd.width) * c.h + hmax - 1) / hmax);
            c.height = static_cast<int>((static_cast<long>(hd.height) * c.v + vmax - 1) / vmax);
            c.stride = static_cast<std::size_t>(mcux) * c.h * 8;
            c.rows = static_cast<std::size_t>(mcuy) * c.v * 8;
            const int hxk = hmax / c.h, vxk = vmax / c.v;
            if (hxk == 1 && vxk == 1) up[k] = Upsample::kNone;
            else if (fast || c.width <= 2) up[k] = Upsample::kReplicate;
            else up[k] = vxk == 2 ? Upsample::kH2V2 : Upsample::kH2V1;
        }
        return kOk;
    }

    void alloc() {
        std::size_t total = 0;
        for (const Component& c : hd.comp) total += c.stride * c.rows;
        if (s->cap < total) {
            s->planes.reset(new std::uint8_t[total]);
            s->cap = total;
        }
        std::uint8_t* p = s->planes.get();
        for (Component& c : hd.comp) {
            c.plane = p;
            p += c.stride * c.rows;
        }
        alloc_rows();
    }

    // The row buffers of a frame hd.width wide.
    void alloc_rows() {
        const std::size_t w = static_cast<std::size_t>(hd.width) + 16;
        if (s->colsum.size() < w) s->colsum.resize(w);
        if (s->packed.size() < w) s->packed.resize(w);
        for (auto& r : s->row)
            if (r.size() < w) r.resize(w);
    }

    // jpeg_resync_to_restart (jdmarker.c), for a marker that is not the
    // RSTn expected next; returns with br.marker cleared (action 1) or
    // left against a marker the next segment will meet (action 3).
    void resync(BitReader& br, Source& src, int desired) {
        for (;;) {
            const int m = br.marker;
            int action;
            if (m < 0xC0) action = 2;
            else if (m < 0xD0 || m > 0xD7) action = 3;
            else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7))
                action = 3;
            else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7))
                action = 2;
            else
                action = 1;
            if (action == 1) {
                br.marker = 0;
                return;
            }
            if (action == 3) return;
            br.marker = src.next_marker();
        }
    }

    int run(const std::uint8_t* data, std::size_t n, std::size_t scan_at,
            std::uint8_t* dst) {
        Source src{data, n, scan_at};
        BitReader br;
        br.src = &src;
        alloc();
        int pred[3] = {0, 0, 0};
        int togo = hd.restart, next_rst = 0;
        alignas(16) std::int16_t blk[64];
        const int band = 8 * vmax;
        for (int my = 0; my < mcuy; ++my) {
            for (int mx = 0; mx < mcux; ++mx) {
                if (hd.restart) {
                    if (togo == 0) {  // process_restart (jdhuff.c)
                        br.nbits = 0;
                        if (!br.marker) br.marker = src.next_marker();
                        if (br.marker == 0xD0 + next_rst) br.marker = 0;
                        else resync(br, src, next_rst);
                        next_rst = (next_rst + 1) & 7;
                        pred[0] = pred[1] = pred[2] = 0;
                        togo = hd.restart;
                        if (!br.marker) br.insufficient = false;
                    }
                }
                // once the data ran out, the segment's MCUs stay zero
                const bool skip = br.insufficient;
                for (int i = 0; i < hd.nscan; ++i) {
                    const int k = hd.scan_order[i];
                    Component& c = hd.comp[k];
                    const Huff& dct = dctab[c.td];
                    const Huff& act = actab[c.ta];
                    for (int by = 0; by < c.v; ++by) {
                        for (int bx = 0; bx < c.h; ++bx) {
                            std::memset(blk, 0, sizeof(blk));
                            if (!skip) {
                                int t = br.decode(dct);
                                const int diff = t ? extend(br.get(t), t) : 0;
                                pred[k] = static_cast<int>(static_cast<unsigned>(diff) +
                                                           static_cast<unsigned>(pred[k]));
                                blk[0] = static_cast<std::int16_t>(pred[k]);
                                for (int z = 1; z < 64; ++z) {
                                    if (br.nbits < kLook) br.fill();
                                    if (br.nbits >= kLook) {  // code + bits at once
                                        const std::int32_t e = act.fast_ac[
                                            (br.buf >> (br.nbits - kLook)) & ((1 << kLook) - 1)];
                                        if (e) {
                                            br.nbits -= e & 0xFF;
                                            z += (e >> 8) & 0xFF;
                                            blk[kNatural[z]] = static_cast<std::int16_t>(e >> 16);
                                            continue;
                                        }
                                    }
                                    t = br.decode(act);
                                    const int r = t >> 4, sz = t & 15;
                                    if (sz) {
                                        z += r;
                                        blk[kNatural[z]] = static_cast<std::int16_t>(
                                            extend(br.get(sz), sz));
                                    } else {
                                        if (r != 15) break;
                                        z += 15;
                                    }
                                }
                            }
                            std::uint8_t* out = c.plane +
                                (static_cast<std::size_t>(my) * c.v + by) * 8 * c.stride +
                                (static_cast<std::size_t>(mx) * c.h + bx) * 8;
                            if (fast) idct_ifast(blk, c.q, out, c.stride);
                            else idct_islow(blk, c.q, out, c.stride);
                        }
                    }
                }
                if (hd.restart) --togo;
            }
            // the rows above this MCU row have every context row they need
            if (my > 0)
                convert(dst, (my - 1) * band, std::min(my * band, hd.height));
        }
        convert(dst, (mcuy - 1) * band, hd.height);
        return trailer(br, src);
    }

    // ---- mode 2 (ffmpeg) ----
    int hs = 0, vs = 0;          // the yuvj format's chroma shifts
    int chroma_h_pos = 128;      // the chroma samples' place in 256ths of a pixel
    bool gray = false;           // one component: FFmpeg's gray8
    const SwsRange* range = &kSwsFull;  // the input's range, swscale's tables
    bool scaled = false;         // swscale's scaled path converts the frame
    std::size_t cofs[3] = {0, 0, 0};  // each component's first block in s->coef

    // The frame as FFmpeg's MJPEG decoder sets it up (mjpegdec.c): the
    // sampling's pixel format after its normalisation (all-even factors
    // halved), the tables of the first scan.
    int setup_ffmpeg() {
        const int nc = hd.ncomp;
        for (int k = 0; k < nc; ++k) {
            const Component& c = hd.comp[k];
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return kCorrupt;
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
        }
        int blocks = 0;
        for (int k = 0; k < nc; ++k) blocks += hd.comp[k].h * hd.comp[k].v;
        if (blocks > 10) return kCorrupt;
        gray = nc == 1;
        const Component &c0 = hd.comp[0], &c1 = hd.comp[1], &c2 = hd.comp[2];
        if (!gray) {
            std::uint32_t pid = 0;
            for (int k = 0; k < 3; ++k)
                pid |= static_cast<std::uint32_t>(hd.comp[k].h) << (28 - 8 * k) |
                       static_cast<std::uint32_t>(hd.comp[k].v) << (24 - 8 * k);
            if (!(pid & 0xD0D0D0D0u)) pid -= (pid & 0xF0F0F0F0u) >> 1;
            if (!(pid & 0x0D0D0D0Du)) pid -= (pid & 0x0F0F0F0Fu) >> 1;
            switch (pid) {  // yuvj444p, 422p, 420p, 411p, 440p
            case 0x11111100: hs = 0; vs = 0; break;
            case 0x21111100: hs = 1; vs = 0; break;
            case 0x22111100: hs = 1; vs = 1; break;
            case 0x41111100: hs = 2; vs = 0; break;
            case 0x12111100: hs = 0; vs = 1; break;
            default: return kUnsupported;
            }
            if (c1.h != c2.h || c1.v != c2.v || (c0.id == 'Q' && c1.id == 'F' && c2.id == 'A'))
                return kUnsupported;
        }
        if (hd.ffmpeg_comment) return kUnmatched;
        // 4:4:4 with IDs 'R', 'G', 'B' or Adobe transform 0 is planar RGB
        rgb = !gray && !hs && !vs &&
              ((hd.adobe && hd.transform == 0) || (c0.id == 'R' && c1.id == 'G' && c2.id == 'B'));
        for (int k = 0; k < nc; ++k)
            if (hd.comp[k].tq > 3 || !hd.qdef[hd.comp[k].tq]) return kCorrupt;
        if (!hd.dc[0].defined) standard_table(hd.dc[0], kDcLumBits, kDcVal, 12);
        if (!hd.ac[0].defined) standard_table(hd.ac[0], kAcLumBits, kAcLumVal, 162);
        if (!hd.dc[1].defined) standard_table(hd.dc[1], kDcChromBits, kDcVal, 12);
        if (!hd.ac[1].defined) standard_table(hd.ac[1], kAcChromBits, kAcChromVal, 162);
        const int rc = scan_tables();
        if (rc != kOk) return rc;
        mcux = (hd.width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (hd.height + 8 * vmax - 1) / (8 * vmax);
        for (int k = 0; k < nc; ++k) {
            Component& c = hd.comp[k];
            c.width = static_cast<int>((static_cast<long>(hd.width) * c.h + hmax - 1) / hmax);
            c.height = static_cast<int>((static_cast<long>(hd.height) * c.v + vmax - 1) / vmax);
            c.stride = static_cast<std::size_t>(mcux) * c.h * 8;
            c.rows = static_cast<std::size_t>(mcuy) * c.v * 8;
        }
        // 4:2:0 and 4:2:2 of even height take swscale's unscaled converter
        scaled = !gray && (hs || vs) && !(hs == 1 && !(hd.height & 1));
        return kOk;
    }

    // The Huffman tables the scan decodes with (a progressive DC scan only
    // DC, a refinement of it none, an AC scan only AC), derived.
    int scan_tables() {
        const bool progressive = hd.sof == 0xC2;
        const bool dc = !progressive || (hd.ss == 0 && !hd.ah);
        const bool ac = !progressive || hd.ss != 0;
        for (int i = 0; i < hd.nscan; ++i) {
            const Component& c = hd.comp[hd.scan_order[i]];
            if (dc && (c.td > 3 || !hd.dc[c.td].defined)) return kCorrupt;
            if (ac && (c.ta > 3 || !hd.ac[c.ta].defined)) return kCorrupt;
        }
        for (int i = 0; i < hd.nscan; ++i) {
            const Component& c = hd.comp[hd.scan_order[i]];
            if (dc && !derive(hd.dc[c.td], true, dctab[c.td])) return kCorrupt;
            if (ac && !derive(hd.ac[c.ta], false, actab[c.ta])) return kCorrupt;
        }
        return kOk;
    }

    // A one-component scan's blocks across and down (FFmpeg counts
    // ceil(width / (8 * hmax / h)) of them).
    void comp_blocks(int k, int& nbx, int& nby) const {
        const int hx = hmax / hd.comp[k].h, vx = vmax / hd.comp[k].v;
        nbx = (hd.width + 8 * hx - 1) / (8 * hx);
        nby = (hd.height + 8 * vx - 1) / (8 * vx);
    }

    // FFmpeg's restart: the interval's padding bits, all ones or all
    // zeros, then any RSTn; false where it would meet an error.
    static bool restart(BitReader& br) {
        if (!br.marker) br.fill();
        if (!br.marker || br.nbits >= 8 || br.marker < 0xD0 || br.marker > 0xD7) return false;
        const std::uint32_t ones = (1u << br.nbits) - 1;
        const std::uint32_t pad = static_cast<std::uint32_t>(br.buf) & ones;
        if (pad != 0 && pad != ones) return false;
        br.buf = 0;
        br.nbits = 0;
        br.marker = 0;
        return true;
    }

    // Calls unit(k, by, bx) for each block of the scan in order, and row()
    // after each row of MCUs (of blocks in a one-component scan), with the
    // restart processing between intervals; returns unit's first fault.
    template <typename Unit, typename Row>
    int each_block(BitReader& br, Unit&& unit, Row&& row, int* pred, int& eobrun) {
        int togo = hd.restart;
        bool first = true;
        auto begin = [&]() {
            if (hd.restart && togo == 0 && !first) {
                if (!restart(br)) return false;
                for (int i = 0; i < 3; ++i) pred[i] = 1024;
                eobrun = 0;
                togo = hd.restart;
            }
            first = false;
            return true;
        };
        auto end = [&]() {
            if (br.bad_code || br.insufficient) return false;
            if (hd.restart) --togo;
            return true;
        };
        if (hd.nscan > 1) {
            for (int my = 0; my < mcuy; ++my) {
                for (int mx = 0; mx < mcux; ++mx) {
                    if (!begin()) return kUnmatched;
                    for (int i = 0; i < hd.nscan; ++i) {
                        const int k = hd.scan_order[i];
                        const Component& c = hd.comp[k];
                        for (int by = 0; by < c.v; ++by)
                            for (int bx = 0; bx < c.h; ++bx) {
                                const int rc = unit(i, k, my * c.v + by, mx * c.h + bx);
                                if (rc != kOk) return rc;
                            }
                    }
                    if (!end()) return kUnmatched;
                }
                row(my * 8 * vmax, std::min((my + 1) * 8 * vmax, hd.height));
            }
            return kOk;
        }
        const int k = hd.scan_order[0];
        int nbx, nby;
        comp_blocks(k, nbx, nby);
        const int band = 8 * (vmax / hd.comp[k].v);
        for (int by = 0; by < nby; ++by) {
            for (int bx = 0; bx < nbx; ++bx) {
                if (!begin()) return kUnmatched;
                const int rc = unit(0, k, by, bx);
                if (rc != kOk) return rc;
                if (!end()) return kUnmatched;
            }
            row(by * band, std::min((by + 1) * band, hd.height));
        }
        return kOk;
    }

    // A sequential scan as FFmpeg's MJPEG decoder reads it (mjpegdec.c):
    // the DC predictor runs on dequantized values from 1024 and each DC is
    // the sum clipped to int16; each block goes through simple_idct into
    // its plane at once.  With `rows`, the output rows of each MCU row are
    // converted as soon as it is decoded.  What FFmpeg would stop at with
    // an error it then conceals returns kUnmatched: a bad Huffman code, a
    // run past the 64th coefficient, a size-0 symbol other than EOB and
    // ZRL, bits past the data, an interval that does not end at its marker.
    int scan_sequential(BitReader& br, bool rows, std::uint8_t* dst) {
        for (int i = 0; i < hd.nscan; ++i) {  // the scan's tables as they stand
            Component& c = hd.comp[hd.scan_order[i]];
            for (int z = 0; z < 64; ++z) c.q[z] = static_cast<std::int16_t>(hd.qt[c.tq][z]);
        }
        int pred[3] = {1024, 1024, 1024}, eobrun = 0;
        alignas(16) std::int16_t blk[64];
        auto unit = [&](int slot, int k, int by, int bx) {
            Component& c = hd.comp[k];
            const Huff& dct = dctab[c.td];
            const Huff& act = actab[c.ta];
            const unsigned q0 = hd.qt[c.tq][0];
            std::memset(blk, 0, sizeof(blk));
            int t = br.decode(dct);
            const int diff = t ? extend(br.get(t), t) : 0;
            pred[slot] = static_cast<int>(static_cast<unsigned>(diff) * q0 +
                                          static_cast<unsigned>(pred[slot]));
            blk[0] = static_cast<std::int16_t>(std::min(std::max(pred[slot], -32768), 32767));
            for (int z = 1; z < 64; ++z) {
                if (br.nbits < kLook) br.fill();
                if (br.nbits >= kLook) {  // code + bits at once
                    const std::int32_t e = act.fast_ac[
                        (br.buf >> (br.nbits - kLook)) & ((1 << kLook) - 1)];
                    if (e) {
                        br.nbits -= e & 0xFF;
                        z += (e >> 8) & 0xFF;
                        if (z > 63) return kUnmatched;
                        blk[kNatural[z]] = static_cast<std::int16_t>(e >> 16);
                        continue;
                    }
                }
                t = br.decode(act);
                const int r = t >> 4, sz = t & 15;
                if (sz) {
                    z += r;
                    if (z > 63) return kUnmatched;
                    blk[kNatural[z]] = static_cast<std::int16_t>(extend(br.get(sz), sz));
                } else {
                    if (r != 15) {
                        if (r) return kUnmatched;
                        break;
                    }
                    z += 15;
                }
            }
            if (br.bad_code) return kUnmatched;
            idct_simple(blk, c.q, c.plane + static_cast<std::size_t>(by) * 8 * c.stride +
                                      static_cast<std::size_t>(bx) * 8, c.stride);
            return kOk;
        };
        auto row = [&](int y0, int y1) {
            if (rows) convert_rows(dst, y0, y1);
        };
        return each_block(br, unit, row, pred, eobrun);
    }

    // A progressive scan (SOF2) into the frame's dequantized coefficients,
    // as mjpegdec.c reads them: a first DC scan clears the block and keeps
    // the running sum of diff * (q << Al) from 1024, wrapped, not clipped;
    // a DC refinement adds bit * q << Al; a first AC band stores level * (q
    // << Al) with EOB runs; an AC refinement adds +-(q << Al) to nonzero
    // terms up to the block's last nonzero index seen so far.  A restart
    // resets the DC sums and the EOB run.
    int scan_progressive(BitReader& br) {
        const int ss = hd.ss, se = hd.se, ah = hd.ah, al = hd.al;
        if (se > 63 || se < ss || (ss == 0) != (se == 0) || (ss && hd.nscan != 1))
            return kUnmatched;
        int pred[3] = {1024, 1024, 1024}, eobrun = 0;
        auto unit = [&](int slot, int k, int by, int bx) {
            const Component& c = hd.comp[k];
            const std::size_t b = cofs[k] + static_cast<std::size_t>(by) * (c.stride / 8) + bx;
            std::int16_t* blk = s->coef.data() + b * 64;
            std::uint8_t* nnz = s->nnz.data() + b;
            const std::uint16_t* qt = hd.qt[c.tq];
            if (ss == 0 && !ah) {
                std::memset(blk, 0, 64 * sizeof(std::int16_t));
                const int t = br.decode(dctab[c.td]);
                const int diff = t ? extend(br.get(t), t) : 0;
                pred[slot] = static_cast<int>(
                    static_cast<unsigned>(diff) * (static_cast<unsigned>(qt[0]) << al) +
                    static_cast<unsigned>(pred[slot]));
                blk[0] = static_cast<std::int16_t>(pred[slot]);
                return kOk;
            }
            if (ss == 0) {
                blk[0] = static_cast<std::int16_t>(blk[0] + ((br.get(1) * qt[0]) << al));
                return kOk;
            }
            return ah ? ac_refine(br, blk, nnz, actab[c.ta], qt, eobrun)
                      : ac_first(br, blk, nnz, actab[c.ta], qt, eobrun);
        };
        return each_block(br, unit, [](int, int) {}, pred, eobrun);
    }

    // decode_block_progressive
    int ac_first(BitReader& br, std::int16_t* blk, std::uint8_t* nnz, const Huff& h,
                 const std::uint16_t* qt, int& eobrun) {
        const int se = hd.se, al = hd.al;
        if (eobrun) {
            --eobrun;
            return kOk;
        }
        int i = hd.ss;
        for (;; ++i) {
            const int t = br.decode(h);
            const int run = t >> 4, size = t & 15;
            if (size) {
                i += run;
                const int level = extend(br.get(size), size);
                if (i >= se) {
                    if (i > se) return kUnmatched;
                    blk[kNatural[se]] = static_cast<std::int16_t>(level * (qt[kNatural[se]] << al));
                    break;
                }
                blk[kNatural[i]] = static_cast<std::int16_t>(level * (qt[kNatural[i]] << al));
            } else if (run == 15) {
                i += 15;
                if (i >= se) return kUnmatched;
            } else {
                int val = 1 << run;
                if (run) val += br.get(run);
                eobrun = val - 1;
                break;
            }
        }
        if (i > *nnz) *nnz = static_cast<std::uint8_t>(i);
        return kOk;
    }

    // decode_block_refinement
    int ac_refine(BitReader& br, std::int16_t* blk, std::uint8_t* nnz, const Huff& h,
                  const std::uint16_t* qt, int& eobrun) {
        const int se = hd.se, al = hd.al;
        const int last = std::min(se, static_cast<int>(*nnz));
        int i = hd.ss;
        auto refine = [&](int at) {
            const int j = kNatural[at];
            const int q = blk[j] < 0 ? -static_cast<int>(qt[j]) : static_cast<int>(qt[j]);
            blk[j] = static_cast<std::int16_t>(blk[j] + br.get(1) * q * (1 << al));
        };
        // ZERO_RUN: false where FFmpeg stops with an error
        auto zero_run = [&](int run) {
            for (;; ++i) {
                if (i > last) {
                    i += run;
                    return i <= se;
                }
                if (blk[kNatural[i]]) refine(i);
                else if (run-- == 0) return true;
            }
        };
        if (eobrun) {
            --eobrun;
        } else {
            for (;; ++i) {
                const int t = br.decode(h);
                const int run = t >> 4;
                if (t & 15) {
                    const int bit = br.get(1);
                    if (!zero_run(run)) return kUnmatched;
                    const int q = qt[kNatural[i]] << al;
                    blk[kNatural[i]] = static_cast<std::int16_t>(bit ? q : -q);
                    if (i == se) {
                        if (i > *nnz) *nnz = static_cast<std::uint8_t>(i);
                        return kOk;
                    }
                } else if (run == 15) {
                    if (!zero_run(run)) return kUnmatched;
                } else {
                    int r = 1 << run;
                    if (run) r += br.get(run);
                    eobrun = r - 1;
                    break;
                }
            }
            if (i > *nnz) *nnz = static_cast<std::uint8_t>(i);
        }
        for (; i <= last; ++i)
            if (blk[kNatural[i]]) refine(i);
        return kOk;
    }

    // The whole frame, every scan, as FFmpeg decodes it and swscale
    // converts it to BGR24.  A progressive frame keeps its coefficients
    // in the thread's scratch (zeroed a frame, grown as needed) until EOI,
    // then each component's blocks go through simple_idct.
    int run_ffmpeg(const std::uint8_t* data, std::size_t n, std::size_t scan_at,
                   std::uint8_t* dst) {
        Source src{data, n, scan_at};
        alloc();
        const bool progressive = hd.sof == 0xC2;
        if (progressive) {
            std::size_t blocks = 0;
            for (int k = 0; k < hd.ncomp; ++k) {
                cofs[k] = blocks;
                blocks += (hd.comp[k].stride / 8) * (hd.comp[k].rows / 8);
            }
            if (s->coef.size() < blocks * 64) s->coef.resize(blocks * 64);
            if (s->nnz.size() < blocks) s->nnz.resize(blocks);
            std::memset(s->coef.data(), 0, blocks * 64 * sizeof(std::int16_t));
            std::memset(s->nnz.data(), 0, blocks);
        }
        // one scan of every component converts its rows as it goes
        const bool rows = !progressive && !scaled && hd.nscan == hd.ncomp;
        bool coded[3] = {false, false, false};
        int scans = 0;
        for (;;) {
            BitReader br;
            br.src = &src;
            const int rc = progressive ? scan_progressive(br)
                                       : scan_sequential(br, rows && !scans, dst);
            if (rc != kOk) return rc;
            ++scans;
            for (int i = 0; i < hd.nscan; ++i) coded[hd.scan_order[i]] = true;
            const int m = walk(src, hd, kFfmpeg, false, br.marker ? br.marker : src.next_marker());
            if (m == kEoi) break;
            if (m < 0) return m;
            const int tc = scan_tables();
            if (tc != kOk) return tc;
        }
        for (int k = 0; k < hd.ncomp; ++k)
            if (!coded[k]) return kUnmatched;
        if (progressive) {
            static const std::int16_t ones[64] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                                  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                                  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                                  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
            for (int k = 0; k < hd.ncomp; ++k) {
                const Component& c = hd.comp[k];
                int nbx, nby;
                comp_blocks(k, nbx, nby);
                for (int by = 0; by < nby; ++by)
                    for (int bx = 0; bx < nbx; ++bx)
                        idct_simple(s->coef.data() + (cofs[k] + by * (c.stride / 8) + bx) * 64,
                                    ones, c.plane + static_cast<std::size_t>(by) * 8 * c.stride + bx * 8,
                                    c.stride);
            }
        }
        if (rows && scans == 1) return kOk;
        if (scaled) scale_frame(dst);
        else convert_rows(dst, 0, hd.height);
        return kOk;
    }

    // Output rows [y0, y1) where swscale converts without scaling: gray8
    // replicated; yuvj420p/422p of even height by the unscaled SSSE3
    // converter (replicated chroma, truncating pmulhw); yuvj444p by the
    // full-chroma scaler output (rounding), or as planar RGB.  Each row is
    // packed a pixel a word, then stored as convert() stores its rows.
    void convert_rows(std::uint8_t* dst, int y0, int y1) {
        const int W = hd.width;
        const Component &c0 = hd.comp[0], &c1 = hd.comp[1], &c2 = hd.comp[2];
        const SwsRange r = *range;
        std::uint32_t* __restrict px = s->packed.data();
        auto clip = [](std::int32_t v) {
            return static_cast<std::uint32_t>(std::min(std::max(v, 0), 255));
        };
        for (int y = y0; y < y1; ++y) {
            const std::uint8_t* __restrict py = c0.plane + y * c0.stride;
            if (gray) {
                for (int x = 0; x < W; ++x) px[x] = py[x] * 0x010101u;
                store_row(dst, y, px);
                continue;
            }
            const std::uint8_t* __restrict pu = c1.plane + (y >> vs) * c1.stride;
            const std::uint8_t* __restrict pv = c2.plane + (y >> vs) * c2.stride;
            if (rgb) {
                for (int x = 0; x < W; ++x)
                    px[x] = pv[x] | (pu[x] << 8) | (py[x] << 16);
            } else if (hs) {  // the unscaled SSSE3 converter: pmulhw
                // chroma replicated across into pairs (the loop below then
                // vectorizes)
                std::uint16_t* __restrict u2 = s->row[0].data();
                std::uint16_t* __restrict v2 = s->row[1].data();
                for (int i = 0; i < (W + 1) / 2; ++i) {
                    u2[i] = static_cast<std::uint16_t>(pu[i] * 0x0101);
                    v2[i] = static_cast<std::uint16_t>(pv[i] * 0x0101);
                }
                const std::uint8_t* __restrict uu = reinterpret_cast<const std::uint8_t*>(u2);
                const std::uint8_t* __restrict vv = reinterpret_cast<const std::uint8_t*>(v2);
                for (int x = 0; x < W; ++x) {
                    const std::int32_t yy = ((py[x] * 8 - r.yo) * r.yc) >> 16,
                                       u = uu[x] * 8 - 1024, v = vv[x] * 8 - 1024;
                    px[x] = clip(yy + ((u * r.ub) >> 16)) |
                            clip(yy + ((u * r.ug) >> 16) + ((v * r.vg) >> 16)) << 8 |
                            clip(yy + ((v * r.vr) >> 16)) << 16;
                }
            } else {  // the full-chroma scaler output: rounds
                // 32-bit sums that wrap, as swscale's unsigned ones do
                // (limited range can pass 2^31: a saturated blue gives 0)
                auto wrap = [](std::uint32_t v) { return static_cast<std::int32_t>(v) >> 22; };
                for (int x = 0; x < W; ++x) {
                    const std::uint32_t yy = static_cast<std::uint32_t>(
                        ((py[x] << 9) - (r.oy >> 7)) * r.yc + (1 << 21));
                    const std::uint32_t u = static_cast<std::uint32_t>((pu[x] - 128) * 512),
                                        v = static_cast<std::uint32_t>((pv[x] - 128) * 512);
                    px[x] = clip(wrap(yy + u * static_cast<std::uint32_t>(r.ub))) |
                            clip(wrap(yy + u * static_cast<std::uint32_t>(r.ug) +
                                      v * static_cast<std::uint32_t>(r.vg))) << 8 |
                            clip(wrap(yy + v * static_cast<std::uint32_t>(r.vr))) << 16;
                }
            }
            store_row(dst, y, px);
        }
    }

    // The frame through swscale's scaled path with cv2's SWS_BICUBIC
    // (jpeg_plain._swscale_bgr has each rule): the chroma planes filtered
    // across to the output's chroma width (ceil(W / 2) for an even width,
    // W for an odd one), then each output row filtered down and converted:
    // an odd width by the full-chroma C output; an even one by the MMXEXT
    // output (16-bit pmulhw sums from the rounder 4) on every row but the
    // last two, which take the C output's lookup tables.  A vertical filter
    // of one tap, or of two weights summing to 4096, takes yuv2packed1's
    // rules instead of the general sum.
    void scale_frame(std::uint8_t* dst) {
        const int W = hd.width, H = hd.height;
        const bool full = W & 1;
        const int cw = (W + (1 << hs) - 1) >> hs, ch = (H + (1 << vs) - 1) >> vs;
        const int dw = full ? W : (W + 1) >> 1;
        const int xinc = static_cast<int>(((static_cast<std::int64_t>(cw) << 16) + (dw >> 1)) / dw);
        const int yinc = static_cast<int>(((static_cast<std::int64_t>(ch) << 16) + (H >> 1)) / H);
        const int hsize = init_filter(xinc, cw, dw, 4, 1 << 14, s->hcoef, s->hpos, chroma_h_pos);
        const int vsize = init_filter(yinc, ch, H, 2, 1 << 12, s->vcoef, s->vpos);
        const Phases ph = find_phases(s->hcoef, s->hpos, hsize, dw, cw);
        const Component &c0 = hd.comp[0], &c1 = hd.comp[1], &c2 = hd.comp[2];
        const std::size_t cstride = static_cast<std::size_t>(dw) + 16;
        for (auto& w : s->work)
            if (w.size() < static_cast<std::size_t>(W) + 16) w.resize(W + 16);
        for (auto& w : s->half)
            if (w.size() < 2 * static_cast<std::size_t>(W) + 32) w.resize(2 * W + 32);
        for (auto& w : s->pairs)
            if (w.size() < static_cast<std::size_t>(W) + 16) w.resize(W + 16);
        if (s->split.size() < static_cast<std::size_t>(cw) + 16) s->split.resize(cw + 16);
        if (s->chroma.size() < 2 * ch * cstride) s->chroma.resize(2 * ch * cstride);
        std::int16_t* hu = s->chroma.data();
        std::int16_t* hv = hu + ch * cstride;
        for (int r = 0; r < ch; ++r) {
            hscale_row(c1.plane + r * c1.stride, cw, hu + r * cstride, dw, s->hcoef.data(),
                       s->hpos.data(), hsize, ph, s->work[0].data(), s->split.data(),
                       s->half[0].data());
            hscale_row(c2.plane + r * c2.stride, cw, hv + r * cstride, dw, s->hcoef.data(),
                       s->hpos.data(), hsize, ph, s->work[0].data(), s->split.data(),
                       s->half[0].data());
        }
        std::uint32_t* __restrict px = s->packed.data();
        for (int y = 0; y < H; ++y) {
            const std::int16_t* c = s->vcoef.data() + static_cast<std::size_t>(y) * vsize;
            const std::int16_t* u[8];
            const std::int16_t* v[8];
            for (int j = 0; j < vsize && j < 8; ++j) {
                const int r = std::min(s->vpos[y] + j, ch - 1);
                u[j] = hu + r * cstride;
                v[j] = hv + r * cstride;
            }
            const bool one = vsize == 1 || (vsize == 2 && c[0] >= 0 && c[1] >= 0 &&
                                            c[1] <= 4096 && c[0] + c[1] == 4096);
            const int alpha = vsize == 1 ? 0 : c[vsize - 1];
            const std::uint8_t* __restrict py = c0.plane + y * c0.stride;
            if (full) row_full(py, u, v, c, vsize, one, alpha, px);
            else if (y < H - 2) row_mmx(py, u, v, c, vsize, one, alpha, dw, px);
            else row_c(py, u, v, c, vsize, one, alpha, dw, px);
            store_row(dst, y, px);
        }
    }

    // yuv2rgb_full_{1,X}_c into BGR24: 32-bit sums, Y << 22 and rounding
    // 2^21, clipped to 30 bits where any channel leaves them
    void row_full(const std::uint8_t* __restrict py, const std::int16_t* const* u,
                  const std::int16_t* const* v, const std::int16_t* c, int n, bool one,
                  int alpha, std::uint32_t* __restrict px) {
        const int W = hd.width;
        std::int32_t* __restrict uu = s->work[0].data();
        std::int32_t* __restrict vv = s->work[1].data();
        if (one && alpha == 0) {
            for (int x = 0; x < W; ++x) {
                uu[x] = (u[0][x] - (128 << 7)) * 4;
                vv[x] = (v[0][x] - (128 << 7)) * 4;
            }
        } else if (one) {
            const std::int32_t a1 = 4096 - alpha;
            for (int x = 0; x < W; ++x) {
                uu[x] = (u[0][x] * a1 + u[1][x] * alpha - (128 << 19)) >> 10;
                vv[x] = (v[0][x] * a1 + v[1][x] * alpha - (128 << 19)) >> 10;
            }
        } else {
            for (int x = 0; x < W; ++x) uu[x] = vv[x] = (1 << 9) - (128 << 19);
            for (int j = 0; j < n; ++j) {
                const std::int32_t cj = c[j];
                const std::int16_t* __restrict uj = u[j];
                const std::int16_t* __restrict vj = v[j];
                for (int x = 0; x < W; ++x) {
                    uu[x] += uj[x] * cj;
                    vv[x] += vj[x] * cj;
                }
            }
            for (int x = 0; x < W; ++x) {
                uu[x] >>= 10;
                vv[x] >>= 10;
            }
        }
        const SwsRange r = *range;
        auto clip30 = [](std::uint32_t t) {
            const std::int32_t v = static_cast<std::int32_t>(t);
            return static_cast<std::uint32_t>(v < 0 ? 0 : v > (1 << 30) - 1 ? (1 << 30) - 1 : v) >> 22;
        };
        for (int x = 0; x < W; ++x) {
            const std::uint32_t yy =
                static_cast<std::uint32_t>(((py[x] << 9) - (r.oy >> 7)) * r.yc) + (1u << 21);
            const std::uint32_t U = static_cast<std::uint32_t>(uu[x]), V = static_cast<std::uint32_t>(vv[x]);
            const std::uint32_t red = yy + V * static_cast<std::uint32_t>(r.vr);
            const std::uint32_t g = yy + V * static_cast<std::uint32_t>(r.vg) + U * static_cast<std::uint32_t>(r.ug);
            const std::uint32_t b = yy + U * static_cast<std::uint32_t>(r.ub);
            px[x] = clip30(b) | clip30(g) << 8 | clip30(red) << 16;
        }
    }

    // The MMXEXT yuv2bgr24_{1,X}: chroma as 8x its value in 16 bits (the
    // sum of pmulhw terms from the rounder 4, or one row >> 4, or two rows'
    // sum >> 5), then pmulhw by the coefficients, two pixels a chroma
    // sample, packuswb.  16-bit lanes throughout, as the MMX code has them.
    void row_mmx(const std::uint8_t* __restrict py, const std::int16_t* const* u,
                 const std::int16_t* const* v, const std::int16_t* c, int n, bool one,
                 int alpha, int dw, std::uint32_t* __restrict px) {
        const int W = hd.width;
        std::int16_t* __restrict cu = s->half[0].data();
        std::int16_t* __restrict cv = s->half[1].data();
        if (one && alpha < 2048) {
            for (int i = 0; i < dw; ++i) {
                cu[i] = static_cast<std::int16_t>(u[0][i] >> 4);
                cv[i] = static_cast<std::int16_t>(v[0][i] >> 4);
            }
        } else if (one) {
            for (int i = 0; i < dw; ++i) {
                cu[i] = static_cast<std::int16_t>(static_cast<std::uint16_t>(u[0][i] + u[1][i]) >> 5);
                cv[i] = static_cast<std::int16_t>(static_cast<std::uint16_t>(v[0][i] + v[1][i]) >> 5);
            }
        } else {
            for (int i = 0; i < dw; ++i) cu[i] = cv[i] = 4;
            for (int j = 0; j < n; ++j) {
                const std::int16_t cj = c[j];
                const std::int16_t* __restrict uj = u[j];
                const std::int16_t* __restrict vj = v[j];
                for (int i = 0; i < dw; ++i) {
                    cu[i] = static_cast<std::int16_t>(cu[i] + ((uj[i] * cj) >> 16));
                    cv[i] = static_cast<std::int16_t>(cv[i] + ((vj[i] * cj) >> 16));
                }
            }
        }
        // each term twice, a pair a word, so the pixel loop reads its own
        std::uint32_t* __restrict b2 = s->pairs[0].data();
        std::uint32_t* __restrict g2 = s->pairs[1].data();
        std::uint32_t* __restrict r2 = s->pairs[2].data();
        const SwsRange r = *range;
        auto twice = [](std::int32_t t) {
            return static_cast<std::uint32_t>(static_cast<std::uint16_t>(t)) * 0x10001u;
        };
        for (int i = 0; i < dw; ++i) {
            const std::int32_t uu = static_cast<std::int16_t>(cu[i] - 1024);
            const std::int32_t vv = static_cast<std::int16_t>(cv[i] - 1024);
            b2[i] = twice((uu * r.ub) >> 16);
            g2[i] = twice(((uu * r.ug) >> 16) + ((vv * r.vg) >> 16));
            r2[i] = twice((vv * r.vr) >> 16);
        }
        const I16Alias* __restrict b = reinterpret_cast<const I16Alias*>(b2);
        const I16Alias* __restrict g = reinterpret_cast<const I16Alias*>(g2);
        const I16Alias* __restrict rr = reinterpret_cast<const I16Alias*>(r2);
        auto sat = [](std::int32_t t) {
            return static_cast<std::uint32_t>(t < 0 ? 0 : t > 255 ? 255 : t);
        };
        // the luma as 8x its value, from the rounder 4 in the general sum,
        // less the offset (16 bits), times its coefficient
        const std::int32_t ybias = (one ? 0 : 4) - r.yo;
        for (int x = 0; x < W; ++x) {
            const std::int32_t yy = (static_cast<std::int16_t>(py[x] * 8 + ybias) * r.yc) >> 16;
            px[x] = sat(yy + b[x]) | sat(yy + g[x]) << 8 | sat(yy + rr[x]) << 16;
        }
    }

    // The C yuv2rgb_{1,X}_c: chroma rounded to 8 bits (a pair's four
    // values clipped together where one leaves them), then the tables
    void row_c(const std::uint8_t* __restrict py, const std::int16_t* const* u,
               const std::int16_t* const* v, const std::int16_t* c, int n, bool one,
               int alpha, int dw, std::uint32_t* __restrict px) {
        auto clip = [](std::int32_t t) { return t < 0 ? 0 : t > 255 ? 255 : t; };
        const SwsRange& r = *range;
        for (int i = 0; i < dw; ++i) {
            std::int32_t U, V;
            if (one && alpha < 2048) {
                U = (u[0][i] + 64) >> 7;
                V = (v[0][i] + 64) >> 7;
            } else if (one) {
                U = (u[0][i] * (4096 - alpha) + u[1][i] * alpha + (128 << 11)) >> 19;
                V = (v[0][i] * (4096 - alpha) + v[1][i] * alpha + (128 << 11)) >> 19;
            } else {
                std::int32_t su = 1 << 18, sv = 1 << 18;
                for (int j = 0; j < n; ++j) {
                    su += u[j][i] * c[j];
                    sv += v[j][i] * c[j];
                }
                U = su >> 19;
                V = sv >> 19;
            }
            std::int32_t y1 = py[2 * i], y2 = py[2 * i + 1];
            if ((y1 | y2 | U | V) & 0x100) {
                y1 = clip(y1);
                y2 = clip(y2);
                U = clip(U);
                V = clip(V);
            }
            const std::int32_t b = ((U * r.cbu) >> 16) - (r.cbu >> 9);
            const std::int32_t g = ((U * r.cgu) >> 16) - (r.cgu >> 9) + ((V * r.cgv) >> 16) - (r.cgv >> 9);
            const std::int32_t red = ((V * r.crv) >> 16) - (r.crv >> 9);
            for (int k = 0; k < 2; ++k) {
                const std::int32_t yy = k ? y2 : y1;
                px[2 * i + k] = static_cast<std::uint32_t>(sws_table(r, yy + b)) |
                                static_cast<std::uint32_t>(sws_table(r, yy + g)) << 8 |
                                static_cast<std::uint32_t>(sws_table(r, yy + red)) << 16;
            }
        }
    }

    // The markers after the scan, up to EOI, as jpeg_finish_decompress
    // reads them: a second scan is a mode this decoder does not read.
    int trailer(BitReader& br, Source& src) {
        int m = br.marker ? br.marker : src.next_marker();
        for (;;) {
            if (m == kEoi) return kOk;
            if (m == 0xDA) return kUnsupported;
            if (m == 0xD8 || (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC))
                return kCorrupt;
            const bool bare = (m >= 0xD0 && m <= 0xD7) || m == 0x01;
            if (!bare) {
                const bool known = m == 0xC4 || m == 0xCC || m == 0xDB || m == 0xDC ||
                                   m == 0xDD || m == 0xFE || (m >= 0xE0 && m <= 0xEF);
                if (!known) return kCorrupt;
                const int len = (src.at(src.pos) << 8) | src.at(src.pos + 1);
                src.pos += std::max(len, 2);
            }
            m = src.next_marker();
        }
    }
};

int decode(const std::uint8_t* data, std::size_t n, std::uint8_t* dst,
           int height, int width, int mode) {
    if (mode < kTurbo || mode > kFfmpeg) return kUnsupported;
    Decoder dec;
    dec.mode = mode;
    dec.fast = mode == kTurboFast;
    dec.s = &tls_scratch;
    Source src{data, n, 0};
    int rc = read_header(src, dec.hd, mode);
    if (rc != kOk)  // FFmpeg gives no frame for data that ends before SOS
        return mode == kFfmpeg && !src.sos && src.pos >= n ? kNoFrame : rc;
    rc = mode == kFfmpeg ? dec.setup_ffmpeg() : dec.setup();
    if (rc != kOk) return rc;
    if (dec.hd.height != height || dec.hd.width != width) return kGeometry;
    if (mode == kFfmpeg) return dec.run_ffmpeg(data, n, src.pos, dst);
    return dec.run(data, n, src.pos, dst);
}

// One TIFF chunk (already spliced with its tables) in TiffForm `form`
// into dst: height*width*3 bytes (RGB or as stored) or height*width
// (gray).
int tiff_decode(const std::uint8_t* data, std::size_t n, std::uint8_t* dst,
                int height, int width, int form, int hs, int vs) {
    if (form < kFormYcc || form > kFormGray) return kUnsupported;
    Decoder dec;
    dec.mode = kTiff;
    dec.form = form;
    dec.ss_h = hs;
    dec.ss_v = vs;
    dec.s = &tls_scratch;
    Source src{data, n, 0};
    int rc = read_header(src, dec.hd, kTiff);
    if (rc != kOk) return rc;
    rc = dec.setup();
    if (rc != kOk) return rc;
    if (dec.hd.height != height || dec.hd.width != width) return kGeometry;
    return dec.run(data, n, src.pos, dst);
}

thread_local std::vector<std::uint8_t> tls_spliced;

// ---- rawvideo: the frames of an uncompressed AVI ----
//
// What cv2.VideoCapture gives for a frame chunk (FFmpeg's rawdec.c, then
// swscale to BGR24; native/rawvideo_plain.py has each rule): pal8 looked
// up in its palette, RGB555 with each field's bits repeated, BGR24 as it
// is, BGR0 its first three bytes, gray8 in three channels; their rows
// bottom-up where the caller says so (BI_RGB of positive height), and
// padded to 4 bytes where the chunk holds the padded frame.  The YUV
// layouts go through the MJPEG decoder's converter with the limited-range
// tables of the BT.601 matrix (or BT.709, for the planes of a stream tagged
// so): yuv420p (I420; YV12 with its planes swapped) and yuv422p by the
// unscaled SSSE3 path at an even height, yuv444p by the full-chroma output,
// every other case by the scaled path.  i420_left is yuv420p whose chroma
// FFmpeg's MPEG-4 decoder sites left (its scaled path filters from there);
// yv24 is yuv444p with the V plane first.
enum RawLayout { kPal8, kRgb555, kBgr24, kBgr0, kGray8, kI420, kYv12, kNv12, kYuyv, kUyvy, kYuv422p,
                 kYuv444p, kI420Left, kYv24 };

constexpr int kShortChunk = -7;   // rawvideo: a chunk shorter than the frame

int raw_decode(const std::uint8_t* data, std::size_t n, std::uint8_t* dst, int height,
               int width, int layout, bool bottom_up, const std::uint8_t* palette,
               const SwsRange* range) {
    if (height < 1 || width < 1 || layout < kPal8 || layout > kYv24) return kUnsupported;
    const std::size_t H = height, W = width, h2 = (H + 1) / 2, w2 = (W + 1) / 2;
    static const int kPixelBytes[5] = {1, 2, 3, 4, 1};
    if (layout <= kGray8) {
        const std::size_t row = W * kPixelBytes[layout], padded = (row + 3) & ~std::size_t{3};
        if (n < row * H) return kShortChunk;
        const std::size_t stride = layout != kBgr0 && padded * H <= n ? padded : row;
        for (std::size_t y = 0; y < H; ++y) {
            const std::uint8_t* __restrict in = data + (bottom_up ? H - 1 - y : y) * stride;
            std::uint8_t* __restrict out = dst + y * W * 3;
            switch (layout) {
            case kPal8:
                for (std::size_t x = 0; x < W; ++x) std::memcpy(out + 3 * x, palette + 4 * in[x], 3);
                break;
            case kGray8:
                for (std::size_t x = 0; x < W; ++x) out[3 * x] = out[3 * x + 1] = out[3 * x + 2] = in[x];
                break;
            case kRgb555:
                for (std::size_t x = 0; x < W; ++x) {
                    const int v = in[2 * x] | in[2 * x + 1] << 8;
                    for (int k = 0; k < 3; ++k) {
                        const int f = (v >> (5 * k)) & 31;
                        out[3 * x + k] = static_cast<std::uint8_t>(f << 3 | f >> 2);
                    }
                }
                break;
            case kBgr24:
                std::memcpy(out, in, W * 3);
                break;
            default:  // kBgr0
                for (std::size_t x = 0; x < W; ++x)
                    for (int k = 0; k < 3; ++k) out[3 * x + k] = in[4 * x + k];
            }
        }
        return kOk;
    }
    const bool packed = layout == kYuyv || layout == kUyvy, planar = !packed && layout != kNv12;
    const bool full = layout == kYuv444p || layout == kYv24;
    const std::size_t ch = packed || layout == kYuv422p || full ? H : h2, cw = full ? W : w2;
    if (n < (packed ? H * w2 * 4 : H * W + 2 * ch * cw)) return kShortChunk;
    Decoder dec;
    dec.mode = kFfmpeg;
    dec.s = &tls_scratch;
    dec.hd.width = width;
    dec.hd.height = height;
    dec.hd.ncomp = 3;
    dec.hs = full ? 0 : 1;
    dec.vs = ch == H ? 0 : 1;
    dec.range = range;
    if (layout == kI420Left) dec.chroma_h_pos = 64;
    dec.alloc_rows();
    Component *c = dec.hd.comp;
    c[0].stride = W;
    c[1].stride = c[2].stride = cw;
    if (planar) {
        std::uint8_t* planes = const_cast<std::uint8_t*>(data);
        c[0].plane = planes;
        const bool swap = layout == kYv12 || layout == kYv24;
        c[swap ? 2 : 1].plane = planes + H * W;
        c[swap ? 1 : 2].plane = planes + H * W + ch * cw;
    } else {  // split into planes of the scratch buffer
        Scratch& sc = *dec.s;
        const std::size_t need = (packed ? H * W : 0) + 2 * ch * w2;
        if (sc.cap < need) {
            sc.planes.reset(new std::uint8_t[need]);
            sc.cap = need;
        }
        std::uint8_t* __restrict u = sc.planes.get();
        std::uint8_t* __restrict v = u + ch * w2;
        if (layout == kNv12) {
            c[0].plane = const_cast<std::uint8_t*>(data);
            const std::uint8_t* __restrict uv = data + H * W;
            for (std::size_t i = 0; i < h2 * w2; ++i) {
                u[i] = uv[2 * i];
                v[i] = uv[2 * i + 1];
            }
        } else {
            std::uint8_t* __restrict y = v + ch * w2;
            const int ly = layout == kYuyv ? 0 : 1, lu = 1 - ly;
            for (std::size_t r = 0; r < H; ++r) {
                const std::uint8_t* __restrict in = data + r * w2 * 4;
                for (std::size_t i = 0; i < w2; ++i) {
                    y[r * W + 2 * i] = in[4 * i + ly];
                    if (2 * i + 1 < W) y[r * W + 2 * i + 1] = in[4 * i + 2 + ly];
                    u[r * w2 + i] = in[4 * i + lu];
                    v[r * w2 + i] = in[4 * i + 2 + lu];
                }
            }
            c[0].plane = y;
        }
        c[1].plane = u;
        c[2].plane = v;
    }
    if (full || (planar && !(height & 1))) dec.convert_rows(dst, 0, height);
    else dec.scale_frame(dst);
    return kOk;
}

}  // namespace

extern "C" {

// Decode one JPEG (bytes src[0..n)) into dst = height*width*3 interleaved
// BGR uint8 in mode 0 (turbo), 1 (turbo_fast) or 2 (ffmpeg).  Returns 0
// on success; -1 a decode error (where libjpeg would stop with one); -2
// the frame's geometry differs from (height, width); -3 a component count
// the mode does not read (modes 0 and 1: other than three; mode 2: other
// than one or three); -4 a mode this decoder does not read (lossless,
// arithmetic, hierarchical, 12-bit; in modes 0 and 1 also progressive,
// several scans and sampling other than 4:4:4/4:2:2/4:2:0; in mode 2
// sampling FFmpeg does not read as gray or yuvj444p/422p/420p/411p/440p);
// mode 2 only: -5 data FFmpeg decodes with an error it conceals, -6 data
// that ends before the first scan (FFmpeg returns no frame).
int clt_jpeg_decode_bgr(const unsigned char* src, std::size_t n,
                        unsigned char* dst, int height, int width,
                        int mode) {
    return decode(src, n, dst, height, width, mode);
}

// Decode k JPEGs (srcs[i], sizes[i] bytes) into dst, frame i at
// i*height*width*3, on up to nthreads threads; rcs[i] gets frame i's
// return code as clt_jpeg_decode_bgr gives it.
void clt_jpeg_decode_bgr_batch(const unsigned char* const* srcs,
                               const std::size_t* sizes, std::size_t k,
                               unsigned char* dst, int height, int width,
                               int mode, int nthreads, int* rcs) {
    const std::size_t frame = static_cast<std::size_t>(height) * width * 3;
    parallel_items(k, nthreads, [&](std::size_t i) {
        rcs[i] = decode(srcs[i], sizes[i], dst + i * frame, height, width,
                        mode);
    });
}

// Decode k uncompressed frames (srcs[i], sizes[i] bytes) of one layout
// (RawLayout: 0 pal8, 1 rgb555, 2 bgr24, 3 bgr0, 4 gray8, 5 i420, 6 yv12,
// 7 nv12, 8 yuyv422, 9 uyvy422, 10 yuv422p, 11 yuv444p, 12 i420_left,
// 13 yv24) into dst, frame i
// at i*height*width*3 as BGR, on up to nthreads threads.  bottom_up: the
// single-plane layouts' rows are stored last first; palette: pal8's 256 B,
// G, R, X entries; matrix: the YUV layouts' (0 BT.601, 1 BT.709, 2 BT.601
// at full range, as the MJPEG decoder's yuvj formats convert).  rcs[i]
// gets 0, -7 for a chunk shorter than the frame, or -4 for an unknown
// layout or matrix or an empty frame.
void clt_raw_decode_bgr_batch(const unsigned char* const* srcs,
                              const std::size_t* sizes, std::size_t k,
                              unsigned char* dst, int height, int width,
                              int layout, int bottom_up,
                              const unsigned char* palette, int matrix,
                              int nthreads, int* rcs) {
    const std::size_t frame = static_cast<std::size_t>(height) * width * 3;
    const SwsRange* range = matrix == 0   ? &kSwsLimited
                            : matrix == 1 ? &kSwsLimited709
                            : matrix == 2 ? &kSwsFull
                                          : nullptr;
    parallel_items(k, nthreads, [&](std::size_t i) {
        rcs[i] = range ? raw_decode(srcs[i], sizes[i], dst + i * frame, height, width,
                                    layout, bottom_up != 0, palette, range)
                       : kUnsupported;
    });
}

// Decode k JPEG chunks of a TIFF's file image `src` (chunk i at
// offsets[i], counts[i] bytes) with one JPEGTables stream (tables_n
// bytes, 0 for none) into dst, chunk i at dst_offsets[i], heights[i] x
// width pixels of 3 bytes (form 0 YCbCr -> RGB, 1 as stored) or 1 (form
// 2 gray); hs, vs: the YCbCrSubSampling form 0 checks the first
// component against.  On up to nthreads threads; rcs[i] gets chunk i's
// return code as clt_jpeg_decode_bgr gives it in mode 0 (-3 also for a
// component count other than the form's), -8 for sampling libtiff
// refuses, -9 for a chunk outside the file, -1 for tables or a chunk
// that do not start with SOI (the tables: or end with EOI).
void clt_jpeg_decode_tiff_batch(const unsigned char* tables, std::size_t tables_n,
                                const unsigned char* src, std::size_t src_size,
                                const std::uint64_t* offsets,
                                const std::uint64_t* counts, std::size_t k,
                                unsigned char* dst, const std::uint64_t* dst_offsets,
                                const int* heights, int width, int form, int hs,
                                int vs, int nthreads, int* rcs) {
    const bool tables_ok = tables_n == 0 ||
        (tables_n >= 4 && tables[0] == 0xFF && tables[1] == 0xD8 &&
         tables[tables_n - 2] == 0xFF && tables[tables_n - 1] == kEoi);
    parallel_items(k, nthreads, [&](std::size_t i) {
        if (offsets[i] > src_size || counts[i] > src_size - offsets[i]) {
            rcs[i] = kOutside;
            return;
        }
        const unsigned char* chunk = src + offsets[i];
        const std::size_t n = counts[i];
        if (!tables_ok || n < 2 || chunk[0] != 0xFF || chunk[1] != 0xD8) {
            rcs[i] = kCorrupt;
            return;
        }
        const unsigned char* data = chunk;
        std::size_t size = n;
        if (tables_n) {  // the tables' segments after the chunk's SOI
            tls_spliced.resize(tables_n - 2 + n - 2);
            std::memcpy(tls_spliced.data(), tables, tables_n - 2);
            std::memcpy(tls_spliced.data() + tables_n - 2, chunk + 2, n - 2);
            data = tls_spliced.data();
            size = tls_spliced.size();
        }
        rcs[i] = tiff_decode(data, size, dst + dst_offsets[i], heights[i], width,
                             form, hs, vs);
    });
}

int clt_jpeg_version() { return 6; }

}  // extern "C"
