// Native MPEG-4 Part 2 (Simple and Advanced Simple Profile) decoder for
// camera_linearity_tpu_torch: the I-, P- and B-VOPs of an MPEG-4 Part 2 AVI
// (FMP4, XVID, DIVX, DX50, ...) as FFmpeg's mpeg4 decoder (mpeg4videodec.c,
// h263dec.c, mpegvideo_motion.c) decodes them, into yuv420p planes that
// jpeg.cpp's rawvideo converter turns into BGR as cv2 gets them.
//
// Python reads each chunk's headers (native/mpeg4_plain.Stream: the VOL,
// user data, the VOP header and times, a packed bitstream's pending VOP,
// the refusals) and hands this library the macroblock data: its first bit
// and the VOP's type, quantiser, fcodes, rounding type, intra DC threshold,
// FFmpeg's bug flags and IDCT, direct mode's times and quant_type 1's
// matrices.  A decoder object per stream keeps what FFmpeg keeps from frame
// to frame: the DC and AC predictors with their borders, the macroblocks
// last coded intra, the two references (macroblock-aligned: the latest I-
// or P-VOP and the one before it) and the latest one's vectors and skipped
// macroblocks, which a B-VOP's direct mode and skips read.  A frame is
// parsed serially (the predictors chain through it) into macroblock
// records; its reconstruction (motion compensation, dequantisation, the
// simple or Xvid IDCT) then runs a macroblock row a thread, each row
// reading only the references, while the next frame is parsed beside it.
// A run of frames that starts at an I-VOP with no B-VOP after it depends on
// nothing before it, so a batch that holds several such runs decodes them
// side by side, one run a thread.  Each frame's decoded picture goes out in
// coded order; Python outputs them in FFmpeg's order.
// native/mpeg4_plain.py is the plain version the tests hold this to, and
// has each rule's origin.
//
// Built as a plain shared library with g++ on first use;
// camera_linearity_tpu_torch.native loads it with ctypes.

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
constexpr int kBad = -1;      // bits FFmpeg fails to decode (it conceals)
constexpr int kEnd = -2;      // the data end inside a macroblock
constexpr int kPacket = -3;   // a video packet header FFmpeg refuses
constexpr int kNoRef = -4;    // a P-VOP with no reference

// -- tables (ISO/IEC 14496-2 annex B; mpeg4_plain has them too) -----------
constexpr std::uint8_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                            {1, 6}, {2, 6}, {3, 6}, {1, 9}};
constexpr std::uint8_t kInterMcbpc[28][2] = {
    {1, 1}, {3, 4}, {2, 4},  {5, 6},  {3, 5},  {4, 8},  {3, 8},  {3, 7},  {3, 3},  {7, 7},
    {6, 7}, {5, 9}, {4, 6},  {4, 9},  {3, 9},  {2, 9},  {2, 3},  {5, 7},  {4, 7},  {5, 8},
    {1, 9}, {0, 0}, {0, 0},  {0, 0},  {2, 11}, {12, 13}, {14, 13}, {15, 13}};
constexpr std::uint8_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                                       {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                                       {4, 4}, {8, 4}, {6, 4}, {3, 2}};
constexpr std::uint8_t kMvtab[33][2] = {
    {1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},   {3, 7},   {11, 9},
    {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}, {11, 10},
    {10, 10}, {9, 10},  {8, 10},  {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},
    {5, 11},  {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
constexpr std::uint8_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},  {1, 4}, {1, 5},
                                        {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
constexpr std::uint8_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3},  {1, 4},  {1, 5}, {1, 6},
                                          {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};
constexpr std::uint16_t kInterVlc[103][2] = {
    {2, 2},   {15, 4},  {21, 6},  {23, 7},  {31, 8},  {37, 9},  {36, 9},  {33, 10}, {32, 10},
    {7, 11},  {6, 11},  {32, 11}, {6, 3},   {20, 6},  {30, 8},  {15, 10}, {33, 11}, {80, 12},
    {14, 4},  {29, 8},  {14, 10}, {81, 12}, {13, 5},  {35, 9},  {13, 10}, {12, 5},  {34, 9},
    {82, 12}, {11, 5},  {12, 10}, {83, 12}, {19, 6},  {11, 10}, {84, 12}, {18, 6},  {10, 10},
    {17, 6},  {9, 10},  {16, 6},  {8, 10},  {22, 7},  {85, 12}, {21, 7},  {20, 7},  {28, 8},
    {27, 8},  {33, 9},  {32, 9},  {31, 9},  {30, 9},  {29, 9},  {28, 9},  {27, 9},  {26, 9},
    {34, 11}, {35, 11}, {86, 12}, {87, 12}, {7, 4},   {25, 9},  {5, 11},  {15, 6},  {4, 11},
    {14, 6},  {13, 6},  {12, 6},  {19, 7},  {18, 7},  {17, 7},  {16, 7},  {26, 8},  {25, 8},
    {24, 8},  {23, 8},  {22, 8},  {21, 8},  {20, 8},  {19, 8},  {24, 9},  {23, 9},  {22, 9},
    {21, 9},  {20, 9},  {19, 9},  {18, 9},  {17, 9},  {7, 10},  {6, 10},  {5, 10},  {4, 10},
    {36, 11}, {37, 11}, {38, 11}, {39, 11}, {88, 12}, {89, 12}, {90, 12}, {91, 12}, {92, 12},
    {93, 12}, {94, 12}, {95, 12}, {3, 7}};
constexpr std::uint16_t kIntraVlc[103][2] = {
    {2, 2},   {6, 3},   {15, 4},  {13, 5},  {12, 5},  {21, 6},  {19, 6},  {18, 6},  {23, 7},
    {31, 8},  {30, 8},  {29, 8},  {37, 9},  {36, 9},  {35, 9},  {33, 9},  {33, 10}, {32, 10},
    {15, 10}, {14, 10}, {7, 11},  {6, 11},  {32, 11}, {33, 11}, {80, 12}, {81, 12}, {82, 12},
    {14, 4},  {20, 6},  {22, 7},  {28, 8},  {32, 9},  {31, 9},  {13, 10}, {34, 11}, {83, 12},
    {85, 12}, {11, 5},  {21, 7},  {30, 9},  {12, 10}, {86, 12}, {17, 6},  {27, 8},  {29, 9},
    {11, 10}, {16, 6},  {34, 9},  {10, 10}, {13, 6},  {28, 9},  {8, 10},  {18, 7},  {27, 9},
    {84, 12}, {20, 7},  {26, 9},  {87, 12}, {25, 8},  {9, 10},  {24, 8},  {35, 11}, {23, 8},
    {25, 9},  {24, 9},  {7, 10},  {88, 12}, {7, 4},   {12, 6},  {22, 8},  {23, 9},  {6, 10},
    {5, 11},  {4, 11},  {89, 12}, {15, 6},  {22, 9},  {5, 10},  {14, 6},  {4, 10},  {17, 7},
    {36, 11}, {16, 7},  {37, 11}, {19, 7},  {90, 12}, {21, 8},  {91, 12}, {20, 8},  {19, 8},
    {26, 8},  {21, 9},  {20, 9},  {19, 9},  {18, 9},  {17, 9},  {38, 11}, {39, 11}, {92, 12},
    {93, 12}, {94, 12}, {95, 12}, {3, 7}};
constexpr int kEscape = 102;
constexpr std::uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
constexpr std::uint8_t kAltH[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14, 13, 12, 19, 18, 24, 25,
    32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37,
    38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
constexpr std::uint8_t kAltV[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3,  11,
    4,  12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44,
    52, 60, 37, 45, 53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
constexpr std::uint8_t kYDcScale[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18,
                                        19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                                        30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
constexpr std::uint8_t kCDcScale[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11,
                                        12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17,
                                        17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
constexpr int kDquant[4] = {-1, -2, 1, 2};
constexpr int kChromaRound[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};

// (run, max level) rows of the two TCOEF tables, not-last then last
struct RunRow { int run, top; };

// A TCOEF table: each code's level, run and last flag; max_level[last][run]
// and max_run[last][level] as ff_rl_init makes them.
struct RunLevel {
    std::int8_t level[102], run[102], last[102];
    std::int8_t max_level[2][65], max_run[2][65];
};

RunLevel make_rl(const std::vector<RunRow>& not_last, const std::vector<RunRow>& last) {
    RunLevel rl{};
    int i = 0;
    for (int l = 0; l < 2; ++l)
        for (const RunRow& r : l ? last : not_last)
            for (int v = 1; v <= r.top; ++v, ++i) {
                rl.level[i] = static_cast<std::int8_t>(v);
                rl.run[i] = static_cast<std::int8_t>(r.run);
                rl.last[i] = static_cast<std::int8_t>(l);
                rl.max_level[l][r.run] = std::max<std::int8_t>(rl.max_level[l][r.run], v);
                rl.max_run[l][v] = std::max<std::int8_t>(rl.max_run[l][v], r.run);
            }
    return rl;
}

std::vector<RunRow> rows(std::initializer_list<RunRow> head, int from, int to, int top) {
    std::vector<RunRow> v(head);
    for (int r = from; r < to; ++r) v.push_back({r, top});
    return v;
}

// A VLC as a table over every `bits`-bit window: the symbol and its length
// (0: no code starts the window).
struct Vlc {
    int bits;
    std::vector<std::int16_t> sym;
    std::vector<std::uint8_t> len;
};

template <typename T, std::size_t N>
Vlc make_vlc(const T (&codes)[N][2], int bits) {
    Vlc v{bits, std::vector<std::int16_t>(std::size_t{1} << bits, -1),
          std::vector<std::uint8_t>(std::size_t{1} << bits, 0)};
    for (std::size_t s = 0; s < N; ++s) {
        const int n = codes[s][1];
        if (!n) continue;
        const std::size_t base = static_cast<std::size_t>(codes[s][0]) << (bits - n);
        for (std::size_t k = 0; k < (std::size_t{1} << (bits - n)); ++k) {
            v.sym[base + k] = static_cast<std::int16_t>(s);
            v.len[base + k] = static_cast<std::uint8_t>(n);
        }
    }
    return v;
}

struct Tables {
    Vlc intra_mcbpc = make_vlc(kIntraMcbpc, 9), inter_mcbpc = make_vlc(kInterMcbpc, 13),
        cbpy = make_vlc(kCbpy, 6), mv = make_vlc(kMvtab, 12), dc_lum = make_vlc(kDcLum, 11),
        dc_chrom = make_vlc(kDcChrom, 12), inter = make_vlc(kInterVlc, 12),
        intra = make_vlc(kIntraVlc, 12);
    RunLevel rl_intra = make_rl(
        rows({{0, 27}, {1, 10}, {2, 5}, {3, 4}, {4, 3}, {5, 3}, {6, 3}, {7, 3}, {8, 2}, {9, 2}},
             10, 15, 1),
        [] {
            auto v = rows({{0, 8}, {1, 3}}, 2, 7, 2);
            for (int r = 7; r < 21; ++r) v.push_back({r, 1});
            return v;
        }());
    RunLevel rl_inter = make_rl(
        [] {
            auto v = rows({{0, 12}, {1, 6}, {2, 4}}, 3, 7, 3);
            for (int r = 7; r < 11; ++r) v.push_back({r, 2});
            for (int r = 11; r < 27; ++r) v.push_back({r, 1});
            return v;
        }(),
        rows({{0, 3}, {1, 2}}, 2, 41, 1));
};

const Tables& tables() {
    static const Tables t;
    return t;
}

struct Fail {
    int rc;
};

// FFmpeg's bit reader: most significant bit first, zeros past the end.
struct Bits {
    const std::uint8_t* p;
    std::size_t n;     // bytes
    std::size_t pos;   // bits
    std::uint32_t peek(int k) const {   // k <= 32
        const std::size_t b = pos >> 3;
        std::uint64_t v;
        if (b + 8 <= n) {
            std::memcpy(&v, p + b, 8);
            v = __builtin_bswap64(v);
        } else {
            v = 0;
            for (std::size_t i = 0; i < 8; ++i) v = v << 8 | (b + i < n ? p[b + i] : 0);
        }
        return static_cast<std::uint32_t>((v << (pos & 7)) >> (64 - k));
    }
    std::uint32_t get(int k) {
        if (!k) return 0;
        const std::uint32_t v = peek(k);
        pos += k;
        return v;
    }
    int sget(int k) {
        const std::uint32_t v = get(k);
        return v >> (k - 1) ? static_cast<int>(v) - (1 << k) : static_cast<int>(v);
    }
    int vlc(const Vlc& t) {
        const std::uint32_t w = peek(t.bits);
        if (!t.len[w]) throw Fail{kBad};
        pos += t.len[w];
        return t.sym[w];
    }
    std::size_t bits() const { return 8 * n; }
};

inline int i16(int v) { return static_cast<std::int16_t>(static_cast<std::uint16_t>(v)); }
inline int mid3(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }
inline std::uint32_t u32(int v) { return static_cast<std::uint32_t>(v); }

// kSkip: a P-VOP's skipped macroblock, or a B-VOP's that the latest
// reference skipped (the forward reference, no vector); kB: a B-VOP's
// coded one (forward, backward or both vectors: one each, or four for
// direct mode over a 4MV macroblock)
enum Kind : std::uint8_t { kSkip, kInter, kInter4, kIntra, kB };

// A parsed macroblock: its kind, vectors, coded blocks and quantiser; its
// six blocks (natural order) beside it, the intra ones in the quantised
// domain, the inter ones dequantised (H.263) or not (quant_type 1).
struct Mb {
    Kind kind;
    std::uint8_t cbp, q;
    bool four, fwd, bwd;
    std::int16_t mv[4][2], bmv[4][2];
};

// One VOP's parameters, as Python read them from its header.
struct Vop {
    int type, quant, fcode, bcode, rounding, dc_thr, edge, dc_clip, xvid, pb, pp, mpeg;
    std::int32_t intra_m[64], inter_m[64];   // quant_type 1's, natural order
};

// The reconstruction of a frame: records in, planes out.
struct Frame {
    std::vector<Mb> mbs;
    std::vector<std::int16_t> blocks;   // 6 * 64 a macroblock
    Vop vop;
};

// simple_idct as ff_simple_idct8_{put,add}_sse2 compute it, before the
// final clip (jpeg.cpp's idct_simple clips it; jpeg_plain._idct_simple).
constexpr std::uint32_t kW1 = 22725, kW2 = 21407, kW3 = 19266, kW4 = 16383,
                        kW5 = 12873, kW6 = 8867, kW7 = 4520;

inline int sat16(std::int32_t v) { return std::min(std::max(v, -32768), 32767); }

void lanes(const std::int32_t (*x)[8], const std::uint32_t* a, std::int32_t (*o)[8]) {
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

// in: 64 int16 coefficients, natural order; out[r * 8 + c]: the sums.
void idct_sums(const std::int16_t* in, std::int32_t* out) {
    std::int32_t x[8][8], o[8][8], y[8][8];
    std::uint32_t a[8];
    int ac = 0;
    for (int i = 1; i < 64; ++i) ac |= in[i];
    if (!ac) {  // a flat block
        const std::int32_t v = static_cast<std::int32_t>(kW4 * u32(i16(i16(in[0] * 8) + 32))) >> 20;
        for (int i = 0; i < 64; ++i) out[i] = v;
        return;
    }
    for (int r = 0; r < 8; ++r)
        for (int k = 0; k < 8; ++k) x[k][r] = in[8 * r + k];
    for (int r = 0; r < 8; ++r) a[r] = kW4 * u32(x[0][r]) + (1u << 10);
    lanes(x, a, o);
    for (int r = 0; r < 8; ++r) {
        const bool any = x[1][r] | x[2][r] | x[3][r] | x[4][r] | x[5][r] | x[6][r] | x[7][r];
        const std::int32_t d = i16(x[0][r] * 8);
        for (int c = 0; c < 8; ++c) y[r][c] = any ? sat16(o[c][r] >> 11) : d;
    }
    for (int c = 0; c < 8; ++c) a[c] = kW4 * u32(i16(y[0][c] + 32));
    lanes(y, a, o);
    for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c) out[8 * r + c] = o[r][c] >> 20;
}

inline std::uint8_t clip255(int v) { return static_cast<std::uint8_t>(std::min(std::max(v, 0), 255)); }

// The Xvid IDCT as ff_xvid_idct_{put,add}_sse2 compute it, before the
// final clip (mpeg4_plain.xvid_idct_sums): rows in 32-bit sums with their
// rounders, shifted by 11 and saturated (rows 0-2 always, 3-7 only where
// nonzero); columns in 16-bit saturating lanes with pmulhw products.
constexpr int kXvidTab[4][7] = {{22725, 21407, 19266, 16384, 12873, 8867, 4520},
                                {31521, 29692, 26722, 22725, 17855, 12299, 6270},
                                {29692, 27969, 25172, 21407, 16819, 11585, 5906},
                                {26722, 25172, 22654, 19266, 15137, 10426, 5315}};
constexpr int kXvidRowTab[8] = {0, 1, 2, 3, 0, 3, 2, 1};
constexpr std::uint32_t kXvidRnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};

inline int mulhi(int a, int c) { return (a * c) >> 16; }

void xvid_idct_sums(const std::int16_t* in, std::int32_t* out) {
    int x[8][8];   // [row][column]
    for (int r = 0; r < 8; ++r) {
        const std::int16_t* v = in + 8 * r;
        bool any = false;
        for (int i = 0; i < 8; ++i) any |= v[i] != 0;
        if (r >= 3 && !any) {
            for (int i = 0; i < 8; ++i) x[r][i] = 0;
            continue;
        }
        const int* t = kXvidTab[kXvidRowTab[r]];
        const std::uint32_t c1 = t[0], c2 = t[1], c3 = t[2], c4 = t[3], c5 = t[4], c6 = t[5], c7 = t[6];
        const std::uint32_t v0 = u32(v[0]), v1 = u32(v[1]), v2 = u32(v[2]), v3 = u32(v[3]), v4 = u32(v[4]),
                            v5 = u32(v[5]), v6 = u32(v[6]), v7 = u32(v[7]);
        const std::uint32_t k = c4 * v0 + kXvidRnd[r];
        const std::uint32_t a0 = k + c2 * v2 + c4 * v4 + c6 * v6, a1 = k + c6 * v2 - c4 * v4 - c2 * v6,
                            a2 = k - c6 * v2 - c4 * v4 + c2 * v6, a3 = k - c2 * v2 + c4 * v4 - c6 * v6;
        const std::uint32_t b0 = c1 * v1 + c3 * v3 + c5 * v5 + c7 * v7, b1 = c3 * v1 - c7 * v3 - c1 * v5 - c5 * v7,
                            b2 = c5 * v1 - c1 * v3 + c7 * v5 + c3 * v7, b3 = c7 * v1 - c5 * v3 + c3 * v5 - c1 * v7;
        const std::uint32_t o[8] = {a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0};
        for (int i = 0; i < 8; ++i) x[r][i] = sat16(static_cast<std::int32_t>(o[i]) >> 11);
    }
    constexpr int kTan1 = 13036, kTan2 = 27146, kTan3 = 43790 - 65536, kSqrt2 = 23170;
    for (int c = 0; c < 8; ++c) {
        const int X0 = x[0][c], X1 = x[1][c], X2 = x[2][c], X3 = x[3][c], X4 = x[4][c], X5 = x[5][c],
                  X6 = x[6][c], X7 = x[7][c];
        const int tm35 = sat16(sat16(mulhi(X3, kTan3) + X3) - X5);
        const int tp35 = sat16(sat16(mulhi(X5, kTan3) + X5) + X3);
        const int tp17 = sat16(mulhi(X7, kTan1) + X1), tm17 = sat16(mulhi(X1, kTan1) - X7);
        const int t1 = sat16(tp17 - tp35), b3 = sat16(tm17 - tm35), b0 = sat16(tp35 + tp17),
                  t2 = sat16(tm35 + tm17);
        int b2 = mulhi(sat16(t1 - t2), kSqrt2), b1 = mulhi(sat16(t2 + t1), kSqrt2);
        b1 = sat16(b1 + b1);
        b2 = sat16(b2 + b2);
        const int tp26 = sat16(mulhi(X6, kTan2) + X2), tm26 = sat16(mulhi(X2, kTan2) - X6);
        const int tm04 = sat16(X0 - X4), tp04 = sat16(X4 + X0);
        const int a3 = sat16(tp04 - tp26), a0 = sat16(tp26 + tp04), a2 = sat16(tm04 - tm26),
                  a1 = sat16(tm26 + tm04);
        const int o[8] = {sat16(b0 + a0), sat16(b1 + a1), sat16(b2 + a2), sat16(b3 + a3),
                          sat16(a3 - b3), sat16(a2 - b2), sat16(a1 - b1), sat16(a0 - b0)};
        for (int r = 0; r < 8; ++r) out[8 * r + c] = o[r] >> 6;
    }
}

inline int abs16(int v) { return (v < 0 ? -v : v) & 0xFFFF; }

// dct_unquantize_mpeg2_intra / _inter as FFmpeg's x86 routines compute
// them (mpeg4_plain.dequant_mpeg_intra / _inter): the quantiser doubled,
// 16-bit lanes; the inter one with mismatch control.
void dequant_mpeg_intra(const std::int16_t* b, int q, int dc_scale, const std::int32_t* m, std::int16_t* out) {
    out[0] = static_cast<std::int16_t>(b[0] * dc_scale);
    for (int i = 1; i < 64; ++i) {
        if (!b[i]) {
            out[i] = 0;
            continue;
        }
        const int qw = (2 * q * m[i]) & 0xFFFF;
        const int p = i16(abs16(b[i]) * qw) >> 4;
        out[i] = static_cast<std::int16_t>(b[i] < 0 ? -p : p);
    }
}

void dequant_mpeg_inter(const std::int16_t* b, int q, const std::int32_t* m, std::int16_t* out) {
    int sum = -1;
    for (int i = 0; i < 64; ++i) {
        if (!b[i]) {
            out[i] = 0;
            continue;
        }
        const int qw = (2 * q * m[i]) & 0xFFFF;
        const int p = ((((2 * abs16(b[i])) & 0xFFFF) * qw + qw) & 0xFFFF) >> 5;
        out[i] = static_cast<std::int16_t>(b[i] < 0 ? -p : p);
        sum += out[i];
    }
    out[63] = static_cast<std::int16_t>(out[63] ^ (sum & 1));
}

// One stream's decoder.
struct Decoder {
    int W, H, mbw, mbh, wrap, cwrap, tib;
    bool resync;
    // FFmpeg's predictors, flat with a border row and column
    std::vector<std::int32_t> dc[3];
    std::vector<std::int16_t> ac[3];   // 16 an entry: [1..7] left column, [9..15] top row
    std::vector<std::uint8_t> mbintra;
    // the frame being parsed
    std::vector<std::int16_t> mv;      // (2 mbh) x (2 mbw + 2) x 2
    std::vector<std::int32_t> qtab;
    int qscale = 1, rx = 0, ry = 0, last_mv[2][2] = {};
    bool first_line = true, dc_clip = false;
    // the latest reference's vectors (four a macroblock), skipped and 4MV
    // macroblocks
    std::vector<std::int16_t> colo_mv;
    std::vector<std::uint8_t> colo_skip, colo_four;
    // macroblock-aligned planes: three for I- and P-VOPs (the latest
    // reference, the one before it, the one being built), one for B-VOPs
    std::vector<std::uint8_t> pic[4][3];
    int ref = -1, fwd = -1;   // pic indices of the latest reference and the one before

    Decoder(int height, int width, int resync_marker, int time_bits)
        : W(width), H(height), mbw((width + 15) / 16), mbh((height + 15) / 16),
          wrap(2 * mbw + 1), cwrap(mbw + 1), tib(time_bits), resync(resync_marker != 0) {
        dc[0].assign(static_cast<std::size_t>(2 * mbh + 1) * wrap + 1, 1024);
        dc[1].assign(static_cast<std::size_t>(mbh + 1) * cwrap + 1, 1024);
        dc[2] = dc[1];
        for (int c = 0; c < 3; ++c) ac[c].assign(dc[c].size() * 16, 0);
        mbintra.assign(static_cast<std::size_t>(mbh) * cwrap, 1);
        const std::size_t mbnum = static_cast<std::size_t>(mbw) * mbh;
        colo_mv.assign(mbnum * 8, 0);
        colo_skip.assign(mbnum, 0);
        colo_four.assign(mbnum, 0);
        for (auto& p : pic)
            for (int c = 0; c < 3; ++c) {
                const std::size_t s = c ? 8 : 16;
                p[c].assign(s * mbh * s * mbw, 0);
            }
    }

    // the pic an I- or P-VOP is built in: neither reference
    int spare() const {
        for (int i = 0; i < 3; ++i)
            if (i != ref && i != fwd) return i;
        return 0;
    }

    std::int16_t* mvat(int row, int col) {
        return mv.data() + (static_cast<std::size_t>(row) * (2 * mbw + 2) + col + 1) * 2;
    }

    void set_q(int q) { qscale = std::min(std::max(q, 1), 31); }

    // ff_mpv_reconstruct_mb's bookkeeping (ff_clean_intra_table_entries)
    void after(int x, int y, bool intra) {
        const int xy = y * cwrap + x;
        qtab[xy] = qscale;
        if (intra) {
            mbintra[xy] = 1;
            return;
        }
        if (!mbintra[xy]) return;
        const int b = wrap + 1 + 2 * y * wrap + 2 * x;
        for (int i : {b, b + 1, b + wrap, b + wrap + 1}) {
            dc[0][i] = 1024;
            std::memset(&ac[0][16 * static_cast<std::size_t>(i)], 0, 32);
        }
        const int c = cwrap + 1 + xy;
        for (int k = 1; k < 3; ++k) {
            dc[k][c] = 1024;
            std::memset(&ac[k][16 * static_cast<std::size_t>(c)], 0, 32);
        }
        mbintra[xy] = 0;
    }

    void clean_buffers(int x, int y) {   // ff_mpeg4_clean_buffers
        const std::ptrdiff_t l = wrap + 1 + (2 * y - 1) * wrap + 2 * x - 1;
        std::fill(ac[0].begin() + 16 * l, ac[0].begin() + 16 * (l + 2 * wrap + 1), 0);
        const std::ptrdiff_t c = cwrap + 1 + (y - 1) * cwrap + x - 1;
        for (int k = 1; k < 3; ++k)
            std::fill(ac[k].begin() + 16 * c, ac[k].begin() + 16 * (c + cwrap + 1), 0);
        std::memset(last_mv, 0, sizeof last_mv);
    }

    void store_mv(int x, int y, int mx, int my) {
        for (int i = 0; i < 4; ++i) {
            std::int16_t* m = mvat(2 * y + (i >> 1), 2 * x + (i & 1));
            m[0] = static_cast<std::int16_t>(mx);
            m[1] = static_cast<std::int16_t>(my);
        }
    }

    // ff_h263_pred_motion
    void pred_mv(int x, int y, int block, int& px, int& py) {
        const int row = 2 * y + (block >> 1), col = 2 * x + (block & 1);
        static const int off[4] = {2, 1, 1, -1};
        std::int16_t* A = mvat(row, col - 1);
        if (first_line && block < 3) {
            if (block == 0) {
                if (x == rx) {
                    px = py = 0;
                } else if (x + 1 == rx) {
                    const std::int16_t* C = mvat(row - 1, col + off[0]);
                    if (x == 0) {
                        px = C[0];
                        py = C[1];
                    } else {
                        px = mid3(A[0], 0, C[0]);
                        py = mid3(A[1], 0, C[1]);
                    }
                } else {
                    px = A[0];
                    py = A[1];
                }
                return;
            }
            if (block == 1) {
                if (x + 1 == rx) {
                    const std::int16_t* C = mvat(row - 1, col + off[1]);
                    px = mid3(A[0], 0, C[0]);
                    py = mid3(A[1], 0, C[1]);
                } else {
                    px = A[0];
                    py = A[1];
                }
                return;
            }
            const std::int16_t* B = mvat(row - 1, col);
            const std::int16_t* C = mvat(row - 1, col + off[2]);
            if (x == rx) A[0] = A[1] = 0;   // FFmpeg zeroes the left block's vector
            px = mid3(A[0], B[0], C[0]);
            py = mid3(A[1], B[1], C[1]);
            return;
        }
        const std::int16_t* B = mvat(row - 1, col);
        const std::int16_t* C = mvat(row - 1, col + off[block]);
        px = mid3(A[0], B[0], C[0]);
        py = mid3(A[1], B[1], C[1]);
    }

    static int motion(Bits& r, int pred, int fcode) {   // ff_h263_decode_motion
        const int code = r.vlc(tables().mv);
        if (!code) return pred;
        const int sign = r.get(1), shift = fcode - 1;
        int val = code;
        if (shift) val = (((val - 1) << shift) | static_cast<int>(r.get(shift))) + 1;
        if (sign) val = -val;
        val += pred;
        const int bits = 5 + fcode;
        val &= (1 << bits) - 1;
        return val >> (bits - 1) ? val - (1 << bits) : val;
    }

    // ff_mpeg4_pred_dc: returns level + prediction; dir 0 left, 1 top
    int pred_dc(int x, int y, int n, int level, int& dir) {
        int scale, w, idx;
        std::int32_t* d;
        if (n < 4) {
            scale = kYDcScale[qscale];
            w = wrap;
            idx = wrap + 1 + (2 * y + (n >> 1)) * wrap + 2 * x + (n & 1);
            d = dc[0].data();
        } else {
            scale = kCDcScale[qscale];
            w = cwrap;
            idx = cwrap + 1 + y * cwrap + x;
            d = dc[n - 3].data();
        }
        int a = d[idx - 1], b = d[idx - 1 - w], c = d[idx - w];
        if (first_line && n != 3) {
            if (n != 2) b = c = 1024;
            if (n != 1 && x == rx) b = a = 1024;
        }
        if (x == rx && y == ry + 1 && (n == 0 || n == 4 || n == 5)) b = 1024;
        int pred;
        if (std::abs(a - b) < std::abs(b - c)) {
            pred = c;
            dir = 1;
        } else {
            pred = a;
            dir = 0;
        }
        pred = (pred + (scale >> 1)) / scale;
        level += pred;
        int stored = level * scale;
        if (stored & ~2047) {
            if (stored < 0) stored = 0;
            else if (!dc_clip) stored = 2047;
        }
        d[idx] = stored;
        return level;
    }

    static int rdiv(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

    // ff_mpeg4_pred_ac
    void pred_ac(std::int16_t* block, int x, int y, int n, int dir, int ac_pred) {
        int w, idx;
        std::int16_t* t;
        if (n < 4) {
            w = wrap;
            idx = wrap + 1 + (2 * y + (n >> 1)) * wrap + 2 * x + (n & 1);
            t = ac[0].data();
        } else {
            w = cwrap;
            idx = cwrap + 1 + y * cwrap + x;
            t = ac[n - 3].data();
        }
        const int q = qscale;
        if (ac_pred) {
            if (dir == 0) {
                const std::int16_t* src = t + 16 * static_cast<std::size_t>(idx - 1);
                const int qn = x ? qtab[y * cwrap + x - 1] : q;
                const bool same = x == 0 || q == qn || n == 1 || n == 3;
                for (int i = 1; i < 8; ++i)
                    block[i * 8] = static_cast<std::int16_t>(block[i * 8] + (same ? src[i] : rdiv(src[i] * qn, q)));
            } else {
                const std::int16_t* src = t + 16 * static_cast<std::size_t>(idx - w);
                const int qn = y ? qtab[(y - 1) * cwrap + x] : q;
                const bool same = y == 0 || q == qn || n == 2 || n == 3;
                for (int i = 1; i < 8; ++i)
                    block[i] = static_cast<std::int16_t>(block[i] + (same ? src[8 + i] : rdiv(src[8 + i] * qn, q)));
            }
        }
        std::int16_t* own = t + 16 * static_cast<std::size_t>(idx);
        for (int i = 1; i < 8; ++i) {
            own[i] = block[i * 8];
            own[8 + i] = block[i];
        }
    }

    // the TCOEF loop of mpeg4_decode_block; returns the last index
    static int tcoef(Bits& r, std::int16_t* block, const std::uint8_t* scan, bool intra,
                     int qmul, int qadd, int i) {
        const Tables& T = tables();
        const Vlc& lut = intra ? T.intra : T.inter;
        const RunLevel& rl = intra ? T.rl_intra : T.rl_inter;
        for (;;) {
            int sym = r.vlc(lut), level, last;
            if (sym == kEscape) {
                const int mode = r.peek(2);
                if (mode == 3) {
                    r.get(2);
                    last = r.get(1);
                    const int run = r.get(6);
                    if (!r.get(1)) throw Fail{kBad};
                    level = r.sget(12);
                    if (!r.get(1)) throw Fail{kBad};
                    level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
                    if (level < -2048 || level > 2047) level = level < 0 ? -2048 : 2047;
                    i += run + 1;
                } else {
                    r.get(mode < 2 ? 1 : 2);
                    sym = r.vlc(lut);
                    if (sym == kEscape) throw Fail{kBad};
                    int lv = rl.level[sym];
                    const int run = rl.run[sym];
                    last = rl.last[sym];
                    if (mode < 2) {
                        lv += rl.max_level[last][run];
                        i += run + 1;
                    } else {
                        i += run + rl.max_run[last][lv] + 2;
                    }
                    level = lv * qmul + qadd;
                    if (r.get(1)) level = -level;
                }
            } else {
                level = rl.level[sym] * qmul + qadd;
                last = rl.last[sym];
                i += rl.run[sym] + 1;
                if (r.get(1)) level = -level;
            }
            if (i > 63 || (i == 63 && !last)) throw Fail{kBad};
            block[scan[i]] = static_cast<std::int16_t>(level);
            if (last) return i;
        }
    }

    void intra_block(Bits& r, std::int16_t* block, int x, int y, int n, bool coded,
                     bool dc_vlc, int ac_pred) {
        int dir, i;
        if (dc_vlc) {
            const int size = r.vlc(n < 4 ? tables().dc_lum : tables().dc_chrom);
            int level = 0;
            if (size) {
                level = r.get(size);
                if (!(level >> (size - 1))) level -= (1 << size) - 1;
                if (size > 8) r.get(1);
            }
            block[0] = static_cast<std::int16_t>(pred_dc(x, y, n, level, dir));
            i = 0;
        } else {
            i = -1;
            pred_dc(x, y, n, 0, dir);
        }
        if (coded) {
            const std::uint8_t* scan = ac_pred ? (dir == 0 ? kAltV : kAltH) : kZigzag;
            tcoef(r, block, scan, true, 1, 0, i);
        }
        if (!dc_vlc) block[0] = static_cast<std::int16_t>(pred_dc(x, y, n, block[0], dir));
        pred_ac(block, x, y, n, dir, ac_pred);
    }

    // mpeg4_decode_mb for an I- or P-VOP
    void decode_mb(Bits& r, const Vop& vop, int x, int y, Mb& mb, std::int16_t* blocks) {
        const Tables& T = tables();
        int cbpc;
        bool intra, dquant;
        std::memset(blocks, 0, 6 * 64 * sizeof(std::int16_t));
        mb = Mb{};
        if (vop.type) {
            for (;;) {
                if (r.get(1)) {   // not coded
                    store_mv(x, y, 0, 0);
                    after(x, y, false);
                    mb.kind = kSkip;
                    mb.q = static_cast<std::uint8_t>(qscale);
                    return;
                }
                cbpc = r.vlc(T.inter_mcbpc);
                if (cbpc != 20) break;
            }
            dquant = cbpc & 8;
            intra = cbpc & 4;
        } else {
            do cbpc = r.vlc(T.intra_mcbpc);
            while (cbpc == 8);
            dquant = cbpc & 4;
            intra = true;
        }
        if (intra) {
            const int ac_pred = r.get(1);
            int cbp = (cbpc & 3) | r.vlc(T.cbpy) << 2;
            const bool dc_vlc = qscale < vop.dc_thr;
            if (dquant) set_q(qscale + kDquant[r.get(2)]);
            for (int n = 0; n < 6; ++n, cbp += cbp)
                intra_block(r, blocks + 64 * n, x, y, n, cbp & 32, dc_vlc, ac_pred);
            store_mv(x, y, 0, 0);
            after(x, y, true);
            mb.kind = kIntra;
            mb.cbp = 63;
            mb.q = static_cast<std::uint8_t>(qscale);
            return;
        }
        int cbp = (cbpc & 3) | (r.vlc(T.cbpy) ^ 15) << 2;
        if (dquant) set_q(qscale + kDquant[r.get(2)]);
        mb.cbp = static_cast<std::uint8_t>(cbp & 63);
        int px, py;
        if (cbpc & 16) {
            mb.kind = kInter4;
            for (int i = 0; i < 4; ++i) {
                pred_mv(x, y, i, px, py);
                const int mx = motion(r, px, vop.fcode), my = motion(r, py, vop.fcode);
                std::int16_t* m = mvat(2 * y + (i >> 1), 2 * x + (i & 1));
                m[0] = mb.mv[i][0] = static_cast<std::int16_t>(mx);
                m[1] = mb.mv[i][1] = static_cast<std::int16_t>(my);
            }
        } else {
            mb.kind = kInter;
            pred_mv(x, y, 0, px, py);
            const int mx = motion(r, px, vop.fcode), my = motion(r, py, vop.fcode);
            store_mv(x, y, mx, my);
            mb.mv[0][0] = static_cast<std::int16_t>(mx);
            mb.mv[0][1] = static_cast<std::int16_t>(my);
        }
        const int q = qscale;
        for (int n = 0; n < 6; ++n, cbp += cbp)
            if (cbp & 32) inter_block(r, blocks + 64 * n, vop);
        mb.q = static_cast<std::uint8_t>(q);
        after(x, y, false);
    }

    // an inter block's levels: dequantised (H.263) or raw (quant_type 1)
    void inter_block(Bits& r, std::int16_t* block, const Vop& vop) {
        const int q = qscale;
        if (vop.mpeg) tcoef(r, block, kZigzag, false, 1, 0, -1);
        else tcoef(r, block, kZigzag, false, 2 * q, (q - 1) | 1, -1);
    }

    // ff_mpeg4_set_direct_mv: block i's forward and backward vectors (C's
    // division, truncating, as FFmpeg's)
    void direct(const Vop& vop, int k, int i, int mx, int my, Mb& mb) {
        const std::int16_t* p = colo_mv.data() + 8 * static_cast<std::size_t>(k) + 2 * i;
        const int d[2] = {mx, my};
        for (int c = 0; c < 2; ++c) {
            const int f = p[c] * vop.pb / vop.pp + d[c];
            mb.mv[i][c] = static_cast<std::int16_t>(f);
            mb.bmv[i][c] = static_cast<std::int16_t>(d[c] ? f - p[c] : p[c] * (vop.pb - vop.pp) / vop.pp);
        }
    }

    // mpeg4_decode_mb for a B-VOP (mpeg4_plain.Decoder._mb_b)
    void decode_mb_b(Bits& r, const Vop& vop, int x, int y, Mb& mb, std::int16_t* blocks) {
        std::memset(blocks, 0, 6 * 64 * sizeof(std::int16_t));
        if (x == 0) std::memset(last_mv, 0, sizeof last_mv);
        const int k = y * mbw + x;
        mb = Mb{};
        mb.q = static_cast<std::uint8_t>(qscale);
        if (colo_skip[k]) {
            mb.kind = kSkip;
            after(x, y, false);
            return;
        }
        mb.kind = kB;
        int cbp = 0, type = 0;   // 0 direct, 1 both, 2 backward, 3 forward
        bool delta = false;
        if (!r.get(1)) {
            const int modb2 = r.get(1);
            const std::uint32_t code = r.peek(4);
            if (!code) throw Fail{kBad};
            type = 3 - (31 - __builtin_clz(code));
            r.get(type + 1);
            delta = type == 0;
            if (!modb2) cbp = r.get(6);
            if (type && cbp && r.get(1)) set_q(qscale + 4 * static_cast<int>(r.get(1)) - 2);
        }
        if (type == 1 || type == 3) {
            const int mx = motion(r, last_mv[0][0], vop.fcode), my = motion(r, last_mv[0][1], vop.fcode);
            last_mv[0][0] = mb.mv[0][0] = static_cast<std::int16_t>(mx);
            last_mv[0][1] = mb.mv[0][1] = static_cast<std::int16_t>(my);
            mb.fwd = true;
        }
        if (type == 1 || type == 2) {
            const int mx = motion(r, last_mv[1][0], vop.bcode), my = motion(r, last_mv[1][1], vop.bcode);
            last_mv[1][0] = mb.bmv[0][0] = static_cast<std::int16_t>(mx);
            last_mv[1][1] = mb.bmv[0][1] = static_cast<std::int16_t>(my);
            mb.bwd = true;
        }
        if (type == 0) {
            const int mx = delta ? motion(r, 0, 1) : 0, my = delta ? motion(r, 0, 1) : 0;
            mb.four = colo_four[k] != 0;
            for (int i = 0; i < (mb.four ? 4 : 1); ++i) direct(vop, k, i, mx, my, mb);
            mb.fwd = mb.bwd = true;
        }
        mb.cbp = static_cast<std::uint8_t>(cbp);
        for (int n = 0; n < 6; ++n, cbp += cbp)
            if (cbp & 32) inter_block(r, blocks + 64 * n, vop);
        mb.q = static_cast<std::uint8_t>(qscale);
        after(x, y, false);
    }

    // mpeg4_is_resync at a macroblock's end: the number of the macroblock
    // a video packet starts with, or 0
    // ff_mpeg4_get_video_packet_prefix_length
    static int prefix_length(const Vop& vop) {
        return vop.type == 0 ? 16 : vop.type == 1 ? vop.fcode + 15 : std::max({vop.fcode, vop.bcode, 2}) + 15;
    }

    int resync_next(Bits& r, const Vop& vop) {
        const int ptype = vop.type == 0 ? 1 : 2;
        std::uint32_t v = r.peek(16);
        while (vop.type != 2 && v <= 0xFF && v >> (8 - ptype) == 1) {
            r.pos += 8 + ptype;
            v = r.peek(16);
        }
        if (r.pos + 8 >= r.bits()) return 0;
        static const std::uint32_t prefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800,
                                                0x7000, 0x6000, 0x4000, 0x0000};
        if (v != prefix[r.pos & 7]) return 0;
        const std::size_t save = r.pos;
        r.get(1);
        r.pos = (r.pos + 7) & ~std::size_t{7};
        int n = 0;
        while (n < 32 && !r.get(1)) ++n;
        const int mbnum = mbw * mbh, nbits = 32 - __builtin_clz(static_cast<unsigned>((mbnum - 1) | 1));
        const int mb = static_cast<int>(r.get(mbnum > 1 ? nbits : 0));
        r.pos = save;
        return n >= prefix_length(vop) && mb > 0 && mb < mbnum ? mb : 0;
    }

    // the video packet header: its first macroblock
    int packet_header(Bits& r, const Vop& vop) {
        int n = 0;
        while (n < 32 && !r.get(1)) ++n;
        if (n != prefix_length(vop)) throw Fail{kPacket};
        const int mbnum = mbw * mbh, nbits = 32 - __builtin_clz(static_cast<unsigned>((mbnum - 1) | 1));
        const int mb = static_cast<int>(r.get(mbnum > 1 ? nbits : 0));
        if (mb <= 0 || mb >= mbnum) throw Fail{kPacket};
        const int q = r.get(5);
        if (q) qscale = q;
        if (r.get(1)) {   // header_extension_code
            while (r.get(1)) {
            }
            r.get(1);
            r.get(tib);
            r.get(1);
            r.get(2);
            r.get(3);
            if (vop.type) r.get(3);
            if (vop.type == 2) r.get(3);
        }
        return mb;
    }

    // Parse one VOP's macroblocks; `where` gets the failing macroblock.
    int parse(const std::uint8_t* data, std::size_t size, std::size_t bit, const Vop& vop,
              Frame& f, int& where) {
        Bits r{data, size, bit};
        const int mbnum = mbw * mbh;
        f.mbs.resize(mbnum);
        f.blocks.resize(static_cast<std::size_t>(mbnum) * 384);
        f.vop = vop;
        qscale = vop.quant;
        dc_clip = vop.dc_clip;
        mv.assign(static_cast<std::size_t>(2 * mbh) * (2 * mbw + 2) * 2, 0);
        qtab.assign(static_cast<std::size_t>(mbh) * cwrap, 0);
        std::memset(last_mv, 0, sizeof last_mv);
        const bool b = vop.type == 2;
        int k = 0;
        try {
            for (;;) {
                rx = k % mbw;
                ry = k / mbw;
                first_line = true;
                for (; k < mbnum; ++k) {
                    const int x = k % mbw, y = k / mbw;
                    where = k;
                    if (x == rx && y == ry + 1) first_line = false;
                    std::int16_t* blocks = f.blocks.data() + 384 * static_cast<std::size_t>(k);
                    if (b) decode_mb_b(r, vop, x, y, f.mbs[k], blocks);
                    else decode_mb(r, vop, x, y, f.mbs[k], blocks);
                    if (r.pos > r.bits()) throw Fail{kEnd};
                    if (resync && k + 1 < mbnum) {
                        int next = resync_next(r, vop);
                        if (b && next > k + 1 && colo_skip[k + 1]) next = 0;   // on through a skip
                        if (next) {
                            if (next != k + 1) throw Fail{kPacket};
                            ++k;
                            break;
                        }
                    }
                }
                if (k >= mbnum) {
                    if (!b) keep_vectors(f);
                    return kOk;
                }
                where = k;
                r.get(1);
                r.pos = (r.pos + 7) & ~std::size_t{7};
                if (packet_header(r, vop) != k) throw Fail{kPacket};
                clean_buffers(k % mbw, k / mbw);
            }
        } catch (const Fail& e) {
            return e.rc;
        }
    }

    // -- reconstruction ---------------------------------------------------

    // A (bh, bw) half-pel prediction at (sx, sy) of plane p (stride s):
    // through FFmpeg's edge emulation (the border of ew x eh replicated)
    // where emu, else straight; averaged as FFmpeg's x86 put_pixels (rnd
    // 0) or put_no_rnd_pixels (rnd 1): the 16-wide ones exact, the 8-wide
    // horizontal and vertical ones averaging max(a - 1, 0) with b (a the
    // left pixel, or the one in an odd row).
    static void hpel(const std::uint8_t* p, int s, int sx, int sy, int bw, int bh, int dxy,
                     int rnd, bool emu, int ew, int eh, std::uint8_t* out, int os) {
        if (dxy == 0 && !emu) {   // a full-pel block inside the picture: rows copied
            const std::uint8_t* row = p + static_cast<std::ptrdiff_t>(sy) * s + sx;
            for (int j = 0; j < bh; ++j) std::memcpy(out + j * os, row + j * s, bw);
            return;
        }
        std::uint8_t src[17 * 17];
        const int sw = bw + (dxy & 1), sh = bh + (dxy >> 1);
        for (int j = 0; j < sh; ++j) {
            const int yy = emu ? std::min(std::max(sy + j, 0), eh - 1) : sy + j;
            const std::uint8_t* row = p + static_cast<std::ptrdiff_t>(yy) * s;
            for (int i = 0; i < sw; ++i) {
                const int xx = emu ? std::min(std::max(sx + i, 0), ew - 1) : sx + i;
                src[j * 17 + i] = row[xx];
            }
        }
        const bool approx = rnd && bw == 8;
        for (int j = 0; j < bh; ++j)
            for (int i = 0; i < bw; ++i) {
                const int a = src[j * 17 + i];
                int v;
                switch (dxy) {
                case 0: v = a; break;
                case 1: {
                    const int b = src[j * 17 + i + 1];
                    v = approx ? (std::max(a - 1, 0) + b + 1) >> 1 : (a + b + 1 - rnd) >> 1;
                    break;
                }
                case 2: {
                    int t = a, b = src[(j + 1) * 17 + i];
                    if (approx) {
                        if (j & 1) t = std::max(t - 1, 0);
                        else b = std::max(b - 1, 0);
                        v = (t + b + 1) >> 1;
                    } else {
                        v = (t + b + 1 - rnd) >> 1;
                    }
                    break;
                }
                default:
                    v = (a + src[j * 17 + i + 1] + src[(j + 1) * 17 + i] + src[(j + 1) * 17 + i + 1] + 2 - rnd) >> 2;
                }
                out[j * os + i] = static_cast<std::uint8_t>(v);
            }
    }

    // An I- or P-VOP's vectors as FFmpeg's motion_val holds them at its end
    // (zero for intra macroblocks, and for a block 3 whose right neighbour
    // zeroed it in pred_mv), skipped and 4MV macroblocks, which the B-VOPs
    // after it read.
    void keep_vectors(const Frame& f) {
        for (std::size_t k = 0; k < f.mbs.size(); ++k) {
            const int x = static_cast<int>(k % mbw), y = static_cast<int>(k / mbw);
            std::int16_t* o = colo_mv.data() + 8 * k;
            for (int i = 0; i < 4; ++i) {
                const std::int16_t* m = mvat(2 * y + (i >> 1), 2 * x + (i & 1));
                o[2 * i] = m[0];
                o[2 * i + 1] = m[1];
            }
            colo_skip[k] = f.mbs[k].kind == kSkip;
            colo_four[k] = f.mbs[k].kind == kInter4;
        }
    }

    // The six 8 x 8 predictions of macroblock (x, y) from reference planes
    // rp into out (luma rows ols apart, chroma ocs): four vectors (4MV) or
    // one.
    void predict(const std::vector<std::uint8_t>* rp, bool four, const std::int16_t (*mvs)[2], int x,
                 int y, const Vop& vop, int rnd, std::uint8_t* const* out, int ols, int ocs) const {
        const int he = vop.edge ? W : 16 * mbw, ve = vop.edge ? H : 16 * mbh;
        const int ls = 16 * mbw, cs = 8 * mbw;
        std::uint8_t *dy = out[0], *du = out[1], *dv = out[2];
        if (four) {
            int sx = 0, sy = 0;
            for (int i = 0; i < 4; ++i) {
                const int mx = mvs[i][0], my = mvs[i][1];
                int src_x = x * 16 + (i & 1) * 8 + (mx >> 1), src_y = y * 16 + (i >> 1) * 8 + (my >> 1);
                int dxy = 0;
                src_x = std::min(std::max(src_x, -16), W);
                if (src_x != W) dxy |= mx & 1;
                src_y = std::min(std::max(src_y, -16), H);
                if (src_y != H) dxy |= (my & 1) << 1;
                const bool emu = u32(src_x) >= u32(std::max(he - (mx & 1) - 7, 0)) ||
                                 u32(src_y) >= u32(std::max(ve - (my & 1) - 7, 0));
                hpel(rp[0].data(), ls, src_x, src_y, 8, 8, dxy, rnd, emu, he, ve,
                     dy + (i >> 1) * 8 * ols + (i & 1) * 8, ols);
                sx += mx;
                sy += my;
            }
            const int mx = kChromaRound[sx & 15] + ((sx >> 3) & ~1);
            const int my = kChromaRound[sy & 15] + ((sy >> 3) & ~1);
            int dxy = ((my & 1) << 1) | (mx & 1);
            int src_x = std::min(std::max(x * 8 + (mx >> 1), -8), W >> 1);
            if (src_x == W >> 1) dxy &= ~1;
            int src_y = std::min(std::max(y * 8 + (my >> 1), -8), H >> 1);
            if (src_y == H >> 1) dxy &= ~2;
            const bool emu = u32(src_x) >= u32(std::max((he >> 1) - (dxy & 1) - 7, 0)) ||
                             u32(src_y) >= u32(std::max((ve >> 1) - (dxy >> 1) - 7, 0));
            hpel(rp[1].data(), cs, src_x, src_y, 8, 8, dxy, rnd, emu, he >> 1, ve >> 1, du, ocs);
            hpel(rp[2].data(), cs, src_x, src_y, 8, 8, dxy, rnd, emu, he >> 1, ve >> 1, dv, ocs);
            return;
        }
        const int mx = mvs[0][0], my = mvs[0][1];
        const int dxy = ((my & 1) << 1) | (mx & 1);
        const int src_x = x * 16 + (mx >> 1), src_y = y * 16 + (my >> 1);
        const int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
        const bool emu = u32(src_x) >= u32(std::max(he - (mx & 1) - 15, 0)) ||
                         u32(src_y) >= u32(std::max(ve - (my & 1) - 15, 0));
        hpel(rp[0].data(), ls, src_x, src_y, 16, 16, dxy, rnd, emu, he, ve, dy, ols);
        hpel(rp[1].data(), cs, src_x >> 1, src_y >> 1, 8, 8, uvdxy, rnd, emu, he >> 1, ve >> 1, du, ocs);
        hpel(rp[2].data(), cs, src_x >> 1, src_y >> 1, 8, 8, uvdxy, rnd, emu, he >> 1, ve >> 1, dv, ocs);
    }

    // One macroblock row of frame f into pic[target]: intra macroblocks
    // put, the others predicted from the references (a B-VOP's backward
    // prediction averaged into its forward one, rounding up) plus their
    // residual.
    void reconstruct_row(const Frame& f, int y, int target) {
        const Vop& vop = f.vop;
        std::vector<std::uint8_t>* cur = pic[target];
        const int ls = 16 * mbw, cs = 8 * mbw;
        std::int16_t deq[64];
        std::int32_t sums[64];
        auto idct = vop.xvid ? xvid_idct_sums : idct_sums;
        static const std::int16_t zero[4][2] = {};
        for (int x = 0; x < mbw; ++x) {
            const std::size_t k = static_cast<std::size_t>(y) * mbw + x;
            const Mb& m = f.mbs[k];
            const std::int16_t* blocks = f.blocks.data() + 384 * k;
            std::uint8_t* dst[3] = {cur[0].data() + static_cast<std::size_t>(16 * y) * ls + 16 * x,
                                    cur[1].data() + static_cast<std::size_t>(8 * y) * cs + 8 * x,
                                    cur[2].data() + static_cast<std::size_t>(8 * y) * cs + 8 * x};
            auto block_at = [&](int n, int& stride) -> std::uint8_t* {
                stride = n < 4 ? ls : cs;
                return n < 4 ? dst[0] + (8 * (n >> 1)) * ls + 8 * (n & 1) : dst[n - 3];
            };
            int stride;
            if (m.kind == kIntra) {
                const int q = m.q, qmul = 2 * q, qadd = (q - 1) | 1;
                for (int n = 0; n < 6; ++n) {
                    const std::int16_t* b = blocks + 64 * n;
                    const int scale = n < 4 ? kYDcScale[q] : kCDcScale[q];
                    if (vop.mpeg) {
                        dequant_mpeg_intra(b, q, scale, vop.intra_m, deq);
                    } else {
                        deq[0] = static_cast<std::int16_t>(b[0] * scale);
                        for (int i = 1; i < 64; ++i)
                            deq[i] = b[i] ? static_cast<std::int16_t>(b[i] > 0 ? b[i] * qmul + qadd : b[i] * qmul - qadd) : 0;
                    }
                    idct(deq, sums);
                    std::uint8_t* d = block_at(n, stride);
                    for (int r = 0; r < 8; ++r)
                        for (int c = 0; c < 8; ++c) d[r * stride + c] = clip255(sums[8 * r + c]);
                }
                continue;
            }
            if (vop.type != 2) {
                predict(pic[ref], m.kind == kInter4, m.kind == kSkip ? zero : m.mv, x, y, vop, vop.rounding, dst,
                        ls, cs);
            } else if (m.kind == kSkip) {
                predict(pic[fwd], false, zero, x, y, vop, 0, dst, ls, cs);
            } else {
                if (m.fwd) predict(pic[fwd], m.four, m.mv, x, y, vop, 0, dst, ls, cs);
                if (m.bwd) {
                    if (!m.fwd) {
                        predict(pic[ref], m.four, m.bmv, x, y, vop, 0, dst, ls, cs);
                    } else {   // avg_pixels: into the forward prediction
                        std::uint8_t tmp[384];
                        std::uint8_t* t[3] = {tmp, tmp + 256, tmp + 320};
                        predict(pic[ref], m.four, m.bmv, x, y, vop, 0, t, 16, 8);
                        for (int j = 0; j < 16; ++j)
                            for (int i = 0; i < 16; ++i) {
                                std::uint8_t& o = dst[0][j * ls + i];
                                o = static_cast<std::uint8_t>((o + tmp[16 * j + i] + 1) >> 1);
                            }
                        for (int c = 1; c < 3; ++c)
                            for (int j = 0; j < 8; ++j)
                                for (int i = 0; i < 8; ++i) {
                                    std::uint8_t& o = dst[c][j * cs + i];
                                    o = static_cast<std::uint8_t>((o + t[c][8 * j + i] + 1) >> 1);
                                }
                    }
                }
            }
            for (int n = 0; n < 6; ++n) {
                if (!(m.cbp & (32 >> n))) continue;
                const std::int16_t* b = blocks + 64 * n;
                if (vop.mpeg) {
                    dequant_mpeg_inter(b, m.q, vop.inter_m, deq);
                    b = deq;
                }
                idct(b, sums);
                std::uint8_t* d = block_at(n, stride);
                for (int r = 0; r < 8; ++r)
                    for (int c = 0; c < 8; ++c) d[r * stride + c] = clip255(d[r * stride + c] + sums[8 * r + c]);
            }
        }
    }

    // The visible picture of pic[target] as an i420 frame.
    void output(int target, std::uint8_t* dst) const {
        const std::vector<std::uint8_t>* cur = pic[target];
        const int w2 = (W + 1) / 2, h2 = (H + 1) / 2;
        for (int y = 0; y < H; ++y)
            std::memcpy(dst + static_cast<std::size_t>(y) * W, cur[0].data() + static_cast<std::size_t>(y) * 16 * mbw, W);
        for (int c = 1; c < 3; ++c) {
            std::uint8_t* o = dst + static_cast<std::size_t>(H) * W + static_cast<std::size_t>(c - 1) * h2 * w2;
            for (int y = 0; y < h2; ++y)
                std::memcpy(o + static_cast<std::size_t>(y) * w2, cur[c].data() + static_cast<std::size_t>(y) * 8 * mbw, w2);
        }
    }
};

// One frame of a batch: where its macroblock data are and its VOP.
struct Job {
    const std::uint8_t* data;
    std::size_t size, bit;
    Vop vop;
};

// Decode jobs [a, b) of one run in order on `threads` threads: each frame
// parsed while the one before it is reconstructed, a macroblock row an
// item.  An I- or P-VOP is built in the pic neither reference holds and
// becomes the latest reference; a B-VOP in its own pic.
void decode_run(Decoder& d, const Job* jobs, std::size_t a, std::size_t b, int threads,
                std::uint8_t* planes, std::size_t plane_bytes, int* rcs, int* wheres) {
    Frame frames[2];
    int where = -1;
    std::size_t i = a;
    if (i >= b) return;
    auto refs_ok = [&](const Vop& v) { return v.type == 0 || (v.type == 1 ? d.ref >= 0 : d.fwd >= 0); };
    int rc = refs_ok(jobs[i].vop) ? d.parse(jobs[i].data, jobs[i].size, jobs[i].bit, jobs[i].vop, frames[0], where)
                                  : kNoRef;
    for (; i < b; ++i) {
        if (rc != kOk) {   // the stream's state is lost: every later frame fails too
            for (std::size_t j = i; j < b; ++j) {
                rcs[j] = j == i ? rc : kNoRef;
                wheres[j] = j == i ? where : -1;
            }
            d.ref = d.fwd = -1;
            return;
        }
        Frame& f = frames[(i - a) & 1];
        Frame& next = frames[(i - a + 1) & 1];
        int next_rc = kOk, next_where = -1;
        const bool more = i + 1 < b;
        const bool anchor = f.vop.type != 2;
        const int target = anchor ? d.spare() : 3;
        // the references as of the next frame (its parse only checks them)
        const int after_ref = anchor ? target : d.ref, after_fwd = anchor ? d.ref : d.fwd;
        const bool next_ok = more && (jobs[i + 1].vop.type == 0 ||
                                      (jobs[i + 1].vop.type == 1 ? after_ref >= 0 : after_fwd >= 0));
        parallel_items(static_cast<std::size_t>(d.mbh) + (more ? 1 : 0), threads, [&](std::size_t k) {
            if (more && k == 0) {
                if (next_ok)
                    next_rc = d.parse(jobs[i + 1].data, jobs[i + 1].size, jobs[i + 1].bit, jobs[i + 1].vop, next,
                                      next_where);
                else
                    next_rc = kNoRef;
                return;
            }
            d.reconstruct_row(f, static_cast<int>(k - (more ? 1 : 0)), target);
        });
        d.output(target, planes + i * plane_bytes);
        if (anchor) {
            d.fwd = d.ref;
            d.ref = target;
        }
        rcs[i] = kOk;
        wheres[i] = -1;
        rc = next_rc;
        where = next_where;
    }
}

}  // namespace

extern "C" {

// A decoder of one height x width stream (resync_marker: the VOL's resync
// markers; time_bits: its vop_time_increment width).
void* clt_mpeg4_new(int height, int width, int resync_marker, int time_bits) {
    if (height < 1 || width < 1 || height > 8192 || width > 8192) return nullptr;
    return new Decoder(height, width, resync_marker, time_bits);
}

void clt_mpeg4_free(void* h) { delete static_cast<Decoder*>(h); }

// Decode k coded VOPs of the decoder's stream, in coded order: frame i's
// macroblock data start at bit bits[i] of srcs[i] (sizes[i] bytes); its
// VOP is params[12 i .. 12 i + 12) = type (0 I, 1 P, 2 B), quant, fcode,
// bcode, rounding, intra DC threshold, FF_BUG_EDGE, FF_BUG_DC_CLIP, the
// Xvid IDCT, direct mode's pb and pp times, quant_type 1; its matrices
// (quant_type 1: intra, then inter, natural order) matrices[128 i ..).
// Frame i's decoded picture goes to planes + i * plane_bytes as an i420
// frame.  A run of frames from an I-VOP with no B-VOP after it depends on
// nothing before it: runs decode side by side where a batch holds several
// (each on its own decoder state, the first on this one's), a run's frames
// one after another, a macroblock row a thread.  rcs[i] gets 0 or a
// negative code (-1 bits FFmpeg fails to decode, -2 data that end inside a
// macroblock, -3 a video packet header FFmpeg refuses, -4 a frame without
// its references: after a failure every later frame of the run),
// wheres[i] the macroblock it failed at or -1.
void clt_mpeg4_decode_batch(void* h, const unsigned char* const* srcs, const std::size_t* sizes,
                            const std::size_t* bits, const int* params, const int* matrices, std::size_t k,
                            unsigned char* planes, std::size_t plane_bytes, int nthreads, int* rcs,
                            int* wheres) {
    Decoder& d = *static_cast<Decoder*>(h);
    std::vector<Job> jobs(k);
    for (std::size_t i = 0; i < k; ++i) {
        const int* p = params + 12 * i;
        Job& j = jobs[i];
        j.data = srcs[i];
        j.size = sizes[i];
        j.bit = bits[i];
        j.vop = Vop{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11], {}, {}};
        std::memcpy(j.vop.intra_m, matrices + 128 * i, sizeof j.vop.intra_m);
        std::memcpy(j.vop.inter_m, matrices + 128 * i + 64, sizeof j.vop.inter_m);
    }
    std::vector<std::size_t> starts{0};
    for (std::size_t i = 1; i < k; ++i)
        if (jobs[i].vop.type == 0 && (i + 1 == k || jobs[i + 1].vop.type != 2)) starts.push_back(i);
    starts.push_back(k);
    const std::size_t runs = starts.size() - 1;
    if (runs <= 1 || nthreads <= 1) {
        decode_run(d, jobs.data(), 0, k, nthreads, planes, plane_bytes, rcs, wheres);
        return;
    }
    // the first run goes on from d's state; the others start afresh, and
    // the stream goes on from the last one's
    std::vector<std::unique_ptr<Decoder>> own(runs);
    for (std::size_t r = 1; r < runs; ++r) own[r].reset(new Decoder(d.H, d.W, d.resync, d.tib));
    const int per = std::max(1, nthreads / static_cast<int>(runs));
    parallel_items(runs, nthreads, [&](std::size_t r) {
        decode_run(r == 0 ? d : *own[r], jobs.data(), starts[r], starts[r + 1], per, planes,
                   plane_bytes, rcs, wheres);
    });
    std::swap(d, *own[runs - 1]);
}

int clt_mpeg4_version() { return 2; }

}  // extern "C"
