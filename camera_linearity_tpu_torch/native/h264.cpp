// H.264 decoder of the Constrained Baseline tools (CAVLC, I and P slices,
// progressive frames, 8-bit 4:2:0): the slice data of a picture into its
// planes, then the deblocking filter.  Python (h264_plain.Stream) reads
// the NAL units, the parameter sets and the slice headers, keeps the
// decoded picture buffer and builds each slice's reference list; this
// file decodes the macroblocks of the slices it is handed, into frame
// slots that a decoder object keeps from call to call.  The decoding
// process is exact by the standard (an integer transform, defined
// interpolation and deblocking), so every conforming decoder, FFmpeg's
// among them, gives the same planes.  h264_plain.py is the plain version
// of the same steps.
//
// Built with -fwrapv, as mpeg4.cpp is.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#include "parallel.h"

namespace {

using u8 = std::uint8_t;

// ---------------------------------------------------------------- tables

constexpr u8 kAlpha[52] = {0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,
                           0,   0,   0,   4,   4,   5,   6,   7,   8,   9,   10,  12,  13,
                           15,  17,  20,  22,  25,  28,  32,  36,  40,  45,  50,  56,  63,
                           71,  80,  90,  101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
constexpr u8 kBeta[52] = {0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,  0,  2,  2,
                          2, 3, 3, 3, 3, 4, 4, 4,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
                          11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
constexpr u8 kTc0[52][3] = {
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},    {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},    {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},    {0, 0, 1},
    {0, 0, 1},   {0, 0, 1},   {0, 0, 1},   {0, 1, 1},   {0, 1, 1},    {1, 1, 1},
    {1, 1, 1},   {1, 1, 1},   {1, 1, 1},   {1, 1, 2},   {1, 1, 2},    {1, 1, 2},
    {1, 1, 2},   {1, 2, 3},   {1, 2, 3},   {2, 2, 3},   {2, 2, 4},    {2, 3, 4},
    {2, 3, 4},   {3, 3, 5},   {3, 4, 6},   {3, 4, 6},   {4, 5, 7},    {4, 5, 8},
    {4, 6, 9},   {5, 7, 10},  {6, 8, 11},  {6, 8, 13},  {7, 10, 14},  {8, 11, 16},
    {9, 12, 18}, {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};
constexpr u8 kChromaQp[52] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12,
                              13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
                              26, 27, 28, 29, 29, 30, 31, 32, 32, 33, 34, 34, 35,
                              35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};
// scan position -> raster position in a 4x4 block
constexpr u8 kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// normAdjust4x4: [qP % 6][class] (0: both coordinates even, 1: both odd,
// 2: the others)
constexpr int kNorm[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                             {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
constexpr u8 kNormClass[16] = {0, 2, 0, 2, 2, 1, 2, 1, 0, 2, 0, 2, 2, 1, 2, 1};

// coded_block_pattern of me(v): codeNum -> Intra_4x4 / Inter cbp
constexpr u8 kCbpIntra[48] = {47, 31, 15, 0,  23, 27, 29, 30, 7,  11, 13, 14, 39, 43, 45, 46,
                              16, 3,  5,  10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1,  2,  4,
                              8,  17, 18, 20, 24, 6,  9,  22, 25, 32, 33, 34, 36, 40, 38, 41};
constexpr u8 kCbpInter[48] = {0,  16, 1,  2,  4,  8,  32, 3,  5,  10, 12, 15, 47, 7,  11, 13,
                              14, 6,  9,  31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
                              17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41};

// coeff_token: [nC class][TotalCoeff * 4 + TrailingOnes] (length, code);
// classes 0 <= nC < 2, 2 <= nC < 4, 4 <= nC < 8, 8 <= nC
constexpr u8 kTokenLen[4][68] = {
    {1,  0,  0,  0,  6,  2,  0,  0,  8,  6,  3,  0,  9,  8,  7,  5,  10, 9,  8,  6,  11, 10, 9,
     7,  13, 11, 10, 8,  13, 13, 11, 9,  13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15,
     14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16},
    {2,  0,  0,  0,  6,  2,  0,  0,  6,  5,  3,  0,  7,  6,  6,  4,  8,  6,  6,  4,  8,  7,  7,
     5,  9,  8,  8,  6,  11, 9,  9,  6,  11, 11, 11, 7,  12, 11, 11, 9,  12, 12, 12, 11, 12, 12,
     12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14},
    {4,  0,  0,  0,  6,  4,  0,  0,  6,  5,  4,  0,  6,  5,  5,  4,  7,  5,  5,  4,  7,  5,  5,
     4,  7,  6,  6,  4,  7,  6,  6,  4,  8,  7,  7,  5,  8,  8,  7,  6,  9,  8,  8,  7,  9,  9,
     8,  8,  9,  9,  9,  8,  10, 9,  9,  9,  10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10},
    {6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6}};
constexpr u8 kTokenCode[4][68] = {
    {1,  0,  0, 0, 5,  1,  0,  0,  7,  4,  1,  0,  7,  6,  5,  3,  7,  6,  5,  3,  7,  6,  5,
     4,  15, 6, 5, 4,  11, 14, 5,  4,  8,  10, 13, 4,  15, 14, 9,  4,  11, 10, 13, 12, 15, 14,
     9,  12, 11, 10, 13, 8,  15, 1,  9,  12, 11, 14, 13, 8,  7,  10, 9,  12, 4,  6,  5,  8},
    {3,  0,  0,  0,  11, 2,  0,  0,  7,  7,  3,  0,  7,  10, 9,  5,  7,  6,  5,  4,  4,  6,  5,
     6,  7,  6,  5,  8,  15, 6,  5,  4,  11, 14, 13, 4,  15, 10, 9,  4,  11, 14, 13, 12, 8,  10,
     9,  8,  15, 14, 13, 12, 11, 10, 9,  12, 7,  11, 6,  8,  9,  8,  10, 1,  7,  6,  5,  4},
    {15, 0,  0,  0,  15, 14, 0,  0,  11, 15, 13, 0,  8,  12, 14, 12, 15, 10, 11, 11, 11, 8,  9,
     10, 9,  14, 13, 9,  8,  10, 9,  8,  15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14,
     9,  12, 8,  10, 13, 8,  13, 7,  9,  12, 9,  12, 11, 10, 5,  8,  7,  6,  1,  4,  3,  2},
    {3,  0,  0,  0,  0,  1,  0,  0,  4,  5,  6,  0,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18,
     19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
     42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63}};
// chroma DC (4:2:0, nC == -1): [TotalCoeff * 4 + TrailingOnes]
constexpr u8 kDcTokenLen[20] = {2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7};
constexpr u8 kDcTokenCode[20] = {1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0};
// total_zeros of 4x4 blocks: [TotalCoeff - 1][total_zeros]
constexpr u8 kZerosLen[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9}, {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6},       {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5},             {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6},                   {6, 4, 5, 3, 2, 2, 3, 3, 6},
    {6, 6, 4, 2, 2, 3, 2, 5},                         {5, 5, 3, 2, 2, 2, 4},
    {4, 4, 3, 3, 1, 3},                               {4, 4, 2, 1, 3},
    {3, 3, 1, 2},                                     {2, 2, 1},
    {1, 1}};
constexpr u8 kZerosCode[15][16] = {
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1}, {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0},       {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0},             {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0},                   {1, 1, 1, 3, 3, 2, 2, 1, 0},
    {1, 0, 1, 3, 2, 1, 1, 1},                         {1, 0, 1, 3, 2, 1, 1},
    {0, 1, 1, 2, 1, 3},                               {0, 1, 1, 1, 1},
    {0, 1, 1, 1},                                     {0, 1, 1},
    {0, 1}};
// total_zeros of the 2x2 chroma DC: [TotalCoeff - 1][total_zeros]
constexpr u8 kDcZerosLen[3][4] = {{1, 2, 3, 3}, {1, 2, 2, 0}, {1, 1, 0, 0}};
constexpr u8 kDcZerosCode[3][4] = {{1, 1, 1, 0}, {1, 1, 0, 0}, {1, 0, 0, 0}};
// run_before: [min(zerosLeft, 7) - 1][run_before]
constexpr u8 kRunLen[7][15] = {{1, 1},
                               {1, 2, 2},
                               {2, 2, 2, 2},
                               {2, 2, 2, 3, 3},
                               {2, 2, 3, 3, 3, 3},
                               {2, 3, 3, 3, 3, 3, 3},
                               {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11}};
constexpr u8 kRunCode[7][15] = {{1, 0},
                                {1, 1, 0},
                                {3, 2, 1, 0},
                                {3, 2, 1, 1, 0},
                                {3, 2, 3, 2, 1, 0},
                                {3, 0, 1, 3, 2, 5, 4},
                                {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1}};

// luma4x4BlkIdx -> (x, y) of the block in 4x4 units
constexpr u8 kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
constexpr u8 kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
// a block below the MB's top row and left of its right column: is the
// block at its top right decoded before it (a smaller luma4x4BlkIdx)?
constexpr bool kTopRightInside[16] = {false, false, true, false, false, false, true, false,
                                      true, true, true, false, true, false, true, false};

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline u8 clip1(int v) { return static_cast<u8>(v < 0 ? 0 : v > 255 ? 255 : v); }

// ---------------------------------------------------------------- errors

// return codes (h264_plain.py names them)
enum : int {
    kBadCode = -1,       // a code no table has, or a value out of its range
    kTruncated = -2,     // the slice data end inside a macroblock
    kMissing = -3,       // macroblocks no slice covered
    kLost = -4,          // an earlier picture of the chain failed
    kNoReference = -5,   // a reference index with no picture behind it
    kOverlap = -6,       // a slice that starts at a decoded macroblock
    kTooManyMbs = -7,    // a slice that runs past the picture's last macroblock
};

struct Fail {
    int code;
};

// ---------------------------------------------------------------- bits

struct Bits {
    const u8* p = nullptr;   // the RBSP, padded with 8 zero bytes
    std::size_t end = 0;     // the rbsp_stop_one_bit's position
    std::size_t pos = 0;

    // the 64 bits from pos (the 8-byte padding keeps the load inside),
    // the first in the top bit; the bits below the 57th are partial
    inline std::uint64_t peek64() const {
        std::uint64_t v;
        std::memcpy(&v, p + (pos >> 3), 8);
        return __builtin_bswap64(v) << (pos & 7);
    }
    inline unsigned u(int n) {
        if (n == 0) return 0;
        const unsigned v = static_cast<unsigned>(peek64() >> (64 - n));
        pos += n;
        return v;
    }
    inline unsigned bit() { return u(1); }
    inline unsigned ue() {
        const std::uint64_t v = peek64();
        if (!v) throw Fail{kBadCode};
        const int lz = __builtin_clzll(v);
        if (lz > 31) throw Fail{kBadCode};
        pos += lz + 1;
        const unsigned rest = lz ? u(lz) : 0;
        return ((1u << lz) - 1) + rest;
    }
    inline int se() {
        const unsigned k = ue();
        return (k & 1) ? static_cast<int>((k + 1) >> 1) : -static_cast<int>(k >> 1);
    }
    inline bool more() const { return pos < end; }
    inline int zeros_before_one(int most) {   // level_prefix
        const std::uint64_t v = peek64();
        const int lz = v ? __builtin_clzll(v) : 64;
        if (lz > most) throw Fail{kBadCode};
        pos += lz + 1;
        return lz;
    }
};

// a VLC of (length, code) pairs, read by trying each: the tables are
// short, and each is tried in order of length
struct Vlc {
    struct E {
        u8 len;
        std::uint16_t code;
        std::int16_t value;
    };
    std::vector<E> e;
    void add(int len, int code, int value) {
        if (len) e.push_back({static_cast<u8>(len), static_cast<std::uint16_t>(code),
                              static_cast<std::int16_t>(value)});
    }
    void sort() {
        std::stable_sort(e.begin(), e.end(), [](const E& a, const E& b) { return a.len < b.len; });
        // a direct lookup over the longest code's bits
        maxlen = e.empty() ? 0 : e.back().len;
        lut.assign(std::size_t(1) << maxlen, -1);
        for (const E& x : e) {
            const int shift = maxlen - x.len;
            const std::size_t base = std::size_t(x.code) << shift;
            for (std::size_t k = 0; k < (std::size_t(1) << shift); ++k)
                if (lut[base + k] < 0)
                    lut[base + k] = static_cast<std::int32_t>((x.value << 8) | x.len);
        }
    }
    int read(Bits& b) const {
        const unsigned v = static_cast<unsigned>(b.peek64() >> (64 - maxlen));
        const std::int32_t r = lut[v];
        if (r < 0) throw Fail{kBadCode};
        b.pos += r & 255;
        return r >> 8;
    }
    int maxlen = 0;
    std::vector<std::int32_t> lut;
};

struct Tables {
    Vlc token[4], dc_token, zeros[15], dc_zeros[3], run[7];
    Tables() {
        for (int c = 0; c < 4; ++c) {
            for (int i = 0; i < 68; ++i) {
                const int tc = i >> 2, t1 = i & 3;
                if (t1 > tc || (tc == 0 && t1)) continue;
                token[c].add(kTokenLen[c][i], kTokenCode[c][i], tc * 4 + t1);
            }
            token[c].sort();
        }
        for (int i = 0; i < 20; ++i) {
            const int tc = i >> 2, t1 = i & 3;
            if (t1 > tc || t1 > 3) continue;
            dc_token.add(kDcTokenLen[i], kDcTokenCode[i], i);
        }
        dc_token.sort();
        for (int t = 0; t < 15; ++t) {
            for (int z = 0; z <= 15 - t; ++z) zeros[t].add(kZerosLen[t][z], kZerosCode[t][z], z);
            zeros[t].sort();
        }
        for (int t = 0; t < 3; ++t) {
            for (int z = 0; z <= 3 - t; ++z)
                dc_zeros[t].add(kDcZerosLen[t][z], kDcZerosCode[t][z], z);
            dc_zeros[t].sort();
        }
        for (int z = 0; z < 7; ++z) {
            for (int r = 0; r < 15; ++r)
                if (r <= (z < 6 ? z + 1 : 14)) run[z].add(kRunLen[z][r], kRunCode[z][r], r);
            run[z].sort();
        }
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// ---------------------------------------------------------------- pictures

enum MbKind : std::int8_t { kNone = 0, kInter = 1, kSkip = 2, kI4 = 3, kI16 = 4, kPcm = 5 };

inline bool is_intra(int kind) { return kind >= kI4; }

// a frame slot: the planes (MB-aligned, no border) and what the
// macroblocks of the picture in it left for prediction and deblocking
struct Slot {
    int mbw = 0, mbh = 0, W = 0, H = 0;
    std::vector<u8> y, u, v;
    std::vector<std::int8_t> kind, qp;      // qp: QPY as deblocking reads it
    std::vector<std::int16_t> slice;        // the slice of each MB, -1: not decoded
    std::vector<std::int8_t> i4;            // 16 a MB (raster 4x4): Intra4x4PredMode
    std::vector<u8> nnz;                    // 24 a MB: 16 luma (raster), 4 Cb, 4 Cr
    std::vector<std::int16_t> mv;           // 32 a MB (raster 4x4, x and y)
    std::vector<std::int8_t> ref;           // 16 a MB: refIdxL0, -1 intra
    std::vector<std::int32_t> rpic;         // 16 a MB: the reference picture's id
    Slot(int mbw_, int mbh_) : mbw(mbw_), mbh(mbh_), W(mbw_ * 16), H(mbh_ * 16) {
        const std::size_t n = static_cast<std::size_t>(mbw) * mbh;
        y.assign(std::size_t(W) * H, 0);
        u.assign(std::size_t(W / 2) * (H / 2), 0);
        v.assign(std::size_t(W / 2) * (H / 2), 0);
        kind.assign(n, kNone);
        qp.assign(n, 0);
        slice.assign(n, -1);
        i4.assign(n * 16, -1);
        nnz.assign(n * 24, 0);
        mv.assign(n * 32, 0);
        ref.assign(n * 16, -1);
        rpic.assign(n * 16, -1);
    }
    void reset() {
        std::fill(kind.begin(), kind.end(), kNone);
        std::fill(slice.begin(), slice.end(), -1);
    }
};

// one slice's parameters (h264_plain.Slice.native_params gives them in
// this order)
struct SliceParams {
    int first_mb = 0, type = 2, qp = 26, disable = 0, off_a = 0, off_b = 0;
    int cqp[2] = {0, 0};
    int cip = 0, nref = 0;
    int refs[32];   // frame slots of RefPicList0
    int ids[32];    // the pictures' ids (deblocking compares them)
};
constexpr int kParams = 10 + 64;

// a slice being decoded
struct SliceCtx {
    Slot* cur = nullptr;
    const Slot* refs[32] = {};
    SliceParams sp;
    int index = 0;   // the slice's number in the picture
};

// the syntax of one macroblock
struct MbData {
    int kind = kNone;
    int ptype = 0;       // inter: 0 16x16, 1 16x8, 2 8x16, 3 P_8x8, 4 P_8x8ref0
    int sub[4] = {0, 0, 0, 0};
    int ref[4] = {0, 0, 0, 0};   // per partition (or sub-macroblock)
    int mvd[16][2] = {};         // per (sub-)partition in decoding order
    int i4mode[16] = {};         // Intra4x4PredMode by luma4x4BlkIdx
    int prev[16] = {}, rem[16] = {};
    int i16mode = 0, cmode = 0;
    int cbp = 0, qp_delta = 0, qp = 0;
    std::int16_t luma[16][16] = {};   // levels by luma4x4BlkIdx, raster in the block
    std::int16_t ldc[16] = {};        // Intra16x16 DC levels (raster of blocks)
    std::int16_t cdc[2][4] = {};
    std::int16_t cac[2][4][16] = {};  // chroma AC (raster; [0] unused)
    u8 pcm[384] = {};
};

// ---------------------------------------------------------------- neighbours

struct Nb {
    bool avail;
    int ref, mvx, mvy;
    std::int32_t pic;
};

struct MbPos {
    int addr, x, y;   // MB address and coordinates
};

inline bool mb_avail(const SliceCtx& s, int mx, int my) {
    const Slot& c = *s.cur;
    if (mx < 0 || my < 0 || mx >= c.mbw || my >= c.mbh) return false;
    return c.slice[my * c.mbw + mx] == s.index;
}

// the partition covering (xn, yn) (luma samples, relative to the current
// MB's corner); `done` marks the current MB's 4x4 blocks already predicted
Nb neighbour(const SliceCtx& s, const MbPos& m, int xn, int yn, unsigned done) {
    Nb n{false, -1, 0, 0, -1};
    if (yn > 15) return n;
    int mx = m.x, my = m.y;
    if (xn < 0) {
        mx -= 1;
        if (yn < 0) my -= 1;
    } else if (xn <= 15) {
        if (yn < 0) my -= 1;
    } else {
        if (yn >= 0) return n;
        mx += 1;
        my -= 1;
    }
    const int bx = ((xn + 16) & 15) >> 2, by = ((yn + 16) & 15) >> 2;
    const Slot& c = *s.cur;
    if (mx == m.x && my == m.y) {
        if (!(done >> (by * 4 + bx) & 1)) return n;
    } else if (!mb_avail(s, mx, my)) {
        return n;
    }
    const std::size_t a = static_cast<std::size_t>(my) * c.mbw + mx;
    n.avail = true;
    const int b = by * 4 + bx;
    n.ref = c.ref[a * 16 + b];
    if (n.ref >= 0) {
        n.mvx = c.mv[a * 32 + b * 2];
        n.mvy = c.mv[a * 32 + b * 2 + 1];
    }
    return n;
}

inline int median3(int a, int b, int c) {
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// mvpLX of the partition at (x, y), w x h luma samples; shape 1: 16x8,
// 2: 8x16, 0: the others
void predict_mv(const SliceCtx& s, const MbPos& m, int x, int y, int w, int h, int shape,
                int ref, unsigned done, int& px, int& py) {
    const Nb a = neighbour(s, m, x - 1, y, done);
    const Nb b = neighbour(s, m, x, y - 1, done);
    Nb c = neighbour(s, m, x + w, y - 1, done);
    if (!c.avail) c = neighbour(s, m, x - 1, y - 1, done);
    (void)h;
    if (shape == 1) {
        if (y == 0 && b.ref == ref) { px = b.mvx; py = b.mvy; return; }
        if (y != 0 && a.ref == ref) { px = a.mvx; py = a.mvy; return; }
    } else if (shape == 2) {
        if (x == 0 && a.ref == ref) { px = a.mvx; py = a.mvy; return; }
        if (x != 0 && c.ref == ref) { px = c.mvx; py = c.mvy; return; }
    }
    Nb bb = b, cc = c;
    if (!b.avail && !c.avail && a.avail) bb = cc = a;
    const int match = (a.ref == ref) + (bb.ref == ref) + (cc.ref == ref);
    if (match == 1) {
        const Nb& o = a.ref == ref ? a : bb.ref == ref ? bb : cc;
        px = o.mvx;
        py = o.mvy;
        return;
    }
    px = median3(a.mvx, bb.mvx, cc.mvx);
    py = median3(a.mvy, bb.mvy, cc.mvy);
}

void skip_mv(const SliceCtx& s, const MbPos& m, int& px, int& py) {
    const Nb a = neighbour(s, m, -1, 0, 0);
    const Nb b = neighbour(s, m, 0, -1, 0);
    px = py = 0;
    if (!a.avail || !b.avail) return;
    if (a.ref == 0 && a.mvx == 0 && a.mvy == 0) return;
    if (b.ref == 0 && b.mvx == 0 && b.mvy == 0) return;
    predict_mv(s, m, 0, 0, 16, 16, 0, 0, 0, px, py);
}

// TotalCoeff of a neighbouring block for nC: comp 0 luma (bx, by in 4x4
// units of the MB, may be -1), 1 Cb, 2 Cr (2x2 units); -1 unavailable
int neighbour_tc(const SliceCtx& s, const MbPos& m, int comp, int bx, int by) {
    const int n = comp ? 2 : 4;
    int mx = m.x, my = m.y;
    if (bx < 0) { mx -= 1; bx += n; }
    if (by < 0) { my -= 1; by += n; }
    const Slot& c = *s.cur;
    if ((mx != m.x || my != m.y) && !mb_avail(s, mx, my)) return -1;
    const std::size_t a = static_cast<std::size_t>(my) * c.mbw + mx;
    return comp ? c.nnz[a * 24 + 16 + (comp - 1) * 4 + by * 2 + bx] : c.nnz[a * 24 + by * 4 + bx];
}

int nc_of(const SliceCtx& s, const MbPos& m, int comp, int bx, int by) {
    const int na = neighbour_tc(s, m, comp, bx - 1, by);
    const int nb = neighbour_tc(s, m, comp, bx, by - 1);
    if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
    if (na >= 0) return na;
    if (nb >= 0) return nb;
    return 0;
}

inline int nc_class(int nc) { return nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3; }

// ---------------------------------------------------------------- CAVLC

// residual_block_cavlc: up to max_coeff levels into coef[start ..] in
// scan order; returns TotalCoeff.  nc -1: chroma DC.
int read_block(Bits& b, int nc, int start, int max_coeff, std::int16_t* coef) {
    const Tables& t = tables();
    const int tok = nc < 0 ? t.dc_token.read(b) : t.token[nc_class(nc)].read(b);
    const int total = tok >> 2, ones = tok & 3;
    if (total > max_coeff) throw Fail{kBadCode};
    if (!total) return 0;
    int level[16];
    int suffix_len = (total > 10 && ones < 3) ? 1 : 0;
    for (int i = 0; i < total; ++i) {
        if (i < ones) {
            level[i] = b.bit() ? -1 : 1;
            continue;
        }
        const int prefix = b.zeros_before_one(25 + 3);
        int code = (std::min(15, prefix) << suffix_len);
        int size = suffix_len;
        if (prefix == 14 && suffix_len == 0) size = 4;
        if (prefix >= 15) size = prefix - 3;
        if (size) code += static_cast<int>(b.u(size));
        if (prefix >= 15 && suffix_len == 0) code += 15;
        if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
        if (i == ones && ones < 3) code += 2;
        const int lv = (code & 1) ? (-code - 1) >> 1 : (code + 2) >> 1;
        level[i] = lv;
        if (suffix_len == 0) suffix_len = 1;
        if (std::abs(lv) > (3 << (suffix_len - 1)) && suffix_len < 6) ++suffix_len;
    }
    int zeros = 0;
    if (total < max_coeff)
        zeros = nc < 0 ? t.dc_zeros[total - 1].read(b) : t.zeros[total - 1].read(b);
    if (zeros + total > max_coeff) throw Fail{kBadCode};
    int pos = total + zeros - 1;   // scan position of level[0], from start
    for (int i = 0; i < total; ++i) {
        int run = 0;
        if (i < total - 1 && zeros > 0) {
            run = t.run[std::min(zeros, 7) - 1].read(b);
            if (run > zeros) throw Fail{kBadCode};
            zeros -= run;
        } else if (i == total - 1) {
            run = zeros;
        }
        coef[start + pos] = static_cast<std::int16_t>(level[i]);
        pos -= run + 1;
    }
    return total;
}

// ---------------------------------------------------------------- transform

// dequantise and inverse-transform one 4x4 block of levels (raster), the
// DC (when dc_given) already scaled, and add it to dst
void add_block(u8* dst, int stride, const std::int16_t* lv, int qp, bool dc_given, int dc) {
    std::uint64_t bits[4];   // the 16 levels as 4 words: any nonzero?
    std::memcpy(bits, lv, 32);
    if (!(bits[0] | bits[1] | bits[2] | bits[3]) && !(dc_given && dc)) return;
    int d[16];
    const int q6 = qp / 6, q = qp % 6;
    bool any = dc_given && dc;
    for (int i = 0; i < 16; ++i) {
        if (i == 0 && dc_given) {
            d[0] = dc;
            continue;
        }
        d[i] = lv[i] ? (lv[i] * kNorm[q][kNormClass[i]]) << q6 : 0;
        any |= d[i] != 0;
    }
    if (!any) return;
    int e[16];
    for (int r = 0; r < 4; ++r) {   // rows
        const int* x = d + r * 4;
        const int a0 = x[0] + x[2], a1 = x[0] - x[2];
        const int a2 = (x[1] >> 1) - x[3], a3 = x[1] + (x[3] >> 1);
        e[r * 4 + 0] = a0 + a3;
        e[r * 4 + 1] = a1 + a2;
        e[r * 4 + 2] = a1 - a2;
        e[r * 4 + 3] = a0 - a3;
    }
    for (int c = 0; c < 4; ++c) {   // columns
        const int a0 = e[c] + e[8 + c], a1 = e[c] - e[8 + c];
        const int a2 = (e[4 + c] >> 1) - e[12 + c], a3 = e[4 + c] + (e[12 + c] >> 1);
        const int r[4] = {a0 + a3, a1 + a2, a1 - a2, a0 - a3};
        for (int k = 0; k < 4; ++k) {
            u8& p = dst[k * stride + c];
            p = clip1(p + ((r[k] + 32) >> 6));
        }
    }
}

// Intra16x16 DC: the 4x4 levels (raster of blocks) -> dcY per block
void luma_dc(const std::int16_t* c, int qp, int* out) {
    int f[16], g[16];
    for (int r = 0; r < 4; ++r) {
        const int x0 = c[r * 4], x1 = c[r * 4 + 1], x2 = c[r * 4 + 2], x3 = c[r * 4 + 3];
        f[r * 4 + 0] = x0 + x1 + x2 + x3;
        f[r * 4 + 1] = x0 + x1 - x2 - x3;
        f[r * 4 + 2] = x0 - x1 - x2 + x3;
        f[r * 4 + 3] = x0 - x1 + x2 - x3;
    }
    for (int k = 0; k < 4; ++k) {
        const int x0 = f[k], x1 = f[4 + k], x2 = f[8 + k], x3 = f[12 + k];
        g[k] = x0 + x1 + x2 + x3;
        g[4 + k] = x0 + x1 - x2 - x3;
        g[8 + k] = x0 - x1 - x2 + x3;
        g[12 + k] = x0 - x1 + x2 - x3;
    }
    const int scale = 16 * kNorm[qp % 6][0], q6 = qp / 6;
    for (int i = 0; i < 16; ++i) {
        if (qp >= 36)
            out[i] = (g[i] * scale) << (q6 - 6);
        else
            out[i] = (g[i] * scale + (1 << (5 - q6))) >> (6 - q6);
    }
}

void chroma_dc(const std::int16_t* c, int qpc, int* out) {
    const int f0 = c[0] + c[1] + c[2] + c[3], f1 = c[0] - c[1] + c[2] - c[3];
    const int f2 = c[0] + c[1] - c[2] - c[3], f3 = c[0] - c[1] - c[2] + c[3];
    const int scale = 16 * kNorm[qpc % 6][0], q6 = qpc / 6;
    const int f[4] = {f0, f1, f2, f3};
    for (int i = 0; i < 4; ++i) out[i] = ((f[i] * scale) << q6) >> 5;
}

// ---------------------------------------------------------------- intra

// the samples around a block: T[-1 .. 15] (T[-1] the corner), L[0 .. 15]
struct Edge {
    int top[17 + 8];   // [0] is the corner p[-1,-1]; p[x,-1] at top[x + 1]
    int left[16];
    bool has_top = false, has_left = false, has_corner = false;
};

inline bool intra_avail(const SliceCtx& s, int mx, int my) {
    if (!mb_avail(s, mx, my)) return false;
    if (!s.sp.cip) return true;
    return is_intra(s.cur->kind[my * s.cur->mbw + mx]);
}

void pred4x4(u8* dst, int stride, const Edge& e, int mode) {
    const int* T = e.top + 1;   // T[-1] the corner
    const int* L = e.left;
    auto Lp = [&](int y) -> int { return y < 0 ? T[-1] : L[y]; };
    int pr[4][4];
    for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
            int v = 128;
            switch (mode) {
                case 0: v = T[x]; break;
                case 1: v = L[y]; break;
                case 2: {
                    int st = 0, sl = 0;
                    for (int k = 0; k < 4; ++k) { st += T[k]; sl += L[k]; }
                    if (e.has_top && e.has_left) v = (st + sl + 4) >> 3;
                    else if (e.has_left) v = (sl + 2) >> 2;
                    else if (e.has_top) v = (st + 2) >> 2;
                    break;
                }
                case 3:
                    v = (x == 3 && y == 3) ? (T[6] + 3 * T[7] + 2) >> 2
                                           : (T[x + y] + 2 * T[x + y + 1] + T[x + y + 2] + 2) >> 2;
                    break;
                case 4:
                    if (x > y) v = (T[x - y - 2] + 2 * T[x - y - 1] + T[x - y] + 2) >> 2;
                    else if (x < y) v = (Lp(y - x - 2) + 2 * Lp(y - x - 1) + Lp(y - x) + 2) >> 2;
                    else v = (T[0] + 2 * T[-1] + L[0] + 2) >> 2;
                    break;
                case 5: {
                    const int z = 2 * x - y;
                    if (z >= 0 && !(z & 1)) v = (T[x - (y >> 1) - 1] + T[x - (y >> 1)] + 1) >> 1;
                    else if (z > 0) v = (T[x - (y >> 1) - 2] + 2 * T[x - (y >> 1) - 1] + T[x - (y >> 1)] + 2) >> 2;
                    else if (z == -1) v = (L[0] + 2 * T[-1] + T[0] + 2) >> 2;
                    else v = (Lp(y - 1) + 2 * Lp(y - 2) + Lp(y - 3) + 2) >> 2;
                    break;
                }
                case 6: {
                    const int z = 2 * y - x;
                    if (z >= 0 && !(z & 1)) v = (Lp(y - (x >> 1) - 1) + Lp(y - (x >> 1)) + 1) >> 1;
                    else if (z > 0) v = (Lp(y - (x >> 1) - 2) + 2 * Lp(y - (x >> 1) - 1) + Lp(y - (x >> 1)) + 2) >> 2;
                    else if (z == -1) v = (L[0] + 2 * T[-1] + T[0] + 2) >> 2;
                    else v = (T[x - 1] + 2 * T[x - 2] + T[x - 3] + 2) >> 2;
                    break;
                }
                case 7:
                    if (!(y & 1)) v = (T[x + (y >> 1)] + T[x + (y >> 1) + 1] + 1) >> 1;
                    else v = (T[x + (y >> 1)] + 2 * T[x + (y >> 1) + 1] + T[x + (y >> 1) + 2] + 2) >> 2;
                    break;
                case 8: {
                    const int z = x + 2 * y;
                    if (z < 5 && !(z & 1)) v = (L[y + (x >> 1)] + L[y + (x >> 1) + 1] + 1) >> 1;
                    else if (z < 5) v = (L[y + (x >> 1)] + 2 * L[y + (x >> 1) + 1] + L[y + (x >> 1) + 2] + 2) >> 2;
                    else if (z == 5) v = (L[2] + 3 * L[3] + 2) >> 2;
                    else v = L[3];
                    break;
                }
            }
            pr[y][x] = v;
        }
    for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) dst[y * stride + x] = static_cast<u8>(pr[y][x]);
}

// the edge of an n x n block at (px, py) in plane (w x h, stride),
// availability of the four neighbours given
void gather(const u8* plane, int stride, int px, int py, int n, bool top, bool left,
            bool corner, bool tr, int tr_n, Edge& e) {
    e.has_top = top;
    e.has_left = left;
    e.has_corner = corner;
    e.top[0] = corner ? plane[(py - 1) * stride + px - 1] : 0;
    for (int x = 0; x < n + tr_n; ++x) e.top[x + 1] = 0;
    if (top) {
        for (int x = 0; x < n; ++x) e.top[x + 1] = plane[(py - 1) * stride + px + x];
        for (int x = n; x < n + tr_n; ++x)
            e.top[x + 1] = tr ? plane[(py - 1) * stride + px + x] : e.top[n];
    }
    for (int y = 0; y < n; ++y) e.left[y] = left ? plane[(py + y) * stride + px - 1] : 0;
}

void pred16(u8* dst, int stride, const Edge& e, int mode, int n) {
    // luma 16x16 (n 16) and chroma 8x8 (n 8) share vertical, horizontal
    // and plane; DC differs and is done by the callers
    const int* T = e.top + 1;
    const int* L = e.left;
    if (mode == 0) {
        for (int y = 0; y < n; ++y)
            for (int x = 0; x < n; ++x) dst[y * stride + x] = static_cast<u8>(T[x]);
    } else if (mode == 1) {
        for (int y = 0; y < n; ++y)
            for (int x = 0; x < n; ++x) dst[y * stride + x] = static_cast<u8>(L[y]);
    } else {   // plane
        const int half = n / 2;
        int H = 0, V = 0;
        for (int k = 0; k < half; ++k) {
            H += (k + 1) * (T[half + k] - T[half - 2 - k]);
            V += (k + 1) * (L[half + k] - (half - 2 - k < 0 ? T[-1] : L[half - 2 - k]));
        }
        const int a = 16 * (L[n - 1] + T[n - 1]);
        const int b = n == 16 ? (5 * H + 32) >> 6 : (34 * H + 32) >> 6;
        const int c = n == 16 ? (5 * V + 32) >> 6 : (34 * V + 32) >> 6;
        const int mid = half - 1;
        for (int y = 0; y < n; ++y)
            for (int x = 0; x < n; ++x)
                dst[y * stride + x] = clip1((a + b * (x - mid) + c * (y - mid) + 16) >> 5);
    }
}

void pred16_dc(u8* dst, int stride, const Edge& e) {
    int st = 0, sl = 0;
    for (int k = 0; k < 16; ++k) { st += e.top[k + 1]; sl += e.left[k]; }
    int v = 128;
    if (e.has_top && e.has_left) v = (st + sl + 16) >> 5;
    else if (e.has_left) v = (sl + 8) >> 4;
    else if (e.has_top) v = (st + 8) >> 4;
    for (int y = 0; y < 16; ++y) std::memset(dst + y * stride, v, 16);
}

void pred_chroma_dc(u8* dst, int stride, const Edge& e) {
    for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx) {
            int st = 0, sl = 0;
            for (int k = 0; k < 4; ++k) { st += e.top[1 + bx * 4 + k]; sl += e.left[by * 4 + k]; }
            int v = 128;
            const bool t = e.has_top, l = e.has_left;
            if (bx == by) {
                if (t && l) v = (st + sl + 4) >> 3;
                else if (l) v = (sl + 2) >> 2;
                else if (t) v = (st + 2) >> 2;
            } else if (bx == 1) {   // top right: the top first
                if (t) v = (st + 2) >> 2;
                else if (l) v = (sl + 2) >> 2;
            } else {                // bottom left: the left first
                if (l) v = (sl + 2) >> 2;
                else if (t) v = (st + 2) >> 2;
            }
            for (int y = 0; y < 4; ++y)
                std::memset(dst + (by * 4 + y) * stride + bx * 4, v, 4);
        }
}

// ---------------------------------------------------------------- inter

// luma: the w x h block at (x, y) of ref moved by (mvx, mvy) quarter
// samples, into dst: the (w + 5) x (h + 5) window from (xi - 2, yi - 2)
// (coordinates clamped to the picture), then the half-sample planes the
// fraction needs, each computed once
void mc_luma(const Slot& ref, int x, int y, int w, int h, int mvx, int mvy, u8* dst, int stride) {
    const int xi = x + (mvx >> 2), yi = y + (mvy >> 2), fx = mvx & 3, fy = mvy & 3;
    const int W = ref.W, H = ref.H;
    const u8* src = ref.y.data();
    const bool inside = xi - 2 >= 0 && yi - 2 >= 0 && xi + w + 3 <= W && yi + h + 3 <= H;
    if (fx == 0 && fy == 0) {   // whole samples
        for (int j = 0; j < h; ++j) {
            const int sy = inside ? yi + j : clip3(0, H - 1, yi + j);
            const u8* row = src + static_cast<std::size_t>(sy) * W;
            if (inside) {
                std::memcpy(dst + j * stride, row + xi, w);
            } else {
                for (int i = 0; i < w; ++i) dst[j * stride + i] = row[clip3(0, W - 1, xi + i)];
            }
        }
        return;
    }
    constexpr int N = 21;
    int win[N * N];
    const int ww = w + 5, wh = h + 5;
    for (int j = 0; j < wh; ++j) {
        const int sy = inside ? yi - 2 + j : clip3(0, H - 1, yi - 2 + j);
        const u8* row = src + static_cast<std::size_t>(sy) * W;
        for (int i = 0; i < ww; ++i)
            win[j * N + i] = row[inside ? xi - 2 + i : clip3(0, W - 1, xi - 2 + i)];
    }
    auto tap = [](int a, int b, int c, int d, int e, int f) {
        return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
    };
    auto G = [&](int i, int j) { return win[(j + 2) * N + i + 2]; };
    // b1: the horizontal half samples of every window row (row r: j = r - 2)
    int b1[N * 16], B[N * 16], Hh[16 * N], J[16 * 16];
    const bool need_b = fx == 2 || fx & 1 || fy & 1 || (fx && fy == 2);
    const bool need_h = fy == 2 || fy & 1 || fx & 1 || (fy && fx == 2);
    const bool need_j = (fx == 2 && fy) || (fy == 2 && fx);
    if (need_b || need_j) {
        for (int r = 0; r < wh; ++r)
            for (int i = 0; i < w; ++i) {
                const int* q = win + r * N + i;
                b1[r * 16 + i] = tap(q[0], q[1], q[2], q[3], q[4], q[5]);
                B[r * 16 + i] = clip1((b1[r * 16 + i] + 16) >> 5);
            }
    }
    if (need_h) {
        for (int j = 0; j < h; ++j)
            for (int c = 0; c < ww; ++c) {
                const int* q = win + j * N + c;
                Hh[j * N + c] = clip1((tap(q[0], q[N], q[2 * N], q[3 * N], q[4 * N], q[5 * N]) + 16) >> 5);
            }
    }
    if (need_j) {
        for (int j = 0; j < h; ++j)
            for (int i = 0; i < w; ++i) {
                const int* q = b1 + j * 16 + i;
                J[j * 16 + i] = clip1((tap(q[0], q[16], q[32], q[48], q[64], q[80]) + 512) >> 10);
            }
    }
    // b(i, j) = B[(j + 2) * 16 + i], h(i, j) = Hh[j * N + i + 2]
    for (int j = 0; j < h; ++j)
        for (int i = 0; i < w; ++i) {
            const int b = (need_b || need_j) ? B[(j + 2) * 16 + i] : 0;
            const int hh = need_h ? Hh[j * N + i + 2] : 0;
            int v;
            switch (fy * 4 + fx) {
                case 1: v = (G(i, j) + b + 1) >> 1; break;                        // a
                case 2: v = b; break;                                             // b
                case 3: v = (G(i + 1, j) + b + 1) >> 1; break;                    // c
                case 4: v = (G(i, j) + hh + 1) >> 1; break;                       // d
                case 5: v = (b + hh + 1) >> 1; break;                             // e
                case 6: v = (b + J[j * 16 + i] + 1) >> 1; break;                  // f
                case 7: v = (b + Hh[j * N + i + 3] + 1) >> 1; break;              // g
                case 8: v = hh; break;                                            // h
                case 9: v = (hh + J[j * 16 + i] + 1) >> 1; break;                 // i
                case 10: v = J[j * 16 + i]; break;                                // j
                case 11: v = (J[j * 16 + i] + Hh[j * N + i + 3] + 1) >> 1; break; // k
                case 12: v = (G(i, j + 1) + hh + 1) >> 1; break;                  // n
                case 13: v = (hh + B[(j + 3) * 16 + i] + 1) >> 1; break;          // p
                case 14: v = (J[j * 16 + i] + B[(j + 3) * 16 + i] + 1) >> 1; break;  // q
                default: v = (Hh[j * N + i + 3] + B[(j + 3) * 16 + i] + 1) >> 1; break;  // r
            }
            dst[j * stride + i] = static_cast<u8>(v);
        }
}

void mc_chroma(const std::vector<u8>& plane, int W, int H, int x, int y, int w, int h, int mvx,
               int mvy, u8* dst, int stride) {
    // x, y, w, h in chroma samples; the vector in eighths
    const int xi = x + (mvx >> 3), yi = y + (mvy >> 3), fx = mvx & 7, fy = mvy & 7;
    const int wa = (8 - fx) * (8 - fy), wb = fx * (8 - fy), wc = (8 - fx) * fy, wd = fx * fy;
    if (xi >= 0 && yi >= 0 && xi + w + 1 <= W && yi + h + 1 <= H) {
        for (int j = 0; j < h; ++j) {
            const u8* r0 = plane.data() + static_cast<std::size_t>(yi + j) * W + xi;
            const u8* r1 = r0 + W;
            for (int i = 0; i < w; ++i)
                dst[j * stride + i] = static_cast<u8>(
                    (wa * r0[i] + wb * r0[i + 1] + wc * r1[i] + wd * r1[i + 1] + 32) >> 6);
        }
        return;
    }
    for (int j = 0; j < h; ++j) {
        const int y0 = clip3(0, H - 1, yi + j), y1 = clip3(0, H - 1, yi + j + 1);
        const u8* r0 = plane.data() + static_cast<std::size_t>(y0) * W;
        const u8* r1 = plane.data() + static_cast<std::size_t>(y1) * W;
        for (int i = 0; i < w; ++i) {
            const int x0 = clip3(0, W - 1, xi + i), x1 = clip3(0, W - 1, xi + i + 1);
            dst[j * stride + i] =
                static_cast<u8>((wa * r0[x0] + wb * r0[x1] + wc * r1[x0] + wd * r1[x1] + 32) >> 6);
        }
    }
}

// ---------------------------------------------------------------- macroblocks

// the (sub-)partitions of an inter MB in decoding order: x, y, w, h
// (luma samples), the partition (or sub-MB) whose ref it takes, shape
struct Part {
    int x, y, w, h, owner, shape;
};

int partitions(const MbData& d, Part* out) {
    int n = 0;
    switch (d.ptype) {
        case 0: out[n++] = {0, 0, 16, 16, 0, 0}; break;
        case 1:
            out[n++] = {0, 0, 16, 8, 0, 1};
            out[n++] = {0, 8, 16, 8, 1, 1};
            break;
        case 2:
            out[n++] = {0, 0, 8, 16, 0, 2};
            out[n++] = {8, 0, 8, 16, 1, 2};
            break;
        default:
            for (int i = 0; i < 4; ++i) {
                const int x0 = (i & 1) * 8, y0 = (i >> 1) * 8;
                switch (d.sub[i]) {
                    case 0: out[n++] = {x0, y0, 8, 8, i, 0}; break;
                    case 1:
                        out[n++] = {x0, y0, 8, 4, i, 0};
                        out[n++] = {x0, y0 + 4, 8, 4, i, 0};
                        break;
                    case 2:
                        out[n++] = {x0, y0, 4, 8, i, 0};
                        out[n++] = {x0 + 4, y0, 4, 8, i, 0};
                        break;
                    default:
                        for (int k = 0; k < 4; ++k)
                            out[n++] = {x0 + (k & 1) * 4, y0 + (k >> 1) * 4, 4, 4, i, 0};
                }
            }
    }
    return n;
}

inline int te(Bits& b, int range) {
    if (range == 1) return !b.bit();
    return static_cast<int>(b.ue());
}

void parse_residual(Bits& b, const SliceCtx& s, const MbPos& m, MbData& d) {
    Slot& c = *s.cur;
    u8* nnz = &c.nnz[static_cast<std::size_t>(m.addr) * 24];
    std::memset(nnz, 0, 24);
    std::int16_t scan[16];
    const bool i16 = d.kind == kI16;
    if (i16) {
        std::memset(scan, 0, sizeof scan);
        read_block(b, nc_of(s, m, 0, 0, 0), 0, 16, scan);
        for (int k = 0; k < 16; ++k) d.ldc[kZigzag[k]] = scan[k];
    }
    for (int blk = 0; blk < 16; ++blk) {
        const int bx = kBlkX[blk], by = kBlkY[blk];
        std::memset(d.luma[blk], 0, sizeof d.luma[blk]);
        if (!(d.cbp >> (blk >> 2) & 1)) continue;
        std::memset(scan, 0, sizeof scan);
        const int nc = nc_of(s, m, 0, bx, by);
        const int tc = i16 ? read_block(b, nc, 1, 15, scan) : read_block(b, nc, 0, 16, scan);
        for (int k = i16 ? 1 : 0; k < 16; ++k) d.luma[blk][kZigzag[k]] = scan[k];
        nnz[by * 4 + bx] = static_cast<u8>(tc);
    }
    const int cc = d.cbp >> 4;
    for (int k = 0; k < 2; ++k) {
        std::memset(d.cdc[k], 0, sizeof d.cdc[k]);
        if (cc & 3) read_block(b, -1, 0, 4, d.cdc[k]);
    }
    for (int k = 0; k < 2; ++k)
        for (int blk = 0; blk < 4; ++blk) {
            std::memset(d.cac[k][blk], 0, sizeof d.cac[k][blk]);
            if (!(cc & 2)) continue;
            std::memset(scan, 0, sizeof scan);
            const int tc = read_block(b, nc_of(s, m, k + 1, blk & 1, blk >> 1), 1, 15, scan);
            for (int j = 1; j < 16; ++j) d.cac[k][blk][kZigzag[j]] = scan[j];
            nnz[16 + k * 4 + blk] = static_cast<u8>(tc);
        }
}

// the prediction-mode syntax -> Intra4x4PredMode, block by block
int i4_predicted(const SliceCtx& s, const MbPos& m, int blk) {
    const Slot& c = *s.cur;
    const int bx = kBlkX[blk], by = kBlkY[blk];
    auto mode_of = [&](int x, int y, bool& dc_flag) -> int {
        int mx = m.x, my = m.y;
        if (x < 0) { mx -= 1; x += 4; }
        if (y < 0) { my -= 1; y += 4; }
        if (mx != m.x || my != m.y) {
            if (!mb_avail(s, mx, my)) { dc_flag = true; return 2; }
            const int k = c.kind[my * c.mbw + mx];
            if (!is_intra(k) && s.sp.cip) { dc_flag = true; return 2; }
            if (k != kI4) return 2;
        }
        return c.i4[(static_cast<std::size_t>(my) * c.mbw + mx) * 16 + y * 4 + x];
    };
    bool dc = false;
    const int a = mode_of(bx - 1, by, dc);
    const int b = mode_of(bx, by - 1, dc);
    return dc ? 2 : std::min(a, b);
}

// the chroma QP of a luma QP for component k (0 Cb, 1 Cr)
inline int chroma_qp(const SliceParams& sp, int qp, int k) {
    return kChromaQp[clip3(0, 51, qp + sp.cqp[k])];
}

// reconstruct one parsed macroblock into the slot
void reconstruct(const SliceCtx& s, const MbPos& m, const MbData& d) {
    Slot& c = *s.cur;
    const std::size_t a = m.addr;
    const int W = c.W, CW = c.W / 2;
    u8* Y = c.y.data() + static_cast<std::size_t>(m.y) * 16 * W + m.x * 16;
    u8* U = c.u.data() + static_cast<std::size_t>(m.y) * 8 * CW + m.x * 8;
    u8* V = c.v.data() + static_cast<std::size_t>(m.y) * 8 * CW + m.x * 8;
    c.kind[a] = static_cast<std::int8_t>(d.kind);
    std::int8_t* i4 = &c.i4[a * 16];
    std::int16_t* mv = &c.mv[a * 32];
    std::int8_t* ref = &c.ref[a * 16];
    std::int32_t* rpic = &c.rpic[a * 16];
    std::fill(i4, i4 + 16, -1);
    if (d.kind == kPcm) {
        for (int y = 0; y < 16; ++y) std::memcpy(Y + y * W, d.pcm + y * 16, 16);
        for (int y = 0; y < 8; ++y) {
            std::memcpy(U + y * CW, d.pcm + 256 + y * 8, 8);
            std::memcpy(V + y * CW, d.pcm + 320 + y * 8, 8);
        }
        std::fill(ref, ref + 16, -1);
        std::fill(mv, mv + 32, 0);
        std::memset(&c.nnz[a * 24], 16, 24);
        c.qp[a] = 0;
        return;
    }
    c.qp[a] = static_cast<std::int8_t>(d.qp);
    const bool intra = d.kind == kI4 || d.kind == kI16;
    if (intra) {
        std::fill(ref, ref + 16, -1);
        std::fill(mv, mv + 32, 0);
        std::fill(rpic, rpic + 16, -1);
    }
    // availability of the neighbouring MBs for intra prediction
    const bool tA = intra_avail(s, m.x - 1, m.y), tB = intra_avail(s, m.x, m.y - 1);
    const bool tC = intra_avail(s, m.x + 1, m.y - 1), tD = intra_avail(s, m.x - 1, m.y - 1);
    const int qpc[2] = {chroma_qp(s.sp, d.qp, 0), chroma_qp(s.sp, d.qp, 1)};
    if (d.kind == kI4) {
        for (int blk = 0; blk < 16; ++blk) {
            const int bx = kBlkX[blk], by = kBlkY[blk];
            const int px = m.x * 16 + bx * 4, py = m.y * 16 + by * 4;
            const bool top = by ? true : tB;
            const bool left = bx ? true : tA;
            const bool corner = (bx && by) ? true : (!bx && !by) ? tD : bx ? tB : tA;
            bool tr;
            if (by == 0) tr = bx < 3 ? tB : tC;
            else if (bx == 3) tr = false;
            else tr = kTopRightInside[blk];   // decoded before this block?
            Edge e;
            gather(c.y.data(), W, px, py, 4, top, left, corner, tr, 4, e);
            pred4x4(Y + by * 4 * W + bx * 4, W, e, d.i4mode[blk]);
            i4[by * 4 + bx] = static_cast<std::int8_t>(d.i4mode[blk]);
            if (d.cbp >> (blk >> 2) & 1)
                add_block(Y + by * 4 * W + bx * 4, W, d.luma[blk], d.qp, false, 0);
        }
    } else if (d.kind == kI16) {
        Edge e;
        gather(c.y.data(), W, m.x * 16, m.y * 16, 16, tB, tA, tD, false, 0, e);
        if (d.i16mode == 2) pred16_dc(Y, W, e);
        else pred16(Y, W, e, d.i16mode, 16);
        int dc[16];
        luma_dc(d.ldc, d.qp, dc);
        for (int blk = 0; blk < 16; ++blk) {
            const int bx = kBlkX[blk], by = kBlkY[blk];
            add_block(Y + by * 4 * W + bx * 4, W, d.luma[blk], d.qp, true, dc[by * 4 + bx]);
        }
    } else {
        // inter: the vectors, partition by partition, then the prediction
        Part parts[16];
        const int n = partitions(d, parts);
        unsigned done = 0;
        if (d.kind == kSkip) {
            int px, py;
            skip_mv(s, m, px, py);
            for (int k = 0; k < 16; ++k) {
                ref[k] = 0;
                mv[2 * k] = static_cast<std::int16_t>(px);
                mv[2 * k + 1] = static_cast<std::int16_t>(py);
            }
        } else {
            for (int p = 0; p < n; ++p) {
                const Part& q = parts[p];
                const int r = d.ref[q.owner];
                int px, py;
                predict_mv(s, m, q.x, q.y, q.w, q.h, q.shape, r, done, px, py);
                const int mx = px + d.mvd[p][0], my = py + d.mvd[p][1];
                for (int y = q.y / 4; y < (q.y + q.h) / 4; ++y)
                    for (int x = q.x / 4; x < (q.x + q.w) / 4; ++x) {
                        ref[y * 4 + x] = static_cast<std::int8_t>(r);
                        mv[2 * (y * 4 + x)] = static_cast<std::int16_t>(mx);
                        mv[2 * (y * 4 + x) + 1] = static_cast<std::int16_t>(my);
                        done |= 1u << (y * 4 + x);
                    }
            }
        }
        for (int k = 0; k < 16; ++k) {
            if (ref[k] >= s.sp.nref || !s.refs[ref[k]]) throw Fail{kNoReference};
            rpic[k] = s.sp.ids[ref[k]];
        }
        // motion compensation by partition (one for P_Skip)
        const int np = d.kind == kSkip ? 1 : n;
        for (int p = 0; p < np; ++p) {
            const Part q = d.kind == kSkip ? Part{0, 0, 16, 16, 0, 0} : parts[p];
            const int k = (q.y / 4) * 4 + q.x / 4;
            const Slot& r = *s.refs[ref[k]];
            const int mx = mv[2 * k], my = mv[2 * k + 1];
            mc_luma(r, m.x * 16 + q.x, m.y * 16 + q.y, q.w, q.h, mx, my, Y + q.y * W + q.x, W);
            const int cx = m.x * 8 + q.x / 2, cy = m.y * 8 + q.y / 2;
            mc_chroma(r.u, CW, c.H / 2, cx, cy, q.w / 2, q.h / 2, mx, my, U + (q.y / 2) * CW + q.x / 2, CW);
            mc_chroma(r.v, CW, c.H / 2, cx, cy, q.w / 2, q.h / 2, mx, my, V + (q.y / 2) * CW + q.x / 2, CW);
        }
        if (d.kind == kSkip) return;
        for (int blk = 0; blk < 16; ++blk) {
            if (!(d.cbp >> (blk >> 2) & 1)) continue;
            const int bx = kBlkX[blk], by = kBlkY[blk];
            add_block(Y + by * 4 * W + bx * 4, W, d.luma[blk], d.qp, false, 0);
        }
    }
    // chroma
    if (intra) {
        Edge e;
        for (int k = 0; k < 2; ++k) {
            const std::vector<u8>& pl = k ? c.v : c.u;
            u8* dst = k ? V : U;
            gather(pl.data(), CW, m.x * 8, m.y * 8, 8, tB, tA, tD, false, 0, e);
            if (d.cmode == 0) pred_chroma_dc(dst, CW, e);
            else pred16(dst, CW, e, d.cmode == 1 ? 1 : d.cmode == 2 ? 0 : 3, 8);
        }
    }
    if (!(d.cbp >> 4)) return;
    for (int k = 0; k < 2; ++k) {
        int dc[4];
        chroma_dc(d.cdc[k], qpc[k], dc);
        u8* dst = k ? V : U;
        for (int blk = 0; blk < 4; ++blk)
            add_block(dst + (blk >> 1) * 4 * CW + (blk & 1) * 4, CW, d.cac[k][blk], qpc[k], true,
                      dc[blk]);
    }
}

// parse one macroblock_layer (not P_Skip) of slice s
void parse_mb(Bits& b, const SliceCtx& s, const MbPos& m, MbData& d, int& qp) {
    Slot& c = *s.cur;
    int mb_type = static_cast<int>(b.ue());
    d = MbData();
    if (s.sp.type == 0) {   // P
        if (mb_type < 5) {
            d.kind = kInter;
            d.ptype = mb_type;
        } else {
            mb_type -= 5;
        }
    }
    if (d.kind != kInter) {
        if (mb_type > 25) throw Fail{kBadCode};
        if (mb_type == 25) {
            d.kind = kPcm;
            b.pos = (b.pos + 7) & ~std::size_t(7);
            for (int i = 0; i < 384; ++i) d.pcm[i] = static_cast<u8>(b.u(8));
            c.qp[m.addr] = 0;
            d.qp = qp;
            return;
        }
        if (mb_type == 0) {
            d.kind = kI4;
        } else {
            d.kind = kI16;
            d.i16mode = (mb_type - 1) % 4;
            d.cbp = (((mb_type - 1) / 4) % 3) << 4 | (mb_type >= 13 ? 15 : 0);
        }
    }
    const int nref = s.sp.nref;
    if (d.kind == kI4) {
        for (int blk = 0; blk < 16; ++blk) {
            d.prev[blk] = static_cast<int>(b.bit());
            if (!d.prev[blk]) d.rem[blk] = static_cast<int>(b.u(3));
        }
    }
    if (d.kind == kI4 || d.kind == kI16) {
        d.cmode = static_cast<int>(b.ue());
        if (d.cmode > 3) throw Fail{kBadCode};
    } else if (d.ptype >= 3) {
        for (int i = 0; i < 4; ++i) {
            d.sub[i] = static_cast<int>(b.ue());
            if (d.sub[i] > 3) throw Fail{kBadCode};
        }
        for (int i = 0; i < 4; ++i) {
            d.ref[i] = (nref > 1 && d.ptype == 3) ? te(b, nref - 1) : 0;
            if (d.ref[i] >= nref) throw Fail{kBadCode};
        }
        Part parts[16];
        const int n = partitions(d, parts);
        for (int p = 0; p < n; ++p) {
            d.mvd[p][0] = b.se();
            d.mvd[p][1] = b.se();
        }
    } else {
        const int np = d.ptype == 0 ? 1 : 2;
        for (int i = 0; i < np; ++i) {
            d.ref[i] = nref > 1 ? te(b, nref - 1) : 0;
            if (d.ref[i] >= nref) throw Fail{kBadCode};
        }
        for (int i = 0; i < np; ++i) {
            d.mvd[i][0] = b.se();
            d.mvd[i][1] = b.se();
        }
    }
    if (d.kind != kI16) {
        const unsigned code = b.ue();
        if (code > 47) throw Fail{kBadCode};
        d.cbp = d.kind == kI4 ? kCbpIntra[code] : kCbpInter[code];
    }
    if (d.cbp || d.kind == kI16) {
        d.qp_delta = b.se();
        if (d.qp_delta < -26 || d.qp_delta > 25) throw Fail{kBadCode};
        qp = (qp + d.qp_delta + 52) % 52;
    }
    d.qp = qp;
    if (d.cbp || d.kind == kI16) parse_residual(b, s, m, d);
    else std::memset(&c.nnz[static_cast<std::size_t>(m.addr) * 24], 0, 24);
    if (d.kind == kI4) {   // the modes need the neighbours' modes
        std::int8_t* i4 = &c.i4[static_cast<std::size_t>(m.addr) * 16];
        c.kind[m.addr] = kI4;
        for (int blk = 0; blk < 16; ++blk) {
            const int pred = i4_predicted(s, m, blk);
            const int mode = d.prev[blk] ? pred : d.rem[blk] < pred ? d.rem[blk] : d.rem[blk] + 1;
            d.i4mode[blk] = mode;
            i4[kBlkY[blk] * 4 + kBlkX[blk]] = static_cast<std::int8_t>(mode);
        }
    }
}

void skip_data(const SliceCtx& s, const MbPos& m, MbData& d, int qp) {
    d = MbData();
    d.kind = kSkip;
    d.qp = qp;
    std::memset(&s.cur->nnz[static_cast<std::size_t>(m.addr) * 24], 0, 24);
}

// decode the slice data of slice s from bit `bit` of the RBSP; returns 0
// or a return code, and the MB where it failed in *where
int decode_slice(SliceCtx& s, const u8* rbsp, std::size_t end_bit, std::size_t bit, int* where) {
    Slot& c = *s.cur;
    Bits b;
    b.p = rbsp;
    b.end = end_bit;
    b.pos = bit;
    const int nmb = c.mbw * c.mbh;
    int mb = s.sp.first_mb;
    int qp = s.sp.qp;
    MbData d;
    *where = mb;
    try {
        if (mb >= nmb) throw Fail{kTooManyMbs};
        bool more = true;
        auto begin = [&](int a) {
            if (a >= nmb) throw Fail{kTooManyMbs};
            if (c.slice[a] >= 0) throw Fail{kOverlap};
            c.slice[a] = static_cast<std::int16_t>(s.index);
            *where = a;
            return MbPos{a, a % c.mbw, a / c.mbw};
        };
        while (more) {
            if (s.sp.type == 0) {
                const unsigned run = b.ue();
                if (b.pos > b.end) throw Fail{kTruncated};
                for (unsigned k = 0; k < run; ++k) {
                    const MbPos m = begin(mb++);
                    skip_data(s, m, d, qp);
                    reconstruct(s, m, d);
                    c.qp[m.addr] = static_cast<std::int8_t>(qp);
                }
                if (run) more = b.more();
            }
            if (more) {
                const MbPos m = begin(mb++);
                parse_mb(b, s, m, d, qp);
                if (b.pos > b.end) throw Fail{kTruncated};
                reconstruct(s, m, d);
                more = b.more();
            }
        }
    } catch (const Fail& f) {
        return f.code;
    }
    return 0;
}

// ---------------------------------------------------------------- deblocking

inline void filter_luma(u8* p0p, int step, int bs, int alpha, int beta, int tc0) {
    // p0p: the q0 sample; step: across the edge
    u8* q = p0p;
    const int p0 = q[-step], p1 = q[-2 * step], p2 = q[-3 * step];
    const int q0 = q[0], q1 = q[step], q2 = q[2 * step];
    if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta)) return;
    const int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
    if (bs < 4) {
        const int tc = tc0 + (ap < beta) + (aq < beta);
        const int delta = clip3(-tc, tc, (((q0 - p0) * 4) + (p1 - q1) + 4) >> 3);
        q[-step] = clip1(p0 + delta);
        q[0] = clip1(q0 - delta);
        if (ap < beta) q[-2 * step] = static_cast<u8>(p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - (p1 * 2)) >> 1));
        if (aq < beta) q[step] = static_cast<u8>(q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - (q1 * 2)) >> 1));
    } else {
        const int p3 = q[-4 * step], q3 = q[3 * step];
        const bool strong = std::abs(p0 - q0) < ((alpha >> 2) + 2);
        if (ap < beta && strong) {
            q[-step] = static_cast<u8>((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
            q[-2 * step] = static_cast<u8>((p2 + p1 + p0 + q0 + 2) >> 2);
            q[-3 * step] = static_cast<u8>((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
        } else {
            q[-step] = static_cast<u8>((2 * p1 + p0 + q1 + 2) >> 2);
        }
        if (aq < beta && strong) {
            q[0] = static_cast<u8>((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
            q[step] = static_cast<u8>((p0 + q0 + q1 + q2 + 2) >> 2);
            q[2 * step] = static_cast<u8>((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
        } else {
            q[0] = static_cast<u8>((2 * q1 + q0 + p1 + 2) >> 2);
        }
    }
}

inline void filter_chroma(u8* q, int step, int bs, int alpha, int beta, int tc0) {
    const int p0 = q[-step], p1 = q[-2 * step], q0 = q[0], q1 = q[step];
    if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta)) return;
    if (bs < 4) {
        const int tc = tc0 + 1;
        const int delta = clip3(-tc, tc, (((q0 - p0) * 4) + (p1 - q1) + 4) >> 3);
        q[-step] = clip1(p0 + delta);
        q[0] = clip1(q0 - delta);
    } else {
        q[-step] = static_cast<u8>((2 * p1 + p0 + q1 + 2) >> 2);
        q[0] = static_cast<u8>((2 * q1 + q0 + p1 + 2) >> 2);
    }
}

// bS of the edge between 4x4 blocks p (MB pa, raster block pb) and q
int strength(const Slot& c, std::size_t pa, int pb, std::size_t qa, int qb, bool mb_edge) {
    const int kp = c.kind[pa], kq = c.kind[qa];
    if (is_intra(kp) || is_intra(kq)) return mb_edge ? 4 : 3;
    if (c.nnz[pa * 24 + pb] || c.nnz[qa * 24 + qb]) return 2;
    if (c.rpic[pa * 16 + pb] != c.rpic[qa * 16 + qb]) return 1;
    if (std::abs(c.mv[pa * 32 + pb * 2] - c.mv[qa * 32 + qb * 2]) >= 4) return 1;
    if (std::abs(c.mv[pa * 32 + pb * 2 + 1] - c.mv[qa * 32 + qb * 2 + 1]) >= 4) return 1;
    return 0;
}

void deblock_mb(Slot& c, const SliceParams* sps, int mx, int my) {
    const std::size_t a = static_cast<std::size_t>(my) * c.mbw + mx;
    const SliceParams& sp = sps[c.slice[a]];
    if (sp.disable == 1) return;
    const bool left = mx > 0 && !(sp.disable == 2 && c.slice[a - 1] != c.slice[a]);
    const bool top = my > 0 && !(sp.disable == 2 && c.slice[a - c.mbw] != c.slice[a]);
    const int W = c.W, CW = W / 2;
    for (int dir = 0; dir < 2; ++dir) {   // 0: vertical edges, 1: horizontal
        for (int e = 0; e < 4; ++e) {
            if (e == 0 && !(dir ? top : left)) continue;
            const std::size_t pa = e ? a : dir ? a - c.mbw : a - 1;
            int bs[4];
            bool any = false;
            for (int k = 0; k < 4; ++k) {
                const int qb = dir ? e * 4 + k : k * 4 + e;
                const int pb = dir ? ((e + 3) & 3) * 4 + k : k * 4 + ((e + 3) & 3);
                bs[k] = strength(c, pa, pb, a, qb, e == 0);
                any |= bs[k] != 0;
            }
            if (!any) continue;
            const int qpp = c.qp[pa], qpq = c.qp[a];
            {
                const int qav = (qpp + qpq + 1) >> 1;
                const int ia = clip3(0, 51, qav + sp.off_a), ib = clip3(0, 51, qav + sp.off_b);
                const int alpha = kAlpha[ia], beta = kBeta[ib];
                for (int k = 0; k < 4; ++k) {
                    if (!bs[k]) continue;
                    const int tc0 = bs[k] < 4 ? kTc0[ia][bs[k] - 1] : 0;
                    for (int i = 0; i < 4; ++i) {
                        u8* q = dir ? &c.y[(my * 16 + e * 4) * std::size_t(W) + mx * 16 + k * 4 + i]
                                    : &c.y[(my * 16 + k * 4 + i) * std::size_t(W) + mx * 16 + e * 4];
                        filter_luma(q, dir ? W : 1, bs[k], alpha, beta, tc0);
                    }
                }
            }
            if (e & 1) continue;   // chroma edges 0 and 2 (chroma 0 and 4)
            for (int comp = 0; comp < 2; ++comp) {
                const int cp = chroma_qp(sp, qpp, comp), cq = chroma_qp(sp, qpq, comp);
                const int qav = (cp + cq + 1) >> 1;
                const int ia = clip3(0, 51, qav + sp.off_a), ib = clip3(0, 51, qav + sp.off_b);
                const int alpha = kAlpha[ia], beta = kBeta[ib];
                std::vector<u8>& pl = comp ? c.v : c.u;
                for (int k = 0; k < 4; ++k) {
                    if (!bs[k]) continue;
                    const int tc0 = bs[k] < 4 ? kTc0[ia][bs[k] - 1] : 0;
                    for (int i = 0; i < 2; ++i) {
                        u8* q = dir ? &pl[(my * 8 + e * 2) * std::size_t(CW) + mx * 8 + k * 2 + i]
                                    : &pl[(my * 8 + k * 2 + i) * std::size_t(CW) + mx * 8 + e * 2];
                        filter_chroma(q, dir ? CW : 1, bs[k], alpha, beta, tc0);
                    }
                }
            }
        }
    }
}

// the deblocking of a picture, MB row by MB row in a wavefront on up to
// nthreads threads: MB (x, y) filters the bottom rows of (x, y - 1) and
// reads what (x + 1, y - 1)'s left edge filtered, so a row runs two MBs
// behind the one above it (rows are taken in order: the row a thread
// waits on is always being filtered)
void deblock(Slot& c, const SliceParams* sps, int nthreads = 1) {
    if (nthreads <= 1 || c.mbh < 2) {
        for (int my = 0; my < c.mbh; ++my)
            for (int mx = 0; mx < c.mbw; ++mx) deblock_mb(c, sps, mx, my);
        return;
    }
    std::vector<std::atomic<int>> done(c.mbh);
    for (auto& d : done) d.store(0);
    parallel_items(c.mbh, nthreads, [&](std::size_t row) {
        const int my = static_cast<int>(row);
        for (int mx = 0; mx < c.mbw; ++mx) {
            if (my) {
                const int need = std::min(mx + 2, c.mbw);
                while (done[my - 1].load(std::memory_order_acquire) < need) std::this_thread::yield();
            }
            deblock_mb(c, sps, mx, my);
            done[my].store(mx + 1, std::memory_order_release);
        }
    });
}

// ---------------------------------------------------------------- decoder

struct Decoder {
    int mbw, mbh;
    std::vector<std::unique_ptr<Slot>> slots;
    Decoder(int mbw_, int mbh_, int n) : mbw(mbw_), mbh(mbh_) {
        for (int i = 0; i < n; ++i) slots.emplace_back(new Slot(mbw, mbh));
    }
};

struct SliceJob {
    const u8* rbsp;
    std::size_t size, end_bit, bit;
    SliceParams sp;
};

struct PicJob {
    int slot = 0, chain = 0;
    std::vector<SliceJob> slices;
};

// decode one picture: its slices (a thread each, up to nthreads), then
// the deblocking; 0 or a return code, *where the MB
int decode_picture(Decoder& dec, PicJob& pj, int nthreads, int* where) {
    Slot& c = *dec.slots[pj.slot];
    c.reset();
    const std::size_t ns = pj.slices.size();
    std::vector<int> rcs(ns, 0), wh(ns, -1);
    std::vector<SliceParams> sps(ns);
    for (std::size_t i = 0; i < ns; ++i) sps[i] = pj.slices[i].sp;
    // slices that overlap or run into each other are found by the slice
    // map; slices decode side by side only where they start in order
    bool ordered = true;
    for (std::size_t i = 1; i < ns; ++i)
        ordered &= pj.slices[i].sp.first_mb > pj.slices[i - 1].sp.first_mb;
    auto run = [&](std::size_t i) {
        SliceCtx s;
        s.cur = &c;
        s.sp = pj.slices[i].sp;
        s.index = static_cast<int>(i);
        for (int r = 0; r < s.sp.nref && r < 32; ++r)
            s.refs[r] = s.sp.refs[r] >= 0 ? dec.slots[s.sp.refs[r]].get() : nullptr;
        std::vector<u8> buf(pj.slices[i].size + 8, 0);
        std::memcpy(buf.data(), pj.slices[i].rbsp, pj.slices[i].size);
        rcs[i] = decode_slice(s, buf.data(), pj.slices[i].end_bit, pj.slices[i].bit, &wh[i]);
    };
    if (ordered && ns > 1 && nthreads > 1) {
        // a slice marks its MBs as it goes; one that runs into the next
        // slice's first MB is refused there (kOverlap) whichever thread
        // comes first, so each slice is bounded by the next one's start
        parallel_items(ns, nthreads, run);
    } else {
        for (std::size_t i = 0; i < ns; ++i) run(i);
    }
    for (std::size_t i = 0; i < ns; ++i)
        if (rcs[i]) {
            *where = wh[i];
            return rcs[i];
        }
    const int nmb = c.mbw * c.mbh;
    for (int a = 0; a < nmb; ++a)
        if (c.slice[a] < 0) {
            *where = a;
            return kMissing;
        }
    deblock(c, sps.data(), nthreads);
    return 0;
}

}  // namespace

extern "C" {

void* clt_h264_new(int mbw, int mbh, int slots) {
    if (mbw <= 0 || mbh <= 0 || slots <= 0 || mbw > 1024 || mbh > 1024) return nullptr;
    tables();
    return new Decoder(mbw, mbh, slots);
}

void clt_h264_free(void* h) { delete static_cast<Decoder*>(h); }

// Grow the decoder to n frame slots (the pictures in its slots stay).
void clt_h264_grow(void* h, int n) {
    Decoder& d = *static_cast<Decoder*>(h);
    while (static_cast<int>(d.slots.size()) < n) d.slots.emplace_back(new Slot(d.mbw, d.mbh));
}

// Decode k pictures.  Picture i goes into frame slot pic[3 i], is of chain
// pic[3 i + 1] (a chain: pictures that reference each other, decoded in
// order; chains go side by side, a thread each) and has pic[3 i + 2]
// slices, which follow the previous picture's in the slice arrays: slice
// j's RBSP srcs[j] (sizes[j] bytes; its stop bit at bit ends[j]), its
// slice data from bit bits[j], its kParams parameters at params[kParams j].
// rcs[i] gets 0 or a return code, wheres[i] the macroblock.
void clt_h264_decode_batch(void* h, const int* pic, std::size_t k, const unsigned char* const* srcs,
                           const std::size_t* sizes, const std::size_t* ends,
                           const std::size_t* bits, const int* params, int nthreads, int* rcs,
                           int* wheres) {
    Decoder& dec = *static_cast<Decoder*>(h);
    std::vector<PicJob> jobs(k);
    std::size_t j = 0;
    for (std::size_t i = 0; i < k; ++i) {
        jobs[i].slot = pic[3 * i];
        jobs[i].chain = pic[3 * i + 1];
        const int ns = pic[3 * i + 2];
        for (int s = 0; s < ns; ++s, ++j) {
            SliceJob sj;
            sj.rbsp = srcs[j];
            sj.size = sizes[j];
            sj.end_bit = ends[j];
            sj.bit = bits[j];
            const int* p = params + kParams * j;
            sj.sp.first_mb = p[0];
            sj.sp.type = p[1];
            sj.sp.qp = p[2];
            sj.sp.disable = p[3];
            sj.sp.off_a = p[4];
            sj.sp.off_b = p[5];
            sj.sp.cqp[0] = p[6];
            sj.sp.cqp[1] = p[7];
            sj.sp.cip = p[8];
            sj.sp.nref = p[9];
            for (int r = 0; r < 32; ++r) {
                sj.sp.refs[r] = p[10 + r];
                sj.sp.ids[r] = p[42 + r];
            }
            jobs[i].slices.push_back(sj);
        }
        rcs[i] = 0;
        wheres[i] = -1;
    }
    // the chains, in order of first appearance
    std::vector<int> chains;
    for (const PicJob& pj : jobs)
        if (std::find(chains.begin(), chains.end(), pj.chain) == chains.end())
            chains.push_back(pj.chain);
    const int per = std::max(1, nthreads / std::max<int>(1, static_cast<int>(chains.size())));
    parallel_items(chains.size(), nthreads, [&](std::size_t ci) {
        bool lost = false;
        for (std::size_t i = 0; i < k; ++i) {
            if (jobs[i].chain != chains[ci]) continue;
            if (lost) {
                rcs[i] = kLost;
                continue;
            }
            rcs[i] = decode_picture(dec, jobs[i], per, &wheres[i]);
            lost = rcs[i] != 0;
        }
    });
}

// Copy the cropped planes of slot `slot` (rows [top, top + height),
// columns [left, left + width) of luma; chroma at half) into dst as
// yuv420p: Y, then U, then V.
void clt_h264_output(void* h, int slot, int top, int left, int height, int width,
                     unsigned char* dst) {
    const Slot& c = *static_cast<Decoder*>(h)->slots[slot];
    for (int y = 0; y < height; ++y)
        std::memcpy(dst + std::size_t(y) * width, &c.y[std::size_t(top + y) * c.W + left], width);
    const int ch = (height + 1) / 2, cw = (width + 1) / 2, CW = c.W / 2;
    unsigned char* u = dst + std::size_t(height) * width;
    unsigned char* v = u + std::size_t(ch) * cw;
    for (int y = 0; y < ch; ++y) {
        std::memcpy(u + std::size_t(y) * cw, &c.u[std::size_t(top / 2 + y) * CW + left / 2], cw);
        std::memcpy(v + std::size_t(y) * cw, &c.v[std::size_t(top / 2 + y) * CW + left / 2], cw);
    }
}

int clt_h264_version() { return 1; }

}  // extern "C"
