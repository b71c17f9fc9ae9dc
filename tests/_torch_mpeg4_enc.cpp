// The MPEG-4 Part 2 encoder of tests/_torch_mpeg4_writer.py for the plans
// of its smoke_plan (intra I-VOPs with the DC through its own VLC, no AC
// prediction; P-VOPs whose macroblocks are all 1MV of zero vectors; B-VOPs
// whose macroblocks are all direct with a zero delta over such a P-VOP or
// an I-VOP; one quantiser, no video packets; H.263 or MPEG quantisation,
// the simple or the Xvid IDCT): the same levels (the integer forward DCT
// and quantisers of the writer), the same macroblock-layer bits after the
// VOP header the writer hands over, and the same reconstruction (FFmpeg's
// IDCT, put for intra blocks and added to the prediction for inter ones: the
// reference, or a B-VOP's average of both), a frame a call.  chip_smoke.py
// encodes its 4K videos with it; tests/test_torch_mpeg4.py and
// tests/test_torch_mpeg4_asp.py hold it to the Python writer byte for
// byte.
//
// Built with g++ into build/native/ by the writer's native_entropy().

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr std::uint8_t kIntraMcbpc[4][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}};
constexpr std::uint8_t kInterMcbpc[4][2] = {{1, 1}, {3, 4}, {2, 4}, {5, 6}};
constexpr std::uint8_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                                       {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                                       {4, 4}, {8, 4}, {6, 4}, {3, 2}};
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
constexpr std::uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
constexpr std::uint8_t kYDcScale[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18,
                                        19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                                        30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
constexpr std::uint8_t kCDcScale[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11,
                                        12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17,
                                        17, 18, 18, 19, 20, 21, 22, 23, 24, 25};

// A TCOEF table's codes by (last, run, level), and max_level / max_run.
struct Table {
    int code[2][64][28], len[2][64][28];
    int max_level[2][65], max_run[2][65];
    std::uint16_t esc[2];
};

void fill(Table& t, const std::uint16_t (*vlc)[2], const int (*rows)[2], int nrows_last0,
          int nrows) {
    std::memset(&t, 0, sizeof t);
    int i = 0;
    for (int r = 0; r < nrows; ++r) {
        const int last = r >= nrows_last0, run = rows[r][0], top = rows[r][1];
        for (int v = 1; v <= top; ++v, ++i) {
            t.code[last][run][v] = vlc[i][0];
            t.len[last][run][v] = vlc[i][1];
            t.max_level[last][run] = std::max(t.max_level[last][run], v);
            t.max_run[last][v] = std::max(t.max_run[last][v], run);
        }
    }
    t.esc[0] = vlc[102][0];
    t.esc[1] = vlc[102][1];
}

struct Tables {
    Table intra, inter;
    Tables() {
        static const int ri[][2] = {{0, 27}, {1, 10}, {2, 5},  {3, 4},  {4, 3},  {5, 3},  {6, 3},
                                    {7, 3},  {8, 2},  {9, 2},  {10, 1}, {11, 1}, {12, 1}, {13, 1},
                                    {14, 1}, {0, 8},  {1, 3},  {2, 2},  {3, 2},  {4, 2},  {5, 2},
                                    {6, 2},  {7, 1},  {8, 1},  {9, 1},  {10, 1}, {11, 1}, {12, 1},
                                    {13, 1}, {14, 1}, {15, 1}, {16, 1}, {17, 1}, {18, 1}, {19, 1},
                                    {20, 1}};
        fill(intra, kIntraVlc, ri, 15, 36);
        static int rp[100][2];
        int n = 0;
        const int head[][2] = {{0, 12}, {1, 6}, {2, 4}, {3, 3}, {4, 3}, {5, 3}, {6, 3},
                               {7, 2},  {8, 2}, {9, 2}, {10, 2}};
        for (auto& h : head) { rp[n][0] = h[0]; rp[n][1] = h[1]; ++n; }
        for (int r = 11; r < 27; ++r) { rp[n][0] = r; rp[n][1] = 1; ++n; }
        const int not_last = n;
        rp[n][0] = 0; rp[n][1] = 3; ++n;
        rp[n][0] = 1; rp[n][1] = 2; ++n;
        for (int r = 2; r < 41; ++r) { rp[n][0] = r; rp[n][1] = 1; ++n; }
        fill(inter, kInterVlc, rp, not_last, n);
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// An MSB-first bit writer.
struct Writer {
    std::vector<std::uint8_t> out;
    std::uint64_t acc = 0;
    int n = 0;   // bits in acc
    std::size_t bits = 0;
    void put(std::uint32_t code, int len) {
        if (!len) return;
        acc = acc << len | (code & ((std::uint64_t{1} << len) - 1));
        n += len;
        bits += len;
        while (n >= 8) {
            out.push_back(static_cast<std::uint8_t>(acc >> (n - 8)));
            n -= 8;
        }
    }
    void stuff() {
        const int pad = bits % 8 ? 7 - static_cast<int>(bits % 8) : 7;
        put(0, 1);
        put((1u << pad) - 1, pad);
    }
};

void tcoef(Writer& w, const Table& t, int last, int run, int level) {
    const int mag = std::abs(level), sign = level < 0;
    if (mag < 28 && run < 64 && t.len[last][run][mag]) {
        w.put(t.code[last][run][mag], t.len[last][run][mag]);
        w.put(sign, 1);
        return;
    }
    const int top = run < 65 ? t.max_level[last][run] : 0;
    if (top && mag > top && mag - top < 28 && t.len[last][run][mag - top]) {
        w.put(t.esc[0], t.esc[1]);
        w.put(0, 1);
        w.put(t.code[last][run][mag - top], t.len[last][run][mag - top]);
        w.put(sign, 1);
        return;
    }
    if (mag < 65 && t.max_level[last][0] >= mag) {
        const int mr = t.max_run[last][mag];
        if (run > mr && t.len[last][run - mr - 1][mag]) {
            w.put(t.esc[0], t.esc[1]);
            w.put(2, 2);
            w.put(t.code[last][run - mr - 1][mag], t.len[last][run - mr - 1][mag]);
            w.put(sign, 1);
            return;
        }
    }
    w.put(t.esc[0], t.esc[1]);
    w.put(3, 2);
    w.put(last, 1);
    w.put(run, 6);
    w.put(1, 1);
    w.put(static_cast<std::uint32_t>(level) & 0xFFF, 12);
    w.put(1, 1);
}

// the TCOEF events of levels in zigzag order from `start`
void events(Writer& w, const Table& t, const std::int64_t* lv, int start) {
    int idx[64], k = 0;
    for (int i = start; i < 64; ++i)
        if (lv[kZigzag[i]]) idx[k++] = i;
    int prev = start - 1;
    for (int j = 0; j < k; ++j) {
        tcoef(w, t, j == k - 1, idx[j] - prev - 1, static_cast<int>(lv[kZigzag[idx[j]]]));
        prev = idx[j];
    }
}

// the writer's integer DCT weights: rint(c(u) / 2 cos((2x + 1) u pi / 16) 2^14)
struct Dct {
    std::int64_t c[8][8];
    Dct() {
        for (int u = 0; u < 8; ++u)
            for (int x = 0; x < 8; ++x)
                c[u][x] = std::llrint((u ? 1.0 : std::sqrt(0.5)) / 2 *
                                      std::cos((2 * x + 1) * u * M_PI / 16) * 16384.0);
    }
};

void fdct(const int* f, std::int64_t* out) {
    static const Dct d;
    std::int64_t t[8][8];
    for (int u = 0; u < 8; ++u)
        for (int col = 0; col < 8; ++col) {
            std::int64_t s = 0;
            for (int row = 0; row < 8; ++row) s += d.c[u][row] * f[row * 8 + col];
            t[u][col] = s;
        }
    for (int u = 0; u < 8; ++u)
        for (int v = 0; v < 8; ++v) {
            std::int64_t s = 0;
            for (int col = 0; col < 8; ++col) s += t[u][col] * d.c[v][col];
            out[u * 8 + v] = s;
        }
}

inline std::int64_t floordiv(std::int64_t a, std::int64_t b) {
    const std::int64_t q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// simple_idct's sums (native/mpeg4.cpp's idct_sums)
constexpr std::uint32_t kW1 = 22725, kW2 = 21407, kW3 = 19266, kW4 = 16383,
                        kW5 = 12873, kW6 = 8867, kW7 = 4520;
inline int i16(int v) { return static_cast<std::int16_t>(static_cast<std::uint16_t>(v)); }
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

void idct_sums(const std::int16_t* in, std::int32_t* out) {
    std::int32_t x[8][8], o[8][8], y[8][8];
    std::uint32_t a[8];
    for (int r = 0; r < 8; ++r)
        for (int k = 0; k < 8; ++k) x[k][r] = in[8 * r + k];
    for (int r = 0; r < 8; ++r) a[r] = kW4 * static_cast<std::uint32_t>(x[0][r]) + (1u << 10);
    lanes(x, a, o);
    for (int r = 0; r < 8; ++r) {
        const bool any = x[1][r] | x[2][r] | x[3][r] | x[4][r] | x[5][r] | x[6][r] | x[7][r];
        const std::int32_t d = i16(x[0][r] * 8);
        for (int c = 0; c < 8; ++c) y[r][c] = any ? sat16(o[c][r] >> 11) : d;
    }
    for (int c = 0; c < 8; ++c) a[c] = kW4 * static_cast<std::uint32_t>(i16(y[0][c] + 32));
    lanes(y, a, o);
    for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c) out[8 * r + c] = o[r][c] >> 20;
}

inline std::uint8_t clip255(int v) { return static_cast<std::uint8_t>(std::min(std::max(v, 0), 255)); }

// the Xvid IDCT as native/mpeg4.cpp's xvid_idct_sums
constexpr int kXvidTab[4][7] = {{22725, 21407, 19266, 16384, 12873, 8867, 4520},
                                {31521, 29692, 26722, 22725, 17855, 12299, 6270},
                                {29692, 27969, 25172, 21407, 16819, 11585, 5906},
                                {26722, 25172, 22654, 19266, 15137, 10426, 5315}};
constexpr int kXvidRowTab[8] = {0, 1, 2, 3, 0, 3, 2, 1};
constexpr std::uint32_t kXvidRnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
inline int mulhi(int a, int c) { return (a * c) >> 16; }
inline std::uint32_t u32(int v) { return static_cast<std::uint32_t>(v); }

void xvid_idct_sums(const std::int16_t* in, std::int32_t* out) {
    int x[8][8];
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

// native/mpeg4.cpp's dequant_mpeg_intra / _inter on 64-bit levels
void dequant_mpeg_intra(const std::int64_t* b, int q, int dc_scale, const int* m, std::int16_t* out) {
    out[0] = static_cast<std::int16_t>(b[0] * dc_scale);
    for (int i = 1; i < 64; ++i) {
        const int v = static_cast<std::int16_t>(b[i]);
        if (!v) {
            out[i] = 0;
            continue;
        }
        const int qw = (2 * q * m[i]) & 0xFFFF;
        const int p = i16(abs16(v) * qw) >> 4;
        out[i] = static_cast<std::int16_t>(v < 0 ? -p : p);
    }
}

void dequant_mpeg_inter(const std::int64_t* b, int q, const int* m, std::int16_t* out) {
    int sum = -1;
    for (int i = 0; i < 64; ++i) {
        const int v = static_cast<std::int16_t>(b[i]);
        if (!v) {
            out[i] = 0;
            continue;
        }
        const int qw = (2 * q * m[i]) & 0xFFFF;
        const int p = ((((2 * abs16(v)) & 0xFFFF) * qw + qw) & 0xFFFF) >> 5;
        out[i] = static_cast<std::int16_t>(v < 0 ? -p : p);
        sum += out[i];
    }
    out[63] = static_cast<std::int16_t>(out[63] ^ (sum & 1));
}

}  // namespace

extern "C" {

// Encode one smoke-plan VOP of the visible planes y (h x w), u and v
// ((h + 1) / 2 x (w + 1) / 2): kind 0 an intra I-VOP, 1 a P-VOP of zero
// vectors against ref, 2 a B-VOP of direct macroblocks with a zero delta
// between fwd and ref (its latest reference a P-VOP of zero vectors or an
// I-VOP: each macroblock predicted by the two references' average at its
// place); ref and fwd are the macroblock-aligned Y, U and V planes, one
// after another; quant the quantiser; mpeg 1 for quant_type 1 with the
// intra then inter matrices (natural order) in mats; xvid 1 for the Xvid
// IDCT.  The macroblock layer follows the first prefix_bits bits of prefix
// (the headers and the VOP header, which the Python writer makes), then
// stuffing; the chunk goes to out (cap bytes) and the reconstruction,
// macroblock-aligned like ref, to recon.  Returns the chunk's size, or -1
// where cap is too small.
long long clt_mpeg4_enc_layer(int kind, const std::uint8_t* y, const std::uint8_t* u,
                              const std::uint8_t* v, int h, int w, int quant,
                              const std::uint8_t* prefix, long long prefix_bits,
                              const std::uint8_t* ref, const std::uint8_t* fwd, std::uint8_t* recon,
                              int mpeg, const int* mats, int xvid, std::uint8_t* out,
                              std::size_t cap) {
    const Tables& T = tables();
    const int mbw = (w + 15) / 16, mbh = (h + 15) / 16, h2 = (h + 1) / 2, w2 = (w + 1) / 2;
    const int ls = 16 * mbw, cs = 8 * mbw;
    const std::size_t lsize = static_cast<std::size_t>(ls) * 16 * mbh,
                      csize = static_cast<std::size_t>(cs) * 8 * mbh;
    // the source, padded by replicating its last row and column
    auto src = [&](int c, int row, int col) -> int {
        const std::uint8_t* p = c == 0 ? y : c == 1 ? u : v;
        const int ph = c ? h2 : h, pw = c ? w2 : w;
        return p[static_cast<std::size_t>(std::min(row, ph - 1)) * pw + std::min(col, pw - 1)];
    };
    auto idct = xvid ? xvid_idct_sums : idct_sums;
    const int* im = mats;
    const int* pm = mats + 64;
    Writer wr;
    for (long long i = 0; i < prefix_bits; i += 8) {
        const int n = static_cast<int>(std::min<long long>(8, prefix_bits - i));
        wr.put(prefix[i / 8] >> (8 - n), n);
    }
    const int q = quant, qmul = 2 * q, qadd = (q - 1) | 1;
    const int top = (2047 - qadd) / (2 * q);
    const std::int64_t one = std::int64_t{1} << 28;
    // DC predictors (an I-VOP from scratch: the first row's rules)
    const int wrap = 2 * mbw + 1, cwrap = mbw + 1;
    std::vector<int> dcl(static_cast<std::size_t>(2 * mbh + 1) * wrap + 1, 1024),
        dcc[2] = {std::vector<int>(static_cast<std::size_t>(mbh + 1) * cwrap + 1, 1024),
                  std::vector<int>(static_cast<std::size_t>(mbh + 1) * cwrap + 1, 1024)};
    int f[64], pred[64];
    std::int64_t coef[64], lv[6][64];
    std::int16_t deq[64];
    std::int32_t sums[64];
    for (int my = 0; my < mbh; ++my)
        for (int mx = 0; mx < mbw; ++mx) {
            const bool first_line = my == 0;
            int cbp = 0;
            for (int n = 0; n < 6; ++n) {
                const int c = n < 4 ? 0 : n - 3;
                const int r0 = n < 4 ? 16 * my + 8 * (n >> 1) : 8 * my;
                const int c0 = n < 4 ? 16 * mx + 8 * (n & 1) : 8 * mx;
                const std::size_t off = c == 0 ? 0 : c == 1 ? lsize : lsize + csize;
                const int stride = c ? cs : ls;
                for (int r = 0; r < 8; ++r)
                    for (int k = 0; k < 8; ++k) {
                        const std::size_t at = off + static_cast<std::size_t>(r0 + r) * stride + c0 + k;
                        pred[r * 8 + k] = kind == 0 ? 0 : kind == 1 ? ref[at] : (fwd[at] + ref[at] + 1) >> 1;
                        f[r * 8 + k] = src(c, r0 + r, c0 + k) - pred[r * 8 + k];
                    }
                fdct(f, coef);
                bool any = false;
                if (!kind) {
                    const std::int64_t d0 = (n < 4 ? kYDcScale[q] : kCDcScale[q]) * one;
                    lv[n][0] = floordiv(coef[0] + d0 / 2, d0);
                    for (int i = 1; i < 64; ++i) {
                        std::int64_t m;
                        if (mpeg) {
                            const std::int64_t qw = 2 * q * im[i];
                            const std::int64_t d = std::max<std::int64_t>(qw, 1) * one;
                            const std::int64_t lim = std::min<std::int64_t>(
                                std::min<std::int64_t>(2047 * 16 / std::max<std::int64_t>(qw, 1),
                                                       32767 / std::max<std::int64_t>(qw, 1)), 2047);
                            m = qw > 0 ? std::min<std::int64_t>((16 * std::llabs(coef[i]) + d / 2) / d, lim) : 0;
                        } else {
                            const std::int64_t d = 2 * q * one;
                            m = std::min<std::int64_t>((std::llabs(coef[i]) + d / 2) / d, top);
                        }
                        lv[n][i] = coef[i] < 0 ? -m : m;
                        any |= m != 0;
                    }
                } else {
                    for (int i = 0; i < 64; ++i) {
                        std::int64_t m;
                        if (mpeg) {
                            const std::int64_t qw = 2 * q * pm[i];
                            const std::int64_t d = std::max<std::int64_t>(qw, 1) * one;
                            const std::int64_t qq = std::max<std::int64_t>(qw, 1);
                            const std::int64_t lim = std::min<std::int64_t>(
                                std::min<std::int64_t>((2047 * 32 / qq - 1) / 2, (65535 / qq - 1) / 2), 2047);
                            m = qw > 0 ? std::min<std::int64_t>(std::max<std::int64_t>(64 * std::llabs(coef[i]) - d, 0) / (4 * d), lim) : 0;
                        } else {
                            const std::int64_t d = 2 * q * one;
                            m = std::min<std::int64_t>(std::max<std::int64_t>(std::llabs(coef[i]) - d / 4, 0) / d, top);
                        }
                        lv[n][i] = coef[i] < 0 ? -m : m;
                        any |= m != 0;
                    }
                }
                if (any) cbp |= 32 >> n;
                // the reconstruction
                std::uint8_t* dst = recon + off;
                if (!kind) {
                    if (mpeg) {
                        dequant_mpeg_intra(lv[n], q, n < 4 ? kYDcScale[q] : kCDcScale[q], im, deq);
                    } else {
                        deq[0] = static_cast<std::int16_t>(lv[n][0] * (n < 4 ? kYDcScale[q] : kCDcScale[q]));
                        for (int i = 1; i < 64; ++i)
                            deq[i] = lv[n][i] ? static_cast<std::int16_t>(lv[n][i] > 0 ? lv[n][i] * qmul + qadd : lv[n][i] * qmul - qadd) : 0;
                    }
                    idct(deq, sums);
                    for (int r = 0; r < 8; ++r)
                        for (int k = 0; k < 8; ++k)
                            dst[static_cast<std::size_t>(r0 + r) * stride + c0 + k] = clip255(sums[r * 8 + k]);
                } else {
                    const bool coded = cbp & (32 >> n);
                    if (coded) {
                        if (mpeg) {
                            dequant_mpeg_inter(lv[n], q, pm, deq);
                        } else {
                            for (int i = 0; i < 64; ++i)
                                deq[i] = lv[n][i] ? static_cast<std::int16_t>(lv[n][i] > 0 ? lv[n][i] * qmul + qadd : lv[n][i] * qmul - qadd) : 0;
                        }
                        idct(deq, sums);
                    }
                    for (int r = 0; r < 8; ++r)
                        for (int k = 0; k < 8; ++k) {
                            const std::size_t at = static_cast<std::size_t>(r0 + r) * stride + c0 + k;
                            dst[at] = coded ? clip255(pred[r * 8 + k] + sums[r * 8 + k]) : pred[r * 8 + k];
                        }
                }
            }
            // the macroblock's bits
            if (!kind) {
                wr.put(kIntraMcbpc[cbp & 3][0], kIntraMcbpc[cbp & 3][1]);
                wr.put(0, 1);   // ac_pred_flag
                wr.put(kCbpy[cbp >> 2][0], kCbpy[cbp >> 2][1]);
                for (int n = 0; n < 6; ++n) {
                    int scale, idx, wp;
                    int* d;
                    if (n < 4) {
                        scale = kYDcScale[q];
                        wp = wrap;
                        idx = wrap + 1 + (2 * my + (n >> 1)) * wrap + 2 * mx + (n & 1);
                        d = dcl.data();
                    } else {
                        scale = kCDcScale[q];
                        wp = cwrap;
                        idx = cwrap + 1 + my * cwrap + mx;
                        d = dcc[n - 4].data();
                    }
                    int a = d[idx - 1], b = d[idx - 1 - wp], cc = d[idx - wp];
                    if (first_line && n != 3) {
                        if (n != 2) b = cc = 1024;
                        if (n != 1 && mx == 0) b = a = 1024;
                    }
                    if (mx == 0 && my == 1 && (n == 0 || n == 4 || n == 5)) b = 1024;
                    const int pr = ((std::abs(a - b) < std::abs(b - cc) ? cc : a) + (scale >> 1)) / scale;
                    const int level = static_cast<int>(lv[n][0]);
                    const int diff = level - pr;
                    int stored = level * scale;
                    if (stored & ~2047) stored = stored < 0 ? 0 : 2047;
                    d[idx] = stored;
                    const int mag = std::abs(diff);
                    const int size = mag ? 32 - __builtin_clz(static_cast<unsigned>(mag)) : 0;
                    const auto& dc = n < 4 ? kDcLum[size] : kDcChrom[size];
                    wr.put(dc[0], dc[1]);
                    if (size) {
                        wr.put(static_cast<std::uint32_t>(diff > 0 ? diff : diff + (1 << size) - 1), size);
                        if (size > 8) wr.put(1, 1);
                    }
                    if (cbp & (32 >> n)) events(wr, T.intra, lv[n], 1);
                }
            } else if (kind == 1) {
                wr.put(0, 1);   // coded
                wr.put(kInterMcbpc[cbp & 3][0], kInterMcbpc[cbp & 3][1]);
                const int cy = (cbp >> 2) ^ 15;
                wr.put(kCbpy[cy][0], kCbpy[cy][1]);
                wr.put(1, 1);   // the zero vector: both differences 0
                wr.put(1, 1);
                for (int n = 0; n < 6; ++n)
                    if (cbp & (32 >> n)) events(wr, T.inter, lv[n], 0);
            } else {
                wr.put(0, 1);          // modb
                wr.put(cbp == 0, 1);   // modb2: no cbpb
                wr.put(1, 1);          // mb_type: direct
                if (cbp) wr.put(static_cast<std::uint32_t>(cbp), 6);
                wr.put(1, 1);          // the zero delta
                wr.put(1, 1);
                for (int n = 0; n < 6; ++n)
                    if (cbp & (32 >> n)) events(wr, T.inter, lv[n], 0);
            }
        }
    wr.stuff();
    if (wr.out.size() > cap) return -1;
    std::memcpy(out, wr.out.data(), wr.out.size());
    return static_cast<long long>(wr.out.size());
}

}  // extern "C"
