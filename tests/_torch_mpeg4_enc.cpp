// The MPEG-4 Part 2 encoder of tests/_torch_mpeg4_writer.py for the plans
// of its smoke_plan (intra I-VOPs with the DC through its own VLC, no AC
// prediction; P-VOPs whose macroblocks are all 1MV of zero vectors; one
// quantiser, no video packets): the same levels (the integer forward DCT
// and quantisers of the writer), the same macroblock-layer bits after the
// VOP header the writer hands over, and the same reconstruction (FFmpeg's
// simple IDCT, put for intra blocks and added to the reference for inter
// ones), a frame a call.  chip_smoke.py encodes its 4K videos with it;
// tests/test_torch_mpeg4.py holds it to the Python writer byte for byte.
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

}  // namespace

extern "C" {

// Encode one smoke-plan VOP of the visible planes y (h x w), u and v
// ((h + 1) / 2 x (w + 1) / 2): kind 0 an intra I-VOP, 1 a P-VOP of zero
// vectors against ref (the macroblock-aligned Y, U and V planes, one after
// another); quant its quantiser.  The macroblock layer follows the first
// prefix_bits bits of prefix (the headers and the VOP header, which the
// Python writer makes), then stuffing; the chunk goes to out (cap bytes)
// and the reconstruction, macroblock-aligned like ref, to recon.  Returns
// the chunk's size, or -1 where cap is too small.
long long clt_mpeg4_enc_layer(int kind, const std::uint8_t* y, const std::uint8_t* u,
                              const std::uint8_t* v, int h, int w, int quant,
                              const std::uint8_t* prefix, long long prefix_bits,
                              const std::uint8_t* ref, std::uint8_t* recon,
                              std::uint8_t* out, std::size_t cap) {
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
    int f[64];
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
                const std::uint8_t* rp = kind ? ref + (c == 0 ? 0 : c == 1 ? lsize : lsize + csize) : nullptr;
                const int stride = c ? cs : ls;
                for (int r = 0; r < 8; ++r)
                    for (int k = 0; k < 8; ++k)
                        f[r * 8 + k] = src(c, r0 + r, c0 + k) -
                                       (kind ? rp[static_cast<std::size_t>(r0 + r) * stride + c0 + k] : 0);
                fdct(f, coef);
                if (!kind) {
                    const std::int64_t d0 = (n < 4 ? kYDcScale[q] : kCDcScale[q]) * one;
                    lv[n][0] = floordiv(coef[0] + d0 / 2, d0);
                    const std::int64_t d = 2 * q * one;
                    for (int i = 1; i < 64; ++i) {
                        const std::int64_t m = std::min<std::int64_t>((std::llabs(coef[i]) + d / 2) / d, top);
                        lv[n][i] = coef[i] < 0 ? -m : m;
                    }
                    bool any = false;
                    for (int i = 1; i < 64; ++i) any |= lv[n][i] != 0;
                    if (any) cbp |= 32 >> n;
                } else {
                    const std::int64_t d = 2 * q * one;
                    bool any = false;
                    for (int i = 0; i < 64; ++i) {
                        const std::int64_t m = std::min<std::int64_t>(std::max<std::int64_t>(std::llabs(coef[i]) - d / 4, 0) / d, top);
                        lv[n][i] = coef[i] < 0 ? -m : m;
                        any |= m != 0;
                    }
                    if (any) cbp |= 32 >> n;
                }
                // the reconstruction
                std::uint8_t* dst = recon + (c == 0 ? 0 : c == 1 ? lsize : lsize + csize);
                if (!kind) {
                    deq[0] = static_cast<std::int16_t>(lv[n][0] * (n < 4 ? kYDcScale[q] : kCDcScale[q]));
                    for (int i = 1; i < 64; ++i)
                        deq[i] = lv[n][i] ? static_cast<std::int16_t>(lv[n][i] > 0 ? lv[n][i] * qmul + qadd : lv[n][i] * qmul - qadd) : 0;
                    idct_sums(deq, sums);
                    for (int r = 0; r < 8; ++r)
                        for (int k = 0; k < 8; ++k)
                            dst[static_cast<std::size_t>(r0 + r) * stride + c0 + k] = clip255(sums[r * 8 + k]);
                } else {
                    const bool coded = cbp & (32 >> n);
                    if (coded) {
                        for (int i = 0; i < 64; ++i)
                            deq[i] = lv[n][i] ? static_cast<std::int16_t>(lv[n][i] > 0 ? lv[n][i] * qmul + qadd : lv[n][i] * qmul - qadd) : 0;
                        idct_sums(deq, sums);
                    }
                    for (int r = 0; r < 8; ++r)
                        for (int k = 0; k < 8; ++k) {
                            const std::size_t at = static_cast<std::size_t>(r0 + r) * stride + c0 + k;
                            dst[at] = coded ? clip255(rp[at] + sums[r * 8 + k]) : rp[at];
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
                    const int pred = ((std::abs(a - b) < std::abs(b - cc) ? cc : a) + (scale >> 1)) / scale;
                    const int level = static_cast<int>(lv[n][0]);
                    const int diff = level - pred;
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
            } else {
                wr.put(0, 1);   // coded
                wr.put(kInterMcbpc[cbp & 3][0], kInterMcbpc[cbp & 3][1]);
                const int cy = (cbp >> 2) ^ 15;
                wr.put(kCbpy[cy][0], kCbpy[cy][1]);
                wr.put(1, 1);   // the zero vector: both differences 0
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
