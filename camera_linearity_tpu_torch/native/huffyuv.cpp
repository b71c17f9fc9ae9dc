// Native HuffYUV decoder for camera_linearity_tpu_torch: the frames of an
// HFYU or FFVH AVI (FFmpeg's huffyuv and ffvhuff) as FFmpeg's
// huffyuvdec.c decodes them, k frames a call, one a thread.
//
// A frame is 32-bit little-endian words whose bits are read most
// significant first: a few raw 8-bit fields, then one Huffman code a
// sample (three tables: Y / U / V, or B / G / R), the residual after the
// left, gradient or median predictor.  RGB (24 and 32 bits a pixel) is
// stored bottom row first and may be G-decorrelated; it is written here
// as BGR straight into the caller's frame.  YUV (YUY2 as yuv422p, and
// ffvhuff's yuv420p) is written as planes (Y, then U, then V) for the
// rawvideo converter of jpeg.cpp to turn into BGR with swscale's
// limited-range tables, as cv2 gets it.  native/huffyuv_plain.py is the
// plain version the tests hold this to, and has each rule's origin.
//
// Built as a plain shared library with g++ on first use;
// camera_linearity_tpu_torch.native loads it with ctypes.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

#include "parallel.h"

namespace {

constexpr int kOk = 0;
constexpr int kOverrun = -1;      // the codes run past the end of the chunk
constexpr int kBadCode = -2;      // bits that are no code of the table
constexpr int kUnsupported = -4;  // parameters this decoder does not read

enum Predictor { kLeft = 0, kGradient = 1, kMedian = 2 };

// The chunk's bits, most significant first in each little-endian word;
// words past the end read as zero, and `used` says how far the codes went.
struct Bits {
    const std::uint8_t* p;
    std::size_t nwords, next = 0;
    std::uint64_t buf = 0, used = 0;
    int n = 0;

    Bits(const std::uint8_t* data, std::size_t size) : p(data), nwords(size / 4) {}

    inline void fill() {
        while (n <= 32) {
            std::uint32_t w = 0;
            if (next < nwords) std::memcpy(&w, p + 4 * next, 4);  // little-endian host
            ++next;
            buf |= static_cast<std::uint64_t>(w) << (32 - n);
            n += 32;
        }
    }
    inline std::uint32_t peek32() const { return static_cast<std::uint32_t>(buf >> 32); }
    inline void skip(int k) {
        buf <<= k;
        n -= k;
        used += k;
    }
    inline int get8() {
        fill();
        const int v = static_cast<int>(buf >> 56);
        skip(8);
        return v;
    }
    bool overrun() const { return used > 32 * static_cast<std::uint64_t>(nwords); }
};

// One table: the next 12 bits index the first level; a code longer than
// 12 bits continues in a subtable indexed by the bits after them (12, then
// the last 8), so every code of up to 32 bits takes at most three lookups.
// An entry is 0 (no code), len << 8 | symbol (len the whole code's), or
// kSub | bits << 24 | offset of a subtable indexed by `bits` more bits.
struct Table {
    static constexpr std::uint32_t kSub = 1u << 31;
    std::vector<std::uint32_t> t;

    void build(const std::uint8_t* lengths, const std::uint32_t* codes) {
        t.assign(4096, 0);
        for (int s = 0; s < 256; ++s)
            if (lengths[s]) insert(0, 12, 0, codes[s], lengths[s], s);
    }

    // Put the code of n bits (the low n of `code`) into the table at
    // `base`, indexed by `bits` bits from bit `used` of the code.
    void insert(std::size_t base, int bits, int used, std::uint32_t code, int n, int sym) {
        const int rem = n - used;
        const std::uint32_t low = rem >= 32 ? code : code & ((1u << rem) - 1);
        if (rem <= bits) {
            const std::uint32_t first = low << (bits - rem);
            for (std::uint32_t k = 0; k < (1u << (bits - rem)); ++k)
                t[base + first + k] = static_cast<std::uint32_t>(n << 8 | sym);
            return;
        }
        const std::size_t at = base + (low >> (rem - bits));
        if (!(t[at] & kSub)) {
            const int sub = std::min(12, 32 - used - bits);
            const std::size_t offset = t.size();
            t.resize(offset + (std::size_t{1} << sub), 0);
            t[at] = kSub | static_cast<std::uint32_t>(sub) << 24 |
                    static_cast<std::uint32_t>(offset);
        }
        const std::uint32_t e = t[at];
        insert(e & 0xFFFFFF, (e >> 24) & 31, used + bits, code, n, sym);
    }

    // The next symbol, or -1 for bits that are no code.
    inline int read(Bits& b) const {
        b.fill();
        const std::uint32_t w = b.peek32();
        std::uint32_t e = t[w >> 20];
        int used = 12;
        while (e & kSub) {
            const int sub = (e >> 24) & 31;
            e = t[(e & 0xFFFFFF) + ((w << used) >> (32 - sub))];
            used += sub;
        }
        if (!e) return -1;
        b.skip(static_cast<int>(e >> 8));
        return static_cast<int>(e & 255);
    }
};

struct Params {
    int height, width, bpp, predictor, interlaced;
    bool decorrelate;
    const Table* tabs;
};

// add_left_pred: out = acc + running sum of d (mod 256); returns the sum.
inline int add_left(std::uint8_t* __restrict out, const int* __restrict d, int n, int acc) {
    for (int i = 0; i < n; ++i) {
        acc = (acc + d[i]) & 255;
        out[i] = static_cast<std::uint8_t>(acc);
    }
    return acc;
}

inline int mid3(int a, int b, int c) {
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// add_median_pred over n samples above `top`.
inline void add_median(std::uint8_t* __restrict out, const std::uint8_t* __restrict top,
                       const int* __restrict d, int n, int& left, int& left_top) {
    int l = left, lt = left_top;
    for (int i = 0; i < n; ++i) {
        const int t = top[i];
        l = (mid3(l, t, (l + t - lt) & 255) + d[i]) & 255;
        lt = t;
        out[i] = static_cast<std::uint8_t>(l);
    }
    left = l;
    left_top = lt;
}

inline void add_rows(std::uint8_t* __restrict out, const std::uint8_t* __restrict above, int n) {
    for (int i = 0; i < n; ++i) out[i] = static_cast<std::uint8_t>(out[i] + above[i]);
}

struct Yuv {
    const Params& p;
    Bits& bits;
    std::vector<int> ty, tu, tv;
    bool bad = false;

    // decode_422_bitstream: count luma, count / 2 of each chroma, Y U Y V.
    void read422(int count) {
        const Table* t = p.tabs;
        for (int i = 0; i < count / 2; ++i) {
            const int y0 = t[0].read(bits), u = t[1].read(bits);
            const int y1 = t[0].read(bits), v = t[2].read(bits);
            bad |= (y0 | u | y1 | v) < 0;
            ty[2 * i] = y0, tu[i] = u, ty[2 * i + 1] = y1, tv[i] = v;
        }
    }
    // decode_gray_bitstream: count luma samples.
    void read_gray(int count) {
        for (int i = 0; i < count / 2 * 2; ++i) {
            ty[i] = p.tabs[0].read(bits);
            bad |= ty[i] < 0;
        }
    }
};

int decode_yuv(const std::uint8_t* data, std::size_t size, std::uint8_t* planes, const Params& p) {
    const int h = p.height, w = p.width, w2 = w >> 1;
    const int ch = p.bpp == 16 ? h : (h + 1) / 2;
    std::uint8_t* Y = planes;
    std::uint8_t* U = Y + static_cast<std::size_t>(h) * w;
    std::uint8_t* V = U + static_cast<std::size_t>(ch) * w2;
    auto y_row = [&](int r) { return Y + static_cast<std::size_t>(r) * w; };
    auto u_row = [&](int r) { return U + static_cast<std::size_t>(r) * w2; };
    auto v_row = [&](int r) { return V + static_cast<std::size_t>(r) * w2; };
    const int fy = p.interlaced ? 2 : 1, fc = fy;
    const bool twelve = p.bpp == 12;
    Bits bits(data, size);
    Yuv s{p, bits, std::vector<int>(w), std::vector<int>(w2), std::vector<int>(w2)};
    int leftv = V[0] = static_cast<std::uint8_t>(bits.get8());
    int lefty = Y[1] = static_cast<std::uint8_t>(bits.get8());
    int leftu = U[0] = static_cast<std::uint8_t>(bits.get8());
    Y[0] = static_cast<std::uint8_t>(bits.get8());
    s.read422(w - 2);
    lefty = add_left(Y + 2, s.ty.data(), w - 2, lefty);
    leftu = add_left(U + 1, s.tu.data(), w2 - 1, leftu);
    leftv = add_left(V + 1, s.tv.data(), w2 - 1, leftv);
    auto full_row_left = [&](int y, int cy) {
        s.read422(w);
        lefty = add_left(y_row(y), s.ty.data(), w, lefty);
        leftu = add_left(u_row(cy), s.tu.data(), w2, leftu);
        leftv = add_left(v_row(cy), s.tv.data(), w2, leftv);
    };
    if (p.predictor != kMedian) {
        const bool grad = p.predictor == kGradient;
        for (int y = 1, cy = 1; y < h; ++y, ++cy) {
            if (twelve) {
                s.read_gray(w);
                lefty = add_left(y_row(y), s.ty.data(), w, lefty);
                if (grad && y > p.interlaced) add_rows(y_row(y), y_row(y - fy), w);
                if (++y >= h) break;
            }
            full_row_left(y, cy);
            if (grad && cy > p.interlaced) {
                add_rows(y_row(y), y_row(y - fy), w);
                add_rows(u_row(cy), u_row(cy - fc), w2);
                add_rows(v_row(cy), v_row(cy - fc), w2);
            }
        }
    } else if (h > 1) {
        int y = 1, cy = 1;
        bool done = false;
        if (p.interlaced) {
            full_row_left(1, 1);
            ++y, ++cy;
            done = y >= h;
        }
        if (!done) {
            s.read422(4);
            lefty = add_left(y_row(fy), s.ty.data(), 4, lefty);
            leftu = add_left(u_row(fc), s.tu.data(), 2, leftu);
            leftv = add_left(v_row(fc), s.tv.data(), 2, leftv);
            int topy = Y[3], topu = U[1], topv = V[1];
            s.read422(w - 4);
            add_median(y_row(fy) + 4, Y + 4, s.ty.data(), w - 4, lefty, topy);
            add_median(u_row(fc) + 2, U + 2, s.tu.data(), w2 - 2, leftu, topu);
            add_median(v_row(fc) + 2, V + 2, s.tv.data(), w2 - 2, leftv, topv);
            ++y, ++cy;
            for (; y < h; ++y, ++cy) {
                if (twelve) {
                    while (2 * cy > y) {
                        s.read_gray(w);
                        add_median(y_row(y), y_row(y - fy), s.ty.data(), w, lefty, topy);
                        ++y;
                    }
                    if (y >= h) break;
                }
                s.read422(w);
                add_median(y_row(y), y_row(y - fy), s.ty.data(), w, lefty, topy);
                add_median(u_row(cy), u_row(cy - fc), s.tu.data(), w2, leftu, topu);
                add_median(v_row(cy), v_row(cy - fc), s.tv.data(), w2, leftv, topv);
            }
        }
    }
    if (s.bad) return kBadCode;
    return bits.overrun() ? kOverrun : kOk;
}

int decode_rgb(const std::uint8_t* data, std::size_t size, std::uint8_t* dst, const Params& p) {
    const int h = p.height, w = p.width;
    const bool alpha = p.bpp == 32;
    const std::size_t stride = static_cast<std::size_t>(w) * 3;
    Bits bits(data, size);
    int left[3];  // B, G, R accumulators
    if (alpha) bits.get8();
    left[2] = bits.get8();
    left[1] = bits.get8();
    left[0] = bits.get8();
    if (!alpha) bits.get8();
    std::uint8_t* bottom = dst + (h - 1) * stride;
    bottom[0] = static_cast<std::uint8_t>(left[0]);
    bottom[1] = static_cast<std::uint8_t>(left[1]);
    bottom[2] = static_cast<std::uint8_t>(left[2]);
    const Table* t = p.tabs;
    bool bad = false;
    auto row = [&](std::uint8_t* out, int count) {
        for (int i = 0; i < count; ++i) {
            int b, g, r;
            if (p.decorrelate) {
                g = t[1].read(bits);
                b = t[0].read(bits);
                r = t[2].read(bits);
                bad |= (g | b | r) < 0;
                b += g, r += g;
            } else {
                b = t[0].read(bits);
                g = t[1].read(bits);
                r = t[2].read(bits);
                bad |= (g | b | r) < 0;
            }
            if (alpha) bad |= t[2].read(bits) < 0;
            left[0] = (left[0] + b) & 255;
            left[1] = (left[1] + g) & 255;
            left[2] = (left[2] + r) & 255;
            out[3 * i] = static_cast<std::uint8_t>(left[0]);
            out[3 * i + 1] = static_cast<std::uint8_t>(left[1]);
            out[3 * i + 2] = static_cast<std::uint8_t>(left[2]);
        }
    };
    row(bottom + 3, w - 1);
    const std::size_t up = (p.interlaced ? 2 : 1) * stride;
    for (int y = h - 2; y >= 0; --y) {
        std::uint8_t* out = dst + y * stride;
        row(out, w);
        if (p.predictor == kGradient && y < h - 1 - p.interlaced)
            add_rows(out, out + up, static_cast<int>(stride));
    }
    if (bad) return kBadCode;
    return bits.overrun() ? kOverrun : kOk;
}

}  // namespace

extern "C" {

// Decode k frames (srcs[i], sizes[i] bytes) of one stream: bpp 24 or 32
// into dst (frame i at i*height*width*3, BGR); bpp 16 (yuv422p) or 12
// (yuv420p) into planes (frame i at i * plane_bytes: Y, then U, then V,
// the chroma width / 2 wide and height or ceil(height / 2) high).
// predictor 0 left, 1 gradient, 2 median; lengths and codes: the three
// tables' 256 code lengths and codes.  On up to nthreads threads; rcs[i]
// gets 0, -1 where the codes run past the chunk's end, -2 for bits that
// are no code, -4 for parameters this decoder does not read.
void clt_huffyuv_decode_batch(const unsigned char* const* srcs, const std::size_t* sizes,
                              std::size_t k, unsigned char* dst, unsigned char* planes,
                              std::size_t plane_bytes, int height, int width, int bpp,
                              int predictor, int decorrelate, int interlaced,
                              const unsigned char* lengths, const std::uint32_t* codes,
                              int nthreads, int* rcs) {
    Table tabs[3];
    for (int i = 0; i < 3; ++i) tabs[i].build(lengths + 256 * i, codes + 256 * i);
    const Params p{height, width, bpp, predictor, interlaced ? 1 : 0, decorrelate != 0, tabs};
    const bool rgb = bpp == 24 || bpp == 32;
    const bool ok = height >= 1 && width >= 2 && predictor >= kLeft && predictor <= kMedian &&
                    (rgb ? predictor != kMedian
                         : (bpp == 12 || bpp == 16) && !(width & 1) &&
                               !(predictor == kMedian &&
                                 (width < 4 || (bpp == 16 && width % 4) ||
                                  (bpp == 12 && height < (interlaced ? 6 : 4)))));
    const std::size_t frame = static_cast<std::size_t>(height) * width * 3;
    parallel_items(k, nthreads, [&](std::size_t i) {
        if (!ok) {
            rcs[i] = kUnsupported;
            return;
        }
        rcs[i] = rgb ? decode_rgb(srcs[i], sizes[i], dst + i * frame, p)
                     : decode_yuv(srcs[i], sizes[i], planes + i * plane_bytes, p);
    });
}

int clt_huffyuv_version() { return 1; }

}  // extern "C"
