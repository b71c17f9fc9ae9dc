// Native UtVideo decoder for camera_linearity_tpu_torch: the frames of a
// Ut Video AVI (ULRG, ULRA, ULY0, ULY2, ULY4, ULH0, ULH2, ULH4) as FFmpeg's
// utvideodec.c decodes them, k frames a call, one a thread (every frame is
// intra).
//
// A frame is its planes, then a 32-bit frame-information word whose bits
// 8-9 are the predictor (none, left, gradient, median).  A plane is 256
// code lengths, one cumulative 32-bit end offset per slice and the
// slices' data: Huffman codes, canonical with the longest codes and,
// within a length, the largest symbols taking the smallest values, in
// 32-bit little-endian words read most significant bit first.  A length
// of 0 makes the plane that one symbol.  Prediction restarts at every
// slice; an interlaced stream predicts each pair of rows as one row of
// twice the width.  RGB (planes G, B - G + 0x80, R - G + 0x80, and A,
// which is dropped) is written as BGR straight into the caller's frame;
// YUV is written as planes (Y, then U, then V) for the rawvideo converter
// of jpeg.cpp to turn into BGR, as cv2 gets it.  native/utvideo_plain.py
// is the plain version the tests hold this to, and has each rule's origin.
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
constexpr int kShort = -1;        // a plane or the frame information runs past the chunk
constexpr int kOffsets = -2;      // slice end offsets that decrease or run past the chunk
constexpr int kLengths = -3;      // code lengths FFmpeg's table builder refuses
constexpr int kBadCode = -4;      // bits that are no code of the plane's table
constexpr int kOverrun = -5;      // the codes run past the slice
constexpr int kEmpty = -6;        // an empty slice in a coded plane
constexpr int kUnsupported = -7;  // parameters this decoder does not read

enum Layout { kGbrp, kGbrap, kYuv420p, kYuv422p, kYuv444p };
enum Predictor { kNone, kLeft, kGradient, kMedian };

// A slice's bits, most significant first in each little-endian word, from
// `p` on; bytes past `avail` read as zero.
struct Bits {
    const std::uint8_t* p;
    std::size_t avail, next = 0;
    std::uint64_t buf = 0, used = 0;
    int n = 0;

    Bits(const std::uint8_t* data, std::size_t size) : p(data), avail(size) {}

    inline void fill() {
        while (n <= 32) {
            std::uint32_t w = 0;
            if (next + 4 <= avail) {
                std::memcpy(&w, p + next, 4);  // little-endian host
            } else {
                for (std::size_t b = next; b < avail; ++b)
                    w |= static_cast<std::uint32_t>(p[b]) << (8 * (b - next));
            }
            next += 4;
            buf |= static_cast<std::uint64_t>(w) << (32 - n);
            n += 32;
        }
    }
};

// One plane's table: the next 12 bits index the first level; a code
// longer than 12 bits continues in a subtable indexed by the bits after
// them (12, then the last 8), so every code of up to 32 bits takes at most
// three lookups.  An entry is 0 (no code), len << 8 | symbol (len the
// whole code's), or kSub | bits << 24 | offset of a subtable indexed by
// `bits` more bits.  fill >= 0: the plane is that one symbol.
struct Table {
    static constexpr std::uint32_t kSub = 1u << 31;
    std::vector<std::uint32_t> t;
    int fill = -1;

    // FFmpeg's build_huff: the first length 0 makes a fill plane, 255 is
    // an unused symbol, 1-32 a length; the codes go from 0 to the longest
    // codes first and, within a length, to the largest symbols first.
    int build(const std::uint8_t* lengths) {
        fill = -1;
        int count[33] = {0};
        for (int s = 0; s < 256; ++s) {
            const int n = lengths[s];
            if (n == 0) {
                fill = s;
                return kOk;
            }
            if (n != 255 && n > 32) return kLengths;
            if (n != 255) ++count[n];
        }
        t.assign(4096, 0);
        bool any = false;
        std::uint64_t code = 0;
        for (int n = 32; n >= 1; --n) {
            if (!count[n]) continue;
            for (int s = 255; s >= 0; --s) {
                if (lengths[s] != n) continue;
                if (code & ((std::uint64_t{1} << (32 - n)) - 1)) return kLengths;
                insert(0, 12, 0, static_cast<std::uint32_t>(code >> (32 - n)), n, s);
                code += std::uint64_t{1} << (32 - n);
                if (code > (std::uint64_t{1} << 32)) return kLengths;
                any = true;
            }
        }
        return any ? kOk : kLengths;
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

    // count symbols into out; false for bits that are no code.
    bool read(Bits& b, std::uint8_t* __restrict out, std::size_t count) const {
        const std::uint32_t* __restrict tab = t.data();
        for (std::size_t i = 0; i < count; ++i) {
            b.fill();
            const std::uint32_t w = static_cast<std::uint32_t>(b.buf >> 32);
            std::uint32_t e = tab[w >> 20];
            int used = 12;
            while (e & kSub) {
                const int sub = (e >> 24) & 31;
                e = tab[(e & 0xFFFFFF) + ((w << used) >> (32 - sub))];
                used += sub;
            }
            if (!e) return false;
            const int len = static_cast<int>(e >> 8);
            b.buf <<= len;
            b.n -= len;
            b.used += len;
            out[i] = static_cast<std::uint8_t>(e);
        }
        return true;
    }
};

inline int mid3(int a, int b, int c) {
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// Restore one slice in place: rows of w samples (an interlaced slice's
// row pairs as rows of twice the width).
void restore(std::uint8_t* __restrict s, std::size_t rows, std::size_t w, int predictor) {
    if (predictor == kNone || !rows || !w) return;
    if (predictor == kLeft) {
        std::uint8_t acc = 0x80;
        for (std::size_t i = 0; i < rows * w; ++i)
            s[i] = acc = static_cast<std::uint8_t>(acc + s[i]);
        return;
    }
    std::uint8_t acc = 0x80;
    for (std::size_t i = 0; i < w; ++i) s[i] = acc = static_cast<std::uint8_t>(acc + s[i]);
    if (predictor == kGradient) {
        // top - top_left + left + residual: the row above plus the
        // running sum of the row's residuals
        for (std::size_t r = 1; r < rows; ++r) {
            std::uint8_t* __restrict row = s + r * w;
            const std::uint8_t* __restrict top = row - w;
            std::uint8_t sum = 0;
            for (std::size_t i = 0; i < w; ++i) {
                sum = static_cast<std::uint8_t>(sum + row[i]);
                row[i] = static_cast<std::uint8_t>(top[i] + sum);
            }
        }
        return;
    }
    if (rows < 2) return;
    // median: the second row's first sample from above, then the median of
    // left, top and left + top - top_left, running on from row to row
    std::uint8_t* row = s + w;
    row[0] = static_cast<std::uint8_t>(row[0] + s[0]);
    int left = row[0], lt = s[0];
    std::size_t i = 1;
    for (std::size_t r = 1; r < rows; ++r, i = 0) {
        row = s + r * w;
        const std::uint8_t* __restrict top = row - w;
        for (; i < w; ++i) {
            const int t = top[i];
            left = (mid3(left, t, (left + t - lt) & 255) + row[i]) & 255;
            lt = t;
            row[i] = static_cast<std::uint8_t>(left);
        }
    }
}

struct Stream {
    int height, width, layout, slices, interlaced;
};

// Each coded plane's rows and columns, in the order they are stored.
int plane_shapes(const Stream& st, int* rows, int* cols) {
    const int h = st.height, w = st.width;
    if (st.layout == kGbrp || st.layout == kGbrap) {
        const int n = st.layout == kGbrp ? 3 : 4;
        for (int k = 0; k < n; ++k) rows[k] = h, cols[k] = w;
        return n;
    }
    rows[0] = h, cols[0] = w;
    rows[1] = rows[2] = st.layout == kYuv420p ? h / 2 : h;
    cols[1] = cols[2] = st.layout == kYuv444p ? w : w / 2;
    return 3;
}

// The row slice boundaries of `plane` are rounded down to a multiple of.
int row_mask(const Stream& st, int plane) {
    const bool luma420 = plane == 0 && st.layout == kYuv420p;
    return st.interlaced ? (luma420 ? 4 : 2) : (luma420 ? 2 : 1);
}

std::size_t le32(const std::uint8_t* p) {
    return static_cast<std::size_t>(p[0]) | static_cast<std::size_t>(p[1]) << 8 |
           static_cast<std::size_t>(p[2]) << 16 | static_cast<std::size_t>(p[3]) << 24;
}

// Decode one frame's planes into out[k] (plane k, rows x cols contiguous).
// On failure *where gets plane << 16 | slice (slice 0xFFFF: the plane).
int decode_frame(const std::uint8_t* data, std::size_t size, const Stream& st,
                 std::uint8_t* const* out, int* where) {
    int rows[4], cols[4];
    const int planes = plane_shapes(st, rows, cols);
    const std::size_t S = static_cast<std::size_t>(st.slices);
    std::size_t at = 0, base[4];
    for (int k = 0; k < planes; ++k) {
        *where = k << 16 | 0xFFFF;
        if (size - at < 256 + 4 * S) return kShort;
        base[k] = at;
        std::size_t start = 0;
        const std::size_t body = at + 256 + 4 * S;
        for (std::size_t j = 0; j < S; ++j) {
            const std::size_t end = le32(data + at + 256 + 4 * j);
            if (end < start || size - body < end) {
                *where = k << 16 | static_cast<int>(j);
                return kOffsets;
            }
            start = end;
        }
        at = body + start;
    }
    *where = -1;
    if (size - at < 4) return kShort;
    const int predictor = static_cast<int>((le32(data + at) >> 8) & 3);
    Table table;
    for (int k = 0; k < planes; ++k) {
        *where = k << 16 | 0xFFFF;
        const std::uint8_t* head = data + base[k];
        if (table.build(head) != kOk) return kLengths;
        const std::size_t body = base[k] + 256 + 4 * S, w = cols[k];
        const int m = row_mask(st, k);
        const std::size_t pair = st.interlaced ? 2 : 1;
        std::size_t r0 = 0, start = 0;
        for (std::size_t j = 0; j < S; ++j) {
            const std::size_t r1 = static_cast<std::size_t>(rows[k]) * (j + 1) / S / m * m;
            const std::size_t end = le32(head + 256 + 4 * j);
            std::uint8_t* s = out[k] + r0 * w;
            const std::size_t n = (r1 - r0) * w;
            *where = k << 16 | static_cast<int>(j);
            if (table.fill >= 0) {
                std::memset(s, table.fill, n);
            } else {
                if (end == start) return kEmpty;
                Bits bits(data + body + start, size - body - start);
                if (!table.read(bits, s, n)) return kBadCode;
                if (bits.used > 8 * (end - start)) return kOverrun;
            }
            restore(s, (r1 - r0) / pair, w * pair, predictor);
            r0 = r1;
            start = end;
        }
    }
    return kOk;
}

thread_local std::vector<std::uint8_t> tls_rgb;

int decode_one(const std::uint8_t* data, std::size_t size, const Stream& st,
               std::uint8_t* dst, std::uint8_t* planes, int* where) {
    const std::size_t H = st.height, W = st.width;
    std::uint8_t* out[4];
    if (st.layout == kGbrp || st.layout == kGbrap) {
        tls_rgb.resize(4 * H * W);
        for (int k = 0; k < 4; ++k) out[k] = tls_rgb.data() + k * H * W;
        const int rc = decode_frame(data, size, st, out, where);
        if (rc != kOk) return rc;
        const std::uint8_t *g = out[0], *b = out[1], *r = out[2];
        for (std::size_t i = 0; i < H * W; ++i) {
            dst[3 * i] = static_cast<std::uint8_t>(b[i] + g[i] - 0x80);
            dst[3 * i + 1] = g[i];
            dst[3 * i + 2] = static_cast<std::uint8_t>(r[i] + g[i] - 0x80);
        }
        return kOk;
    }
    int rows[4], cols[4];
    plane_shapes(st, rows, cols);
    out[0] = planes;
    out[1] = out[0] + H * W;
    out[2] = out[1] + static_cast<std::size_t>(rows[1]) * cols[1];
    return decode_frame(data, size, st, out, where);
}

}  // namespace

extern "C" {

// Decode k frames (srcs[i], sizes[i] bytes) of one stream: layout 0 gbrp
// or 1 gbrap into dst (frame i at i*height*width*3, BGR); 2 yuv420p, 3
// yuv422p or 4 yuv444p into planes (frame i at i * plane_bytes: Y, then
// U, then V).  slices: the stream's; interlaced: row pairs predicted as
// one row.  On up to nthreads threads; rcs[i] gets 0, -1 where a plane or
// the frame information runs past the chunk, -2 for slice end offsets
// that decrease or run past it, -3 for code lengths FFmpeg refuses, -4 for
// bits that are no code, -5 where the codes run past their slice, -6 for
// an empty slice in a coded plane, -7 for parameters this decoder does not
// read; wheres[i] the plane << 16 | slice it failed in (slice 0xFFFF: the
// plane's table or header; -1: the frame information).
void clt_utvideo_decode_batch(const unsigned char* const* srcs, const std::size_t* sizes,
                              std::size_t k, unsigned char* dst, unsigned char* planes,
                              std::size_t plane_bytes, int height, int width, int layout,
                              int slices, int interlaced, int nthreads, int* rcs, int* wheres) {
    const Stream st{height, width, layout, slices, interlaced ? 1 : 0};
    const bool subsampled = layout == kYuv420p || layout == kYuv422p;
    // FFmpeg refuses odd subsampled sizes; an interlaced height that is
    // not a whole number of row pairs (of 4 rows for yuv420p) leaves rows
    // it never decodes
    const int rows_mod = interlaced ? (layout == kYuv420p ? 4 : 2) : (layout == kYuv420p ? 2 : 1);
    const bool ok = height >= 1 && width >= 1 && layout >= kGbrp && layout <= kYuv444p &&
                    slices >= 1 && slices <= 256 && !(subsampled && width & 1) &&
                    height % rows_mod == 0;
    const std::size_t frame = static_cast<std::size_t>(height) * width * 3;
    parallel_items(k, nthreads, [&](std::size_t i) {
        wheres[i] = 0;
        rcs[i] = ok ? decode_one(srcs[i], sizes[i], st, dst + i * frame,
                                 planes ? planes + i * plane_bytes : nullptr, wheres + i)
                    : kUnsupported;
    });
}

int clt_utvideo_version() { return 1; }

}  // extern "C"
