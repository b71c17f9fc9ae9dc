// Native PNG frame decoder for camera_linearity_tpu_torch: the inflated
// scanlines of PNG frames (the chunks of an MPNG / PNG1 / "png " AVI) into
// BGR24, as cv2.VideoCapture gives them (FFmpeg's pngdec.c, then swscale).
//
// Each row is unfiltered by its own filter type (PNG section 9: None, Sub,
// Up, Average, Paeth), an Adam7 image pass by pass, each pass's pixels put
// at their place in the frame; then converted: gray at 1, 2 and 4 bits
// scaled to 8 (x 255, 85, 17), gray and gray+alpha at 16 bits as
// min(255, (v + 128) >> 8), RGB and RGBA at 8 bits swapped to B, G, R,
// at 16 bits through swscale's limited-range YUV and back (rgb16_to_bgr),
// palette indices looked up, alpha dropped.  native/png_plain.py is the
// plain version the tests hold this to, and has each rule's origin.
//
// The zlib streams are inflated by the caller (Python's zlib, on a thread
// pool); this library needs no zlib.  Built as a plain shared library with
// g++ on first use; camera_linearity_tpu_torch.native loads it with ctypes.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "parallel.h"

namespace {

constexpr int kOk = 0;
constexpr int kShort = -1;        // fewer scanline bytes than the image needs
constexpr int kBadFilter = -2;    // a filter type past 4
constexpr int kBadIndex = -3;     // a palette index past the PLTE entries
constexpr int kUnsupported = -4;  // a colour type and depth not read here

int channels(int color_type) {
    switch (color_type) {
    case 0: case 3: return 1;
    case 2: return 3;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
    }
}

bool supported(int color_type, int depth) {
    switch (color_type) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
    }
}

// Undo the filter of one row of n bytes (bpp: bytes a complete pixel, at
// least 1) in place; prior is the unfiltered row above (zeros for the
// first).  False for a filter type past 4.
bool unfilter_row(int type, std::uint8_t* __restrict row, const std::uint8_t* __restrict prior,
                  std::size_t n, std::size_t bpp) {
    switch (type) {
    case 0:
        return true;
    case 1:
        for (std::size_t i = bpp; i < n; ++i) row[i] = static_cast<std::uint8_t>(row[i] + row[i - bpp]);
        return true;
    case 2:
        for (std::size_t i = 0; i < n; ++i) row[i] = static_cast<std::uint8_t>(row[i] + prior[i]);
        return true;
    case 3:
        for (std::size_t i = 0; i < std::min(bpp, n); ++i)
            row[i] = static_cast<std::uint8_t>(row[i] + (prior[i] >> 1));
        for (std::size_t i = bpp; i < n; ++i)
            row[i] = static_cast<std::uint8_t>(row[i] + ((row[i - bpp] + prior[i]) >> 1));
        return true;
    case 4:
        for (std::size_t i = 0; i < std::min(bpp, n); ++i)
            row[i] = static_cast<std::uint8_t>(row[i] + prior[i]);
        for (std::size_t i = bpp; i < n; ++i) {
            const int a = row[i - bpp], b = prior[i], c = prior[i - bpp];
            const int p = a + b - c;
            const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
            const int pred = pa <= pb && pa <= pc ? a : pb <= pc ? b : c;
            row[i] = static_cast<std::uint8_t>(row[i] + pred);
        }
        return true;
    default:
        return false;
    }
}

// One 16-bit R, G, B pixel into o as swscale gives it in BGR24
// (png_plain.rgb16_to_bgr): 15-bit limited-range Y, U, V at full chroma
// from the BT.601 coefficients fill_rgb2yuv_table sets (RGB2YUV_SHIFT 15),
// then yuv2rgb_write_full with the limited-range tables (jpeg.cpp's
// kSwsLimited: y offset 128 << 6, y 9539, u2b 16525, u2g -3209, v2g -6660,
// v2r 13075).  Every sum stays inside int32, as swscale's does.
inline void rgb16_to_bgr(std::int64_t r, std::int64_t g, std::int64_t b,
                         std::uint8_t* __restrict o) {
    const std::int64_t y = (8414 * r + 16519 * g + 3208 * b + (0x2001LL << 14)) >> 16;
    const std::int64_t u =
        (((-4865 * r - 9528 * g + 14392 * b + (0x10001LL << 14)) >> 16) - (128 << 7)) * 4;
    const std::int64_t v =
        (((14392 * r - 12061 * g - 2332 * b + (0x10001LL << 14)) >> 16) - (128 << 7)) * 4;
    const std::int64_t yy = (y * 4 - 8192) * 9539 + (1 << 21);
    const std::int64_t c[3] = {yy + u * 16525, yy + u * -3209 + v * -6660, yy + v * 13075};
    for (int k = 0; k < 3; ++k)
        o[k] = static_cast<std::uint8_t>(std::clamp<std::int64_t>(c[k], 0, (1 << 30) - 1) >> 22);
}

struct Frame {
    int height, width, depth, color_type;
    const std::uint8_t* palette;  // R, G, B entries
    int entries;
};

// Convert the `count` pixels of one unfiltered row to BGR, pixel i at
// out + i * step * 3.
int convert_row(const Frame& f, const std::uint8_t* __restrict in, std::size_t count,
                std::uint8_t* __restrict out, std::size_t step) {
    const int d = f.depth;
    const std::size_t s = step * 3;
    switch (f.color_type) {
    case 0: case 3:
        if (d < 8) {
            const int per = 8 / d, mask = (1 << d) - 1, scale = 255 / mask;
            for (std::size_t i = 0; i < count; ++i) {
                const int v = in[i / per] >> (8 - d * (static_cast<int>(i % per) + 1)) & mask;
                std::uint8_t* o = out + i * s;
                if (f.color_type == 3) {
                    if (v >= f.entries) return kBadIndex;
                    const std::uint8_t* e = f.palette + 3 * v;
                    o[0] = e[2], o[1] = e[1], o[2] = e[0];
                } else {
                    o[0] = o[1] = o[2] = static_cast<std::uint8_t>(v * scale);
                }
            }
        } else if (f.color_type == 3) {
            for (std::size_t i = 0; i < count; ++i) {
                if (in[i] >= f.entries) return kBadIndex;
                const std::uint8_t* e = f.palette + 3 * in[i];
                std::uint8_t* o = out + i * s;
                o[0] = e[2], o[1] = e[1], o[2] = e[0];
            }
        } else if (d == 8) {
            for (std::size_t i = 0; i < count; ++i) {
                std::uint8_t* o = out + i * s;
                o[0] = o[1] = o[2] = in[i];
            }
        } else {
            for (std::size_t i = 0; i < count; ++i) {
                const int v = in[2 * i] << 8 | in[2 * i + 1];
                std::uint8_t* o = out + i * s;
                o[0] = o[1] = o[2] = static_cast<std::uint8_t>(std::min(255, (v + 128) >> 8));
            }
        }
        return kOk;
    case 4: {
        const std::size_t px = d == 8 ? 2 : 4;
        for (std::size_t i = 0; i < count; ++i) {
            const std::uint8_t* p = in + i * px;
            const int v = d == 8 ? p[0] : std::min(255, ((p[0] << 8 | p[1]) + 128) >> 8);
            std::uint8_t* o = out + i * s;
            o[0] = o[1] = o[2] = static_cast<std::uint8_t>(v);
        }
        return kOk;
    }
    default: {  // RGB, RGBA
        const std::size_t px = f.color_type == 2 ? 3 : 4;
        if (d == 16) {
            for (std::size_t i = 0; i < count; ++i) {
                const std::uint8_t* p = in + i * px * 2;
                rgb16_to_bgr(p[0] << 8 | p[1], p[2] << 8 | p[3], p[4] << 8 | p[5], out + i * s);
            }
            return kOk;
        }
        if (step == 1 && px == 3) {
            for (std::size_t i = 0; i < count; ++i) {
                out[3 * i] = in[3 * i + 2];
                out[3 * i + 1] = in[3 * i + 1];
                out[3 * i + 2] = in[3 * i];
            }
            return kOk;
        }
        for (std::size_t i = 0; i < count; ++i) {
            const std::uint8_t* p = in + i * px;
            std::uint8_t* o = out + i * s;
            o[0] = p[2], o[1] = p[1], o[2] = p[0];
        }
        return kOk;
    }
    }
}

thread_local std::vector<std::uint8_t> tls_rows;

// One frame's scanlines (n bytes, each pass's rows with their filter
// byte) into dst (height * width * 3 BGR).
int decode(const std::uint8_t* data, std::size_t n, std::uint8_t* dst, const Frame& f,
           bool interlace) {
    static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                     {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
    static const int kWhole[1][4] = {{0, 0, 1, 1}};
    const int ch = channels(f.color_type);
    if (!ch || !supported(f.color_type, f.depth) || f.height < 1 || f.width < 1)
        return kUnsupported;
    const std::size_t bits = static_cast<std::size_t>(ch) * f.depth;
    const std::size_t bpp = std::max<std::size_t>(1, bits / 8);
    const std::size_t W = f.width;
    const auto& passes = interlace ? kAdam7 : kWhole;
    const int npasses = interlace ? 7 : 1;
    std::size_t at = 0;
    for (int p = 0; p < npasses; ++p) {
        const int x0 = passes[p][0], y0 = passes[p][1], dx = passes[p][2], dy = passes[p][3];
        if (f.width <= x0 || f.height <= y0) continue;   // an empty pass
        const std::size_t pw = (f.width - x0 + dx - 1) / dx, ph = (f.height - y0 + dy - 1) / dy;
        const std::size_t rb = (pw * bits + 7) / 8;
        if (n - at < ph * (rb + 1) || at > n) return kShort;
        tls_rows.assign(2 * rb, 0);
        std::uint8_t* prior = tls_rows.data();
        std::uint8_t* row = prior + rb;
        for (std::size_t r = 0; r < ph; ++r) {
            const std::uint8_t* line = data + at + r * (rb + 1);
            std::memcpy(row, line + 1, rb);
            if (!unfilter_row(line[0], row, prior, rb, bpp)) return kBadFilter;
            std::uint8_t* out = dst + ((y0 + r * dy) * W + x0) * 3;
            const int rc = convert_row(f, row, pw, out, dx);
            if (rc != kOk) return rc;
            std::swap(prior, row);
        }
        at += ph * (rb + 1);
    }
    return kOk;
}

}  // namespace

extern "C" {

// Decode k PNG frames of one geometry and layout, frame i given as its
// inflated scanlines (srcs[i], sizes[i] bytes) and its PLTE (palettes[i]:
// entries[i] R, G, B triples; null for none), into dst, frame i at
// i*height*width*3 as BGR, on up to nthreads threads.  rcs[i] gets 0, -1
// for scanlines shorter than the image, -2 for a filter type past 4, -3
// for a palette index past the PLTE entries, -4 for a colour type and
// depth this decoder does not read.
void clt_png_decode_bgr_batch(const unsigned char* const* srcs, const std::size_t* sizes,
                              std::size_t k, unsigned char* dst, int height, int width,
                              int depth, int color_type, int interlace,
                              const unsigned char* const* palettes, const int* entries,
                              int nthreads, int* rcs) {
    const std::size_t frame = static_cast<std::size_t>(height) * width * 3;
    parallel_items(k, nthreads, [&](std::size_t i) {
        const Frame f{height, width, depth, color_type, palettes ? palettes[i] : nullptr,
                      entries ? entries[i] : 0};
        rcs[i] = decode(srcs[i], sizes[i], dst + i * frame, f, interlace != 0);
    });
}

int clt_png_version() { return 1; }

}  // extern "C"
