// Native Lagarith decoder for camera_linearity_tpu_torch: the frames of a
// Lagarith (LAGS) AVI as FFmpeg's lagarith.c and lagarithrac.c decode
// them, k frames a call.  Every frame is intra and every plane has its own
// offset, so the planes of all k frames are decoded side by side, one
// plane a thread (each plane is one serial range-coder chain).
//
// A frame's first byte is its type: RGB24 (2, 4) and RGBA (8), coded
// bottom-up as B - G, G, R - G (and A) planes; YUY2 (3) and YV12 (10),
// coded top-down as Y, U, V (YV12: Y, V, U); solid grey (5), colour (6)
// and RGBA (9).  A plane is range coded with optional zero runs (escape
// 0-3), raw (4), zero-run coded without the range coder (5-7) or filled
// (0xff), then predicted (left on the first row, a median after it).
// RGB frames are written as BGR straight into the caller's frames; YUV
// frames as planes (Y, then U, then V) for the rawvideo converter of
// jpeg.cpp to turn into BGR, as cv2 gets them.  native/lagarith_plain.py
// is the plain version the tests hold this to, and has each rule's
// origin.
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
constexpr int kHeader = -1;   // a chunk shorter than its frame header
constexpr int kOffset = -2;   // a plane offset past the chunk
constexpr int kProbs = -3;    // a probability header FFmpeg refuses
constexpr int kEnd = -4;      // data that end before the plane does
constexpr int kEscape = -5;   // an escape byte FFmpeg refuses
constexpr int kRun = -6;      // a zero run longer than its row or plane
constexpr int kType = -7;     // a frame type FFmpeg refuses

enum Type {
    kURgb24 = 2, kYuy2 = 3, kRgb24 = 4, kSolidGray = 5, kSolidColor = 6,
    kRgba = 8, kSolidRgba = 9, kYv12 = 10
};
enum Predictor { kMedian, kMedianYv12, kYuy2Luma, kYuy2Chroma };

constexpr int kMaxOverread = 4;

inline std::uint32_t le32(const std::uint8_t* p) {
    return static_cast<std::uint32_t>(p[0]) | static_cast<std::uint32_t>(p[1]) << 8 |
           static_cast<std::uint32_t>(p[2]) << 16 | static_cast<std::uint32_t>(p[3]) << 24;
}

inline int av_log2(std::uint64_t v) { return v ? 63 - __builtin_clzll(v) : 0; }

// FFmpeg's bit reader: most significant bit first, zeros past the end.
struct Bits {
    const std::uint8_t* p;
    std::size_t limit, pos;

    std::uint32_t read(int n) {
        std::uint32_t v = 0;
        for (int i = 0; i < n; ++i, ++pos) {
            const std::uint32_t bit = pos < limit ? (p[pos >> 3] >> (7 - (pos & 7))) & 1 : 0;
            v = v << 1 | bit;
        }
        return v;
    }
};

// lag_decode_prob: a Fibonacci-coded bit length, then the bits below the
// top one.  False for a length FFmpeg refuses.
bool read_prob(Bits& b, std::uint32_t* value) {
    static const int series[] = {1, 2, 3, 5, 8, 13, 21};
    int bit = 0, prev = 0, bits = 0;
    for (int i = 0; i < 7; ++i) {
        if (prev && bit) break;
        prev = bit;
        bit = static_cast<int>(b.read(1));
        if (bit && !prev) bits += series[i];
    }
    --bits;
    if (bits < 0 || bits > 31) return false;
    if (bits == 0) {
        *value = 0;
        return true;
    }
    *value = (b.read(bits) | 1u << bits) - 1;
    return true;
}

std::uint64_t softfloat_reciprocal(std::uint32_t denom) {
    const int shift = av_log2(denom - 1) + 1;
    std::uint64_t ret = (std::uint64_t{1} << 52) / denom;
    std::uint64_t err = (std::uint64_t{1} << 52) - ret * denom;
    ret <<= shift;
    err <<= shift;
    err += denom / 2;
    return ret + err / denom;
}

std::uint32_t softfloat_mul(std::uint32_t x, std::uint64_t mantissa) {
    std::uint64_t l = x * (mantissa & 0xffffffff);
    std::uint64_t h = x * (mantissa >> 32);
    h += l >> 32;
    l &= 0xffffffff;
    l += std::uint64_t{1} << av_log2(h >> 21);
    h += l >> 32;
    return static_cast<std::uint32_t>(h >> 20);
}

// A plane's range decoder: lag_read_prob_header's table and lagarithrac.
struct Rac {
    const std::uint8_t* data;  // the chunk
    std::size_t size, pos = 0, end = 0;
    std::uint32_t low = 0, range = 0x80, scale = 0, hash_shift = 0;
    int overread = 0;
    std::uint32_t cum[258];
    std::uint16_t hash[1024];

    // The header from bit reader b; kOk or kProbs.
    int read_header(Bits& b) {
        std::uint32_t prob[258];
        prob[0] = 0;
        std::uint64_t total = 0;
        for (int i = 1; i < 257; ++i) {
            if (!read_prob(b, &prob[i])) return kProbs;
            if (total + prob[i] > 0xFFFFFFFFull) return kProbs;
            total += prob[i];
            if (!prob[i]) {
                std::uint32_t run;
                if (!read_prob(b, &run)) return kProbs;
                if (run > static_cast<std::uint32_t>(256 - i)) run = 256 - i;
                for (std::uint32_t j = 0; j < run; ++j) prob[++i] = 0;
            }
        }
        if (!total) return kProbs;
        int sc = av_log2(total);
        if (total & (total - 1)) {
            const std::uint64_t mul = softfloat_reciprocal(static_cast<std::uint32_t>(total));
            std::uint64_t scaled = 0;
            int i = 1;
            for (; i <= 128; ++i) {
                prob[i] = softfloat_mul(prob[i], mul);
                scaled += prob[i];
            }
            if (!scaled) return kProbs;
            for (; i < 257; ++i) {
                prob[i] = softfloat_mul(prob[i], mul);
                scaled += prob[i];
            }
            ++sc;
            if (sc >= 32) return kProbs;
            const std::uint64_t target = std::uint64_t{1} << sc;
            if (scaled > target) return kProbs;
            std::uint64_t rest = target - scaled;
            for (i = 1; rest; i = (i & 0x7f) + 1) {
                if (prob[i]) {
                    ++prob[i];
                    --rest;
                }
            }
        }
        if (sc > 23) return kProbs;
        scale = static_cast<std::uint32_t>(sc);
        cum[0] = 0;
        for (int i = 1; i < 257; ++i) cum[i] = cum[i - 1] + prob[i];
        cum[257] = 0xFFFFFFFFu;
        hash_shift = std::max(scale, 10u) - 10;
        for (int i = 0, j = 0; i < 1024; ++i) {
            const std::uint32_t r = static_cast<std::uint32_t>(i) << hash_shift;
            while (j < 256 && cum[j + 1] <= r) ++j;
            hash[i] = static_cast<std::uint16_t>(j);
        }
        return kOk;
    }

    void start(std::size_t at) {
        pos = at;
        end = std::max(at, size);
        low = (at < size ? data[at] : 0) >> 1;
        range = 0x80;
        overread = 0;
    }

    inline std::uint32_t byte(std::size_t p) const { return p < size ? data[p] : 0; }

    // One symbol.
    inline int get() {
        while (range <= 0x800000) {
            low = low << 8 | (((byte(pos) << 8 | byte(pos + 1)) >> 1) & 0xff);
            range <<= 8;
            if (pos < end) ++pos;
            else ++overread;
        }
        const std::uint32_t rs = range >> scale;
        if (low < rs * cum[1]) {
            range = rs * cum[1];
            return 0;
        }
        if (low >= rs * cum[255]) {
            // 255 takes all the range above its start
            low -= rs * cum[255];
            range -= rs * cum[255];
            return 255;
        }
        // low >= rs * cum[s] exactly where low / rs >= cum[s]
        const std::uint32_t t = low / rs;
        int v = hash[t >> hash_shift];
        while (cum[v + 1] <= t) ++v;
        low -= rs * cum[v];
        range = rs * (cum[v + 1] - cum[v]);
        return v;
    }
};

inline std::uint8_t zero_run(std::uint8_t x) {
    const int s = static_cast<std::int8_t>(x);
    return static_cast<std::uint8_t>((s * 2) ^ (s >> 7));
}

// lag_decode_zero_run_line: one row from data[src..src_end), the bytes it
// read into *used; kOk, kEnd or kRun.
int zero_run_line(std::uint8_t* dst, const std::uint8_t* data, std::size_t src,
                  std::size_t src_end, int width, int esc, std::uint32_t& zeros_rem,
                  std::size_t* used) {
    const std::size_t start = src;
    const std::uint8_t mask1 = esc < 2 ? 0xff : 0, mask2 = esc < 3 ? 0xff : 0;
    const long end = width - 2;
    long d = 0, i = 0;
    bool found = false;
    std::memset(dst, 0, width);
    for (;;) {
        if (zeros_rem) {
            const long count = std::min<long>(zeros_rem, width - i);
            if (end - d < count) return kRun;
            zeros_rem -= static_cast<std::uint32_t>(count);
            d += count;
        }
        bool again = false;
        while (d < end) {
            i = 0;
            while (!found && d + i < end) {
                ++i;
                if (static_cast<std::size_t>(i + 2) >= src_end - src) return kEnd;
                found = !(data[src + i] | (data[src + i + 1] & mask1) |
                          (data[src + i + 2] & mask2));
            }
            if (found) {
                found = false;
                i += esc;
                if (i > end - d || static_cast<std::size_t>(i) >= src_end - src) return kEnd;
                std::memcpy(dst + d, data + src, i);
                d += i;
                zeros_rem = zero_run(data[src + i]);
                src += i + 1;
                again = true;
                break;
            }
            std::memcpy(dst + d, data + src, i);
            src += i;
            d += i;
        }
        if (!again) break;
    }
    *used = src - start;
    return kOk;
}

inline int mid3(int a, int b, int c) {
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// lag_pred_line over a plane in coded order (rows x w), in place.
void predict(std::uint8_t* __restrict s, std::size_t rows, std::size_t w, bool yv12) {
    std::uint8_t acc = 0;
    for (std::size_t i = 0; i < w; ++i) s[i] = acc = static_cast<std::uint8_t>(acc + s[i]);
    for (std::size_t r = 1; r < rows; ++r) {
        std::uint8_t* __restrict row = s + r * w;
        const std::uint8_t* __restrict top = row - w;
        int left = row[-1];
        int tl = r == 1 ? (yv12 ? s[0] : left) : top[-1];
        for (std::size_t i = 0; i < w; ++i) {
            const int t = top[i];
            left = (mid3(left, t, left + t - tl) + row[i]) & 255;
            tl = t;
            row[i] = static_cast<std::uint8_t>(left);
        }
    }
}

// lag_pred_line_yuy2 over a plane, in place.
void predict_yuy2(std::uint8_t* __restrict s, std::size_t rows, std::size_t w, bool luma) {
    const std::uint8_t first = s[0];
    if (luma) s[0] = 0;
    std::uint8_t acc = 0;
    for (std::size_t i = 0; i < w; ++i) s[i] = acc = static_cast<std::uint8_t>(acc + s[i]);
    if (luma) s[0] = first;
    for (std::size_t r = 1; r < rows; ++r) {
        std::uint8_t* __restrict row = s + r * w;
        const std::uint8_t* __restrict top = row - w;
        int left = row[-1], tl;
        std::size_t i = 0;
        if (r == 1) {
            const std::size_t head = std::min<std::size_t>(luma ? 4 : 2, w);
            for (; i < head; ++i) row[i] = static_cast<std::uint8_t>(left = (left + row[i]) & 255);
            tl = i < w ? top[i - 1] : 0;
        } else {
            tl = top[-1];
        }
        for (; i < w; ++i) {
            const int t = top[i];
            left = (mid3(left, t, (left + t - tl) & 255) + row[i]) & 255;
            tl = t;
            row[i] = static_cast<std::uint8_t>(left);
        }
    }
}

// lag_decode_arith_plane: the plane at `offset` of the chunk into out
// (rows x cols, coded order).
int decode_plane(const std::uint8_t* data, std::size_t size, std::size_t offset, int rows,
                 int cols, int predictor, std::uint8_t* out) {
    const std::size_t src_size = size - offset;
    if (src_size < 2) return kEnd;
    const int esc0 = data[offset];
    const std::size_t n = static_cast<std::size_t>(rows) * cols;
    std::uint32_t zeros_rem = 0;
    if (esc0 == 0xff) {
        std::memset(out, data[offset + 1], n);
        return kOk;
    }
    if (esc0 < 4) {
        if (src_size < 5) return kEnd;
        std::size_t at = offset + 1;
        if (esc0 && le32(data + offset + 1) < n) at += 4;
        Rac rac;
        rac.data = data;
        rac.size = size;
        Bits bits{data, 8 * size, 8 * at};
        if (rac.read_header(bits) != kOk) return kProbs;
        rac.start((bits.pos + 7) / 8);
        const int limit = esc0 ? esc0 : -1;
        int zeros = 0;
        for (int r = 0; r < rows; ++r) {
            if (rac.overread > kMaxOverread) return kEnd;
            std::uint8_t* row = out + static_cast<std::size_t>(r) * cols;
            int i = 0;
            while (i < cols) {
                if (zeros_rem) {
                    const int k = static_cast<int>(std::min<std::uint32_t>(zeros_rem, cols - i));
                    std::memset(row + i, 0, k);
                    i += k;
                    zeros_rem -= k;
                    continue;
                }
                const int v = rac.get();
                row[i++] = static_cast<std::uint8_t>(v);
                zeros = v ? 0 : zeros + 1;
                if (zeros == limit) {
                    zeros_rem = zero_run(static_cast<std::uint8_t>(rac.get()));
                    zeros = 0;
                }
            }
        }
    } else if (esc0 < 8) {
        const int esc = esc0 - 4;
        std::size_t src = offset + 1;
        if (esc) {
            for (int r = 0; r < rows; ++r) {
                std::size_t used = 0;
                const int rc = zero_run_line(out + static_cast<std::size_t>(r) * cols, data, src,
                                             size, cols, esc, zeros_rem, &used);
                if (rc != kOk) return rc;
                src += used;
            }
        } else {
            if (size - src < n) return kEnd;
            std::memcpy(out, data + src, n);
        }
    } else {
        return kEscape;
    }
    if (zeros_rem) return kRun;
    if (predictor == kMedian || predictor == kMedianYv12)
        predict(out, rows, cols, predictor == kMedianYv12);
    else
        predict_yuy2(out, rows, cols, predictor == kYuy2Luma);
    return kOk;
}

// The plane FFmpeg decodes q-th (an index in the offsets' order): RGB's
// R - G plane first, then G, B - G and A; YUV's in the offsets' order.
int decode_order(int type, int q) {
    static const int rgb[] = {2, 1, 0, 3};
    return type == kYuy2 || type == kYv12 ? q : rgb[q];
}

struct Frame {
    const std::uint8_t* data;
    std::size_t size;
    int type, planes, rc, where;
    std::size_t offsets[4];
};

struct Item {
    std::size_t frame;
    int plane;
};

thread_local std::vector<std::uint8_t> tls_plane;

}  // namespace

extern "C" {

// Decode k frames (srcs[i], sizes[i] bytes) of a height x width stream:
// RGB and solid frames into dst (frame i at i*height*width*3, BGR), YUY2
// and YV12 frames into planes (frame i at i * plane_bytes: Y, then U,
// then V: yuv422p and yuv420p planes; plane_bytes at least a yuv422p
// frame's).  On up to nthreads threads, a plane a thread.  rcs[i] gets 0
// or a negative code (-1 a chunk
// shorter than its header, -2 a plane offset past the chunk, -3 a
// probability header FFmpeg refuses, -4 data that end early, -5 an escape
// byte FFmpeg refuses, -6 a zero run longer than its row or plane, -7 a
// frame type FFmpeg refuses); wheres[i] the plane it failed in (in the order the offsets
// give them; of several, the first FFmpeg decodes), or -1.
void clt_lagarith_decode_batch(const unsigned char* const* srcs, const std::size_t* sizes,
                               std::size_t k, unsigned char* dst, unsigned char* planes,
                               std::size_t plane_bytes, int height, int width, int nthreads,
                               int* rcs, int* wheres) {
    const std::size_t H = static_cast<std::size_t>(height), W = static_cast<std::size_t>(width);
    const std::size_t frame_px = H * W;
    const int cw = (width + 1) / 2, ch = (height + 1) / 2;
    std::vector<Frame> frames(k);
    std::vector<Item> items;
    items.reserve(4 * k);
    for (std::size_t i = 0; i < k; ++i) {
        Frame& f = frames[i];
        f.data = srcs[i];
        f.size = sizes[i];
        f.rc = kOk;
        f.where = -1;
        f.planes = 0;
        f.type = f.size ? f.data[0] : -1;
        const bool yuv = f.type == kYuy2 || f.type == kYv12;
        int need;
        switch (f.type) {
            case kURgb24: case kRgb24: case kYuy2: case kYv12: need = 9; f.planes = 3; break;
            case kRgba: need = 13; f.planes = 4; break;
            case kSolidGray: need = 2; break;
            case kSolidColor: need = 4; break;
            case kSolidRgba: need = 5; break;
            default: need = -1;
        }
        if (!f.size) {
            f.rc = kHeader;
            continue;
        }
        if (need < 0 || height < 1 || width < 1) {
            f.rc = kType;
            continue;
        }
        if (f.size < static_cast<std::size_t>(need)) {
            f.rc = kHeader;
            continue;
        }
        if (yuv && (!planes || plane_bytes < frame_px + 2 * H * cw)) {
            f.rc = kType;
            continue;
        }
        if (!f.planes) continue;
        f.offsets[0] = f.type == kRgba ? 13 : 9;
        f.offsets[1] = le32(f.data + 1);
        f.offsets[2] = le32(f.data + 5);
        if (f.type == kRgba) f.offsets[3] = le32(f.data + 9);
        for (int q = 0; q < f.planes; ++q) {
            const int p = decode_order(f.type, q);
            if (f.offsets[p] >= f.size) {
                f.rc = kOffset;
                f.where = p;
                break;
            }
        }
        if (f.rc == kOk)
            for (int p = 0; p < f.planes; ++p) items.push_back({i, p});
    }
    std::vector<int> item_rc(items.size(), kOk);
    parallel_items(items.size(), nthreads, [&](std::size_t j) {
        const Item it = items[j];
        const Frame& f = frames[it.frame];
        int rows = height, cols = width, predictor = kMedian;
        std::uint8_t* out;
        if (f.type == kYuy2 || f.type == kYv12) {
            std::uint8_t* base = planes + it.frame * plane_bytes;
            const int crows = f.type == kYv12 ? ch : height;
            const std::size_t cplane = static_cast<std::size_t>(crows) * cw;
            // YUY2 codes Y, U, V; YV12 codes Y, V, U
            const bool u = it.plane == (f.type == kYuy2 ? 1 : 2);
            out = it.plane == 0 ? base : base + frame_px + (u ? 0 : cplane);
            if (it.plane) {
                rows = crows;
                cols = cw;
            }
            predictor = f.type == kYv12 ? kMedianYv12
                        : cols == width ? kYuy2Luma : kYuy2Chroma;
        } else {
            tls_plane.resize(frame_px);
            out = tls_plane.data();
        }
        item_rc[j] = decode_plane(f.data, f.size, f.offsets[it.plane], rows, cols, predictor, out);
        if (item_rc[j] != kOk || f.type == kYuy2 || f.type == kYv12 || it.plane == 3) return;
        // B - G, G, R - G into channels 0, 1, 2, bottom row first
        std::uint8_t* frame = dst + it.frame * frame_px * 3;
        const int c = it.plane;
        for (std::size_t r = 0; r < H; ++r) {
            const std::uint8_t* src = out + r * W;
            std::uint8_t* px = frame + (H - 1 - r) * W * 3 + c;
            for (std::size_t x = 0; x < W; ++x) px[3 * x] = src[x];
        }
    });
    // FFmpeg stops at the first plane that fails in its order
    std::vector<int> rank(k, 4);
    for (std::size_t j = 0; j < items.size(); ++j) {
        Frame& f = frames[items[j].frame];
        int q = 0;
        while (decode_order(f.type, q) != items[j].plane) ++q;
        if (item_rc[j] != kOk && q < rank[items[j].frame]) {
            rank[items[j].frame] = q;
            f.rc = item_rc[j];
            f.where = items[j].plane;
        }
    }
    parallel_items(k, nthreads, [&](std::size_t i) {
        const Frame& f = frames[i];
        rcs[i] = f.rc;
        wheres[i] = f.where;
        if (f.rc != kOk || f.type == kYuy2 || f.type == kYv12) return;
        std::uint8_t* frame = dst + i * frame_px * 3;
        if (!f.planes) {
            const std::uint8_t b = f.data[1];
            const std::uint8_t g = f.type == kSolidGray ? b : f.data[2];
            const std::uint8_t r = f.type == kSolidGray ? b : f.data[3];
            for (std::size_t p = 0; p < frame_px; ++p) {
                frame[3 * p] = b;
                frame[3 * p + 1] = g;
                frame[3 * p + 2] = r;
            }
            return;
        }
        for (std::size_t p = 0; p < frame_px; ++p) {
            const std::uint8_t g = frame[3 * p + 1];
            frame[3 * p] = static_cast<std::uint8_t>(frame[3 * p] + g);
            frame[3 * p + 2] = static_cast<std::uint8_t>(frame[3 * p + 2] + g);
        }
    });
}

int clt_lagarith_version() { return 1; }

}  // extern "C"
