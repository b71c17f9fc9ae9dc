// Native Lagarith encoder for the port's tests and chip_smoke.py: the bytes
// of tests/_torch_lagarith_writer.py's encode_picture (the Python encoder,
// which the tests hold to cv2's decode) for the range-coded, raw and
// filled escape forms, fast enough for 4K frames.  One call codes one
// frame, so callers code many on as many threads as they like (ctypes lets
// go of the GIL during the call).
//
// Built with g++ on first use by tests/_torch_lagarith_writer.native_encoder.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Predictor { kMedian, kMedianYv12, kYuy2Luma, kYuy2Chroma };
constexpr std::uint64_t kMaxTotal = 1u << 22;

inline int av_log2(std::uint64_t v) { return v ? 63 - __builtin_clzll(v) : 0; }

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

// lagarith_plain.scale_probs: the decoder's cumulative table and scale,
// false where it refuses the counts.
bool scale_probs(const std::uint64_t* counts, std::uint32_t* cum, int* scale) {
    std::uint64_t prob[257];
    prob[0] = 0;
    std::uint64_t total = 0;
    for (int i = 1; i < 257; ++i) total += prob[i] = counts[i - 1];
    if (!total || total > 0xFFFFFFFFull) return false;
    int sc = av_log2(total);
    if (total & (total - 1)) {
        const std::uint64_t mul = softfloat_reciprocal(static_cast<std::uint32_t>(total));
        std::uint64_t low = 0, scaled = 0;
        for (int i = 1; i < 257; ++i) {
            prob[i] = softfloat_mul(static_cast<std::uint32_t>(prob[i]), mul);
            scaled += prob[i];
            if (i <= 128) low += prob[i];
        }
        if (!low) return false;
        if (++sc >= 32) return false;
        const std::uint64_t target = std::uint64_t{1} << sc;
        if (scaled > target) return false;
        for (int i = 1, rest = static_cast<int>(target - scaled); rest; i = (i & 0x7f) + 1)
            if (prob[i]) ++prob[i], --rest;
    }
    if (sc > 23) return false;
    *scale = sc;
    cum[0] = 0;
    for (int i = 1; i < 257; ++i) cum[i] = static_cast<std::uint32_t>(cum[i - 1] + prob[i]);
    return true;
}

// counts_for: the histogram, scaled down to at most 2^22, nudged until
// every coded symbol keeps a nonzero probability.
bool counts_for(const std::vector<std::uint8_t>& sym, std::uint64_t* counts, std::uint32_t* cum,
                int* scale) {
    std::uint64_t hist[256] = {0};
    for (std::uint8_t s : sym) ++hist[s];
    const std::uint64_t total = sym.size();
    for (int s = 0; s < 256; ++s)
        counts[s] = total > kMaxTotal && hist[s] ? std::max<std::uint64_t>(hist[s] * kMaxTotal / total, 1)
                                                 : hist[s];
    bool low = false;
    for (int s = 0; s < 128; ++s) low = low || counts[s];
    if (!low) counts[0] = 1;
    for (int round = 0; round < 64; ++round) {
        if (!scale_probs(counts, cum, scale)) return false;
        bool dead = false;
        std::uint64_t bump[256] = {0};
        for (int s = 0; s < 256; ++s)
            if (hist[s] && cum[s + 1] == cum[s]) dead = true, bump[s] = 1 + counts[s];
        if (!dead) return true;
        for (int s = 0; s < 256; ++s) counts[s] += bump[s];
    }
    return false;
}

inline int mid3(int a, int b, int c) {
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// residuals(): the decoder's predictor inverted on a known plane.
void residuals(const std::uint8_t* x, std::size_t h, std::size_t w, int pred, std::uint8_t* res) {
    const bool yuy2 = pred == kYuy2Luma || pred == kYuy2Chroma;
    for (std::size_t i = 0; i < w; ++i) res[i] = static_cast<std::uint8_t>(x[i] - (i ? x[i - 1] : 0));
    if (pred == kYuy2Luma) {
        res[0] = x[0];
        if (w > 1) res[1] = x[1];
    }
    const std::size_t head = yuy2 ? std::min<std::size_t>(pred == kYuy2Luma ? 4 : 2, w) : 0;
    for (std::size_t j = w; j < h * w; ++j) {
        const int left = x[j - 1], top = x[j - w];
        const int tl = j == w ? (pred == kMedianYv12 ? x[0] : x[w - 1]) : x[j - w - 1];
        int p;
        if (yuy2 && j - w < head) p = left;
        else p = mid3(left, top, yuy2 ? (left + top - tl) & 255 : left + top - tl);
        res[j] = static_cast<std::uint8_t>(x[j] - p);
    }
}

void run_symbols(const std::uint8_t* res, std::size_t n, int esc, std::vector<std::uint8_t>& out) {
    out.clear();
    out.reserve(n + 16);
    int zeros = 0;
    for (std::size_t p = 0; p < n;) {
        const std::uint8_t v = res[p++];
        out.push_back(v);
        zeros = v ? 0 : zeros + 1;
        if (esc && zeros == esc) {
            std::size_t run = 0;
            while (run < 255 && p + run < n && !res[p + run]) ++run;
            out.push_back(static_cast<std::uint8_t>(run % 2 == 0 ? run / 2 : 256 - (run + 1) / 2));
            p += run;
            zeros = 0;
        }
    }
}

struct BitWriter {
    std::vector<std::uint8_t>& out;
    std::uint32_t acc = 0;
    int n = 0;
    void put(std::uint32_t bit) {
        acc = acc << 1 | bit;
        if (++n == 8) out.push_back(static_cast<std::uint8_t>(acc)), acc = 0, n = 0;
    }
    void flush() {
        while (n) put(0);
    }
};

// lagarith_plain.prob_bits
void put_prob(BitWriter& bw, std::uint64_t value) {
    static const int fib[] = {1, 2, 3, 5, 8, 13, 21};
    const int n = av_log2(value + 1) + 1;
    int code[7] = {0}, rest = n, top = -1;
    for (int k = 6; k >= 0; --k)
        if (fib[k] <= rest) code[k] = 1, rest -= fib[k], top = std::max(top, k);
    for (int k = 0; k <= top; ++k) bw.put(code[k]);
    if (top < 6) bw.put(1);
    for (int b = n - 2; b >= 0; --b) bw.put(static_cast<std::uint32_t>(((value + 1) >> b) & 1));
}

void prob_header(const std::uint64_t* counts, std::vector<std::uint8_t>& out) {
    BitWriter bw{out};
    for (int i = 0; i < 256;) {
        put_prob(bw, counts[i]);
        ++i;
        if (!counts[i - 1]) {
            int run = 0;
            while (i + run < 256 && !counts[i + run]) ++run;
            put_prob(bw, static_cast<std::uint64_t>(run));
            i += run;
        }
    }
    bw.flush();
}

// range_encode(): mirrors lagarithrac's decoder, the carry running back
// into the bytes written.
void range_encode(const std::vector<std::uint8_t>& sym, const std::uint32_t* cum, int scale,
                  std::vector<std::uint8_t>& out) {
    const std::size_t first = out.size();
    std::uint64_t low = 0;
    std::uint32_t rng = 0x80;
    int width = 7;
    for (std::uint8_t s : sym) {
        while (rng <= 0x800000) {
            low <<= 8;
            rng <<= 8;
            width += 8;
            if (width > 31) {
                out.push_back(static_cast<std::uint8_t>(low >> 31));
                low &= (std::uint64_t{1} << 31) - 1;
                width = 31;
            }
        }
        const std::uint32_t rs = rng >> scale;
        low += static_cast<std::uint64_t>(rs) * cum[s];
        rng = s == 255 ? rng - rs * cum[255] : rs * (cum[s + 1] - cum[s]);
        if (low >> width) {
            low -= std::uint64_t{1} << width;
            std::size_t j = out.size() - 1;
            while (out[j] == 0xFF && j > first) out[j--] = 0;
            ++out[j];
        }
    }
    const int bytes = (width + 1) / 8;
    const std::uint64_t tail = low << 1;
    for (int b = bytes - 1; b >= 0; --b) out.push_back(static_cast<std::uint8_t>(tail >> (8 * b)));
}

// encode_plane: one plane's bytes into `bytes` under escape esc (-1: 1
// where its zero runs leave fewer symbols than samples, else 0; 0-4), a
// constant plane as a filled one; 0, or -2 where the counts cannot be
// coded.
int encode_plane(const std::uint8_t* plane, int rows, int cols, int predictor, int esc,
                 std::vector<std::uint8_t>& bytes) {
    const std::size_t n = static_cast<std::size_t>(rows) * cols;
    bytes.clear();
    bool constant = n > 0;
    for (std::size_t i = 1; i < n && constant; ++i) constant = plane[i] == plane[0];
    if (constant) {
        bytes = {0xFF, plane[0]};
        return 0;
    }
    std::vector<std::uint8_t> res(n), sym;
    residuals(plane, rows, cols, predictor, res.data());
    if (esc < 0) {
        run_symbols(res.data(), n, 1, sym);
        esc = sym.size() < n ? 1 : 0;
    }
    if (esc == 4) {
        bytes.reserve(n + 1);
        bytes.push_back(4);
        bytes.insert(bytes.end(), res.begin(), res.end());
        return 0;
    }
    if (sym.empty() || esc != 1) run_symbols(res.data(), n, esc, sym);
    if (esc && sym.size() >= n) return -2;
    std::uint64_t counts[256];
    std::uint32_t cum[258];
    int scale = 0;
    if (!counts_for(sym, counts, cum, &scale)) return -2;
    bytes.reserve(sym.size() + sym.size() / 8 + 1024);
    bytes.push_back(static_cast<std::uint8_t>(esc));
    if (esc)
        for (int b = 0; b < 4; ++b) bytes.push_back(static_cast<std::uint8_t>(sym.size() >> (8 * b)));
    prob_header(counts, bytes);
    range_encode(sym, cum, scale, bytes);
    return 0;
}

}  // namespace

extern "C" {

// Code one frame of type 2 or 4 (RGB24: src a height x width x 3 B, G, R
// picture), 8 (RGBA: x 4 B, G, R, A), 3 (YUY2) or 10 (YV12: src the Y, U
// and V planes one after another), each plane under escape esc (-1: 1
// where its zero runs leave fewer symbols than samples, else 0; 0-4), a
// constant plane as a filled one, into out (cap bytes): the type, the
// offsets, the planes.
// Returns the chunk's length, -1 where out is too small, -2 where a
// plane's counts cannot be coded, -3 for another type.
long long clt_lagarith_enc_frame(int type, const unsigned char* src, int height, int width,
                                 int esc, unsigned char* out, std::size_t cap) {
    const std::size_t H = height, W = width, px = H * W;
    const bool rgb = type == 2 || type == 4 || type == 8;
    if (!rgb && type != 3 && type != 10) return -3;
    std::vector<std::vector<std::uint8_t>> planes;
    std::vector<int> rows, cols, preds;
    if (rgb) {
        const int c = type == 8 ? 4 : 3;
        planes.assign(c, std::vector<std::uint8_t>(px));
        // coded bottom-up: B - G, G, R - G (and A)
        for (std::size_t r = 0; r < H; ++r) {
            const std::uint8_t* row = src + (H - 1 - r) * W * c;
            for (std::size_t x = 0; x < W; ++x) {
                const std::uint8_t* p = row + x * c;
                const std::size_t i = r * W + x;
                planes[0][i] = static_cast<std::uint8_t>(p[0] - p[1]);
                planes[1][i] = p[1];
                planes[2][i] = static_cast<std::uint8_t>(p[2] - p[1]);
                if (c == 4) planes[3][i] = p[3];
            }
        }
        rows.assign(c, height);
        cols.assign(c, width);
        preds.assign(c, kMedian);
    } else {
        const int cw = (width + 1) / 2, ch = type == 10 ? (height + 1) / 2 : height;
        const std::size_t cplane = static_cast<std::size_t>(ch) * cw;
        const std::uint8_t* u = src + px;
        const std::uint8_t* v = u + cplane;
        // YUY2 codes Y, U, V; YV12 Y, V, U
        planes.emplace_back(src, src + px);
        planes.emplace_back(type == 3 ? u : v, (type == 3 ? u : v) + cplane);
        planes.emplace_back(type == 3 ? v : u, (type == 3 ? v : u) + cplane);
        rows = {height, ch, ch};
        cols = {width, cw, cw};
        const int chroma = type == 10 ? kMedianYv12 : cw == width ? kYuy2Luma : kYuy2Chroma;
        preds = {type == 10 ? kMedianYv12 : kYuy2Luma, chroma, chroma};
    }
    const std::size_t head = type == 8 ? 13 : 9;
    std::size_t at = head;
    std::vector<std::uint8_t> bytes;
    std::vector<std::size_t> offsets;
    for (std::size_t k = 0; k < planes.size(); ++k) {
        if (encode_plane(planes[k].data(), rows[k], cols[k], preds[k], esc, bytes)) return -2;
        if (at + bytes.size() > cap) return -1;
        std::memcpy(out + at, bytes.data(), bytes.size());
        offsets.push_back(at);
        at += bytes.size();
    }
    out[0] = static_cast<std::uint8_t>(type);
    for (std::size_t k = 1; k < planes.size(); ++k)
        for (int b = 0; b < 4; ++b)
            out[1 + 4 * (k - 1) + b] = static_cast<std::uint8_t>(offsets[k] >> (8 * b));
    return static_cast<long long>(at);
}

}  // extern "C"
