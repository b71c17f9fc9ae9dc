// Native FFV1 encoder for the port's tests and chip_smoke.py: the layouts
// cv2.VideoWriter(fourcc "FFV1") writes (bgra as its BGR, gray8, gray16),
// and bgr0, yuv420p and yuv422p beside them, as FFmpeg 8's ffv1enc.c codes
// them at version 3 (micro version 4, slice CRCs): the Golomb-Rice coder
// with its run mode, or the range coder with the default or FFmpeg's
// ver2_state table; context model 0 or 1; any slice grid and GOP.  It
// gives the bytes of tests/_torch_ffv1_writer.py's Encoder (the Python
// encoder, which the tests hold to cv2's own files), a slice a thread: the
// thread that takes slice s codes it in every frame in turn, carrying its
// context states from frame to frame.
//
// Built with g++ on first use by tests/_torch_ffv1_writer.native_encoder.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

#include "../camera_linearity_tpu_torch/native/parallel.h"

namespace {

constexpr int kContext = 32;

const std::uint8_t kLog2Run[41] = {0,  0,  0,  0,  1,  1,  1,  1,  2,  2,  2,  2,  3,  3,
                                   3,  3,  4,  4,  5,  5,  6,  6,  7,  7,  8,  9,  10, 11,
                                   12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24};

// FFmpeg's ver2_state (ffv1enc.c)
const std::uint8_t kVer2State[256] = {
    0,   10,  10,  10,  10,  16,  16,  16,  28,  16,  16,  29,  42,  49,  20,  49,  59,  25,  26,
    26,  27,  31,  33,  33,  33,  34,  34,  37,  67,  38,  39,  39,  40,  40,  41,  79,  43,  44,
    45,  45,  48,  48,  64,  50,  51,  52,  88,  52,  53,  74,  55,  57,  58,  58,  74,  60,  101,
    61,  62,  84,  66,  66,  68,  69,  87,  82,  71,  97,  73,  73,  82,  75,  111, 77,  94,  78,
    87,  81,  83,  97,  85,  83,  94,  86,  99,  89,  90,  99,  111, 92,  93,  134, 95,  98,  105,
    98,  105, 110, 102, 108, 102, 118, 103, 106, 106, 113, 109, 112, 114, 112, 116, 125, 115, 116,
    117, 117, 126, 119, 125, 121, 121, 123, 145, 124, 126, 131, 127, 129, 165, 130, 132, 138, 133,
    135, 145, 136, 137, 139, 146, 141, 143, 142, 144, 148, 147, 155, 151, 149, 151, 150, 152, 157,
    153, 154, 156, 168, 158, 162, 161, 160, 172, 163, 169, 164, 166, 184, 167, 170, 177, 174, 171,
    173, 182, 176, 180, 178, 175, 189, 179, 181, 186, 183, 192, 185, 200, 187, 191, 188, 190, 197,
    193, 196, 197, 194, 195, 196, 198, 202, 199, 201, 210, 203, 207, 204, 205, 206, 208, 214, 209,
    211, 221, 212, 213, 215, 224, 216, 217, 218, 219, 220, 222, 228, 223, 225, 226, 224, 227, 229,
    240, 230, 231, 232, 233, 234, 235, 236, 238, 239, 237, 242, 241, 243, 242, 244, 245, 246, 247,
    248, 249, 250, 251, 252, 252, 253, 254, 255};

struct Tables {
    std::uint8_t one[256], zero[256];
    std::uint32_t crc[256];
    Tables() {
        // ff_build_rac_states(c, 0.05 * (1LL << 32), 256 - 8)
        const std::int64_t unit = std::int64_t{1} << 32;
        const std::int64_t factor = static_cast<std::int64_t>(0.05 * (1LL << 32));
        const int max_p = 248;
        std::memset(one, 0, sizeof one);
        std::memset(zero, 0, sizeof zero);
        int last_p8 = 0;
        std::int64_t p = unit / 2;
        for (int i = 0; i < 128; ++i) {
            int p8 = static_cast<int>((256 * p + unit / 2) >> 32);
            if (p8 <= last_p8) p8 = last_p8 + 1;
            if (last_p8 && last_p8 < 256 && p8 <= max_p) one[last_p8] = static_cast<std::uint8_t>(p8);
            p += ((unit - p) * factor + unit / 2) >> 32;
            last_p8 = p8;
        }
        for (int i = 256 - max_p; i <= max_p; ++i) {
            if (one[i]) continue;
            p = (i * unit + 128) >> 8;
            p += ((unit - p) * factor + unit / 2) >> 32;
            int p8 = static_cast<int>((256 * p + unit / 2) >> 32);
            if (p8 <= i) p8 = i + 1;
            if (p8 > max_p) p8 = max_p;
            one[i] = static_cast<std::uint8_t>(p8);
        }
        for (int i = 1; i < 255; ++i) zero[i] = static_cast<std::uint8_t>(256 - one[256 - i]);
        for (std::uint32_t i = 0; i < 256; ++i) {
            std::uint32_t c = i << 24;
            for (int k = 0; k < 8; ++k) c = (c & 0x80000000u) ? (c << 1) ^ 0x04C11DB7u : c << 1;
            crc[i] = c;
        }
    }
};
const Tables kTables;

// FFmpeg's range encoder
struct RacWriter {
    std::vector<std::uint8_t>& out;
    std::uint32_t low = 0, range = 0xFF00;
    int outstanding_count = 0, outstanding_byte = -1;
    const std::uint8_t* one = kTables.one;
    const std::uint8_t* zero = kTables.zero;

    explicit RacWriter(std::vector<std::uint8_t>& o) : out(o) {}
    void renorm() {
        while (range < 0x100) {
            if (outstanding_byte < 0) {
                outstanding_byte = static_cast<int>(low >> 8);
            } else if (low <= 0xFF00) {
                out.push_back(static_cast<std::uint8_t>(outstanding_byte));
                for (; outstanding_count; --outstanding_count) out.push_back(0xFF);
                outstanding_byte = static_cast<int>(low >> 8);
            } else if (low >= 0x10000) {
                out.push_back(static_cast<std::uint8_t>(outstanding_byte + 1));
                for (; outstanding_count; --outstanding_count) out.push_back(0x00);
                outstanding_byte = static_cast<int>(low >> 8) - 0x100;
            } else {
                ++outstanding_count;
            }
            low = (low & 0xFF) << 8;
            range <<= 8;
        }
    }
    inline void bit(std::uint8_t* st, int b) {
        const std::uint32_t r1 = (range * *st) >> 8;
        if (!b) {
            range -= r1;
            *st = zero[*st];
        } else {
            low += range - r1;
            range = r1;
            *st = one[*st];
        }
        renorm();
    }
    inline void symbol(std::uint8_t* st, int v, bool is_signed) {
        if (!v) {
            bit(st, 1);
            return;
        }
        const unsigned a = static_cast<unsigned>(v < 0 ? -v : v);
        const int e = 31 - __builtin_clz(a);
        bit(st, 0);
        for (int i = 0; i < e; ++i) bit(st + 1 + std::min(i, 9), 1);
        bit(st + 1 + std::min(e, 9), 0);
        for (int i = e - 1; i >= 0; --i) bit(st + 22 + std::min(i, 9), (a >> i) & 1);
        if (is_signed) bit(st + 11 + std::min(e, 10), v < 0);
    }
    // ff_rac_terminate(c, 1)
    void terminate() {
        std::uint8_t st = 129;
        bit(&st, 0);
        range = 0xFF;
        low += 0xFF;
        renorm();
        range = 0xFF;
        renorm();
    }
};

struct BitWriter {
    std::vector<std::uint8_t>& out;
    std::uint64_t acc = 0;
    int n = 0;
    explicit BitWriter(std::vector<std::uint8_t>& o) : out(o) {}
    inline void put(int bits, std::uint32_t v) {
        acc = acc << bits | (v & ((std::uint64_t{1} << bits) - 1));
        n += bits;
        while (n >= 8) {
            n -= 8;
            out.push_back(static_cast<std::uint8_t>(acc >> n));
        }
    }
    void flush() {
        if (n) out.push_back(static_cast<std::uint8_t>(acc << (8 - n)));
        n = 0;
        acc = 0;
    }
};

struct Vlc {
    int drift = 0, error_sum = 4, bias = 0, count = 1;
};

inline int fold(int v, int bits) {
    const int shift = 32 - bits;
    return static_cast<int>(static_cast<std::uint32_t>(v) << shift) >> shift;
}

// layouts, by their index in _torch_ffv1_writer._NATIVE_LAYOUTS
enum Layout { kBgr0 = 0, kBgra, kGray8, kGray16, kYuv420, kYuv422 };

struct Encoder {
    int height, width, layout, coder, context_model, num_h, num_v, gop, threads;
    int bits, plane_count, h_shift = 0, v_shift = 0;
    bool rgb, alpha, chroma;
    std::vector<std::int16_t> quant;  // the context model's table, 5 x 256
    int contexts = 0;
    std::uint8_t one[256], zero[256];
    long frames = 0;

    struct Slice {
        int sx, sy, x, y, w, h;
        std::vector<std::vector<std::uint8_t>> states;
        std::vector<std::vector<Vlc>> vlc;
        std::vector<std::uint8_t> out;
        int run_index = 0;
    };
    std::vector<Slice> slices;

    Encoder(int h, int w, int lay, int cod, int cm, int nh, int nv, int g, int t)
        : height(h), width(w), layout(lay), coder(cod), context_model(cm), num_h(nh), num_v(nv),
          gop(g), threads(t) {
        rgb = layout == kBgr0 || layout == kBgra;
        alpha = layout == kBgra;
        chroma = rgb || layout == kYuv420 || layout == kYuv422;
        bits = layout == kGray16 ? 16 : 8;
        if (layout == kYuv420) h_shift = v_shift = 1;
        if (layout == kYuv422) h_shift = 1;
        plane_count = 2 + alpha;
        // the run lengths of FFmpeg's tables' levels (_QUANT_RUNS)
        static const std::vector<int> q11 = {1, 1, 3, 7, 23, 93}, q5 = {1, 3, 124},
                                      q9 = {5, 8, 14, 29, 72}, q5_10 = {11, 39, 78}, none = {128};
        const std::vector<int>* runs[5];
        const bool deep = bits > 8;
        for (int i = 0; i < 5; ++i)
            runs[i] = i < 2 ? (deep ? &q9 : &q11)
                            : i == 2 ? (context_model ? (deep ? &q5_10 : &q5) : (deep ? &q9 : &q11))
                                     : (context_model ? (deep ? &q5_10 : &q5) : &none);
        quant.assign(5 * 256, 0);
        int count = 1;
        for (int i = 0; i < 5; ++i) {
            std::int16_t* t = quant.data() + 256 * i;
            int k = 0, v = 0;
            for (int n : *runs[i]) {
                for (int j = 0; j < n; ++j) t[k++] = static_cast<std::int16_t>(count * v);
                ++v;
            }
            for (int j = 1; j < 128; ++j) t[256 - j] = static_cast<std::int16_t>(-t[j]);
            t[128] = static_cast<std::int16_t>(-t[127]);
            count *= 2 * v - 1;
        }
        contexts = (count + 1) / 2;
        std::memcpy(one, kTables.one, 256);
        std::memcpy(zero, kTables.zero, 256);
        if (coder == 2)
            for (int j = 1; j < 256; ++j) {
                one[j] = kVer2State[j];
                zero[256 - j] = static_cast<std::uint8_t>(256 - one[j]);
            }
        for (int i = 0; i < num_h * num_v; ++i) {
            Slice s;
            s.sx = i % num_h;
            s.sy = i / num_h;
            const auto coord = [](int size, int n, int k) {
                return static_cast<int>(static_cast<std::int64_t>(size) * k / n);
            };
            s.x = coord(width, num_h, s.sx);
            s.y = coord(height, num_v, s.sy);
            s.w = coord(width, num_h, s.sx + 1) - s.x;
            s.h = coord(height, num_v, s.sy + 1) - s.y;
            slices.push_back(std::move(s));
        }
    }

    void reset(Slice& s) const {
        s.states.assign(plane_count, std::vector<std::uint8_t>(static_cast<std::size_t>(contexts) * kContext, 128));
        s.vlc.assign(plane_count, std::vector<Vlc>(contexts));
    }

    static void vlc_symbol(BitWriter& pb, Vlc& st, int v, int nbits) {
        v = fold(v - st.bias, nbits);
        int k = 0;
        for (int i = st.count; i < st.error_sum; i += i) ++k;
        const int code = (2 * st.drift + st.count < 0) ? ~v : v;
        const std::uint32_t u = static_cast<std::uint32_t>(2 * code) ^ static_cast<std::uint32_t>(code >> 31);
        const std::uint32_t e = u >> k;
        if (e < 12)
            pb.put(static_cast<int>(e) + k + 1, (1u << k) + (u & ((1u << k) - 1)));
        else
            pb.put(12 + nbits, u - 12 + 1);
        st.error_sum += v < 0 ? -v : v;
        st.drift += v;
        if (st.count == 128) {
            st.count >>= 1;
            st.drift >>= 1;
            st.error_sum >>= 1;
        }
        st.count++;
        if (st.drift <= -st.count) {
            st.bias = std::max(st.bias - 1, -128);
            st.drift = std::max(st.drift + st.count, -st.count + 1);
        } else if (st.drift > 0) {
            st.bias = std::min(st.bias + 1, 127);
            st.drift = std::min(st.drift - st.count, 0);
        }
    }

    // encode_line of `values` into cur (the decoder's row buffer)
    void line(Slice& s, RacWriter& rac, BitWriter* pb, int* cur, const int* prev,
              const int* values, int plane, int nbits, int w) const {
        const std::int16_t *q0 = quant.data(), *q1 = q0 + 256, *q2 = q0 + 512, *q3 = q0 + 768,
                           *q4 = q0 + 1024;
        const bool five = q3[127] || q4[127];
        std::uint8_t* states = s.states[plane].data();
        Vlc* vlc = s.vlc[plane].data();
        int run_mode = 0, run_count = 0, ri = s.run_index;
        for (int x = 0; x < w; ++x) {
            const int L = cur[x - 1], T = prev[x], LT = prev[x - 1], RT = prev[x + 1];
            int ctx = q0[(L - LT) & 0xFF] + q1[(LT - T) & 0xFF] + q2[(T - RT) & 0xFF];
            if (five) ctx += q3[(cur[x - 2] - L) & 0xFF] + q4[(cur[x] - T) & 0xFF];
            const int b = L + T - LT;
            int lo = L, hi = b;
            if (lo > hi) std::swap(lo, hi);
            const int pred = hi < T ? hi : (lo > T ? lo : T);
            const int v = values[x];
            int diff = v - pred;
            if (ctx < 0) {
                ctx = -ctx;
                diff = -diff;
            }
            diff = fold(diff, nbits);
            if (!pb) {
                rac.symbol(states + static_cast<std::size_t>(ctx) * kContext, diff, true);
            } else {
                if (ctx == 0) run_mode = 1;
                if (run_mode) {
                    if (diff) {
                        while (run_count >= 1 << kLog2Run[ri]) {
                            run_count -= 1 << kLog2Run[ri];
                            ++ri;
                            pb->put(1, 1);
                        }
                        pb->put(1 + kLog2Run[ri], static_cast<std::uint32_t>(run_count));
                        if (ri) --ri;
                        run_count = run_mode = 0;
                        if (diff > 0) --diff;
                    } else {
                        ++run_count;
                    }
                }
                if (!run_mode) vlc_symbol(*pb, vlc[ctx], diff, nbits);
            }
            cur[x] = v;
        }
        if (run_mode) {
            while (run_count >= 1 << kLog2Run[ri]) {
                run_count -= 1 << kLog2Run[ri];
                ++ri;
                pb->put(1, 1);
            }
            if (run_count) pb->put(1, 1);
        }
        s.run_index = ri;
    }

    // encode_plane: sample(y, x) gives the stored sample
    template <typename Sample>
    void plane(Slice& s, RacWriter& rac, BitWriter* pb, int w, int h, int plane_index, int nbits,
               Sample sample) const {
        std::vector<int> rows(2 * static_cast<std::size_t>(w + 6), 0), values(w);
        int* r[2] = {rows.data() + 3, rows.data() + w + 6 + 3};
        s.run_index = 0;
        for (int y = 0; y < h; ++y) {
            std::swap(r[0], r[1]);
            r[1][-1] = r[0][0];
            r[0][w] = r[0][w - 1];
            for (int x = 0; x < w; ++x) values[x] = sample(y, x);
            line(s, rac, pb, r[1], r[0], values.data(), plane_index, nbits, w);
        }
    }

    void rgb_frame(Slice& s, RacWriter& rac, BitWriter* pb, const std::uint8_t* bgra) const {
        const int w = s.w, planes = alpha ? 4 : 3;
        std::vector<int> rows(8 * static_cast<std::size_t>(w + 6), 0), values(4 * static_cast<std::size_t>(w));
        int* r[4][2];
        for (int k = 0; k < 4; ++k) {
            r[k][0] = rows.data() + 2 * k * (w + 6) + 3;
            r[k][1] = rows.data() + (2 * k + 1) * (w + 6) + 3;
        }
        s.run_index = 0;
        for (int y = 0; y < s.h; ++y) {
            const std::uint8_t* px = bgra + (static_cast<std::size_t>(s.y + y) * width + s.x) * 4;
            for (int x = 0; x < w; ++x) {
                int b = px[4 * x], g = px[4 * x + 1], rr = px[4 * x + 2];
                b -= g;
                rr -= g;
                g += (b + rr) >> 2;
                values[x] = g;
                values[w + x] = b + 256;
                values[2 * w + x] = rr + 256;
                values[3 * w + x] = px[4 * x + 3];
            }
            for (int k = 0; k < planes; ++k) {
                std::swap(r[k][0], r[k][1]);
                r[k][1][-1] = r[k][0][0];
                r[k][0][w] = r[k][0][w - 1];
                line(s, rac, pb, r[k][1], r[k][0], values.data() + k * w, (k + 1) / 2, 9, w);
            }
        }
    }

    void encode_slice(Slice& s, bool key, const std::uint8_t* src) const {
        s.out.clear();
        std::vector<std::uint8_t> tail;
        RacWriter rac(s.out);
        if (s.sx == 0 && s.sy == 0) {
            std::uint8_t keystate = 128;
            rac.bit(&keystate, key);
        }
        rac.one = one;
        rac.zero = zero;
        if (key) reset(s);
        std::uint8_t hs[kContext];
        std::memset(hs, 128, sizeof hs);
        for (int v : {s.sx, s.sy, 0, 0}) rac.symbol(hs, v, false);
        for (int k = 0; k < plane_count; ++k) rac.symbol(hs, context_model, false);
        for (int v : {3, 0, 1}) rac.symbol(hs, v, false);
        BitWriter bw(tail);
        BitWriter* pb = nullptr;
        if (coder == 0) {
            rac.terminate();
            pb = &bw;
        }
        if (rgb) {
            rgb_frame(s, rac, pb, src);
        } else if (!chroma) {
            if (bits == 16) {
                const std::uint16_t* px = reinterpret_cast<const std::uint16_t*>(src);
                plane(s, rac, pb, s.w, s.h, 0, 16, [&](int y, int x) {
                    return static_cast<int>(static_cast<std::int16_t>(
                        px[static_cast<std::size_t>(s.y + y) * width + s.x + x]));
                });
            } else {
                plane(s, rac, pb, s.w, s.h, 0, 8, [&](int y, int x) {
                    return static_cast<int>(src[static_cast<std::size_t>(s.y + y) * width + s.x + x]);
                });
            }
        } else {
            const int cw = -(-width >> h_shift), ch = -(-height >> v_shift);
            const std::uint8_t* planes[3] = {src, src + static_cast<std::size_t>(width) * height,
                                             src + static_cast<std::size_t>(width) * height +
                                                 static_cast<std::size_t>(cw) * ch};
            plane(s, rac, pb, s.w, s.h, 0, 8, [&](int y, int x) {
                return static_cast<int>(planes[0][static_cast<std::size_t>(s.y + y) * width + s.x + x]);
            });
            const int sw = -(-s.w >> h_shift), sh = -(-s.h >> v_shift);
            const int cx = s.x >> h_shift, cy = s.y >> v_shift;
            for (int k = 1; k <= 2; ++k)
                plane(s, rac, pb, sw, sh, 1, 8, [&](int y, int x) {
                    return static_cast<int>(planes[k][static_cast<std::size_t>(cy + y) * cw + cx + x]);
                });
        }
        if (coder == 0) {
            bw.flush();
            s.out.insert(s.out.end(), tail.begin(), tail.end());
        } else {
            rac.terminate();
        }
        const std::size_t n = s.out.size();
        s.out.push_back(static_cast<std::uint8_t>(n >> 16));
        s.out.push_back(static_cast<std::uint8_t>(n >> 8));
        s.out.push_back(static_cast<std::uint8_t>(n));
        s.out.push_back(0);
        std::uint32_t crc = 0;
        for (std::uint8_t b : s.out) crc = (crc << 8) ^ kTables.crc[(crc >> 24) ^ b];
        for (int k = 3; k >= 0; --k) s.out.push_back(static_cast<std::uint8_t>(crc >> (8 * k)));
    }
};

}  // namespace

extern "C" {

void* clt_ffv1_enc_new(int height, int width, int layout, int coder, int context_model, int num_h,
                       int num_v, int gop, int threads) {
    if (height < 1 || width < 1 || layout < 0 || layout > kYuv422 || coder < 0 || coder > 2 ||
        num_h < 1 || num_v < 1 || num_h > width || num_v > height)
        return nullptr;
    return new Encoder(height, width, layout, coder, context_model ? 1 : 0, num_h, num_v, gop, threads);
}

void clt_ffv1_enc_free(void* enc) { delete static_cast<Encoder*>(enc); }

// Code the next frame of src (BGRA bytes, gray8 bytes, gray16 words, or Y,
// U, V planes back to back) into out; returns its bytes, -1 where cap is
// too small.
std::int64_t clt_ffv1_enc_frame(void* handle, const void* src, void* out, std::size_t cap, int) {
    auto* e = static_cast<Encoder*>(handle);
    const bool key = e->gop <= 1 || e->frames % e->gop == 0;
    ++e->frames;
    const auto* px = static_cast<const std::uint8_t*>(src);
    parallel_items(e->slices.size(), e->threads,
                   [&](std::size_t i) { e->encode_slice(e->slices[i], key, px); });
    std::size_t n = 0;
    for (const auto& s : e->slices) n += s.out.size();
    if (n > cap) return -1;
    auto* o = static_cast<std::uint8_t*>(out);
    for (const auto& s : e->slices) {
        std::memcpy(o, s.out.data(), s.out.size());
        o += s.out.size();
    }
    return static_cast<std::int64_t>(n);
}

}  // extern "C"
