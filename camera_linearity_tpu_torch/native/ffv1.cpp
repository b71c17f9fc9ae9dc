// Native FFV1 decoder for camera_linearity_tpu_torch: the frames of an FFV1
// AVI as FFmpeg's ffv1dec.c decodes them (RFC 9043), into the BGR bytes
// cv2.VideoCapture gives, or into the YUV planes the rawvideo converter of
// jpeg.cpp turns into them.
//
// A stream is decoded by one decoder object (clt_ffv1_new), which keeps
// every slice's context states from one batch call to the next: FFV1 resets
// them only on a keyframe, so frames are decoded in order.  A batch call
// walks each frame's keyframe bit, header (versions 0-2) and slice trailers
// on the calling thread, then decodes a slice a thread: the thread that
// takes slice s decodes slice s of every frame in turn, carrying its
// states.  It does so in rounds that each start at a keyframe, which may
// change the slice count and each slice's tables.  native/ffv1_plain.py is the plain version the tests
// hold this to, and has each rule's origin.
//
// Built as a plain shared library with g++ on first use;
// camera_linearity_tpu_torch.native loads it with ctypes.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

#include "parallel.h"

namespace {

constexpr int kOk = 0;
constexpr int kCrc = -1;          // a slice whose CRC fails
constexpr int kChain = -2;        // a slice whose size runs past the chunk
constexpr int kNoKeyframe = -3;   // the first frame is no keyframe
constexpr int kDataEnd = -4;      // the data end before the slice's samples
constexpr int kSliceHeader = -5;  // a slice header out of range
constexpr int kSymbol = -6;       // a symbol of more than 32 bits, a bad header
constexpr int kLayoutChange = -7; // a keyframe header that changes the layout
constexpr int kSliceCount = -8;   // a frame of another slice count than its keyframe
constexpr int kEmpty = -9;        // a chunk of fewer than 2 bytes
constexpr int kFailed = -10;      // an earlier call failed: the states are lost
constexpr int kChromaGap = -11;   // a slice that leaves the last chroma row undecoded

constexpr int kContext = 32;
constexpr int kMaxSlices = 1024;
constexpr int kGolomb = 0, kRangeCustom = 2;

const std::uint8_t kLog2Run[41] = {0,  0,  0,  0,  1,  1,  1,  1,  2,  2,  2,  2,  3,  3,
                                   3,  3,  4,  4,  5,  5,  6,  6,  7,  7,  8,  9,  10, 11,
                                   12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24};

struct CrcTable {
    std::uint32_t t[256];
    CrcTable() {
        for (std::uint32_t i = 0; i < 256; ++i) {
            std::uint32_t c = i << 24;
            for (int k = 0; k < 8; ++k) c = (c & 0x80000000u) ? (c << 1) ^ 0x04C11DB7u : c << 1;
            t[i] = c;
        }
    }
};
const CrcTable kCrcTable;

// FFmpeg's AV_CRC_32_IEEE: most significant bit first, no final xor.
std::uint32_t crc32(const std::uint8_t* p, std::size_t n, std::uint32_t crc) {
    for (std::size_t i = 0; i < n; ++i) crc = (crc << 8) ^ kCrcTable.t[(crc >> 24) ^ p[i]];
    return crc;
}

// ff_build_rac_states(c, 0.05 * (1LL << 32), 256 - 8)
struct States {
    std::uint8_t one[256], zero[256];
    States() {
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
    }
};
const States kDefault;

struct Fail {
    int rc;
};

// FFmpeg's range decoder over [p, end); bytes past the end are not read.
struct Rac {
    const std::uint8_t* p;
    const std::uint8_t* end;
    std::uint32_t low = 0, range = 0xFF00;
    int overread = 0;
    const std::uint8_t* one = kDefault.one;
    const std::uint8_t* zero = kDefault.zero;

    Rac(const std::uint8_t* b, const std::uint8_t* e) : p(b + 2), end(e) {
        if (e - b >= 2) low = static_cast<std::uint32_t>(b[0]) << 8 | b[1];
        if (low >= 0xFF00) {
            low = 0xFF00;
            end = p;
        }
    }
    inline void refill() {
        if (range < 0x100) {
            range <<= 8;
            low <<= 8;
            if (p < end)
                low += *p++;
            else
                ++overread;
        }
    }
    inline int bit(std::uint8_t* st) {
        const std::uint32_t r1 = (range * *st) >> 8;
        range -= r1;
        if (low < range) {
            *st = zero[*st];
            refill();
            return 0;
        }
        low -= range;
        *st = one[*st];
        range = r1;
        refill();
        return 1;
    }
    inline int symbol(std::uint8_t* st, bool is_signed) {
        if (bit(st)) return 0;
        int e = 0;
        while (bit(st + 1 + std::min(e, 9))) {
            if (++e > 31) throw Fail{kSymbol};
        }
        std::uint32_t a = 1;
        for (int i = e - 1; i >= 0; --i) a += a + bit(st + 22 + std::min(i, 9));
        const bool neg = is_signed && bit(st + 11 + std::min(e, 10));
        return neg ? -static_cast<int>(a) : static_cast<int>(a);
    }
};

// The Golomb-Rice bits, most significant first; bits past the end read 0.
struct Bits {
    const std::uint8_t* data;
    std::size_t size, pos = 0;  // pos in bits
    Bits(const std::uint8_t* d, std::size_t n) : data(d), size(n) {}
    inline std::uint32_t peek32() const {
        const std::size_t byte = pos >> 3;
        std::uint64_t v = 0;
        if (byte + 8 <= size) {
            std::memcpy(&v, data + byte, 8);
            v = __builtin_bswap64(v);
        } else {
            for (int i = 0; i < 8; ++i) v = v << 8 | (byte + i < size ? data[byte + i] : 0);
        }
        return static_cast<std::uint32_t>(v << (pos & 7) >> 32);
    }
    inline std::uint32_t get(int n) {
        if (!n) return 0;
        const std::uint32_t v = peek32() >> (32 - n);
        pos += n;
        return v;
    }
    long left() const { return static_cast<long>(size * 8) - static_cast<long>(pos); }
    // get_ur_golomb(k, limit 12, esc_len), folded as get_sr_golomb
    inline int golomb(int k, int esc_len) {
        const std::uint32_t w = peek32();
        const int q = w ? __builtin_clz(w) : 32;
        std::uint32_t v;
        if (q < 12 && q + 1 + k <= 32) {
            // the k bits after the stop bit are in the same word
            const std::uint32_t rest = k ? (w << (q + 1)) >> (32 - k) : 0;
            pos += q + 1 + k;
            v = (static_cast<std::uint32_t>(q) << k) + rest;
        } else if (q < 12) {
            pos += q + 1;
            v = (static_cast<std::uint32_t>(q) << k) + get(k);
        } else {
            pos += 12;
            v = get(esc_len) + 11;
        }
        return static_cast<int>(v >> 1) ^ -static_cast<int>(v & 1);
    }
};

struct Vlc {
    int drift = 0, error_sum = 4, bias = 0, count = 1;
};

inline int fold(int v, int bits) {
    const int shift = 32 - bits;
    return static_cast<int>(static_cast<std::uint32_t>(v) << shift) >> shift;
}

struct Params {
    int version, micro, coder, colorspace, bits, chroma_planes, h_shift, v_shift, alpha;
    int num_h, num_v, ec, plane_count;
    std::vector<std::int16_t> quant;  // table i at i * 5 * 256
    std::vector<int> contexts;
    std::vector<std::vector<std::uint8_t>> initial;  // empty: 128
    std::uint8_t one[256], zero[256];
    int combined() const { return version << 16 | micro; }
};

struct Rect {
    int x, y, w, h;
};

struct SliceState {
    std::vector<int> tables;
    std::vector<std::vector<std::uint8_t>> states;
    std::vector<std::vector<Vlc>> vlc;
    void reset(const Params& p) {
        states.assign(tables.size(), {});
        vlc.assign(tables.size(), {});
        for (std::size_t k = 0; k < tables.size(); ++k) {
            const int idx = tables[k], n = p.contexts[idx];
            if (p.initial[idx].empty())
                states[k].assign(static_cast<std::size_t>(n) * kContext, 128);
            else
                states[k] = p.initial[idx];
            vlc[k].assign(n, Vlc{});
        }
    }
};

// the slice-grid rectangle of positions (sx, sy, sw, sh)
Rect slice_rect(const Params& p, int height, int width, int sx, int sy, int sw, int sh) {
    const auto coord = [](int size, int n, int k) {
        return static_cast<int>(static_cast<std::int64_t>(size) * k / n);
    };
    const int x = coord(width, p.num_h, sx), y = coord(height, p.num_v, sy);
    return {x, y, coord(width, p.num_h, sx + sw) - x, coord(height, p.num_v, sy + sh) - y};
}

// One slice of one frame.
struct SliceDecoder {
    const Params& p;
    Rac& rac;
    Bits* bits;  // the Golomb-Rice bits, or null for the range coder
    SliceState& st;
    int run_index = 0;

    // get_vlc_symbol and update_vlc_state on the bits `b`
    static inline int vlc_symbol(Bits& b, Vlc& s, int nbits) {
        int k = 0;  // the least k with count << k >= error_sum
        if (s.count < s.error_sum) {
            k = __builtin_clz(static_cast<unsigned>(s.count)) -
                __builtin_clz(static_cast<unsigned>(s.error_sum));
            k += (s.count << k) < s.error_sum;
        }
        int v = b.golomb(k, nbits);
        v ^= (2 * s.drift + s.count) >> 31;  // branch-free, as FFmpeg
        const int ret = fold(v + s.bias, nbits);
        s.error_sum += v < 0 ? -v : v;
        int drift = s.drift + v, count = s.count;
        if (count == 128) {
            count >>= 1;
            drift >>= 1;
            s.error_sum >>= 1;
        }
        ++count;
        // the two corrections as selects: the drift's sign is data, not a
        // pattern a branch predictor learns
        const bool down = drift <= -count, up = !down && drift > 0;
        const int bias_down = std::max(s.bias - 1, -128), bias_up = std::min(s.bias + 1, 127);
        const int drift_down = std::max(drift + count, -count + 1), drift_up = std::min(drift - count, 0);
        s.bias = down ? bias_down : up ? bias_up : s.bias;
        s.drift = down ? drift_down : up ? drift_up : drift;
        s.count = count;
        return ret;
    }

    // decode_line: cur and prev point at sample 0 of rows with 3 samples of
    // padding a side; cur still holds the row two up (the context's TT).
    void line(int* cur, const int* prev, int plane, int nbits, int w) {
        const std::int16_t* q = p.quant.data() + static_cast<std::size_t>(st.tables[plane]) * 5 * 256;
        const bool five = q[768 + 127] || q[1024 + 127];
        if (bits)
            five ? line_as<true, true>(cur, prev, plane, nbits, w, q)
                 : line_as<true, false>(cur, prev, plane, nbits, w, q);
        else
            five ? line_as<false, true>(cur, prev, plane, nbits, w, q)
                 : line_as<false, false>(cur, prev, plane, nbits, w, q);
    }

    template <bool kRice, bool kFive>
    void line_as(int* cur, const int* prev, int plane, int nbits, int w, const std::int16_t* q) {
        const std::int16_t *q0 = q, *q1 = q + 256, *q2 = q + 512, *q3 = q + 768, *q4 = q + 1024;
        std::uint8_t* states = st.states[plane].data();
        Vlc* vlc = st.vlc[plane].data();
        const int mask = (1 << nbits) - 1;
        const bool wrap = nbits == 16;
        // local copies of the coders: the state stores (bytes, which may
        // alias anything) then do not force their fields back to memory
        Bits b = kRice ? *bits : Bits(nullptr, 0);
        Rac r = rac;
        const auto ended = [&] { return kRice ? b.left() < 1 : r.overread > 2; };
        if (ended()) throw Fail{kDataEnd};
        int run_mode = 0, run_count = 0, ri = run_index;
        // the neighbours in registers: the sample just decoded is the next
        // one's left, with no store and load between them
        int L = cur[-1], LL = cur[-2], LT = prev[-1], T = prev[0];
        for (int x = 0; x < w; ++x) {
            if (!(x & 1023) && ended()) throw Fail{kDataEnd};
            const int RT = prev[x + 1];
            int ctx = q0[(L - LT) & 0xFF] + q1[(LT - T) & 0xFF] + q2[(T - RT) & 0xFF];
            if (kFive) ctx += q3[(LL - L) & 0xFF] + q4[(cur[x] - T) & 0xFF];
            const bool sign = ctx < 0;
            if (sign) ctx = -ctx;
            int diff;
            if (!kRice) {
                diff = r.symbol(states + static_cast<std::size_t>(ctx) * kContext, true);
            } else {
                if (ctx == 0 && run_mode == 0) run_mode = 1;
                if (run_mode) {
                    if (run_count == 0 && run_mode == 1) {
                        if (b.get(1)) {
                            run_count = 1 << kLog2Run[ri];
                            if (x + run_count <= w) ++ri;
                        } else {
                            run_count = static_cast<int>(b.get(kLog2Run[ri]));
                            if (ri) --ri;
                            run_mode = 2;
                        }
                    }
                    if (--run_count < 0) {
                        run_mode = run_count = 0;
                        diff = vlc_symbol(b, vlc[ctx], nbits);
                        if (diff >= 0) ++diff;
                    } else {
                        diff = 0;
                    }
                } else {
                    diff = vlc_symbol(b, vlc[ctx], nbits);
                }
            }
            diff = (diff ^ -static_cast<int>(sign)) + static_cast<int>(sign);
            const int m = L + T - LT;  // mid_pred(L, L + T - LT, T)
            const int lo = std::min(L, m), hi = std::max(L, m);
            const int pred = std::max(lo, std::min(hi, T));
            const int v = (pred + diff) & mask;
            const int stored = wrap ? static_cast<std::int16_t>(v) : v;
            cur[x] = stored;
            LL = L;
            L = stored;
            LT = T;
            T = RT;
        }
        run_index = ri;
        if (kRice)
            *bits = b;
        else
            rac = r;
    }

    // decode_plane into (h, w) samples of `out` (row stride `stride`)
    template <typename Store>
    void plane(int w, int h, int plane_index, int nbits, Store store) {
        std::vector<int> rows(2 * static_cast<std::size_t>(w + 6), 0);
        int* r[2] = {rows.data() + 3, rows.data() + w + 6 + 3};
        run_index = 0;
        for (int y = 0; y < h; ++y) {
            std::swap(r[0], r[1]);
            int* prev = r[0];
            int* cur = r[1];
            cur[-1] = prev[0];
            prev[w] = prev[w - 1];
            line(cur, prev, plane_index, nbits, w);
            store(y, cur);
        }
    }

    // decode_rgb_frame at 8 bits: B, G, R straight into the BGR frame
    void rgb(int w, int h, std::uint8_t* dst, std::size_t stride) {
        const int planes = p.alpha ? 4 : 3;
        std::vector<int> rows(8 * static_cast<std::size_t>(w + 6), 0);
        int* r[4][2];
        for (int k = 0; k < 4; ++k) {
            r[k][0] = rows.data() + 2 * k * (w + 6) + 3;
            r[k][1] = rows.data() + (2 * k + 1) * (w + 6) + 3;
        }
        run_index = 0;
        for (int y = 0; y < h; ++y) {
            for (int k = 0; k < planes; ++k) {
                std::swap(r[k][0], r[k][1]);
                r[k][1][-1] = r[k][0][0];
                r[k][0][w] = r[k][0][w - 1];
                line(r[k][1], r[k][0], (k + 1) / 2, 9, w);
            }
            std::uint8_t* out = dst + y * stride;
            for (int x = 0; x < w; ++x) {
                int g = r[0][1][x], b = r[1][1][x] - 256, rr = r[2][1][x] - 256;
                g -= (b + rr) >> 2;
                b += g;
                rr += g;
                // the 32-bit B, G, R, A word FFmpeg stores, carries included
                const std::uint32_t word = static_cast<std::uint32_t>(b) +
                                           (static_cast<std::uint32_t>(g) << 8) +
                                           (static_cast<std::uint32_t>(rr) << 16);
                out[3 * x] = static_cast<std::uint8_t>(word);
                out[3 * x + 1] = static_cast<std::uint8_t>(word >> 8);
                out[3 * x + 2] = static_cast<std::uint8_t>(word >> 16);
            }
        }
    }
};

// a frame's keyframe bit, the first symbol of its range coder
bool key_bit(const std::uint8_t* data, std::size_t size) {
    if (size < 2) return false;
    Rac rac(data, data + size);
    std::uint8_t keystate = 128;
    return rac.bit(&keystate);
}

struct Frame {
    const std::uint8_t* data;
    std::size_t size;
    bool key;
    std::vector<std::pair<std::size_t, std::size_t>> spans;
    std::shared_ptr<std::vector<Rect>> rects;  // versions 0-2
};

struct Decoder {
    Params p;
    int height, width;
    std::vector<SliceState> slices;
    std::shared_ptr<std::vector<Rect>> rects;  // versions 0-2: the last keyframe's
    bool keyframe_seen = false, failed = false;

    // read_quant_tables into q (5 x 256); returns the context count
    static int read_quant_tables(Rac& rac, std::int16_t* q) {
        int count = 1;
        for (int i = 0; i < 5; ++i) {
            std::uint8_t state[kContext];
            std::memset(state, 128, sizeof state);
            std::int16_t* t = q + i * 256;
            int k = 0, v = 0;
            for (; k < 128; ++v) {
                const int n = rac.symbol(state, false) + 1;
                if (n > 128 - k || n <= 0) throw Fail{kSymbol};
                for (int j = 0; j < n; ++j) t[k++] = static_cast<std::int16_t>(count * v);
            }
            for (int j = 1; j < 128; ++j) t[256 - j] = static_cast<std::int16_t>(-t[j]);
            t[128] = static_cast<std::int16_t>(-t[127]);
            count *= 2 * v - 1;
            if (count > 32768) throw Fail{kSymbol};
        }
        return (count + 1) / 2;
    }

    // a version 0/1 keyframe's header: must be the stream's
    void v01_header(Rac& rac) const {
        std::uint8_t state[kContext];
        std::memset(state, 128, sizeof state);
        const int version = rac.symbol(state, false);
        const int coder = rac.symbol(state, false);
        std::uint8_t one[256];
        std::memcpy(one, kDefault.one, 256);
        if (coder == kRangeCustom)
            for (int i = 1; i < 256; ++i) one[i] = static_cast<std::uint8_t>(rac.symbol(state, true) + rac.one[i]);
        const int colorspace = rac.symbol(state, false);
        const int bits = version > 0 ? rac.symbol(state, false) : 8;
        const int chroma = rac.bit(state);
        const int hs = rac.symbol(state, false), vs = rac.symbol(state, false);
        const int alpha = rac.bit(state);
        std::vector<std::int16_t> q(5 * 256);
        const int contexts = read_quant_tables(rac, q.data());
        bool same = version == p.version && coder == p.coder && colorspace == p.colorspace &&
                    bits == p.bits && chroma == p.chroma_planes && hs == p.h_shift &&
                    vs == p.v_shift && alpha == p.alpha && contexts == p.contexts[0] &&
                    q == std::vector<std::int16_t>(p.quant.begin(), p.quant.begin() + 5 * 256);
        if (coder == kRangeCustom) same = same && !std::memcmp(one + 1, p.one + 1, 255);
        if (!same) throw Fail{kLayoutChange};
    }

    // version 2: a keyframe's slice layout
    void v2_layout(Rac& rac, std::vector<Rect>& rs, std::vector<std::vector<int>>& tables) const {
        std::uint8_t state[kContext];
        std::memset(state, 128, sizeof state);
        const int count = rac.symbol(state, false);
        if (count <= 0 || count > p.num_h * p.num_v) throw Fail{kSliceHeader};
        rs.clear();
        tables.assign(count, {});
        for (int s = 0; s < count; ++s) {
            int pos[4];
            for (int k = 0; k < 4; ++k) pos[k] = rac.symbol(state, false) + (k >= 2);
            if (pos[0] < 0 || pos[1] < 0 || pos[2] <= 0 || pos[3] <= 0 ||
                pos[0] > p.num_h - pos[2] || pos[1] > p.num_v - pos[3])
                throw Fail{kSliceHeader};
            rs.push_back(slice_rect(p, height, width, pos[0], pos[1], pos[2], pos[3]));
            for (int k = 0; k < p.plane_count; ++k) {
                const int idx = rac.symbol(state, false);
                if (idx < 0 || idx >= static_cast<int>(p.contexts.size())) throw Fail{kSliceHeader};
                tables[s].push_back(idx);
            }
        }
    }

    // the slices, walked from the chunk's end; throws with the slice number
    void find_slices(Frame& f, int count, int* bad_slice) {
        f.spans.clear();
        if (p.version <= 1) {
            f.spans.push_back({0, f.size});
            return;
        }
        const std::size_t trailer = 3 + 5 * (p.ec != 0);
        std::size_t end = f.size;
        if (p.version == 2) {
            for (int s = count - 1; s >= 1; --s) {
                *bad_slice = s;
                if (end < trailer) throw Fail{kChain};
                const std::size_t n = (static_cast<std::size_t>(f.data[end - trailer]) << 16 |
                                       static_cast<std::size_t>(f.data[end - trailer + 1]) << 8 |
                                       f.data[end - trailer + 2]) + trailer;
                if (n > end) throw Fail{kChain};
                f.spans.push_back({end - n, end});
                end -= n;
            }
            f.spans.push_back({0, end});
        } else {
            while (end > trailer) {
                const std::size_t n = (static_cast<std::size_t>(f.data[end - trailer]) << 16 |
                                       static_cast<std::size_t>(f.data[end - trailer + 1]) << 8 |
                                       f.data[end - trailer + 2]) + trailer;
                if (n > end) {
                    if (f.spans.empty()) {
                        *bad_slice = -1;
                        throw Fail{kChain};
                    }
                    break;
                }
                f.spans.push_back({end - n, end});
                end -= n;
                if (f.spans.size() > static_cast<std::size_t>(kMaxSlices)) throw Fail{kChain};
            }
            if (f.spans.empty() || end != 0) {
                *bad_slice = 0;
                throw Fail{kChain};
            }
        }
        std::reverse(f.spans.begin(), f.spans.end());
    }

    // the walk of one frame before any slice is decoded
    void prepare(Frame& f, int* bad_slice) {
        *bad_slice = -1;
        if (f.size < 2) throw Fail{kEmpty};
        Rac rac(f.data, f.data + f.size);
        std::uint8_t keystate = 128;
        f.key = rac.bit(&keystate);
        if (f.key) {
            *bad_slice = 0;
            if (p.version <= 1) {
                v01_header(rac);
                if (!rects) {
                    rects = std::make_shared<std::vector<Rect>>(1, Rect{0, 0, width, height});
                    slices.assign(1, {});
                    slices[0].tables.assign(p.plane_count, 0);
                }
            } else if (p.version == 2) {
                auto rs = std::make_shared<std::vector<Rect>>();
                std::vector<std::vector<int>> tables;
                v2_layout(rac, *rs, tables);
                rects = rs;
                if (slices.size() < tables.size()) slices.resize(tables.size());
                for (std::size_t s = 0; s < tables.size(); ++s) slices[s].tables = tables[s];
            }
            keyframe_seen = true;
        } else if (!keyframe_seen) {
            throw Fail{kNoKeyframe};
        }
        f.rects = rects;
        find_slices(f, rects ? static_cast<int>(rects->size()) : 0, bad_slice);
        if (p.version == 3) {
            if (f.key)
                slices.resize(f.spans.size());
            else if (f.spans.size() != slices.size())
                throw Fail{kSliceCount};
        }
    }

    // a slice at the bottom or right edge that leaves the last chroma row or
    // column undecoded (FFmpeg gives memory it never wrote there)
    bool chroma_gap(const Rect& r) const {
        if (!p.chroma_planes || p.colorspace != 0) return false;
        const auto up = [](int v, int s) { return -(-v >> s); };
        return (r.x + r.w == width && (r.x >> p.h_shift) + up(r.w, p.h_shift) < up(width, p.h_shift)) ||
               (r.y + r.h == height && (r.y >> p.v_shift) + up(r.h, p.v_shift) < up(height, p.v_shift));
    }

    // one slice of a prepared frame, into its frame's BGR (dst) or planes
    void slice(const Frame& f, int s, std::uint8_t* dst, std::uint8_t* planes) {
        const auto [start, end] = f.spans[s];
        const std::uint8_t* base = f.data + start;
        if (p.ec && crc32(base, end - start, 0)) throw Fail{kCrc};
        // slice 0 continues the frame's coder: the keyframe bit (and the
        // header of versions 0-2) come first
        Rac rac(s == 0 ? f.data : base, f.data + end);
        if (s == 0) {
            std::uint8_t keystate = 128;
            rac.bit(&keystate);
            if (f.key && p.version <= 1) {
                v01_header(rac);
            } else if (f.key && p.version == 2) {
                std::vector<Rect> rs;
                std::vector<std::vector<int>> tables;
                v2_layout(rac, rs, tables);
            }
        }
        rac.one = p.one;
        rac.zero = p.zero;
        SliceState& st = slices[s];
        Rect rc;
        if (p.version == 3) {
            std::uint8_t hs[kContext];
            std::memset(hs, 128, sizeof hs);
            int pos[4];
            for (int k = 0; k < 4; ++k) pos[k] = rac.symbol(hs, false) + (k >= 2);
            if (pos[0] < 0 || pos[1] < 0 || pos[2] <= 0 || pos[3] <= 0 ||
                pos[0] > p.num_h - pos[2] || pos[1] > p.num_v - pos[3])
                throw Fail{kSliceHeader};
            rc = slice_rect(p, height, width, pos[0], pos[1], pos[2], pos[3]);
            std::vector<int> tables;
            for (int k = 0; k < p.plane_count; ++k) {
                const int idx = rac.symbol(hs, false);
                if (idx < 0 || idx >= static_cast<int>(p.contexts.size())) throw Fail{kSliceHeader};
                tables.push_back(idx);
            }
            if (!f.key && tables != st.tables) throw Fail{kSliceHeader};
            st.tables = tables;
            rac.symbol(hs, false);  // picture structure
            rac.symbol(hs, false);  // sample aspect ratio
            rac.symbol(hs, false);
        } else {
            rc = (*f.rects)[s];
        }
        if (chroma_gap(rc)) throw Fail{kChromaGap};
        if (f.key) st.reset(p);
        std::unique_ptr<Bits> bits;
        if (p.coder == kGolomb) {
            if (p.combined() >= 0x30002) {
                std::uint8_t st129 = 129;
                rac.bit(&st129);
            }
            const std::uint8_t* from = s == 0 ? f.data : base;
            const std::size_t skip = (p.version > 2 || (rc.x == 0 && rc.y == 0))
                                         ? static_cast<std::size_t>(rac.p - from) - 1
                                         : 0;
            bits.reset(new Bits(from + skip, static_cast<std::size_t>(f.data + end - from) - skip));
        }
        if (rc.w <= 0 || rc.h <= 0) return;
        SliceDecoder sd{p, rac, bits.get(), st};
        const std::size_t stride = static_cast<std::size_t>(width) * 3;
        if (p.colorspace == 1) {
            sd.rgb(rc.w, rc.h, dst + rc.y * stride + static_cast<std::size_t>(rc.x) * 3, stride);
            return;
        }
        if (!p.chroma_planes) {
            std::uint8_t* out = dst + rc.y * stride + static_cast<std::size_t>(rc.x) * 3;
            const bool sixteen = p.bits > 8;
            sd.plane(rc.w, rc.h, 0, sixteen ? p.bits : 8, [&](int y, const int* row) {
                std::uint8_t* o = out + y * stride;
                for (int x = 0; x < rc.w; ++x) {
                    const int v = sixteen ? std::min(255, ((row[x] & 0xFFFF) + 128) >> 8) : row[x];
                    o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = static_cast<std::uint8_t>(v);
                }
            });
            return;
        }
        // yuv420p / yuv422p / yuv444p planes: Y, then U, then V (I420 / Y42B
        // order)
        const int cw = -(-width >> p.h_shift), ch = -(-height >> p.v_shift);
        std::uint8_t* planes_at[3] = {planes, planes + static_cast<std::size_t>(width) * height,
                                      planes + static_cast<std::size_t>(width) * height +
                                          static_cast<std::size_t>(cw) * ch};
        sd.plane(rc.w, rc.h, 0, 8, [&](int y, const int* row) {
            std::uint8_t* o = planes_at[0] + static_cast<std::size_t>(rc.y + y) * width + rc.x;
            for (int x = 0; x < rc.w; ++x) o[x] = static_cast<std::uint8_t>(row[x]);
        });
        const int sw = -(-rc.w >> p.h_shift), sh = -(-rc.h >> p.v_shift);
        const int cx = rc.x >> p.h_shift, cy = rc.y >> p.v_shift;
        for (int k = 1; k <= 2; ++k)
            sd.plane(sw, sh, 1, 8, [&](int y, const int* row) {
                std::uint8_t* o = planes_at[k] + static_cast<std::size_t>(cy + y) * cw + cx;
                for (int x = 0; x < sw; ++x) o[x] = static_cast<std::uint8_t>(row[x]);
            });
    }
};

}  // namespace

extern "C" {

// A decoder of one stream.  ints: version, micro version, coder, colour
// space, bits, chroma planes, h shift, v shift, alpha, slice columns, slice
// rows, ec, planes with contexts, quantisation table count; quant: the
// tables (5 x 256 int16 each); contexts: each table's context count;
// initial: each table's initial states (contexts x 32) back to back, where
// has_initial[i]; transition: the custom state-transition table (256), or
// null.  Null for parameters out of range.
void* clt_ffv1_new(const int* ints, const std::int16_t* quant, const int* contexts,
                   const int* has_initial, const std::uint8_t* initial,
                   const std::uint8_t* transition, int height, int width) {
    if (height < 1 || width < 1 || ints[13] < 1 || ints[13] > 8) return nullptr;
    auto* d = new Decoder();
    Params& p = d->p;
    int* f[] = {&p.version, &p.micro, &p.coder, &p.colorspace, &p.bits, &p.chroma_planes,
                &p.h_shift, &p.v_shift, &p.alpha, &p.num_h, &p.num_v, &p.ec, &p.plane_count};
    for (int i = 0; i < 13; ++i) *f[i] = ints[i];
    const int n = ints[13];
    p.quant.assign(quant, quant + static_cast<std::size_t>(n) * 5 * 256);
    p.contexts.assign(contexts, contexts + n);
    p.initial.assign(n, {});
    std::size_t at = 0;
    for (int i = 0; i < n; ++i) {
        if (!has_initial[i]) continue;
        const std::size_t size = static_cast<std::size_t>(contexts[i]) * kContext;
        p.initial[i].assign(initial + at, initial + at + size);
        at += size;
    }
    std::memcpy(p.one, kDefault.one, 256);
    std::memcpy(p.zero, kDefault.zero, 256);
    if (transition)
        for (int j = 1; j < 256; ++j) {
            p.one[j] = transition[j];
            p.zero[256 - j] = static_cast<std::uint8_t>(256 - p.one[j]);
        }
    d->height = height;
    d->width = width;
    return d;
}

void clt_ffv1_free(void* decoder) { delete static_cast<Decoder*>(decoder); }

// Decode the next k frames (srcs[i], sizes[i] bytes) of the decoder's
// stream: RGB and gray into dst (frame i at i * height * width * 3, BGR),
// yuv420p / yuv422p / yuv444p into planes (frame i at i * plane_bytes: Y,
// U, V).
// A slice a thread on up to nthreads threads.  rcs[i] gets 0 or a code
// (kCrc ...) and bad_slices[i] the slice at fault (-1 for none); frames
// after the first that fails are not decoded (their rcs stay 1), and the
// decoder refuses every later call (kFailed).
void clt_ffv1_decode_batch(void* decoder, const unsigned char* const* srcs,
                           const std::size_t* sizes, std::size_t k, unsigned char* dst,
                           unsigned char* planes, std::size_t plane_bytes, int nthreads,
                           int* rcs, int* bad_slices) {
    auto* d = static_cast<Decoder*>(decoder);
    for (std::size_t i = 0; i < k; ++i) {
        rcs[i] = 1;
        bad_slices[i] = -1;
    }
    if (d->failed) {
        if (k) rcs[0] = kFailed;
        return;
    }
    // A keyframe changes the states the decoder shares (the slice count,
    // each slice's tables), so a call decodes in rounds that each start at
    // a keyframe or at the call's first frame: every frame of a round is
    // prepared before its slices are decoded.
    const std::size_t frame_bytes = static_cast<std::size_t>(d->height) * d->width * 3;
    std::vector<Frame> frames(k);
    for (std::size_t from = 0; from < k;) {
        std::size_t good = from;
        bool prepared = true;
        for (; good < k; ++good) {
            Frame& f = frames[good];
            f.data = srcs[good];
            f.size = sizes[good];
            if (good > from && key_bit(f.data, f.size)) break;
            try {
                d->prepare(f, &bad_slices[good]);
            } catch (const Fail& e) {
                rcs[good] = e.rc;
                d->failed = true;
                prepared = false;
                break;
            }
            bad_slices[good] = -1;
        }
        std::size_t nslices = 0;
        for (std::size_t i = from; i < good; ++i) nslices = std::max(nslices, frames[i].spans.size());
        // per slice: the first frame it failed in, and how
        std::vector<std::size_t> fail_at(nslices, k);
        std::vector<int> fail_rc(nslices, kOk);
        parallel_items(nslices, nthreads, [&](std::size_t s) {
            for (std::size_t i = from; i < good; ++i) {
                if (s >= frames[i].spans.size()) continue;
                try {
                    d->slice(frames[i], static_cast<int>(s), dst + i * frame_bytes,
                             planes ? planes + i * plane_bytes : nullptr);
                } catch (const Fail& e) {
                    fail_at[s] = i;
                    fail_rc[s] = e.rc;
                    return;
                }
            }
        });
        std::size_t first = good;
        int first_slice = -1, rc = kOk;
        for (std::size_t s = 0; s < nslices; ++s)
            if (fail_at[s] < first) {
                first = fail_at[s];
                first_slice = static_cast<int>(s);
                rc = fail_rc[s];
            }
        for (std::size_t i = from; i < first; ++i) rcs[i] = kOk;
        if (first < good) {
            rcs[first] = rc;
            bad_slices[first] = first_slice;
            d->failed = true;
            return;
        }
        if (!prepared) return;
        from = good;
    }
}

int clt_ffv1_version() { return 1; }

}  // extern "C"
