// The H.264 test encoder of tests/_torch_h264_writer.py: the slice data
// (macroblock layer, CAVLC) of I and P slices, after the slice header the
// writer hands over, with seeded choices over every Constrained Baseline
// tool: I_PCM, Intra4x4 (every mode the neighbours allow) and Intra16x16
// with the four chroma modes, P_Skip, P_L0 16x16 / 16x8 / 8x16, P_8x8 and
// P_8x8ref0 with every sub-partition, any reference index, vectors from a
// small search plus quarter-sample offsets and vectors far outside the
// picture, mb_qp_delta (with its wrap) and residuals coded from the
// content: the integer forward transform and a dead-zone quantiser.  In
// its coverage mode it sets some blocks' levels to a (TotalCoeff,
// TrailingOnes) pair that has not yet been written for the block's nC, so
// that a short stream holds every coeff_token, total_zeros and run_before
// code, and the level_prefix escapes.
//
// It builds its own reconstruction of each macroblock (rebuild()), its
// choices made in between, from the prediction, transform and deblocking
// functions of the port's decoder (native/h264.cpp, included here), so
// the reference pictures it predicts from are what those functions give.
// The two share the code tables too; only a decoder of its own (cv2's
// FFmpeg, or h264_plain.py's macroblock layer) can find a wrong one,
// which is what the tests hold the streams to.
//
// Built with g++ into build/native/ by the writer's native_encoder().

#include "../camera_linearity_tpu_torch/native/h264.cpp"

namespace {

// ---------------------------------------------------------------- bits out

struct Writer {
    std::vector<u8> out;
    std::uint64_t acc = 0;
    int n = 0;            // bits in acc
    void put(unsigned v, int len) {
        for (int i = len - 1; i >= 0; --i) {
            acc = (acc << 1) | ((v >> i) & 1);
            if (++n == 8) {
                out.push_back(static_cast<u8>(acc));
                acc = 0;
                n = 0;
            }
        }
    }
    void ue(unsigned v) {
        const unsigned x = v + 1;
        const int len = 32 - __builtin_clz(x);
        put(0, len - 1);
        put(x, len);
    }
    void se(int v) { ue(v > 0 ? 2 * v - 1 : -2 * v); }
    void align_zero() {
        while (n) put(0, 1);
    }
    void trailing() {
        put(1, 1);
        align_zero();
    }
};

// ---------------------------------------------------------------- counts

// what the writer counts (layout shared with _torch_h264_writer.py)
enum : int {
    kCntToken = 0,                       // [4][68]
    kCntDcToken = kCntToken + 4 * 68,    // [20]
    kCntZeros = kCntDcToken + 20,        // [15][16]
    kCntDcZeros = kCntZeros + 15 * 16,   // [3][4]
    kCntRun = kCntDcZeros + 12,          // [7][15]
    kCntPrefix = kCntRun + 7 * 15,       // [32]
    kCntKind = kCntPrefix + 32,          // [8] MbKind
    kCntPtype = kCntKind + 8,            // [5]
    kCntSub = kCntPtype + 5,             // [4]
    kCntI4 = kCntSub + 4,                // [9]
    kCntI16 = kCntI4 + 9,                // [4]
    kCntChroma = kCntI16 + 4,            // [4]
    kCntQp = kCntChroma + 4,             // [52] MB QPs of coded residuals
    kCntRef = kCntQp + 52,               // [32] reference indices
    kCntFar = kCntRef + 32,              // [1] vectors far outside
    kCntSize = kCntFar + 1,
};

// ---------------------------------------------------------------- choices

struct Rng {
    std::uint64_t s;
    explicit Rng(std::uint64_t seed) : s(seed * 0x9E3779B97F4A7C15ull + 1) {}
    std::uint64_t next() {
        s ^= s << 13;
        s ^= s >> 7;
        s ^= s << 17;
        return s;
    }
    int below(int n) { return n <= 1 ? 0 : static_cast<int>(next() % static_cast<std::uint64_t>(n)); }
    bool per_mille(int p) { return below(1000) < p; }
};

// the options (the writer's Options, in this order)
struct Opts {
    int seed, p_skip, p_intra, p_pcm, p_i16, part_mask, p_dqp, qp_min, qp_max, search, p_far,
        p_random_mode, coverage, p_subpel, zero_mv, sub_mask;
};
constexpr int kOpts = 16;

constexpr int kMf[6][3] = {{13107, 5243, 8066}, {11916, 4660, 7490}, {10082, 4194, 6554},
                           {9362, 3647, 5825},  {8192, 3355, 5243},  {7282, 2893, 4559}};

// the forward core transform of a 4x4 residual (raster)
void forward4(const int* x, int* w) {
    int t[16];
    for (int r = 0; r < 4; ++r) {
        const int* a = x + r * 4;
        const int s03 = a[0] + a[3], d03 = a[0] - a[3], s12 = a[1] + a[2], d12 = a[1] - a[2];
        t[r * 4 + 0] = s03 + s12;
        t[r * 4 + 1] = 2 * d03 + d12;
        t[r * 4 + 2] = s03 - s12;
        t[r * 4 + 3] = d03 - 2 * d12;
    }
    for (int c = 0; c < 4; ++c) {
        const int s03 = t[c] + t[12 + c], d03 = t[c] - t[12 + c];
        const int s12 = t[4 + c] + t[8 + c], d12 = t[4 + c] - t[8 + c];
        w[c] = s03 + s12;
        w[4 + c] = 2 * d03 + d12;
        w[8 + c] = s03 - s12;
        w[12 + c] = d03 - 2 * d12;
    }
}

inline int quant(int w, int mf, int qbits, int f) {
    const int a = (std::abs(w) * mf + f) >> qbits;
    return w < 0 ? -a : a;
}

// the largest sum of dequantised magnitudes a block may hold: the inverse
// transform's 16-bit intermediates (FFmpeg keeps them in int16) stay in
// range below it
constexpr int kMaxAbsSum = 14000;
// the largest dequantised DC of an Intra16x16 or chroma block
constexpr int kMaxDc = 12000;

struct Encoder {
    Decoder& dec;
    SliceCtx s;
    Opts o;
    Rng rng;
    const u8 *sy, *su, *sv;    // the source planes (MB-aligned)
    int* cnt;
    MbPos m{};
    int want[16][2] = {};      // the chosen vector of each partition
    bool intra_slice = true;

    Encoder(Decoder& d, const Opts& op, int* counts)
        : dec(d), o(op), rng(static_cast<std::uint64_t>(op.seed)), cnt(counts) {}

    // ------------------------------------------------------------ choices
    int sad_block(const u8* pred, int stride, const u8* src, int sstride, int w, int h) const {
        int t = 0;
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) t += std::abs(pred[y * stride + x] - src[y * sstride + x]);
        return t;
    }

    // an Intra4x4 block's mode, its neighbours gathered in e
    void intra4(MbData& d, int blk, const Edge& e) {
        const bool top = e.has_top, left = e.has_left, all = top && left && e.has_corner;
        int modes[9], n = 0;
        for (int k = 0; k < 9; ++k) {
            const bool ok = k == 2 || ((k == 0 || k == 3 || k == 7) && top) ||
                            ((k == 1 || k == 8) && left) || ((k >= 4 && k <= 6) && all);
            if (ok) modes[n++] = k;
        }
        int best = modes[0];
        if (rng.per_mille(o.p_random_mode)) {
            best = modes[rng.below(n)];
        } else {
            const int W = s.cur->W;
            const int px = m.x * 16 + kBlkX[blk] * 4, py = m.y * 16 + kBlkY[blk] * 4;
            int cost = 1 << 30;
            u8 tmp[16];
            for (int k = 0; k < n; ++k) {
                pred4x4(tmp, 4, e, modes[k]);
                const int c = sad_block(tmp, 4, sy + std::size_t(py) * W + px, W, 4, 4);
                if (c < cost) { cost = c; best = modes[k]; }
            }
        }
        d.i4mode[blk] = best;
        ++cnt[kCntI4 + best];
    }

    // levels of the 4x4 residual src - pred at (px, py) of a plane
    void block_levels(const u8* plane, const u8* src, int stride, int px, int py, int qp,
                      bool intra, bool skip_dc, std::int16_t* lv, int* dc_coef) {
        int x[16], w[16];
        for (int j = 0; j < 4; ++j)
            for (int i = 0; i < 4; ++i) {
                const std::size_t at = std::size_t(py + j) * stride + px + i;
                x[j * 4 + i] = src[at] - plane[at];
            }
        forward4(x, w);
        const int qbits = 15 + qp / 6, f = (1 << qbits) / (intra ? 3 : 6);
        for (int k = 0; k < 16; ++k) {
            if (k == 0 && skip_dc) {
                lv[0] = 0;
                if (dc_coef) *dc_coef = w[0];
                continue;
            }
            lv[k] = static_cast<std::int16_t>(clip3(-2047, 2047, quant(w[k], kMf[qp % 6][kNormClass[k]], qbits, f)));
        }
    }

    // keep the dequantised block (dc: its DC's magnitude, where given
    // apart) within the inverse transform's range
    void bound(std::int16_t* lv, int qp, int first, int dc) {
        for (;;) {
            long sum = std::abs(dc);
            bool any = false;
            for (int k = first; k < 16; ++k) {
                sum += static_cast<long>(std::abs(lv[k])) * kNorm[qp % 6][kNormClass[k]] << (qp / 6);
                any |= lv[k] != 0;
            }
            if (sum <= kMaxAbsSum || !any) return;
            for (int k = first; k < 16; ++k) lv[k] = static_cast<std::int16_t>(lv[k] / 2);
        }
    }

    // coverage: set the levels of a block (scan order start .. start + n)
    // so that it codes a (TotalCoeff, TrailingOnes) not yet written for
    // its class (cls: 0-3 nC class, 4 chroma DC)
    void cover(std::int16_t* lv_raster, int start, int n, int cls, bool dc_block, const u8* scan,
               int qp = 51) {
        // scan position k of the block is lv_raster[scan ? scan[start + k] : k];
        // an Intra16x16 DC at a QP under 6 takes a level_prefix escape
        const bool escape = dc_block && n == 16 && qp < 6 && o.coverage;
        if (!escape && !rng.per_mille(o.coverage)) return;
        const int maxtc = n;
        int cand[68], nc = 0;
        for (int tc = 0; tc <= maxtc; ++tc)
            for (int t1 = 0; t1 <= std::min(3, tc); ++t1) {
                const int at = cls == 4 ? kCntDcToken + tc * 4 + t1 : kCntToken + cls * 68 + tc * 4 + t1;
                if (!cnt[at]) cand[nc++] = tc * 4 + t1;
            }
        int pick;
        if (nc) pick = cand[rng.below(nc)];
        else {
            const int tc = rng.below(maxtc + 1);
            pick = tc * 4 + rng.below(std::min(3, tc) + 1);
        }
        const int tc = pick >> 2, t1 = pick & 3;
        // total_zeros at random, then the other positions below the last
        int pos[16], np = 0;
        if (tc) {
            const int zeros = rng.below(n - tc + 1), top = tc + zeros - 1;
            int order[16];
            for (int k = 0; k < top; ++k) order[k] = k;
            for (int k = top - 1; k > 0; --k) std::swap(order[k], order[rng.below(k + 1)]);
            const bool low = rng.below(4) == 0;   // the others lowest: a long last run
            for (int k = 0; k < tc - 1; ++k) pos[np++] = low ? k : order[k];
            pos[np++] = top;
        }
        std::sort(pos, pos + np);
        std::int16_t val[16] = {};
        for (int k = 0; k < n; ++k) val[k] = lv_raster[scan ? scan[start + k] : k];
        std::int16_t out[16] = {};
        for (int i = 0; i < tc; ++i) {
            const int from_top = tc - 1 - i;   // 0: the highest frequency
            int v = val[pos[i]];
            const int sign = (v < 0 || (v == 0 && rng.below(2))) ? -1 : 1;
            int mag = std::abs(v);
            if (from_top < t1) mag = 1;
            else if (from_top == t1 && t1 < 3) mag = std::max(2, std::min(mag, 40));
            else mag = std::max(1, std::min(mag, 40));
            out[pos[i]] = static_cast<std::int16_t>(sign * mag);
        }
        // an escape now and then: a large DC level (where the scale keeps
        // it in range)
        if (dc_block && tc && (escape || rng.below(2) == 0)) {
            const int big[4] = {8, 20, 600, 2400};
            const int k = pos[0];
            if (!(tc - 1 < t1)) {   // not a trailing one
                const int mag = escape ? 2400 : big[rng.below(4)];
                out[k] = static_cast<std::int16_t>(out[k] < 0 ? -mag : mag);
            }
        }
        for (int k = 0; k < n; ++k) lv_raster[scan ? scan[start + k] : k] = out[k];
    }

    int nc_class_here(int comp, int bx, int by) { return nc_class(nc_of(s, m, comp, bx, by)); }

    // the levels of a part whose prediction is in the picture. what: 0
    // an Intra4x4 block (blk), 1 the luma of an Intra16x16 or inter MB,
    // 2 the chroma
    void residual(MbData& d, int what, int blk) {
        Slot& c = *s.cur;
        const int W = c.W, CW = W / 2;
        const bool intra = d.kind == kI4 || d.kind == kI16;
        u8* nnz = &c.nnz[std::size_t(m.addr) * 24];
        if (what == 0) {
            const int px = m.x * 16 + kBlkX[blk] * 4, py = m.y * 16 + kBlkY[blk] * 4;
            block_levels(c.y.data(), sy, W, px, py, d.qp, true, false, d.luma[blk], nullptr);
            if (blk == 0) std::memset(nnz, 0, 16);
            cover(d.luma[blk], 0, 16, nc_class_here(0, kBlkX[blk], kBlkY[blk]), false, kZigzag);
            bound(d.luma[blk], d.qp, 0, 0);
            nnz[kBlkY[blk] * 4 + kBlkX[blk]] = static_cast<u8>(total(d.luma[blk], 0));
        } else if (what == 1) {
            int dcw[16];
            std::memset(nnz, 0, 16);
            for (int b = 0; b < 16; ++b) {
                const int px = m.x * 16 + kBlkX[b] * 4, py = m.y * 16 + kBlkY[b] * 4;
                block_levels(c.y.data(), sy, W, px, py, d.qp, intra, d.kind == kI16, d.luma[b],
                             &dcw[kBlkY[b] * 4 + kBlkX[b]]);
            }
            if (d.kind == kI16) {
                // the Hadamard of the DC coefficients, halved
                int f[16], g[16];
                for (int r = 0; r < 4; ++r) {
                    const int* x = dcw + r * 4;
                    f[r * 4 + 0] = x[0] + x[1] + x[2] + x[3];
                    f[r * 4 + 1] = x[0] + x[1] - x[2] - x[3];
                    f[r * 4 + 2] = x[0] - x[1] - x[2] + x[3];
                    f[r * 4 + 3] = x[0] - x[1] + x[2] - x[3];
                }
                for (int k = 0; k < 4; ++k) {
                    const int x0 = f[k], x1 = f[4 + k], x2 = f[8 + k], x3 = f[12 + k];
                    g[k] = (x0 + x1 + x2 + x3) >> 1;
                    g[4 + k] = (x0 + x1 - x2 - x3) >> 1;
                    g[8 + k] = (x0 - x1 - x2 + x3) >> 1;
                    g[12 + k] = (x0 - x1 + x2 - x3) >> 1;
                }
                const int qbits = 15 + d.qp / 6, fr = (1 << qbits) / 3;
                for (int k = 0; k < 16; ++k)
                    d.ldc[k] = static_cast<std::int16_t>(
                        clip3(-2047, 2047, quant(g[k], kMf[d.qp % 6][0], qbits + 1, 2 * fr)));
                cover(d.ldc, 0, 16, nc_class_here(0, 0, 0), true, kZigzag, d.qp);
                bound_dc16(d);
            }
            bool ac = false;
            int dcs[16] = {};
            if (d.kind == kI16) luma_dc(d.ldc, d.qp, dcs);
            for (int b = 0; b < 16; ++b) {
                const int bx = kBlkX[b], by = kBlkY[b];
                if (d.kind == kI16) {
                    cover(d.luma[b], 1, 15, nc_class_here(0, bx, by), false, kZigzag);
                } else {
                    cover(d.luma[b], 0, 16, nc_class_here(0, bx, by), false, kZigzag);
                }
                bound(d.luma[b], d.qp, d.kind == kI16 ? 1 : 0, dcs[by * 4 + bx]);
                const int t = total(d.luma[b], d.kind == kI16 ? 1 : 0);
                nnz[by * 4 + bx] = static_cast<u8>(t);
                ac |= t != 0;
            }
            if (d.kind != kI16) {
                // an 8x8 whose blocks hold no level is not coded
                for (int i8 = 0; i8 < 4; ++i8) {
                    bool any = false;
                    for (int b = i8 * 4; b < i8 * 4 + 4; ++b) any |= total(d.luma[b], 0) != 0;
                    if (any) d.cbp |= 1 << i8;
                }
            } else if (ac) {
                d.cbp |= 15;
            } else {
                for (int b = 0; b < 16; ++b) nnz[kBlkY[b] * 4 + kBlkX[b]] = 0;
            }
            if (d.kind == kI16 && !ac)
                for (int b = 0; b < 16; ++b) std::memset(d.luma[b], 0, sizeof d.luma[b]);
        } else {
            if (d.kind == kI4)
                for (int i8 = 0; i8 < 4; ++i8) {
                    bool any = false;
                    for (int b = i8 * 4; b < i8 * 4 + 4; ++b) any |= total(d.luma[b], 0) != 0;
                    if (any) d.cbp |= 1 << i8;
                }
            const int qpc[2] = {chroma_qp(s.sp, d.qp, 0), chroma_qp(s.sp, d.qp, 1)};
            bool any_dc = false, any_ac = false;
            int dcs[2][4] = {};
            for (int k = 0; k < 2; ++k) {
                const u8* pl = k ? c.v.data() : c.u.data();
                const u8* src = k ? sv : su;
                int dcw[4];
                for (int b = 0; b < 4; ++b)
                    block_levels(pl, src, CW, m.x * 8 + (b & 1) * 4, m.y * 8 + (b >> 1) * 4, qpc[k],
                                 intra, true, d.cac[k][b], &dcw[b]);
                const int f[4] = {dcw[0] + dcw[1] + dcw[2] + dcw[3], dcw[0] - dcw[1] + dcw[2] - dcw[3],
                                  dcw[0] + dcw[1] - dcw[2] - dcw[3], dcw[0] - dcw[1] - dcw[2] + dcw[3]};
                const int qbits = 15 + qpc[k] / 6, fr = (1 << qbits) / (intra ? 3 : 6);
                for (int b = 0; b < 4; ++b)
                    d.cdc[k][b] = static_cast<std::int16_t>(
                        clip3(-2047, 2047, quant(f[b], kMf[qpc[k] % 6][0], qbits + 1, 2 * fr)));
                cover(d.cdc[k], 0, 4, 4, true, nullptr);
                bound_dc4(d.cdc[k], qpc[k]);
                chroma_dc(d.cdc[k], qpc[k], dcs[k]);
                for (int b = 0; b < 4; ++b) any_dc |= d.cdc[k][b] != 0;
            }
            for (int k = 0; k < 2; ++k)
                for (int b = 0; b < 4; ++b) {
                    cover(d.cac[k][b], 1, 15, nc_class_here(k + 1, b & 1, b >> 1), false, kZigzag);
                    bound(d.cac[k][b], qpc[k], 1, dcs[k][b]);
                    const int t = total(d.cac[k][b], 1);
                    nnz[16 + k * 4 + b] = static_cast<u8>(t);
                    any_ac |= t != 0;
                }
            const int cc = any_ac ? 2 : any_dc ? 1 : 0;
            if (cc < 2)
                for (int k = 0; k < 2; ++k)
                    for (int b = 0; b < 4; ++b) {
                        std::memset(d.cac[k][b], 0, sizeof d.cac[k][b]);
                        nnz[16 + k * 4 + b] = 0;
                    }
            d.cbp |= cc << 4;
        }
    }

    // the dequantised Intra16x16 DC stays in range
    void bound_dc16(MbData& d) {
        for (;;) {
            int dc[16];
            luma_dc(d.ldc, d.qp, dc);
            int most = 0;
            for (int k = 0; k < 16; ++k) most = std::max(most, std::abs(dc[k]));
            if (most <= kMaxDc) return;
            for (int k = 0; k < 16; ++k) d.ldc[k] = static_cast<std::int16_t>(d.ldc[k] / 2);
        }
    }
    void bound_dc4(std::int16_t* c, int qpc) {
        for (;;) {
            int dc[4];
            chroma_dc(c, qpc, dc);
            int most = 0;
            for (int k = 0; k < 4; ++k) most = std::max(most, std::abs(dc[k]));
            if (most <= kMaxDc) return;
            for (int k = 0; k < 4; ++k) c[k] = static_cast<std::int16_t>(c[k] / 2);
        }
    }

    static int total(const std::int16_t* lv, int first) {
        int t = 0;
        for (int k = first; k < 16; ++k) t += lv[k] != 0;
        return t;
    }

    // ------------------------------------------------------------ decisions

    int sad16(const Slot& ref, int mvx, int mvy) const {
        const int W = s.cur->W;
        u8 tmp[256];
        mc_luma(ref, m.x * 16, m.y * 16, 16, 16, mvx, mvy, tmp, 16);
        return sad_block(tmp, 16, sy + std::size_t(m.y) * 16 * W + m.x * 16, W, 16, 16);
    }

    void choose_vectors(MbData& d) {
        Part parts[16];
        const int n = partitions(d, parts);
        // a search of whole-sample vectors for the MB on its first
        // partition's reference
        int bx = 0, by = 0;
        if (!o.zero_mv && o.search > 0) {
            const Slot& r = *s.refs[d.ref[0]];
            int best = sad16(r, 0, 0);
            for (int dy = -o.search; dy <= o.search; dy += 1)
                for (int dx = -o.search; dx <= o.search; dx += 1) {
                    const int c = sad16(r, dx * 4, dy * 4);
                    if (c < best) { best = c; bx = dx * 4; by = dy * 4; }
                }
        }
        for (int p = 0; p < n; ++p) {
            int vx = bx, vy = by;
            if (!o.zero_mv) {
                if (rng.per_mille(o.p_subpel)) {
                    vx += rng.below(7) - 3;
                    vy += rng.below(7) - 3;
                }
                if (rng.per_mille(o.p_far)) {
                    const int W = s.cur->W, H = s.cur->H;
                    vx = (rng.below(2) ? 1 : -1) * (W + 16 + rng.below(64)) * 4 + rng.below(4);
                    vy = (rng.below(2) ? 1 : -1) * (H + 16 + rng.below(64)) * 4 + rng.below(4);
                    if (rng.below(2)) vy = rng.below(9) - 4;
                    ++cnt[kCntFar];
                }
            }
            want[p][0] = clip3(-2048 * 4, 2047 * 4, vx);
            want[p][1] = clip3(-512 * 4, 511 * 4, vy);
        }
    }

    void choose(MbData& d, int qp_pred) {
        d = MbData();
        const int nref = s.sp.nref;
        // the MB's QP
        d.qp = qp_pred;
        if (o.p_dqp >= 1000)   // a sweep: each MB the next QP of the range
            d.qp = o.qp_min + (m.addr + o.seed) % (o.qp_max - o.qp_min + 1);
        else if (rng.per_mille(o.p_dqp))
            d.qp = o.qp_min + rng.below(o.qp_max - o.qp_min + 1);
        const bool pcm = rng.per_mille(o.p_pcm);
        bool intra = intra_slice || pcm || rng.per_mille(o.p_intra);
        if (!intra && s.refs[0] && rng.per_mille(o.p_skip)) {
            d.kind = kSkip;
            d.qp = qp_pred;
            return;
        }
        if (pcm) {
            d.kind = kPcm;
            const int W = s.cur->W, CW = W / 2;
            for (int y = 0; y < 16; ++y)
                for (int x = 0; x < 16; ++x) d.pcm[y * 16 + x] = sy[std::size_t(m.y * 16 + y) * W + m.x * 16 + x];
            for (int y = 0; y < 8; ++y)
                for (int x = 0; x < 8; ++x) {
                    d.pcm[256 + y * 8 + x] = su[std::size_t(m.y * 8 + y) * CW + m.x * 8 + x];
                    d.pcm[320 + y * 8 + x] = sv[std::size_t(m.y * 8 + y) * CW + m.x * 8 + x];
                }
            d.qp = qp_pred;
            return;
        }
        if (intra) {
            const bool tA = intra_avail(s, m.x - 1, m.y), tB = intra_avail(s, m.x, m.y - 1);
            const bool tD = intra_avail(s, m.x - 1, m.y - 1);
            d.kind = rng.per_mille(o.p_i16) ? kI16 : kI4;
            Slot& c = *s.cur;
            const int W = c.W, CW = W / 2;
            if (d.kind == kI16) {
                int modes[4], n = 0;
                modes[n++] = 2;
                if (tB) modes[n++] = 0;
                if (tA) modes[n++] = 1;
                if (tA && tB && tD) modes[n++] = 3;
                Edge e;
                gather(c.y.data(), W, m.x * 16, m.y * 16, 16, tB, tA, tD, false, 0, e);
                int best = 2;
                if (rng.per_mille(o.p_random_mode)) {
                    best = modes[rng.below(n)];
                } else {
                    int cost = 1 << 30;
                    u8 tmp[256];
                    for (int k = 0; k < n; ++k) {
                        if (modes[k] == 2) pred16_dc(tmp, 16, e);
                        else pred16(tmp, 16, e, modes[k], 16);
                        const int cst = sad_block(tmp, 16, sy + std::size_t(m.y) * 16 * W + m.x * 16, W, 16, 16);
                        if (cst < cost) { cost = cst; best = modes[k]; }
                    }
                }
                d.i16mode = best;
                ++cnt[kCntI16 + best];
            }
            int cm[4], n = 0;
            cm[n++] = 0;
            if (tA) cm[n++] = 1;
            if (tB) cm[n++] = 2;
            if (tA && tB && tD) cm[n++] = 3;
            int best = 0;
            if (rng.per_mille(o.p_random_mode)) {
                best = cm[rng.below(n)];
            } else {
                Edge e;
                gather(c.u.data(), CW, m.x * 8, m.y * 8, 8, tB, tA, tD, false, 0, e);
                int cost = 1 << 30;
                u8 tmp[64];
                for (int k = 0; k < n; ++k) {
                    if (cm[k] == 0) pred_chroma_dc(tmp, 8, e);
                    else pred16(tmp, 8, e, cm[k] == 1 ? 1 : cm[k] == 2 ? 0 : 3, 8);
                    const int cst = sad_block(tmp, 8, su + std::size_t(m.y) * 8 * CW + m.x * 8, CW, 8, 8);
                    if (cst < cost) { cost = cst; best = cm[k]; }
                }
            }
            d.cmode = best;
            ++cnt[kCntChroma + best];
            return;
        }
        d.kind = kInter;
        // the reference indices with a picture behind them
        int valid[32], nv = 0;
        for (int r = 0; r < nref; ++r)
            if (s.refs[r]) valid[nv++] = r;
        int types[5], nt = 0;
        for (int t = 0; t < 5; ++t)
            if (o.part_mask >> t & 1 && !(t == 4 && (nref < 2 || !s.refs[0]))) types[nt++] = t;
        d.ptype = nt ? types[rng.below(nt)] : 0;
        ++cnt[kCntPtype + d.ptype];
        int subs[4], ns = 0;
        for (int t = 0; t < 4; ++t)
            if (o.sub_mask >> t & 1) subs[ns++] = t;
        for (int i = 0; i < 4; ++i) {
            d.sub[i] = d.ptype >= 3 ? subs[rng.below(ns)] : 0;
            if (d.ptype >= 3) ++cnt[kCntSub + d.sub[i]];
            d.ref[i] = d.ptype == 4 ? 0 : valid[rng.below(nv)];
            if (d.ptype >= 3 || i < (d.ptype ? 2 : 1)) ++cnt[kCntRef + d.ref[i]];
        }
        choose_vectors(d);
    }

    // ------------------------------------------------------------ reconstruction

    // the chosen macroblock d into the slot: its prediction, the choices
    // that depend on it (intra modes, the vectors' differences, levels)
    // and the residual, as a decoder reconstructs what it reads
    void rebuild(MbData& d) {
        Slot& c = *s.cur;
        const std::size_t a = m.addr;
        const int W = c.W, CW = W / 2;
        u8* Y = c.y.data() + std::size_t(m.y) * 16 * W + m.x * 16;
        u8* U = c.u.data() + std::size_t(m.y) * 8 * CW + m.x * 8;
        u8* V = c.v.data() + std::size_t(m.y) * 8 * CW + m.x * 8;
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
        const bool tA = intra_avail(s, m.x - 1, m.y), tB = intra_avail(s, m.x, m.y - 1);
        const bool tC = intra_avail(s, m.x + 1, m.y - 1), tD = intra_avail(s, m.x - 1, m.y - 1);
        if (d.kind == kI4) {
            for (int blk = 0; blk < 16; ++blk) {
                const int bx = kBlkX[blk], by = kBlkY[blk];
                const bool top = by ? true : tB, left = bx ? true : tA;
                const bool corner = (bx && by) ? true : (!bx && !by) ? tD : bx ? tB : tA;
                const bool tr = by == 0 ? (bx < 3 ? tB : tC) : bx == 3 ? false : kTopRightInside[blk];
                Edge e;
                gather(c.y.data(), W, m.x * 16 + bx * 4, m.y * 16 + by * 4, 4, top, left, corner,
                       tr, 4, e);
                intra4(d, blk, e);
                u8* dst = Y + by * 4 * W + bx * 4;
                pred4x4(dst, W, e, d.i4mode[blk]);
                i4[by * 4 + bx] = static_cast<std::int8_t>(d.i4mode[blk]);
                residual(d, 0, blk);
                add_block(dst, W, d.luma[blk], d.qp, false, 0);
            }
        } else if (d.kind == kI16) {
            Edge e;
            gather(c.y.data(), W, m.x * 16, m.y * 16, 16, tB, tA, tD, false, 0, e);
            if (d.i16mode == 2) pred16_dc(Y, W, e);
            else pred16(Y, W, e, d.i16mode, 16);
            residual(d, 1, 0);
            int dc[16];
            luma_dc(d.ldc, d.qp, dc);
            for (int blk = 0; blk < 16; ++blk) {
                const int bx = kBlkX[blk], by = kBlkY[blk];
                add_block(Y + by * 4 * W + bx * 4, W, d.luma[blk], d.qp, true, dc[by * 4 + bx]);
            }
        } else {
            // the vectors: P_Skip's predicted one, else each partition's
            // chosen one, coded as its difference from the prediction
            Part parts[16];
            const int n = d.kind == kSkip ? 1 : partitions(d, parts);
            if (d.kind == kSkip) parts[0] = Part{0, 0, 16, 16, 0, 0};
            unsigned done = 0;
            for (int p = 0; p < n; ++p) {
                const Part& q = parts[p];
                const int r = d.kind == kSkip ? 0 : d.ref[q.owner];
                int px, py, vx, vy;
                if (d.kind == kSkip) {
                    skip_mv(s, m, vx, vy);
                } else {
                    predict_mv(s, m, q.x, q.y, q.w, q.h, q.shape, r, done, px, py);
                    vx = want[p][0];
                    vy = want[p][1];
                    d.mvd[p][0] = vx - px;
                    d.mvd[p][1] = vy - py;
                }
                for (int y = q.y / 4; y < (q.y + q.h) / 4; ++y)
                    for (int x = q.x / 4; x < (q.x + q.w) / 4; ++x) {
                        ref[y * 4 + x] = static_cast<std::int8_t>(r);
                        mv[2 * (y * 4 + x)] = static_cast<std::int16_t>(vx);
                        mv[2 * (y * 4 + x) + 1] = static_cast<std::int16_t>(vy);
                        done |= 1u << (y * 4 + x);
                    }
                const Slot& rf = *s.refs[r];
                mc_luma(rf, m.x * 16 + q.x, m.y * 16 + q.y, q.w, q.h, vx, vy, Y + q.y * W + q.x, W);
                const int cx = m.x * 8 + q.x / 2, cy = m.y * 8 + q.y / 2;
                u8* du = U + (q.y / 2) * CW + q.x / 2;
                u8* dv = V + (q.y / 2) * CW + q.x / 2;
                mc_chroma(rf.u, CW, c.H / 2, cx, cy, q.w / 2, q.h / 2, vx, vy, du, CW);
                mc_chroma(rf.v, CW, c.H / 2, cx, cy, q.w / 2, q.h / 2, vx, vy, dv, CW);
            }
            for (int k = 0; k < 16; ++k) rpic[k] = s.sp.ids[ref[k]];
            if (d.kind == kSkip) return;
            residual(d, 1, 0);
            for (int blk = 0; blk < 16; ++blk) {
                const int bx = kBlkX[blk], by = kBlkY[blk];
                add_block(Y + by * 4 * W + bx * 4, W, d.luma[blk], d.qp, false, 0);
            }
        }
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
        residual(d, 2, 0);
        const int qpc[2] = {chroma_qp(s.sp, d.qp, 0), chroma_qp(s.sp, d.qp, 1)};
        for (int k = 0; k < 2; ++k) {
            int dc[4];
            chroma_dc(d.cdc[k], qpc[k], dc);
            u8* dst = k ? V : U;
            for (int blk = 0; blk < 4; ++blk)
                add_block(dst + (blk >> 1) * 4 * CW + (blk & 1) * 4, CW, d.cac[k][blk], qpc[k],
                          true, dc[blk]);
        }
    }

    // ------------------------------------------------------------ syntax

    // residual_block_cavlc of the levels at raster[scan ? scan[start + k]
    // : k], k < maxc
    void write_block(Writer& w, const std::int16_t* raster, int start, int maxc, int nc,
                     const u8* scan) {
        int lv[16], n = 0;
        for (int k = 0; k < maxc; ++k) lv[k] = raster[scan ? scan[start + k] : k];
        int idx[16];   // scan positions of the nonzero levels, high first
        for (int k = maxc - 1; k >= 0; --k)
            if (lv[k]) idx[n++] = k;
        const int total = n;
        int ones = 0;
        for (int i = 0; i < n && ones < 3; ++i) {
            if (std::abs(lv[idx[i]]) == 1) ++ones;
            else break;
        }
        if (nc < 0) {
            w.put(kDcTokenCode[total * 4 + ones], kDcTokenLen[total * 4 + ones]);
            ++cnt[kCntDcToken + total * 4 + ones];
        } else {
            const int cls = nc_class(nc);
            w.put(kTokenCode[cls][total * 4 + ones], kTokenLen[cls][total * 4 + ones]);
            ++cnt[kCntToken + cls * 68 + total * 4 + ones];
        }
        if (!total) return;
        for (int i = 0; i < ones; ++i) w.put(lv[idx[i]] < 0, 1);
        int suffix_len = (total > 10 && ones < 3) ? 1 : 0;
        for (int i = ones; i < total; ++i) {
            const int level = lv[idx[i]];
            int code = level > 0 ? 2 * level - 2 : -2 * level - 1;
            if (i == ones && ones < 3) code -= 2;
            int prefix, size, suffix;
            if (suffix_len == 0 && code < 14) {
                prefix = code; size = 0; suffix = 0;
            } else if (suffix_len == 0 && code < 30) {
                prefix = 14; size = 4; suffix = code - 14;
            } else if (suffix_len > 0 && (code >> suffix_len) < 15) {
                prefix = code >> suffix_len; size = suffix_len; suffix = code & ((1 << suffix_len) - 1);
            } else {
                int rem = code - (15 << suffix_len) - (suffix_len == 0 ? 15 : 0);
                prefix = 15;
                while (rem >= (1 << (prefix - 3))) {
                    rem -= prefix == 15 ? 4096 : (1 << (prefix - 3));
                    ++prefix;
                    // prefix p >= 16 starts at (1 << (p - 3)) - 4096
                }
                size = prefix - 3;
                suffix = rem;
            }
            w.put(0, prefix);
            w.put(1, 1);
            if (size) w.put(static_cast<unsigned>(suffix), size);
            ++cnt[kCntPrefix + std::min(prefix, 31)];
            if (suffix_len == 0) suffix_len = 1;
            if (std::abs(level) > (3 << (suffix_len - 1)) && suffix_len < 6) ++suffix_len;
        }
        int zeros = (idx[0] + 1) - total;
        if (total < maxc) {
            if (nc < 0) {
                w.put(kDcZerosCode[total - 1][zeros], kDcZerosLen[total - 1][zeros]);
                ++cnt[kCntDcZeros + (total - 1) * 4 + zeros];
            } else {
                w.put(kZerosCode[total - 1][zeros], kZerosLen[total - 1][zeros]);
                ++cnt[kCntZeros + (total - 1) * 16 + zeros];
            }
        }
        for (int i = 0; i < total - 1 && zeros > 0; ++i) {
            const int run = idx[i] - idx[i + 1] - 1;
            const int z = std::min(zeros, 7) - 1;
            w.put(kRunCode[z][run], kRunLen[z][run]);
            ++cnt[kCntRun + z * 15 + run];
            zeros -= run;
        }
    }

    void write_mb(Writer& w, const MbData& d, int qp_pred) {
        const bool p_slice = !intra_slice;
        int itype = 0;
        if (d.kind == kPcm) itype = 25;
        else if (d.kind == kI16) itype = 1 + d.i16mode + 4 * (d.cbp >> 4) + ((d.cbp & 15) ? 12 : 0);
        if (d.kind == kInter) w.ue(d.ptype);
        else w.ue(itype + (p_slice ? 5 : 0));
        if (d.kind == kPcm) {
            w.align_zero();
            for (int i = 0; i < 384; ++i) w.put(d.pcm[i], 8);
            return;
        }
        const int nref = s.sp.nref;
        if (d.kind == kI4) {
            for (int blk = 0; blk < 16; ++blk) {
                const int pred = i4_predicted(s, m, blk);
                if (d.i4mode[blk] == pred) w.put(1, 1);
                else {
                    w.put(0, 1);
                    w.put(d.i4mode[blk] < pred ? d.i4mode[blk] : d.i4mode[blk] - 1, 3);
                }
            }
        }
        if (d.kind == kI4 || d.kind == kI16) {
            w.ue(d.cmode);
        } else {
            Part parts[16];
            const int n = partitions(d, parts);
            if (d.ptype >= 3) {
                for (int i = 0; i < 4; ++i) w.ue(d.sub[i]);
                if (nref > 1 && d.ptype == 3)
                    for (int i = 0; i < 4; ++i) {
                        if (nref == 2) w.put(!d.ref[i], 1);
                        else w.ue(d.ref[i]);
                    }
            } else {
                const int np = d.ptype == 0 ? 1 : 2;
                if (nref > 1)
                    for (int i = 0; i < np; ++i) {
                        if (nref == 2) w.put(!d.ref[i], 1);
                        else w.ue(d.ref[i]);
                    }
            }
            for (int p = 0; p < n; ++p) {
                w.se(d.mvd[p][0]);
                w.se(d.mvd[p][1]);
            }
        }
        if (d.kind != kI16) {
            const u8* table = d.kind == kI4 ? kCbpIntra : kCbpInter;
            int code = 0;
            while (table[code] != d.cbp) ++code;
            w.ue(code);
        }
        if (d.cbp || d.kind == kI16) {
            const int delta = ((d.qp - qp_pred + 26 + 52) % 52) - 26;
            w.se(delta);
            ++cnt[kCntQp + d.qp];
            // the residual, as parse_residual reads it
            if (d.kind == kI16) write_block(w, d.ldc, 0, 16, nc_of(s, m, 0, 0, 0), kZigzag);
            for (int blk = 0; blk < 16; ++blk) {
                if (!(d.cbp >> (blk >> 2) & 1)) continue;
                const int nc = nc_of(s, m, 0, kBlkX[blk], kBlkY[blk]);
                if (d.kind == kI16) write_block(w, d.luma[blk], 1, 15, nc, kZigzag);
                else write_block(w, d.luma[blk], 0, 16, nc, kZigzag);
            }
            const int cc = d.cbp >> 4;
            if (cc & 3)
                for (int k = 0; k < 2; ++k) write_block(w, d.cdc[k], 0, 4, -1, nullptr);
            if (cc & 2)
                for (int k = 0; k < 2; ++k)
                    for (int b = 0; b < 4; ++b)
                        write_block(w, d.cac[k][b], 1, 15, nc_of(s, m, k + 1, b & 1, b >> 1), kZigzag);
        }
    }

    // code MBs [first, last) of the slice into w
    void slice(Writer& w, int last) {
        Slot& c = *s.cur;
        int qp = s.sp.qp;
        int run = 0;
        MbData d;
        for (int a = s.sp.first_mb; a < last; ++a) {
            m = MbPos{a, a % c.mbw, a / c.mbw};
            c.slice[a] = static_cast<std::int16_t>(s.index);
            choose(d, qp);
            ++cnt[kCntKind + d.kind];
            if (d.kind == kSkip) {
                std::memset(&c.nnz[std::size_t(a) * 24], 0, 24);
                rebuild(d);
                c.qp[a] = static_cast<std::int8_t>(qp);
                ++run;
                continue;
            }
            if (d.kind != kPcm) std::memset(&c.nnz[std::size_t(a) * 24], 0, 24);
            rebuild(d);
            if (d.kind != kPcm) {
                if (!d.cbp && d.kind != kI16) d.qp = qp;   // no mb_qp_delta: the QP stays
                c.qp[a] = static_cast<std::int8_t>(d.qp);
            }
            if (!intra_slice) {
                w.ue(run);
                run = 0;
            }
            write_mb(w, d, qp);
            if (d.kind != kPcm) qp = d.qp;
        }
        if (!intra_slice && run) w.ue(run);
        w.trailing();
    }
};

}  // namespace

extern "C" {

void* clt_h264enc_new(int mbw, int mbh, int slots) { return clt_h264_new(mbw, mbh, slots); }

void clt_h264enc_free(void* h) { clt_h264_free(h); }

// Code macroblocks [params[0], last) of one slice into slot `slot` from
// the source planes (MB-aligned yuv420p, the slot's size), after the
// slice header's `head_bits` bits in `head`; `index`: the slice's number
// in the picture (the first of a picture resets the slot).  Writes the
// RBSP (header, slice data, trailing bits) to out (capacity cap) and
// returns its size in bytes, or -1 where it does not fit; `opts`: kOpts
// options; `counts` (kCntSize) accumulates what was written.
long long clt_h264enc_slice(void* h, int slot, int index, const unsigned char* y,
                            const unsigned char* u, const unsigned char* v, const int* params,
                            int last, const unsigned char* head, long long head_bits,
                            const int* opts, int* counts, unsigned char* out, long long cap) {
    Decoder& dec = *static_cast<Decoder*>(h);
    Opts o;
    std::memcpy(&o, opts, sizeof o);
    Encoder e(dec, o, counts);
    Slot& c = *dec.slots[slot];
    if (index == 0) c.reset();
    e.s.cur = &c;
    e.s.index = index;
    const int* p = params;
    SliceParams& sp = e.s.sp;
    sp.first_mb = p[0];
    sp.type = p[1];
    sp.qp = p[2];
    sp.disable = p[3];
    sp.off_a = p[4];
    sp.off_b = p[5];
    sp.cqp[0] = p[6];
    sp.cqp[1] = p[7];
    sp.cip = p[8];
    sp.nref = p[9];
    for (int r = 0; r < 32; ++r) {
        sp.refs[r] = p[10 + r];
        sp.ids[r] = p[42 + r];
        e.s.refs[r] = (r < sp.nref && sp.refs[r] >= 0) ? dec.slots[sp.refs[r]].get() : nullptr;
    }
    e.intra_slice = sp.type == 2;
    e.sy = y;
    e.su = u;
    e.sv = v;
    Writer w;
    for (long long i = 0; i < head_bits; ++i) w.put(head[i >> 3] >> (7 - (i & 7)) & 1, 1);
    try {
        e.slice(w, last);
    } catch (const Fail&) {
        return -2;
    }
    if (static_cast<long long>(w.out.size()) > cap) return -1;
    std::memcpy(out, w.out.data(), w.out.size());
    return static_cast<long long>(w.out.size());
}

// Deblock slot `slot` whose ns slices had the parameters params (kParams
// each, in the order of their numbers).
void clt_h264enc_deblock(void* h, int slot, const int* params, int ns) {
    Decoder& dec = *static_cast<Decoder*>(h);
    std::vector<SliceParams> sps(ns);
    for (int i = 0; i < ns; ++i) {
        const int* p = params + kParams * i;
        sps[i].first_mb = p[0];
        sps[i].type = p[1];
        sps[i].qp = p[2];
        sps[i].disable = p[3];
        sps[i].off_a = p[4];
        sps[i].off_b = p[5];
        sps[i].cqp[0] = p[6];
        sps[i].cqp[1] = p[7];
    }
    deblock(*dec.slots[slot], sps.data());
}

void clt_h264enc_planes(void* h, int slot, unsigned char* dst) {
    const Slot& c = *static_cast<Decoder*>(h)->slots[slot];
    clt_h264_output(h, slot, 0, 0, c.H, c.W, dst);
}

int clt_h264enc_counts() { return kCntSize; }
int clt_h264enc_opts() { return kOpts; }

}  // extern "C"
