// Native host-side staging primitives for camera_linearity_tpu_torch.
//
// The exact integer moments of raw uint8 video frames and their fused
// finalization, copied from camera_linearity_tpu/native/stager.cpp (the
// functions the video statistics use).  Everything here is threaded with a
// simple pthread fork-join over element ranges.
//
// One change from the copy: the f16 std of the wire finalize is narrowed
// by a portable round-to-nearest-even routine (f64_to_f16_bits) instead of
// the compiler's _Float16, which g++ older than 12 lacks on x86-64.  It is
// bit-identical to NumPy's float64 -> float16 cast.
//
// Built as a plain shared library; camera_linearity_tpu_torch.native loads
// it via ctypes and falls back to NumPy when unavailable.

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

template <typename F>
void parallel_for(std::size_t n, int nthreads, F&& fn) {
    if (nthreads <= 1 || n < 1u << 16) {
        fn(std::size_t{0}, n);
        return;
    }
    std::vector<std::thread> threads;
    std::size_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        std::size_t lo = std::min(n, t * chunk);
        std::size_t hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back([lo, hi, &fn] { fn(lo, hi); });
    }
    for (auto& th : threads) th.join();
}

// IEEE binary16 bits of d, rounded to nearest with ties to even, as
// NumPy's float64 -> float16 cast narrows it: overflow goes to a signed
// infinity, values below half the smallest subnormal (2^-25) to a signed
// zero, and a NaN keeps the top 10 bits of its payload (and stays a NaN).
inline std::uint16_t f64_to_f16_bits(double d) {
    std::uint64_t b;
    std::memcpy(&b, &d, sizeof b);
    const auto sign = static_cast<std::uint16_t>((b >> 48) & 0x8000u);
    const int exp = static_cast<int>((b >> 52) & 0x7ffu);
    const std::uint64_t man = b & 0xfffffffffffffULL;
    if (exp == 0x7ff) {  // infinity or NaN
        if (man == 0) return sign | 0x7c00u;
        auto h = static_cast<std::uint16_t>(0x7c00u | (man >> 42));
        if (h == 0x7c00u) h |= 1u;
        return sign | h;
    }
    const int e = exp - 1023;  // unbiased; a subnormal double is far below
    if (e > 15) return sign | 0x7c00u;
    if (e >= -14) {
        // normal half: keep 10 mantissa bits, round on the 42 dropped; a
        // carry moves into the exponent, up to infinity
        std::uint64_t h = (static_cast<std::uint64_t>(e + 15) << 10)
                          | (man >> 42);
        const std::uint64_t rest = man & ((1ULL << 42) - 1);
        const std::uint64_t half = 1ULL << 41;
        if (rest > half || (rest == half && (h & 1u))) ++h;
        return sign | static_cast<std::uint16_t>(h);
    }
    if (e < -25) return sign;
    // subnormal half: m = round(|d| * 2^24) with |d| = sig * 2^(e - 52);
    // a carry to 0x400 is the smallest normal, which is right
    const std::uint64_t sig = (1ULL << 52) | man;
    const int s = 28 - e;  // 43..53
    std::uint64_t m = sig >> s;
    const std::uint64_t rest = sig & ((1ULL << s) - 1);
    const std::uint64_t half = 1ULL << (s - 1);
    if (rest > half || (rest == half && (m & 1u))) ++m;
    return sign | static_cast<std::uint16_t>(m);
}

}  // namespace

extern "C" {

// Exact integer moment accumulation over a (B, n) uint8 frame batch:
//   sum[i]   += sum_b frames[b][i]
//   sumsq[i] += sum_b frames[b][i]^2
//
// For raw-DN streams this replaces the running f64 Welford update entirely:
// the accumulated sums are EXACT integers, and the caller recovers
//   mean = sum/n,  M2 = sumsq - sum^2/n
// which equals Welford's M2 with zero accumulation error (reference loop:
// modules/video_processing.py:206-208 carries f64 rounding per frame).
// A pixel tile's u32 partials stay in L1 across the whole sub-batch, so
// steady-state traffic is ~1 byte per element per frame plus amortized u64
// spills.
//
// Sub-batches are capped at 64 frames so the u32 sumsq partial cannot
// overflow (64 * 255^2 < 2^32); the u64 totals are exact to 2^46 frames.
void clt_accum_moments_u8(const std::uint8_t* frames, std::size_t batch,
                          std::size_t n, std::uint64_t* sum,
                          std::uint64_t* sumsq, int nthreads) {
    constexpr std::size_t TILE = 4096;
    constexpr std::size_t SUB = 64;
    parallel_for(n, nthreads, [&](std::size_t lo, std::size_t hi) {
        std::uint32_t ps[TILE];
        std::uint32_t pq[TILE];
        for (std::size_t t0 = lo; t0 < hi; t0 += TILE) {
            const std::size_t tn = std::min(TILE, hi - t0);
            for (std::size_t b0 = 0; b0 < batch; b0 += SUB) {
                const std::size_t bn = std::min(SUB, batch - b0);
                for (std::size_t i = 0; i < tn; ++i) { ps[i] = 0; pq[i] = 0; }
                for (std::size_t b = b0; b < b0 + bn; ++b) {
                    const std::uint8_t* in = frames + b * n + t0;
                    for (std::size_t i = 0; i < tn; ++i) {
                        const std::uint32_t x = in[i];
                        ps[i] += x;
                        pq[i] += x * x;
                    }
                }
                for (std::size_t i = 0; i < tn; ++i) {
                    sum[t0 + i] += ps[i];
                    sumsq[t0 + i] += pq[i];
                }
            }
        }
    });
}

// Fused finalization of the exact integer moments into mean and
// std-of-mean frames, single pass, no temporaries.  Mirrors the NumPy
// expression in HostMoments.finalize operation-for-operation:
//   mean = (sum / n) * scale
//   m2   = (sumsq - sum*sum/n) * scale^2, clamped at 0
//   std  = sqrt(m2 / (n-1)) / sqrt(n)
// (reference semantics: modules/video_processing.py:210-215).
// std_of_mean may be null to skip the uncertainty output.
void clt_finalize_moments_u64(const std::uint64_t* sum,
                              const std::uint64_t* sumsq, std::size_t n,
                              double count, double scale, double* mean,
                              double* std_of_mean, int nthreads) {
    // divisions kept as divisions (not reciprocal multiplies) so results
    // are bit-identical to the NumPy fallback expression
    const double scale2 = scale * scale;
    const double nm1 = count - 1.0;
    const double sqrt_n = std::sqrt(count);
    parallel_for(n, nthreads, [&](std::size_t lo, std::size_t hi) {
        for (std::size_t i = lo; i < hi; ++i) {
            const double s = static_cast<double>(sum[i]);
            mean[i] = s / count * scale;
            if (std_of_mean != nullptr) {
                double m2 = (static_cast<double>(sumsq[i]) - s * s / count)
                            * scale2;
                m2 = std::max(m2, 0.0);
                std_of_mean[i] = std::sqrt(m2 / nm1) / sqrt_n;
            }
        }
    });
}

// f32-output variant: identical double-precision arithmetic, results cast
// to float on store (bit-identical to computing in f64 and narrowing
// afterwards, without the extra full-frame pass).
void clt_finalize_moments_u64_f32(const std::uint64_t* sum,
                                  const std::uint64_t* sumsq, std::size_t n,
                                  double count, double scale, float* mean,
                                  float* std_of_mean, int nthreads) {
    const double scale2 = scale * scale;
    const double nm1 = count - 1.0;
    const double sqrt_n = std::sqrt(count);
    parallel_for(n, nthreads, [&](std::size_t lo, std::size_t hi) {
        for (std::size_t i = lo; i < hi; ++i) {
            const double s = static_cast<double>(sum[i]);
            mean[i] = static_cast<float>(s / count * scale);
            if (std_of_mean != nullptr) {
                double m2 = (static_cast<double>(sumsq[i]) - s * s / count)
                            * scale2;
                m2 = std::max(m2, 0.0);
                std_of_mean[i] =
                    static_cast<float>(std::sqrt(m2 / nm1) / sqrt_n);
            }
        }
    });
}

// Wire-format finalization: the same fused moment finalize, writing the
// host->device WIRE encodings directly — u16 fixed-point mean
// (round(mean * 65535), mean is in [0,1] by construction for DN streams)
// and the IEEE f16 bits of the std-of-mean — so the quantized upload
// stream costs no extra host pass over finalizing to f32.
// std_of_mean may be null to skip the uncertainty output.
//
// Quantization budget: u16 val error is <= 2^-17 ~ 7.6e-6 absolute on the
// [0,1] scale, and f16 std error is <= 2^-11 relative.  Callers dequantize
// on the device.
void clt_finalize_moments_u64_wire(const std::uint64_t* sum,
                                   const std::uint64_t* sumsq,
                                   std::size_t n, double count,
                                   double scale, std::uint16_t* mean_q,
                                   std::uint16_t* std_of_mean,
                                   int nthreads) {
    const double scale2 = scale * scale;
    const double nm1 = count - 1.0;
    const double sqrt_n = std::sqrt(count);
    parallel_for(n, nthreads, [&](std::size_t lo, std::size_t hi) {
        for (std::size_t i = lo; i < hi; ++i) {
            const double s = static_cast<double>(sum[i]);
            double m = s / count * scale * 65535.0 + 0.5;
            // defensive clamp: DN means are <= 1.0 exactly, but a caller
            // with a miscalibrated scale must saturate, not wrap
            m = std::min(std::max(m, 0.0), 65535.0);
            mean_q[i] = static_cast<std::uint16_t>(m);
            if (std_of_mean != nullptr) {
                double m2 = (static_cast<double>(sumsq[i]) - s * s / count)
                            * scale2;
                m2 = std::max(m2, 0.0);
                std_of_mean[i] =
                    f64_to_f16_bits(std::sqrt(m2 / nm1) / sqrt_n);
            }
        }
    });
}

// out[i] = the f16 bits of in[i], as the wire finalize narrows its std
void clt_f64_to_f16(const double* in, std::uint16_t* out, std::size_t n) {
    for (std::size_t i = 0; i < n; ++i) out[i] = f64_to_f16_bits(in[i]);
}

int clt_version() { return 6; }

}  // extern "C"
