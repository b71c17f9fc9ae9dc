// Native TIFF codec primitives for camera_linearity_tpu_torch.
//
// LZW (TIFF 6.0 section 13, libtiff's variant: codes MSB-first, 9 to 12
// bits, Clear 256, EOI 257, the width growing one code early, a Clear
// once the table holds 4094 entries), PackBits (section 9, decoded as
// libtiff's PackBitsDecode does) and the predictors: horizontal
// differencing (2) at 8, 16, 32 and 64 bits, undone, and at 8 and 16
// bits applied, and libtiff's floating-point predictor (3) at 32 and 64
// bits, undone.  Chunks
// (strips or tiles) and rows are independent, so every entry point takes
// a batch and spreads it over threads, each taking the next chunk or row
// block from a shared counter.
//
// Built as a plain shared library with g++ on first use;
// camera_linearity_tpu_torch.native loads it with ctypes, and
// utils/tiff.py holds the container around it.  The plain Python
// versions in native/tiff_plain.py are what the tests hold it to.

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kMaxBits = 12;
constexpr int kTable = 1 << kMaxBits;

// Run fn(i) for i in [0, n) on up to nthreads threads, each taking the
// next index from a shared counter (chunks differ in cost).
template <typename F>
void parallel_items(std::size_t n, int nthreads, F&& fn) {
    const int t = static_cast<int>(
        std::min<std::size_t>(n, static_cast<std::size_t>(std::max(1, nthreads))));
    if (t <= 1) {
        for (std::size_t i = 0; i < n; ++i) fn(i);
        return;
    }
    std::atomic<std::size_t> next{0};
    auto work = [&] {
        for (std::size_t i = next++; i < n; i = next++) fn(i);
    };
    std::vector<std::thread> threads;
    for (int k = 1; k < t; ++k) threads.emplace_back(work);
    work();
    for (auto& th : threads) th.join();
}

// Decode one LZW chunk into dst.  Returns the bytes written, -1 for a
// code the table cannot hold, -2 when the data decode to more than cap.
// A chunk that ends without EOI ends where its bytes do, as in libtiff.
std::int64_t lzw_decode(const std::uint8_t* src, std::size_t n,
                        std::uint8_t* dst, std::size_t cap) {
    std::uint16_t prefix[kTable];
    std::uint8_t suffix[kTable];
    std::uint8_t first[kTable];
    std::uint16_t length[kTable];
    for (int i = 0; i < 256; ++i) {
        suffix[i] = first[i] = static_cast<std::uint8_t>(i);
        length[i] = 1;
        prefix[i] = 0;
    }
    std::uint64_t bits = 0;
    int nbits = 0;
    std::size_t pos = 0, out = 0;
    int width = 9, next = kFirst, old = -1;
    for (;;) {
        while (nbits < width && pos < n) {
            bits = (bits << 8) | src[pos++];
            nbits += 8;
        }
        if (nbits < width) break;
        const int code = static_cast<int>((bits >> (nbits - width))
                                          & ((1u << width) - 1));
        nbits -= width;
        if (code == kEoi) break;
        if (code == kClear) {
            width = 9;
            next = kFirst;
            old = -1;
            continue;
        }
        if (old < 0) {  // the first code after a Clear adds no entry
            if (code > 255) return -1;
            if (out >= cap) return -2;
            dst[out++] = static_cast<std::uint8_t>(code);
            old = code;
            continue;
        }
        int len;
        std::uint8_t head;
        if (code < next) {
            len = length[code];
            if (out + len > cap) return -2;
            int c = code;
            for (int i = len - 1; i >= 0; --i) {
                dst[out + i] = suffix[c];
                c = prefix[c];
            }
            head = first[code];
        } else if (code == next) {  // the string of old plus its own head
            len = length[old] + 1;
            if (out + len > cap) return -2;
            int c = old;
            for (int i = len - 2; i >= 0; --i) {
                dst[out + i] = suffix[c];
                c = prefix[c];
            }
            head = first[old];
            dst[out + len - 1] = head;
        } else {
            return -1;
        }
        if (next < kTable) {
            prefix[next] = static_cast<std::uint16_t>(old);
            suffix[next] = head;
            first[next] = first[old];
            length[next] = static_cast<std::uint16_t>(length[old] + 1);
            ++next;
        }
        out += static_cast<std::size_t>(len);
        old = code;
        if (next + 1 >= (1 << width) && width < kMaxBits) ++width;
    }
    return static_cast<std::int64_t>(out);
}

// Decode one PackBits chunk into dst as libtiff does: a header n >= 0
// copies n + 1 bytes, n in [-127, -1] repeats the next byte 1 - n times,
// -128 is a no-op; output past cap is dropped.  Returns the bytes
// written (short of cap when the data run out).
std::int64_t packbits_decode(const std::uint8_t* src, std::size_t n,
                             std::uint8_t* dst, std::size_t cap) {
    std::size_t pos = 0, out = 0;
    while (pos < n && out < cap) {
        const int h = static_cast<std::int8_t>(src[pos++]);
        if (h == -128) continue;
        if (h < 0) {
            if (pos == n) break;
            const std::size_t len = std::min<std::size_t>(1 - h, cap - out);
            std::memset(dst + out, src[pos++], len);
            out += len;
        } else {
            const std::size_t len = static_cast<std::size_t>(h) + 1;
            if (n - pos < len) break;
            const std::size_t keep = std::min(len, cap - out);
            std::memcpy(dst + out, src + pos, keep);
            out += keep;
            pos += len;
        }
    }
    return static_cast<std::int64_t>(out);
}

class BitWriter {
  public:
    BitWriter(std::uint8_t* dst, std::size_t cap) : dst_(dst), cap_(cap) {}
    void put(int code, int width) {
        bits_ = (bits_ << width) | static_cast<std::uint32_t>(code);
        nbits_ += width;
        while (nbits_ >= 8) {
            nbits_ -= 8;
            emit(static_cast<std::uint8_t>(bits_ >> nbits_));
        }
        bits_ &= (1u << nbits_) - 1;
    }
    void flush() {
        if (nbits_ > 0) emit(static_cast<std::uint8_t>(bits_ << (8 - nbits_)));
        nbits_ = 0;
    }
    bool overflowed() const { return out_ > cap_; }
    std::size_t size() const { return out_; }

  private:
    void emit(std::uint8_t b) {
        if (out_ < cap_) dst_[out_] = b;
        ++out_;
    }
    std::uint8_t* dst_;
    std::size_t cap_;
    std::size_t out_ = 0;
    std::uint32_t bits_ = 0;
    int nbits_ = 0;
};

// Open-addressed (prefix code, byte) -> code table; a Clear empties it.
class CodeTable {
  public:
    CodeTable() : keys_(kSize), codes_(kSize) { clear(); }
    void clear() { std::fill(keys_.begin(), keys_.end(), -1); }
    int find(std::int32_t key, std::size_t* slot) const {
        std::size_t h = (static_cast<std::uint32_t>(key) * 2654435761u) >> 18;
        for (;; h = (h + 1) & (kSize - 1)) {
            if (keys_[h] == key) return codes_[h];
            if (keys_[h] < 0) {
                *slot = h;
                return -1;
            }
        }
    }
    void insert(std::size_t slot, std::int32_t key, int code) {
        keys_[slot] = key;
        codes_[slot] = static_cast<std::uint16_t>(code);
    }

  private:
    static constexpr std::size_t kSize = 1 << 14;  // <= 4094 live entries
    std::vector<std::int32_t> keys_;
    std::vector<std::uint16_t> codes_;
};

// Encode one chunk as libtiff's LZWEncode does.  Returns the encoded
// size (which may exceed cap: then nothing past cap was written).
std::size_t lzw_encode(const std::uint8_t* src, std::size_t n,
                       std::uint8_t* dst, std::size_t cap) {
    BitWriter w(dst, cap);
    CodeTable table;
    int width = 9, next = kFirst;
    w.put(kClear, width);
    auto grow = [&] {  // after an entry: Clear when full, else widen early
        if (next == kTable - 2) {
            w.put(kClear, width);
            table.clear();
            next = kFirst;
            width = 9;
        } else if (next > (1 << width) - 1) {
            ++width;
        }
    };
    if (n > 0) {
        int ent = src[0];
        for (std::size_t i = 1; i < n; ++i) {
            const int c = src[i];
            const std::int32_t key = (ent << 8) | c;
            std::size_t slot = 0;
            const int code = table.find(key, &slot);
            if (code >= 0) {
                ent = code;
                continue;
            }
            w.put(ent, width);
            table.insert(slot, key, next++);
            grow();
            ent = c;
        }
        w.put(ent, width);
        ++next;  // the decoder adds an entry on reading that code
        grow();
    }
    w.put(kEoi, width);
    w.flush();
    return w.size();
}

inline void swap_bytes(std::uint8_t* p, std::size_t count, int size) {
    for (std::size_t i = 0; i < count; ++i, p += size)
        std::reverse(p, p + size);
}

template <typename T>
void hor_acc(T* row, std::size_t samples, int spp) {
    for (std::size_t i = static_cast<std::size_t>(spp); i < samples; ++i)
        row[i] = static_cast<T>(row[i] + row[i - spp]);
}

template <typename T>
void hor_diff(T* row, std::size_t samples, int spp) {
    for (std::size_t i = samples; i-- > static_cast<std::size_t>(spp);)
        row[i] = static_cast<T>(row[i] - row[i - spp]);
}

// libtiff's fpAcc: add the bytes across the row with stride spp, then
// gather byte plane k (most significant first) into each sample's byte.
void fp_acc(std::uint8_t* row, std::size_t samples, int spp, int size,
            std::uint8_t* tmp) {
    const std::size_t nbytes = samples * static_cast<std::size_t>(size);
    for (std::size_t i = static_cast<std::size_t>(spp); i < nbytes; ++i)
        row[i] = static_cast<std::uint8_t>(row[i] + row[i - spp]);
    std::memcpy(tmp, row, nbytes);
    for (std::size_t s = 0; s < samples; ++s)
        for (int b = 0; b < size; ++b)  // little-endian host
            row[s * size + b] = tmp[(size - 1 - b) * samples + s];
}

}  // namespace

extern "C" {

int clt_tiff_version() { return 2; }

// Decode n LZW chunks of the file image `src` (chunk i at offsets[i],
// counts[i] bytes) into dst (chunk i at dst_offsets[i], room for
// dst_sizes[i] bytes).  got[i] receives the bytes chunk i decoded to, or
// a negative code (-1 corrupt, -2 longer than its room, -3 outside the
// file).
void clt_lzw_decode_chunks(const std::uint8_t* src, std::size_t src_size,
                           const std::uint64_t* offsets,
                           const std::uint64_t* counts, std::size_t n,
                           std::uint8_t* dst, const std::uint64_t* dst_offsets,
                           const std::uint64_t* dst_sizes, std::int64_t* got,
                           int nthreads) {
    parallel_items(n, nthreads, [&](std::size_t i) {
        if (offsets[i] > src_size || counts[i] > src_size - offsets[i]) {
            got[i] = -3;
            return;
        }
        got[i] = lzw_decode(src + offsets[i], counts[i], dst + dst_offsets[i],
                            dst_sizes[i]);
    });
}

// Decode n PackBits chunks as clt_lzw_decode_chunks decodes LZW ones
// (got[i] < 0 only for a chunk outside the file, -3).
void clt_packbits_decode_chunks(const std::uint8_t* src, std::size_t src_size,
                                const std::uint64_t* offsets,
                                const std::uint64_t* counts, std::size_t n,
                                std::uint8_t* dst,
                                const std::uint64_t* dst_offsets,
                                const std::uint64_t* dst_sizes,
                                std::int64_t* got, int nthreads) {
    parallel_items(n, nthreads, [&](std::size_t i) {
        if (offsets[i] > src_size || counts[i] > src_size - offsets[i]) {
            got[i] = -3;
            return;
        }
        got[i] = packbits_decode(src + offsets[i], counts[i],
                                 dst + dst_offsets[i], dst_sizes[i]);
    });
}

// Encode n chunks of src (chunk i at src_offsets[i], src_sizes[i] bytes)
// into dst (chunk i at dst_offsets[i], room for dst_caps[i] bytes).
// sizes[i] receives chunk i's encoded size; a size above dst_caps[i]
// means the room was too small.
void clt_lzw_encode_chunks(const std::uint8_t* src,
                           const std::uint64_t* src_offsets,
                           const std::uint64_t* src_sizes, std::size_t n,
                           std::uint8_t* dst, const std::uint64_t* dst_offsets,
                           const std::uint64_t* dst_caps, std::uint64_t* sizes,
                           int nthreads) {
    parallel_items(n, nthreads, [&](std::size_t i) {
        sizes[i] = lzw_encode(src + src_offsets[i], src_sizes[i],
                              dst + dst_offsets[i], dst_caps[i]);
    });
}

// Undo a predictor in place over `rows` rows of `samples` samples of
// `size` bytes each, stored back to back: 1 none, 2 horizontal
// differencing (size 1, 2, 4 or 8), 3 floating point (size 4 or 8).  `swap`
// says the samples are big-endian in the file: they are swapped to the
// host's order first (predictor 3 yields the host's order itself).
// Returns 0, or -1 for a combination it does not handle.
int clt_predictor_undo(std::uint8_t* data, std::size_t rows,
                       std::size_t samples, int spp, int size, int predictor,
                       int swap, int nthreads) {
    if (spp < 1 ||
        (predictor == 2 && size != 1 && size != 2 && size != 4 && size != 8) ||
        (predictor == 3 && size != 4 && size != 8) ||
        (predictor != 1 && predictor != 2 && predictor != 3))
        return -1;
    const std::size_t row_bytes = samples * static_cast<std::size_t>(size);
    const std::size_t block = std::max<std::size_t>(1, (1u << 16) / std::max<std::size_t>(1, row_bytes));
    const std::size_t blocks = (rows + block - 1) / block;
    parallel_items(blocks, nthreads, [&](std::size_t k) {
        std::vector<std::uint8_t> tmp(predictor == 3 ? row_bytes : 0);
        const std::size_t hi = std::min(rows, (k + 1) * block);
        for (std::size_t r = k * block; r < hi; ++r) {
            std::uint8_t* row = data + r * row_bytes;
            if (predictor == 3) {
                fp_acc(row, samples, spp, size, tmp.data());
                continue;
            }
            if (swap && size > 1) swap_bytes(row, samples, size);
            if (predictor != 2) continue;
            if (size == 1) hor_acc(row, samples, spp);
            else if (size == 2)
                hor_acc(reinterpret_cast<std::uint16_t*>(row), samples, spp);
            else if (size == 4)
                hor_acc(reinterpret_cast<std::uint32_t*>(row), samples, spp);
            else
                hor_acc(reinterpret_cast<std::uint64_t*>(row), samples, spp);
        }
    });
    return 0;
}

// Apply horizontal differencing in place (size 1 or 2, host order) to
// `rows` rows of `samples` samples.  Returns 0, or -1 for another size.
int clt_predictor_apply(std::uint8_t* data, std::size_t rows,
                        std::size_t samples, int spp, int size, int nthreads) {
    if (spp < 1 || (size != 1 && size != 2)) return -1;
    const std::size_t row_bytes = samples * static_cast<std::size_t>(size);
    const std::size_t block = std::max<std::size_t>(1, (1u << 16) / std::max<std::size_t>(1, row_bytes));
    const std::size_t blocks = (rows + block - 1) / block;
    parallel_items(blocks, nthreads, [&](std::size_t k) {
        const std::size_t hi = std::min(rows, (k + 1) * block);
        for (std::size_t r = k * block; r < hi; ++r) {
            std::uint8_t* row = data + r * row_bytes;
            if (size == 1) hor_diff(row, samples, spp);
            else hor_diff(reinterpret_cast<std::uint16_t*>(row), samples, spp);
        }
    });
    return 0;
}

}  // extern "C"
