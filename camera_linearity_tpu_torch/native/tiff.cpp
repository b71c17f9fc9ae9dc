// Native TIFF codec primitives for camera_linearity_tpu_torch.
//
// LZW (TIFF 6.0 section 13, libtiff's variant: codes MSB-first, 9 to 12
// bits, Clear 256, EOI 257, the width growing one code early, a Clear
// once the table holds 4094 entries), PackBits (section 9, decoded as
// libtiff's PackBitsDecode does) and the predictors: horizontal
// differencing (2) at 8, 16, 32 and 64 bits, undone, and at 8 and 16
// bits applied, and libtiff's floating-point predictor (3) at 32 and 64
// bits, undone; CCITT bilevel decoding (T.4 and T.6: Modified Huffman
// rows, T.4 one- and two-dimensional rows after EOLs, T.6 rows) into
// packed rows, 1 for black, as libtiff's Fax3 decoder fills them.  Chunks
// (strips or tiles) and rows are independent, so every entry point takes
// a batch and spreads it over threads, each taking the next chunk or row
// block from a shared counter.
//
// Built as a plain shared library with g++ on first use;
// camera_linearity_tpu_torch.native loads it with ctypes, and
// utils/tiff.py holds the container around it.  The plain Python
// versions in native/tiff_plain.py are what the tests hold it to.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

#include "parallel.h"

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kMaxBits = 12;
constexpr int kTable = 1 << kMaxBits;

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

// ---- CCITT ----
//
// T.4's code tables as bit strings (the same as native/tiff_plain.py's):
// terminating codes of runs 0-63, make-up codes of 64-1728, then the
// extended make-up codes of 1792-2560 both colours share.
constexpr const char* kWhiteTerm =
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 "
    "01000 001000 000011 110100 110101 101010 101011 0100111 0001100 "
    "0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 "
    "0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 "
    "00101011 00101100 00101101 00000100 00000101 00001010 00001011 "
    "01010010 01010011 01010100 01010101 00100100 00100101 01011000 "
    "01011001 01011010 01011011 01001010 01001011 00110010 00110011 "
    "00110100";
constexpr const char* kWhiteMakeup =
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 "
    "011011011 010011000 010011001 010011010 011000 010011011";
constexpr const char* kBlackTerm =
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111";
constexpr const char* kBlackMakeup =
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101";
constexpr const char* kExtendedMakeup =
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111";

constexpr int kFaxPeek = 13;          // the longest run code
constexpr int kFaxBad = -1;           // a bad code, a row of the wrong length
constexpr int kFaxShort = -4;         // the data end inside a row
constexpr int kFaxNoEol = -5;         // a T.4 row without its EOL

// A lookup of kFaxPeek bits: (length << 16) | value, 0 for no code.
struct FaxTable {
    std::vector<std::uint32_t> look = std::vector<std::uint32_t>(1 << kFaxPeek, 0);
    void add(const char* codes, int first, int step) {
        int value = first;
        for (const char* p = codes; *p;) {
            while (*p == ' ') ++p;
            if (!*p) break;
            int len = 0, code = 0;
            for (; *p == '0' || *p == '1'; ++p, ++len) code = (code << 1) | (*p - '0');
            const int shift = kFaxPeek - len;
            for (int k = 0; k < (1 << shift); ++k)
                look[(code << shift) | k] = (static_cast<std::uint32_t>(len) << 16) |
                                            static_cast<std::uint32_t>(value);
            value += step;
        }
    }
};

struct FaxTables {
    FaxTable run[2];     // white, black: value the run length
    FaxTable mode;       // 2-D modes: value 0 pass, 1 horizontal, 5 + (a1 - b1) vertical
    FaxTables() {
        run[0].add(kWhiteTerm, 0, 1);
        run[0].add(kWhiteMakeup, 64, 64);
        run[0].add(kExtendedMakeup, 1792, 64);
        run[1].add(kBlackTerm, 0, 1);
        run[1].add(kBlackMakeup, 64, 64);
        run[1].add(kExtendedMakeup, 1792, 64);
        mode.add("0001 001", 0, 1);
        mode.add("0000010 000010 010 1 011 000011 0000011", 2, 1);
    }
};

const FaxTables& fax_tables() {
    static const FaxTables tables;
    return tables;
}

struct FaxBits {
    const std::uint8_t* src;
    std::size_t n;
    std::size_t pos = 0;  // in bits
    std::uint32_t peek(int k) const {
        std::uint32_t v = 0;
        for (int i = 0; i < k; ++i) {
            const std::size_t b = pos + i;
            const std::uint32_t bit = b < 8 * n ? (src[b >> 3] >> (7 - (b & 7))) & 1 : 0;
            v = (v << 1) | bit;
        }
        return v;
    }
    // A code of `table` (up to `longest` bits): its value, or kFaxBad /
    // kFaxShort.
    int read(const FaxTable& table, int longest) {
        const std::uint32_t e = table.look[peek(longest) << (kFaxPeek - longest)];
        const int len = static_cast<int>(e >> 16);
        if (len == 0 || len > longest) return pos + longest > 8 * n ? kFaxShort : kFaxBad;
        pos += len;
        if (pos > 8 * n) return kFaxShort;
        return static_cast<int>(e & 0xFFFF);
    }
};

// One run of `colour`: make-up codes, then a terminating one.
int fax_run(FaxBits& bits, int colour) {
    int total = 0;
    for (;;) {
        const int run = bits.read(fax_tables().run[colour], kFaxPeek);
        if (run < 0) return run;
        total += run;
        if (run < 64) return total;
    }
}

// Cancel equal neighbours (a zero-length run changes nothing) and drop
// changes at or past the row's end.
void fax_tidy(std::vector<int>& changes, int width) {
    while (!changes.empty() && changes.back() >= width) changes.pop_back();
    std::size_t out = 0;
    for (const int c : changes) {
        if (out && changes[out - 1] == c) --out;
        else changes[out++] = c;
    }
    changes.resize(out);
}

int fax_row_1d(FaxBits& bits, int width, std::vector<int>& cur) {
    cur.clear();
    int a0 = 0, colour = 0;
    while (a0 < width) {
        const int run = fax_run(bits, colour);
        if (run < 0) return run;
        a0 += run;
        if (a0 > width) return kFaxBad;
        cur.push_back(a0);
        colour ^= 1;
    }
    fax_tidy(cur, width);
    return 0;
}

// A two-dimensional row against `ref` (its changes, then width twice).
int fax_row_2d(FaxBits& bits, int width, const std::vector<int>& ref,
               std::vector<int>& cur) {
    cur.clear();
    int a0 = -1, colour = 0;
    std::size_t first = 0;  // the first change of ref right of a0
    while (a0 < width) {
        while (ref[first] <= a0 && ref[first] < width) ++first;
        // b1: right of a0, to the opposite of a0's colour (changes to
        // black sit at even indices)
        std::size_t i = first;
        if (ref[i] < width && static_cast<int>(i & 1) != colour) ++i;
        const int b1 = std::min(ref[i], width), b2 = std::min(ref[i + 1], width);
        const int mode = bits.read(fax_tables().mode, 7);
        if (mode < 0) return mode;
        if (mode == 0) {  // pass
            a0 = b2;
        } else if (mode == 1) {  // horizontal
            const int r1 = fax_run(bits, colour);
            if (r1 < 0) return r1;
            const int r2 = fax_run(bits, colour ^ 1);
            if (r2 < 0) return r2;
            const int a1 = std::max(a0, 0) + r1, a2 = a1 + r2;
            if (a2 > width) return kFaxBad;
            cur.push_back(a1);
            cur.push_back(a2);
            a0 = a2;
        } else {  // vertical
            const int a1 = b1 + mode - 5;
            if (a1 < 0 || a1 > width || a1 <= a0) return kFaxBad;
            cur.push_back(a1);
            a0 = a1;
            colour ^= 1;
        }
    }
    fax_tidy(cur, width);
    return 0;
}

// Fill a packed row (1 bits black) from its changes.
void fax_fill(const std::vector<int>& changes, int width, std::uint8_t* row) {
    std::memset(row, 0, static_cast<std::size_t>(width + 7) / 8);
    for (std::size_t k = 0; k < changes.size(); k += 2) {
        const int a = changes[k], b = k + 1 < changes.size() ? changes[k + 1] : width;
        for (int x = a; x < b; ++x) row[x >> 3] |= static_cast<std::uint8_t>(0x80 >> (x & 7));
    }
}

// Decode one CCITT chunk of `rows` rows into dst (rows x ceil(width / 8)
// bytes): compression 2, 3 (t4 bit 0: a tag bit after each EOL) or 4.
// Returns the bytes written, or kFaxBad / kFaxShort / kFaxNoEol, or -2
// when dst has no room for the rows.
std::int64_t ccitt_decode(const std::uint8_t* src, std::size_t n, std::uint8_t* dst,
                          std::size_t cap, int width, int rows, int compression,
                          int t4) {
    const std::size_t row_bytes = static_cast<std::size_t>(width + 7) / 8;
    if (row_bytes * rows > cap) return -2;
    FaxBits bits{src, n};
    std::vector<int> ref{width, width}, cur;
    cur.reserve(64);
    for (int r = 0; r < rows; ++r) {
        int rc;
        if (compression == 2) {
            rc = fax_row_1d(bits, width, cur);
            bits.pos = (bits.pos + 7) / 8 * 8;
        } else if (compression == 3) {
            int zeros = 0;  // fill bits, then the EOL
            while (bits.pos < 8 * n && !bits.peek(1)) {
                ++zeros;
                ++bits.pos;
            }
            if (bits.pos >= 8 * n || zeros < 11) return kFaxNoEol;
            ++bits.pos;
            bool one_d = true;
            if (t4 & 1) {
                if (bits.pos >= 8 * n) return kFaxShort;
                one_d = bits.peek(1) != 0;
                ++bits.pos;
            }
            rc = one_d ? fax_row_1d(bits, width, cur) : fax_row_2d(bits, width, ref, cur);
        } else {
            rc = fax_row_2d(bits, width, ref, cur);
        }
        if (rc < 0) return rc;
        fax_fill(cur, width, dst + row_bytes * r);
        ref.assign(cur.begin(), cur.end());
        ref.push_back(width);
        ref.push_back(width);
    }
    return static_cast<std::int64_t>(row_bytes * rows);
}

}  // namespace

extern "C" {

int clt_tiff_version() { return 3; }

// Decode n CCITT chunks of the file image src (chunk i at offsets[i],
// counts[i] bytes, rows[i] rows of `width` pixels) into dst (chunk i at
// dst_offsets[i], room for dst_sizes[i] bytes): compression 2 (Modified
// Huffman), 3 (T.4, t4 = T4Options) or 4 (T.6).  got[i] receives the
// bytes written or a negative code: -1 a bad code or a row of the wrong
// length, -2 no room, -3 outside the file, -4 the data end inside a row,
// -5 a T.4 row without its EOL.
void clt_ccitt_decode_chunks(const std::uint8_t* src, std::size_t src_size,
                             const std::uint64_t* offsets,
                             const std::uint64_t* counts, std::size_t n,
                             std::uint8_t* dst, const std::uint64_t* dst_offsets,
                             const std::uint64_t* dst_sizes, const std::int32_t* rows,
                             int width, int compression, int t4, std::int64_t* got,
                             int nthreads) {
    fax_tables();  // built once, before the threads
    parallel_items(n, nthreads, [&](std::size_t i) {
        if (offsets[i] > src_size || counts[i] > src_size - offsets[i]) {
            got[i] = -3;
            return;
        }
        got[i] = ccitt_decode(src + offsets[i], counts[i], dst + dst_offsets[i],
                              dst_sizes[i], width, rows[i], compression, t4);
    });
}

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
