// HDR-merge kernels K2 and K3 for NVIDIA Hopper (sm_90a): the merge through
// the interpolant of 256-point base curves, without (K2) and with (K3) the
// 3x3-median repair of hot pixels.  Plain C interface, loaded through ctypes
// (camera_linearity_tpu_torch/csrc/__init__.py).
//
// They replace two Pallas TPU kernels of
// camera_linearity_tpu/ops/hdr_pallas2.py:
//
//   K2 cl_merge_lerp     <- merge_planar_lerp (:532), body
//                           _make_kernel_lerp(bad_pixel=False) (:284).
//   K3 cl_merge_lerp_bp  <- merge_planar_lerp_bp (:595), body
//                           _make_kernel_lerp(bad_pixel=True) with
//                           _median9_block (:265).
//
// The arithmetic is K1's (csrc/hdr_merge.cu) with g and f' read from the
// interpolant of the base curves at position idx * 255 / max_dn; K3 first
// replaces, per exposure, the value and std of each element that its dark
// frame (or mask) flags hot by the 3x3 median of the UNREPAIRED neighbours,
// edge pixels repeated (scipy mode 'reflect').  ops/hdr_cuda.py holds the
// plain PyTorch versions the kernels are held to.
//
// What bounds them: bytes on paper.  A config-3 K3 call reads 6 exposures
// of value, std and dark (1200 x 1920 x 3 f32 each) and writes value and
// std: 553 MB, 0.165 ms at 3.35 TB/s.  But about 70 instructions per
// element and exposure come close to the card's instruction rate: on the
// H100 K2's arithmetic alone takes longer than a copy of its bytes
// (PERF.md), so loads and arithmetic must overlap.  The design:
//   * a block owns a tile of TH rows x TWE elements of the (H, W*C) output
//     (one plane per batch entry on the grid's z axis) and stages the tiles
//     of all N exposures in shared memory once: value and std (K3: with a
//     one-pixel halo, TWE + 2 * pad columns) and K3's dark or mask.  Every
//     input byte crosses device memory once; the two passes over the
//     exposures (sum of weights, then value and variance) read shared memory.
//   * the tiles arrive by TMA: one thread issues cp.async.bulk.tensor per
//     array and exposure, each exposure completing on its own mbarrier, so
//     pass 1 starts on exposure 0 while the later ones land.  Stacks whose
//     base or row pitch TMA cannot take (16-byte alignment) take the copy
//     route: the block's threads copy the same tiles element by element.
//   * each thread owns 4 consecutive elements of a row: one 16-byte load per
//     array and exposure from shared memory, one 16-byte store per output on
//     the TMA route.  Index math is 32-bit; only plane bases are 64-bit.
//   * K3's hot test is made once per element and exposure (pass 1 keeps the
//     result as a bit; streamed exposures are tested again in pass 2); the
//     median reads the halo tile, whose image-edge neighbours are clamped
//     into the image, never the TMA's zero fill.
//   * the tile plan (TH, TWE, halo pad, exposures per load, shared-memory
//     offsets) comes from the wrapper's planner, ops/hdr_cuda.py::
//     plan_lerp_tiles, so that two blocks fit on an SM where they can; an
//     exposure count beyond what a block holds streams through its slots,
//     and pass 2 then loads the exposures again.
// Rounding is rintf (half to even) and the weight uses expf, in the same
// order over exposures as K1; build without -use_fast_math.  Products and
// sums that the compiler would fuse into a multiply-add are rounded one by
// one (__fmul_rn, __fadd_rn), as the plain version rounds them: with one
// exposure the std's bracket cancels to dg, and a fused multiply-add there
// moved the std by 5e-3.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes via dlsym
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;       // shared memory a block may take
constexpr int kNoTensorMaps = 20000;   // libcuda has no cuTensorMapEncodeTiled
constexpr int kTensorMapFailed = 10000;  // + the CUresult of the encoder

// One launch's tiling, field for field ops/hdr_cuda.py::TilePlan.
struct TilePlan {
  int th, twe;      // output tile: rows, elements of a row (multiple of 4)
  int pad;          // K3's halo columns on each side (C rounded up to 4)
  int slots;        // exposures a block holds at once
  int tma;          // 1: TMA route, 0: copy route
  int rows, stride; // value / std tile: rows (th + 2 halo) and row pitch
  int off_std, off_dark, slot_bytes;  // byte offsets within a slot
  int off_bar, off_slots;  // byte offsets of the mbarriers and slot 0
  int smem;         // dynamic shared memory of the launch, bytes
  int tx_bytes;     // bytes TMA writes into one slot
};

struct LerpArgs {
  const void* val;        // (B, N, H, W, C): f32 in [0,1], or u8 / i32 DNs
  const float* std;       // (B, N, H, W, C) f32, or null (value-only merge)
  const void* dark;       // K3: (N, H, W, C) f32 dark frames or u8 mask
  const float* tab;       // (256, C) base curve
  const float* tab_diff;  // (256, C) its derivative; read only with std
  const float* inv_t;     // (N,) 1 / exposure time, f32
  float* out_val;         // (B, H, W, C)
  float* out_std;         // (B, H, W, C), or null
  int N, H, WC, C;        // WC = W * C, the elements of a row
  int max_dn;             // bits - 1
  float inv_max_dn;       // f32(1 / max_dn): x of an integer DN
  float pos_scale;        // f32(255 / max_dn): position on the base curve
  float threshold;        // K3: a dark value above it flags the pixel hot
  int reference;          // compat "reference" (1) or "corrected" (0)
  TilePlan p;
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\tLAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\tbra LAB_WAIT;\n\tDONE:\n\t}"
      :: "r"(bar), "r"(parity) : "memory");
}

// box of the 2-D tensor map at (column x, row y) into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(bar) : "memory");
}

// Rows [r0, r1) x columns [c0, c1) of a plane (rows of WC elements) into a
// tile whose row 0 is the plane's row row0 and column 0 its column xs.
template <typename T>
__device__ void copy_rows(T* tile, int stride, const T* plane, int WC,
                          int row0, int xs, int r0, int r1, int c0, int c1) {
  for (int r = r0; r < r1; ++r) {
    const T* src = plane + r * WC;
    T* dst = tile + (r - row0) * stride;
    for (int c = c0 + (int)threadIdx.x; c < c1; c += blockDim.x)
      dst[c - xs] = src[c];
  }
}

// x in [0,1] and the table index, kept as the integer-valued float it is
// (no conversion to int and back: those run at a quarter of the f32 rate)
__device__ __forceinline__ void quantize(float v, const LerpArgs& a,
                                         float& x, float& idx) {
  x = v;
  const float m = (float)a.max_dn;
  idx = fminf(fmaxf(rintf(v * m), 0.0f), m);
}

__device__ __forceinline__ void quantize_dn(int dn, const LerpArgs& a,
                                            float& x, float& idx) {
  const float f = (float)dn;
  x = __fmul_rn(f, a.inv_max_dn);  // not fused into x - 0.5
  idx = fminf(fmaxf(f, 0.0f), (float)a.max_dn);
}

// four consecutive elements of a tile (16- or 4-byte aligned)
__device__ __forceinline__ void quantize4(const float* t, const LerpArgs& a,
                                          float x[4], float idx[4]) {
  const float4 v = *reinterpret_cast<const float4*>(t);
  quantize(v.x, a, x[0], idx[0]);
  quantize(v.y, a, x[1], idx[1]);
  quantize(v.z, a, x[2], idx[2]);
  quantize(v.w, a, x[3], idx[3]);
}

__device__ __forceinline__ void quantize4(const uint8_t* t, const LerpArgs& a,
                                          float x[4], float idx[4]) {
  const uchar4 v = *reinterpret_cast<const uchar4*>(t);
  quantize_dn(v.x, a, x[0], idx[0]);
  quantize_dn(v.y, a, x[1], idx[1]);
  quantize_dn(v.z, a, x[2], idx[2]);
  quantize_dn(v.w, a, x[3], idx[3]);
}

__device__ __forceinline__ void quantize4(const int32_t* t, const LerpArgs& a,
                                          float x[4], float idx[4]) {
  const int4 v = *reinterpret_cast<const int4*>(t);
  quantize_dn(v.x, a, x[0], idx[0]);
  quantize_dn(v.y, a, x[1], idx[1]);
  quantize_dn(v.z, a, x[2], idx[2]);
  quantize_dn(v.w, a, x[3], idx[3]);
}

__device__ __forceinline__ void hot4(const float* t, float threshold,
                                     bool hot[4]) {
  const float4 v = *reinterpret_cast<const float4*>(t);
  hot[0] = v.x > threshold;
  hot[1] = v.y > threshold;
  hot[2] = v.z > threshold;
  hot[3] = v.w > threshold;
}

__device__ __forceinline__ void hot4(const uint8_t* t, float, bool hot[4]) {
  const uchar4 v = *reinterpret_cast<const uchar4*>(t);
  hot[0] = v.x != 0;
  hot[1] = v.y != 0;
  hot[2] = v.z != 0;
  hot[3] = v.w != 0;
}

// the interpolant of hdr_pallas2.py:374-378, 416 between b0 and b1
__device__ __forceinline__ float lerp(float b0, float b1, float frac) {
  return __fadd_rn(b0, __fmul_rn(frac, b1 - b0));
}

__device__ __forceinline__ void exchange(float& lo, float& hi) {
  const float a = fminf(lo, hi);
  hi = fmaxf(lo, hi);
  lo = a;
}

// 3x3 median around tile element i; up/dn/lf/rt are the offsets of the
// neighbours, 0 where the image edge repeats the pixel.  The 19-exchange
// network of hdr_pallas2.py:260-262 and ops/filters.py.
__device__ float median9(const float* t, int i, int up, int dn, int lf,
                         int rt) {
  float v[9] = {t[i + up + lf], t[i + up], t[i + up + rt],
                t[i + lf],      t[i],      t[i + rt],
                t[i + dn + lf], t[i + dn], t[i + dn + rt]};
  exchange(v[1], v[2]); exchange(v[4], v[5]); exchange(v[7], v[8]);
  exchange(v[0], v[1]); exchange(v[3], v[4]); exchange(v[6], v[7]);
  exchange(v[1], v[2]); exchange(v[4], v[5]); exchange(v[7], v[8]);
  exchange(v[0], v[3]); exchange(v[5], v[8]); exchange(v[4], v[7]);
  exchange(v[3], v[6]); exchange(v[1], v[4]); exchange(v[2], v[5]);
  exchange(v[4], v[7]); exchange(v[4], v[2]); exchange(v[6], v[4]);
  exchange(v[4], v[2]);
  return v[4];
}

// TV: stack element type.  BAD_PIXEL: K3's repair, with TD the dark element
// type (f32 frames or u8 mask); K3 takes f32 stacks and B == 1.
template <typename TV, bool BAD_PIXEL, typename TD>
__global__ void __launch_bounds__(kMaxThreads)
lerp_kernel(const __grid_constant__ CUtensorMap map_val,
            const __grid_constant__ CUtensorMap map_std,
            const __grid_constant__ CUtensorMap map_dark,
            const __grid_constant__ LerpArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // TMA writes to 128-byte aligned addresses; the plan leaves 128 bytes
  unsigned char* smem =
      smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u);
  const TilePlan& p = a.p;
  constexpr int kHalo = BAD_PIXEL ? 1 : 0;
  const bool use_std = a.std != nullptr;
  const bool resident = a.N <= p.slots;  // every exposure loaded once
  const int x0 = blockIdx.x * p.twe;
  const int h0 = blockIdx.y * p.th;
  const int b = blockIdx.z;
  const uint32_t bars = smem_addr(smem + p.off_bar);

  // exposures [e0, e0 + slots) into slots 0, 1, ...
  auto load_tiles = [&](int e0) {
    const int ne = min(p.slots, a.N - e0);
    if (p.tma) {
      if (threadIdx.x == 0) {
        // the slots' earlier contents were read through the generic proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        for (int k = 0; k < ne; ++k) {
          unsigned char* slot = smem + p.off_slots + k * p.slot_bytes;
          const int row = (b * a.N + e0 + k) * a.H + h0;
          const uint32_t bar = bars + 8 * k;
          bar_expect(bar, p.tx_bytes);
          tma_load(smem_addr(slot), &map_val, x0 - p.pad, row - kHalo, bar);
          if (use_std)
            tma_load(smem_addr(slot + p.off_std), &map_std, x0 - p.pad,
                     row - kHalo, bar);
          if constexpr (BAD_PIXEL)
            tma_load(smem_addr(slot + p.off_dark), &map_dark, x0, row, bar);
        }
      }
    } else {
      const int r0 = max(h0 - kHalo, 0);
      const int r1 = min(h0 + p.th + kHalo, a.H);
      const int c0 = max(x0 - p.pad, 0);
      const int c1 = min(x0 + p.twe + p.pad, a.WC);
      for (int k = 0; k < ne; ++k) {
        unsigned char* slot = smem + p.off_slots + k * p.slot_bytes;
        const size_t plane = (size_t)(b * a.N + e0 + k) * a.H * a.WC;
        copy_rows(reinterpret_cast<TV*>(slot), p.stride,
                  static_cast<const TV*>(a.val) + plane, a.WC, h0 - kHalo,
                  x0 - p.pad, r0, r1, c0, c1);
        if (use_std)
          copy_rows(reinterpret_cast<float*>(slot + p.off_std), p.stride,
                    a.std + plane, a.WC, h0 - kHalo, x0 - p.pad, r0, r1, c0,
                    c1);
        if constexpr (BAD_PIXEL)
          copy_rows(reinterpret_cast<TD*>(slot + p.off_dark), p.twe,
                    static_cast<const TD*>(a.dark) + plane, a.WC, h0, x0, h0,
                    min(h0 + p.th, a.H), x0, min(x0 + p.twe, a.WC));
      }
      __syncthreads();
    }
  };
  uint32_t phase = 0;  // bit k: the parity of slot k's next completion
  auto wait = [&](int k) {
    if (p.tma) {
      bar_wait(bars + 8 * k, (phase >> k) & 1u);
      phase ^= 1u << k;
    }
  };

  if (p.tma && threadIdx.x == 0) {
    for (int k = 0; k < p.slots; ++k) bar_init(bars + 8 * k);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  load_tiles(0);
  // the base curve and its derivative, channel-major, as (f, f') pairs: a
  // lookup is two 8-byte loads at j and j + 1 of the element's channel
  float2* s_tab = reinterpret_cast<float2*>(smem);
  for (int c = 0; c < a.C; ++c)
    for (int j = threadIdx.x; j < 256; j += blockDim.x)
      s_tab[c * 256 + j] = make_float2(
          a.tab[j * a.C + c], use_std ? a.tab_diff[j * a.C + c] : 0.0f);
  __syncthreads();

  // this thread's 4 elements: row h, columns col .. col + 3 of the tile
  const int quads = p.twe >> 2;
  const int r = threadIdx.x / quads;
  const int q4 = (threadIdx.x - r * quads) * 4;
  const int h = h0 + r;
  const int col = x0 + q4;
  const int si = (r + kHalo) * p.stride + p.pad + q4;  // in value/std tiles
  const int di = r * p.twe + q4;                       // in the dark tile
  bool ok[4];
  int tab0[4];  // each element's channel in s_tab
#pragma unroll
  for (int q = 0, c = col % a.C; q < 4; ++q) {
    ok[q] = h < a.H && col + q < a.WC;
    tab0[q] = c * 256;
    if (++c == a.C) c = 0;
  }
  // 3x3 neighbourhood offsets in a value/std tile, edge pixels repeated
  const int up = h > 0 ? -p.stride : 0;
  const int dn = h + 1 < a.H ? p.stride : 0;
  auto median_at = [&](const float* t, int q) {
    const int lf = col + q >= a.C ? -a.C : 0;
    const int rt = col + q + a.C < a.WC ? a.C : 0;
    return median9(t, si + q, up, dn, lf, rt);
  };

  // pass 1: sum of weights
  float sw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  uint32_t hot_bits[4] = {0u, 0u, 0u, 0u};  // K3, resident: bit e is hot
  for (int e0 = 0; e0 < a.N; e0 += p.slots) {
    if (e0 > 0) {
      __syncthreads();  // every thread is done with the previous exposures
      load_tiles(e0);
    }
    const int ne = min(p.slots, a.N - e0);
    for (int k = 0; k < ne; ++k) {
      wait(k);
      const unsigned char* slot = smem + p.off_slots + k * p.slot_bytes;
      const TV* tv = reinterpret_cast<const TV*>(slot);
      float x[4];
      float idx[4];
      quantize4(tv + si, a, x, idx);
      if constexpr (BAD_PIXEL) {
        bool hot[4];
        hot4(reinterpret_cast<const TD*>(slot + p.off_dark) + di, a.threshold,
             hot);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (hot[q] && ok[q]) {
            if (resident) hot_bits[q] |= 1u << (e0 + k);
            quantize(median_at(reinterpret_cast<const float*>(tv), q), a,
                     x[q], idx[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float d = x[q] - 0.5f;
        sw[q] += expf(-30.0f * (d * d));
      }
    }
  }
  float inv_sw[4], inv_sw2[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    inv_sw[q] = 1.0f / sw[q];
    inv_sw2[q] = inv_sw[q] * inv_sw[q];
  }

  // pass 2: accumulate value and variance
  float acc_v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc_s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int e0 = 0; e0 < a.N; e0 += p.slots) {
    const int ne = min(p.slots, a.N - e0);
    if (!resident) {
      __syncthreads();
      load_tiles(e0);
    }
    for (int k = 0; k < ne; ++k) {
      if (!resident) wait(k);
      const int e = e0 + k;
      const float invt = __ldg(a.inv_t + e);
      const unsigned char* slot = smem + p.off_slots + k * p.slot_bytes;
      const TV* tv = reinterpret_cast<const TV*>(slot);
      const float* ts = reinterpret_cast<const float*>(slot + p.off_std);
      float x[4], s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float idx[4];
      quantize4(tv + si, a, x, idx);
      if (use_std) {
        const float4 v = *reinterpret_cast<const float4*>(ts + si);
        s[0] = v.x;
        s[1] = v.y;
        s[2] = v.z;
        s[3] = v.w;
      }
      if constexpr (BAD_PIXEL) {
        bool hot[4];
        if (resident) {
#pragma unroll
          for (int q = 0; q < 4; ++q) hot[q] = (hot_bits[q] >> e) & 1u;
        } else {
          hot4(reinterpret_cast<const TD*>(slot + p.off_dark) + di,
               a.threshold, hot);
#pragma unroll
          for (int q = 0; q < 4; ++q) hot[q] = hot[q] && ok[q];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (hot[q]) {
            quantize(median_at(reinterpret_cast<const float*>(tv), q), a,
                     x[q], idx[q]);
            if (use_std) s[q] = median_at(ts, q);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float d = x[q] - 0.5f;
        const float wt = expf(-30.0f * (d * d));
        const float pos = __fmul_rn(idx[q], a.pos_scale);
        const int j = min((int)pos, 254);
        const float frac = pos - (float)j;
        const float2 b0 = s_tab[tab0[q] + j];
        const float2 b1 = s_tab[tab0[q] + j + 1];
        const float g = lerp(b0.x, b1.x, frac);
        acc_v[q] = __fadd_rn(acc_v[q], wt * g * invt);
        if (use_std) {
          const float dw = -60.0f * d * wt;
          const float dg = lerp(b0.y, b1.y, frac) * s[q];
          const float bracket = __fsub_rn(
              __fmul_rn(__fadd_rn(__fmul_rn(dw, g), __fmul_rn(wt, dg)),
                        inv_sw[q]),
              __fmul_rn(dw * wt * g, inv_sw2[q]));
          const float term = bracket * (a.reference ? dg : s[q]) * invt;
          acc_s[q] = __fadd_rn(acc_s[q], __fmul_rn(term, term));
        }
      }
    }
  }

  if (h >= a.H || col >= a.WC) return;
  const size_t plane = (size_t)b * a.H * a.WC;
  float* ov = a.out_val + plane + (h * a.WC + col);
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = acc_v[q] * inv_sw[q];
  if (p.tma) {  // the row pitch is a multiple of 16 bytes: all 4 in the row
    *reinterpret_cast<float4*>(ov) = make_float4(v[0], v[1], v[2], v[3]);
    if (use_std)
      *reinterpret_cast<float4*>(a.out_std + plane + (h * a.WC + col)) =
          make_float4(sqrtf(acc_s[0]), sqrtf(acc_s[1]), sqrtf(acc_s[2]),
                      sqrtf(acc_s[3]));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!ok[q]) continue;
      ov[q] = v[q];
      if (use_std) a.out_std[plane + (h * a.WC + col + q)] = sqrtf(acc_s[q]);
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda the runtime loaded
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
        : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

CUtensorMapDataType tma_type(float) { return CU_TENSOR_MAP_DATA_TYPE_FLOAT32; }
CUtensorMapDataType tma_type(uint8_t) { return CU_TENSOR_MAP_DATA_TYPE_UINT8; }
CUtensorMapDataType tma_type(int32_t) { return CU_TENSOR_MAP_DATA_TYPE_INT32; }

// a stack seen as (rows, WC) row-major, loaded in boxes of box_h x box_w;
// boxes reaching outside it are zero-filled (the kernel never reads those)
template <typename T>
int encode(CUtensorMap* map, const void* base, int WC, long long rows,
           int box_w, int box_h) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoTensorMaps;
  const cuuint64_t dims[2] = {(cuuint64_t)WC, (cuuint64_t)rows};
  const cuuint64_t pitch[1] = {(cuuint64_t)WC * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_w, (cuuint32_t)box_h};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, tma_type(T()), 2, const_cast<void*>(base), dims,
                        pitch, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapFailed + (int)r;
}

template <typename TV, bool BAD_PIXEL, typename TD>
int launch(const LerpArgs& a, int B, void* stream) {
  const auto kernel = lerp_kernel<TV, BAD_PIXEL, TD>;
  // the shared-memory limit is raised once per device for each kernel
  static uint32_t raised = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const uint32_t bit = device < 32 ? 1u << device : 0u;
  if (!(raised & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    raised |= bit;
  }
  const TilePlan& p = a.p;
  const int threads = p.th * p.twe / 4;
  if (p.smem > kMaxSmem || threads > kMaxThreads || p.slots > 32)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_val{}, map_std{}, map_dark{};
  if (p.tma) {
    const long long rows = (long long)B * a.N * a.H;
    int rc = encode<TV>(&map_val, a.val, a.WC, rows, p.stride, p.rows);
    if (rc == 0 && a.std != nullptr)
      rc = encode<float>(&map_std, a.std, a.WC, rows, p.stride, p.rows);
    if (rc == 0 && BAD_PIXEL)
      rc = encode<TD>(&map_dark, a.dark, a.WC, rows, p.twe, p.th);
    if (rc != 0) return rc;
  }
  const dim3 grid((a.WC + p.twe - 1) / p.twe, (a.H + p.th - 1) / p.th, B);
  kernel<<<grid, threads, p.smem, (cudaStream_t)stream>>>(map_val, map_std,
                                                          map_dark, a);
  return (int)cudaGetLastError();
}

LerpArgs make_args(const void* val, const float* std, const float* base,
                   const float* diff_base, int bits, const float* inv_t,
                   int N, int H, int W, int C, int reference,
                   float pos_scale, float* out_val, float* out_std,
                   const TilePlan* plan) {
  LerpArgs a;
  a.val = val;
  a.std = std;
  a.dark = nullptr;
  a.tab = base;
  a.tab_diff = diff_base;
  a.inv_t = inv_t;
  a.out_val = out_val;
  a.out_std = out_std;
  a.N = N;
  a.H = H;
  a.WC = W * C;
  a.C = C;
  a.max_dn = bits - 1;
  a.inv_max_dn = 0.0f;
  a.pos_scale = pos_scale;
  a.threshold = 0.0f;
  a.reference = reference;
  a.p = *plan;
  return a;
}

}  // namespace

// val_kind: 0 f32 [0,1] values, 1 u8 DNs, 2 i32 DNs.  plan: the TilePlan of
// ops/hdr_cuda.py::plan_lerp_tiles.  Returns a cudaError_t, or 10000 + the
// CUresult of a failed tensor-map encoding (20000: no encoder in libcuda).
extern "C" int cl_merge_lerp(const void* val, int val_kind, const float* std,
                             const float* base, const float* diff_base,
                             int bits, const float* inv_t, long long B,
                             int N, int H, int W, int C, int reference,
                             float inv_max_dn, float pos_scale,
                             float* out_val, float* out_std, void* stream,
                             const int* plan) {
  LerpArgs a = make_args(val, std, base, diff_base, bits, inv_t, N, H, W, C,
                         reference, pos_scale, out_val, out_std,
                         reinterpret_cast<const TilePlan*>(plan));
  a.inv_max_dn = inv_max_dn;
  switch (val_kind) {
    case 0: return launch<float, false, float>(a, (int)B, stream);
    case 1: return launch<uint8_t, false, float>(a, (int)B, stream);
    case 2: return launch<int32_t, false, float>(a, (int)B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// dark_is_mask: 0 f32 dark frames (hot where dark > threshold), 1 u8 mask
// (hot where nonzero).
extern "C" int cl_merge_lerp_bp(const float* val, const float* std,
                                const void* dark, int dark_is_mask,
                                float threshold, const float* base,
                                const float* diff_base, int bits,
                                const float* inv_t, int N, int H, int W,
                                int C, int reference, float pos_scale,
                                float* out_val, float* out_std,
                                void* stream, const int* plan) {
  LerpArgs a = make_args(val, std, base, diff_base, bits, inv_t, N, H, W, C,
                         reference, pos_scale, out_val, out_std,
                         reinterpret_cast<const TilePlan*>(plan));
  a.dark = dark;
  a.threshold = threshold;
  if (dark_is_mask) return launch<float, true, uint8_t>(a, 1, stream);
  return launch<float, true, float>(a, 1, stream);
}
