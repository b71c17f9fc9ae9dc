// HDR-merge kernel K1 for NVIDIA Hopper (sm_90a), with a plain C interface
// loaded through ctypes (camera_linearity_tpu_torch/csrc/__init__.py).
//
// It replaces the Pallas TPU kernel of camera_linearity_tpu/ops/hdr_pallas2.py:
//
//   K1 cl_merge_fused    <- merge_planar_fused (:474), body _make_kernel
//                           (:142): exact ICRF lookup, 256- or 4096-entry
//                           tables, float [0,1] or integer-DN stacks.
//
// K2 and K3, the merges through base curves, are in hdr_merge_lerp.cu.
//
// Per output element (b, h, w, c), over the N exposures: x is the [0,1]
// value (or DN / max_dn), idx = clamp(rint(x * max_dn)), w = exp(-30 (x -
// 1/2)^2), g = ICRF[idx], f' = ICRF'[idx]; val = sum(w g / t) / sum(w) and,
// with std, std = sqrt(sum((bracket * scale / t)^2)) where bracket =
// (dw g + w dg) / sum(w) - dw w g / sum(w)^2, dw = -60 (x - 1/2) w, dg = f'
// s, and scale is dg under compat "reference", s otherwise.
// ops/hdr_cuda.py holds the plain PyTorch version of the kernel, which the
// tests compare against.
//
// What bounds it on the card: bytes.  A config-2 merge (6 exposures of
// 1200 x 1920 x 3, f32 value and std) reads 332 MB and writes 55 MB for
// about 48 flops per exposure and element: far below the H100's ratio of
// flops to bytes, so the floor is the time to move 387 MB through HBM.
// The design reads every input once from device memory, writes every output
// once, and keeps enough loads in flight to cover the memory's latency:
//   * the quad walk: a persistent grid (the blocks resident on the SMs)
//     walks units of consecutive elements of each scene's flat H*W*C
//     output, in the stack's own channels-last layout (no planar transpose:
//     on the TPU that was a free relabel, here it would be a copy).  A
//     thread issues all N value loads and all N std loads of the units it
//     holds before it uses any of them, one load a plane and unit, and
//     stores one a unit.  Indexing is 32-bit within a plane (H*W*C < 2^31);
//     only the scene's base is 64-bit.  Each lane's channel is (r + k) % C,
//     computed once a unit.  A unit never straddles two scenes, since the
//     walk requires H*W*C % 4 == 0;
//   * one weight per exposure and element: x, idx, w and dw are computed
//     once into registers; pass 1 sums w, pass 2 uses them (one expf a
//     value);
//   * the tables sit in shared memory channel-major, as (f, f') pairs for a
//     merge with std (a lookup is one 8-byte indexed load; the TPU had no
//     vector gather and used one-hot matrix products) or f alone without.
//     A block stages them from the two (rows, C) arrays with 16 loads in
//     flight a thread: one at a time waits out the cache's latency for each
//     of up to 96 entries a thread (4096 rows x 3 channels x 2 tables);
//   * instances by MAXN, the exposures a thread holds (4, 8, 16).  A thread
//     holds a quad of 4 elements at MAXN 4 and 8 (16-byte loads) and half a
//     quad at 16 (8-byte loads; u8 DNs load 4 or 2 bytes): at most 32
//     values and 32 stds.  All fit 128 registers, so two 256-thread blocks
//     share an SM, beside 4096-entry pair tables too (96 KB a block at C =
//     3).  A whole quad at MAXN 16 took 255 registers, one block an SM, and
//     ran slower than one element a thread (PERF.md, section 6);
//   * the scalar route takes what the quad walk cannot: planes that are not
//     a multiple of 4 elements, a value stack not aligned to a quad's load
//     (16 bytes, 4 for u8) or a std stack not 16-byte aligned, and N > 16.
//     One element a thread, two passes over the exposures (any N), the same
//     32-bit plane indexing and tables.
// The route, the MAXN instance, the block and the shared-memory layout come
// from the wrapper's planner (ops/hdr_cuda.py::plan_fused, struct FusedPlan
// here, field for field).  Products and sums are rounded one by one
// (__fmul_rn, __fadd_rn) in the plain version's order, so that no multiply-
// add the compiler might fuse differs between the routes: both give the same
// bits.  Rounding is rintf (half to even, as jnp.round and torch.round) and
// the weight uses expf; build without -use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;   // a block, at most
constexpr int kMaxSmem = 232448;   // shared memory a block may take
constexpr int kStageLoads = 16;    // table loads in flight a thread
constexpr int kMaxHeld = 16;       // the largest MAXN instance

// One K1 launch, field for field ops/hdr_cuda.py::FusedPlan; bytes.
struct FusedPlan {
  int quad;      // 1: the quad walk, 0: the scalar route
  int maxn;      // exposures a thread holds on the quad walk (4, 8, 16)
  int threads;   // a block
  int pairs;     // 1: (f, f') pairs (a merge with std), 0: f alone
  int off_invt;  // the N reciprocal exposure times, after the tables
  int smem;      // the launch's dynamic shared memory
};

struct MergeArgs {
  const void* val;        // (B, N, H, W, C): f32 in [0,1], or u8 / i32 DNs
  const float* std;       // (B, N, H, W, C) f32, or null (value-only merge)
  const float* tab;       // (rows, C) ICRF
  const float* tab_diff;  // (rows, C) derivative; read only with std
  const float* inv_t;     // (N,) 1 / exposure time, f32
  float* out_val;         // (B, H, W, C)
  float* out_std;         // (B, H, W, C), or null
  int B, N, C;
  int plane;              // H * W * C, the elements of one exposure's plane
  int rows;               // table rows (bits)
  int max_dn;             // bits - 1
  float inv_max_dn;       // f32(1 / max_dn): x of an integer DN
  int reference;          // compat "reference" (1) or "corrected" (0)
  int off_invt;           // FusedPlan::off_invt
};

// ---------------------------------------------------------------------------
// values
// ---------------------------------------------------------------------------

// a stack element as a thread holds it: f32 values as float, DNs as int
template <typename TV>
struct Held {
  using T = int;
};
template <>
struct Held<float> {
  using T = float;
};

__device__ __forceinline__ void quantize(float v, const MergeArgs& a,
                                         float& x, int& idx) {
  x = v;
  const float m = (float)a.max_dn;
  idx = (int)fminf(fmaxf(rintf(v * m), 0.0f), m);
}

__device__ __forceinline__ void quantize(int dn, const MergeArgs& a,
                                         float& x, int& idx) {
  x = (float)dn * a.inv_max_dn;
  idx = min(max(dn, 0), a.max_dn);
}

// V (4 or 2) consecutive elements in one load: 16 or 8 bytes (u8: 4 or 2).
// Loads and stores are marked streaming (evict first): each byte of the
// stacks and outputs is used once.
template <typename TV, int V> struct Vec;
template <> struct Vec<float, 4> { using T = float4; };
template <> struct Vec<float, 2> { using T = float2; };
template <> struct Vec<int32_t, 4> { using T = int4; };
template <> struct Vec<int32_t, 2> { using T = int2; };
template <> struct Vec<uint8_t, 4> { using T = uchar4; };
template <> struct Vec<uint8_t, 2> { using T = uchar2; };

template <int V, typename TV, typename T>
__device__ __forceinline__ void load_vec(const TV* p, T (&v)[V]) {
  const typename Vec<TV, V>::T q =
      __ldcs(reinterpret_cast<const typename Vec<TV, V>::T*>(p));
  v[0] = q.x;
  v[1] = q.y;
  if constexpr (V == 4) {
    v[2] = q.z;
    v[3] = q.w;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
}

// w = exp(-30 d^2) and dw = -60 d w of d = x - 1/2, rounded as the plain
// version rounds them
__device__ __forceinline__ float weight(float d) {
  return expf(__fmul_rn(-30.0f, __fmul_rn(d, d)));
}

__device__ __forceinline__ float weight_slope(float d, float w) {
  return __fmul_rn(__fmul_rn(-60.0f, d), w);
}

// one exposure's terms of an element
template <bool STD>
__device__ __forceinline__ void accumulate(float w, float dw, float g,
                                           float fp, float s, float invt,
                                           float inv_sw, float inv_sw2,
                                           int reference, float& acc_v,
                                           float& acc_s) {
  acc_v = __fadd_rn(acc_v, __fmul_rn(__fmul_rn(w, g), invt));
  if (STD) {
    const float dg = __fmul_rn(fp, s);
    const float bracket = __fsub_rn(
        __fmul_rn(__fadd_rn(__fmul_rn(dw, g), __fmul_rn(w, dg)), inv_sw),
        __fmul_rn(__fmul_rn(__fmul_rn(dw, w), g), inv_sw2));
    const float term = __fmul_rn(__fmul_rn(bracket, reference ? dg : s),
                                 invt);
    acc_s = __fadd_rn(acc_s, __fmul_rn(term, term));
  }
}

// ---------------------------------------------------------------------------
// tables in shared memory
// ---------------------------------------------------------------------------

// entry (r, c) of the (rows, C) tables at c * rows + r: (f, f') pairs with
// PAIRS, f alone without; then the N reciprocal exposure times
template <bool PAIRS>
__device__ void stage_tables(unsigned char* smem, const MergeArgs& a) {
  constexpr int kBatch = PAIRS ? kStageLoads / 2 : kStageLoads;
  const int total = a.rows * a.C;
  for (int j0 = threadIdx.x; j0 < total; j0 += kBatch * blockDim.x) {
    float f[kBatch], d[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int j = j0 + k * blockDim.x;
      if (j < total) {
        f[k] = __ldg(a.tab + j);
        if (PAIRS) d[k] = __ldg(a.tab_diff + j);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int j = j0 + k * blockDim.x;
      if (j < total) {
        const int r = j / a.C;
        const int at = (j - r * a.C) * a.rows + r;
        if (PAIRS)
          reinterpret_cast<float2*>(smem)[at] = make_float2(f[k], d[k]);
        else
          reinterpret_cast<float*>(smem)[at] = f[k];
      }
    }
  }
  float* invt = reinterpret_cast<float*>(smem + a.off_invt);
  for (int i = threadIdx.x; i < a.N; i += blockDim.x) invt[i] = a.inv_t[i];
}

// g = f[idx] and fp = f'[idx] of the channel whose entries start at base
template <bool PAIRS>
__device__ __forceinline__ void lookup(const unsigned char* smem, int base,
                                       int idx, float& g, float& fp) {
  if (PAIRS) {
    const float2 t = reinterpret_cast<const float2*>(smem)[base + idx];
    g = t.x;
    fp = t.y;
  } else {
    g = reinterpret_cast<const float*>(smem)[base + idx];
    fp = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// the quad walk
// ---------------------------------------------------------------------------

// A thread holds a unit of V consecutive elements of one scene's plane:
// a quad at MAXN 4 and 8, half a quad at MAXN 16, so that at most 32 values
// and 32 stds are in flight and every instance fits 128 registers, two
// 256-thread blocks an SM.
template <int MAXN>
struct Unit {
  static constexpr int V = MAXN > 8 ? 2 : 4;  // elements a unit
};

// the unit `stride` units after (b, u), in scene b and unit u of its plane
__device__ __forceinline__ void advance(int& b, int& u, int stride,
                                        int units) {
  u += stride;
  if (u >= units) {  // on to a later scene
    const int skip = u / units;
    b += skip;
    u -= skip * units;
  }
}

template <typename TV, int MAXN, bool STD>
__global__ void __launch_bounds__(kMaxThreads, 2)
quad_kernel(const __grid_constant__ MergeArgs a) {
  constexpr int V = Unit<MAXN>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  stage_tables<STD>(smem, a);
  __syncthreads();
  const float* s_invt = reinterpret_cast<const float*>(smem + a.off_invt);
  const TV* val = static_cast<const TV*>(a.val);
  const long long scene = (long long)a.N * a.plane;  // one scene's stack
  const int units = a.plane / V;
  const int stride = gridDim.x * blockDim.x;
  const int g0 = blockIdx.x * blockDim.x + threadIdx.x;
  int b = g0 / units;       // scene
  int u = g0 - b * units;   // unit within the scene's plane
  while (b < a.B) {
    const int r = V * u;    // the unit's first element within the plane
    const long long first = b * scene + r;
    typename Held<TV>::T x[MAXN][V];
    float s[MAXN][V];
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      if (n < a.N) {
        load_vec<V>(val + first + (long long)n * a.plane, x[n]);
        if (STD) load_vec<V>(a.std + first + (long long)n * a.plane, s[n]);
      }
    }
    int base[V];  // each lane's table entries: channel * rows
    {
      int c = r % a.C;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        base[k] = c * a.rows;
        if (++c == a.C) c = 0;
      }
    }
    float out_v[V], out_s[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float w[MAXN], dw[MAXN];
      int idx[MAXN];
      float sw = 0.0f;
#pragma unroll
      for (int n = 0; n < MAXN; ++n) {
        if (n < a.N) {
          float xf;
          quantize(x[n][k], a, xf, idx[n]);
          const float d = xf - 0.5f;
          w[n] = weight(d);
          if (STD) dw[n] = weight_slope(d, w[n]);
          sw = __fadd_rn(sw, w[n]);
        }
      }
      const float inv_sw = 1.0f / sw;
      const float inv_sw2 = __fmul_rn(inv_sw, inv_sw);
      float acc_v = 0.0f, acc_s = 0.0f;
#pragma unroll
      for (int n = 0; n < MAXN; ++n) {
        if (n < a.N) {
          float g, fp;
          lookup<STD>(smem, base[k], idx[n], g, fp);
          accumulate<STD>(w[n], STD ? dw[n] : 0.0f, g, fp,
                          STD ? s[n][k] : 0.0f, s_invt[n], inv_sw, inv_sw2,
                          a.reference, acc_v, acc_s);
        }
      }
      out_v[k] = __fmul_rn(acc_v, inv_sw);
      out_s[k] = sqrtf(acc_s);
    }
    const long long out = (long long)b * a.plane + r;
    store_vec<V>(a.out_val + out, out_v);
    if (STD) store_vec<V>(a.out_std + out, out_s);
    advance(b, u, stride, units);
  }
}

// ---------------------------------------------------------------------------
// the scalar route: one element a thread, any N
// ---------------------------------------------------------------------------

template <typename TV, bool STD>
__global__ void __launch_bounds__(kMaxThreads)
scalar_kernel(const __grid_constant__ MergeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  stage_tables<STD>(smem, a);
  __syncthreads();
  const float* s_invt = reinterpret_cast<const float*>(smem + a.off_invt);
  const TV* val = static_cast<const TV*>(a.val);
  const long long scene = (long long)a.N * a.plane;
  const int stride = gridDim.x * blockDim.x;
  const int g0 = blockIdx.x * blockDim.x + threadIdx.x;
  int b = g0 / a.plane;     // scene
  int r = g0 - b * a.plane; // element within the scene's plane
  while (b < a.B) {
    const int base = (r % a.C) * a.rows;
    const TV* v = val + b * scene + r;
    const float* sd = STD ? a.std + b * scene + r : nullptr;

    // pass 1: sum of weights
    float sw = 0.0f;
    for (int e = 0; e < a.N; ++e) {
      float x;
      int idx;
      quantize(static_cast<typename Held<TV>::T>(v[(long long)e * a.plane]),
               a, x, idx);
      sw = __fadd_rn(sw, weight(x - 0.5f));
    }
    const float inv_sw = 1.0f / sw;
    const float inv_sw2 = __fmul_rn(inv_sw, inv_sw);

    // pass 2: accumulate value and variance
    float acc_v = 0.0f, acc_s = 0.0f;
    for (int e = 0; e < a.N; ++e) {
      const long long at = (long long)e * a.plane;
      float x, g, fp;
      int idx;
      quantize(static_cast<typename Held<TV>::T>(v[at]), a, x, idx);
      const float d = x - 0.5f;
      const float w = weight(d);
      lookup<STD>(smem, base, idx, g, fp);
      accumulate<STD>(w, STD ? weight_slope(d, w) : 0.0f, g, fp,
                      STD ? sd[at] : 0.0f, s_invt[e], inv_sw, inv_sw2,
                      a.reference, acc_v, acc_s);
    }
    const long long out = (long long)b * a.plane + r;
    a.out_val[out] = __fmul_rn(acc_v, inv_sw);
    if (STD) a.out_std[out] = sqrtf(acc_s);
    advance(b, r, stride, a.plane);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// as many blocks as fit on the SMs at once, or fewer when the work is small
template <typename Kernel>
int launch(Kernel kernel, const MergeArgs& a, const FusedPlan& p,
           long long items, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      p.threads, p.smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (items + p.threads - 1) / p.threads;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > resident) blocks = resident;
  kernel<<<(unsigned)blocks, p.threads, p.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TV, bool STD>
int dispatch(const MergeArgs& a, const FusedPlan& p, void* stream) {
  if (!p.quad)
    return launch(scalar_kernel<TV, STD>, a, p, (long long)a.B * a.plane,
                  stream);
  // threads the walk could use: one a unit
  const long long elems = (long long)a.B * a.plane;
  switch (p.maxn) {
    case 4: return launch(quad_kernel<TV, 4, STD>, a, p, elems / 4, stream);
    case 8: return launch(quad_kernel<TV, 8, STD>, a, p, elems / 4, stream);
    case kMaxHeld:
      return launch(quad_kernel<TV, kMaxHeld, STD>, a, p, elems / 2, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TV>
int dispatch(const MergeArgs& a, const FusedPlan& p, void* stream) {
  return a.std != nullptr ? dispatch<TV, true>(a, p, stream)
                          : dispatch<TV, false>(a, p, stream);
}

// whether the plan fits these arguments: its layout holds the tables and
// the reciprocal times, and the quad walk's accesses are aligned
bool plan_fits(const FusedPlan& p, const MergeArgs& a, int val_size) {
  const long long tables = (long long)a.rows * a.C * (p.pairs ? 8 : 4);
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % 32 != 0
      || p.pairs != (a.std != nullptr ? 1 : 0)
      || (a.std == nullptr) != (a.out_std == nullptr)
      || p.off_invt < tables || p.off_invt % 16 != 0
      || p.smem < (long long)p.off_invt + 4LL * a.N || p.smem > kMaxSmem)
    return false;
  if (!p.quad) return true;
  const uintptr_t outs = (uintptr_t)a.out_val | (uintptr_t)a.out_std
      | (uintptr_t)a.std;
  return a.plane % 4 == 0 && a.N <= p.maxn
      && (p.maxn == 4 || p.maxn == 8 || p.maxn == kMaxHeld)
      && (uintptr_t)a.val % (4 * val_size) == 0 && outs % 16 == 0;
}

}  // namespace

// val_kind: 0 f32 [0,1] values, 1 u8 DNs, 2 i32 DNs.  plan: the FusedPlan
// of ops/hdr_cuda.py::plan_fused.  Returns a cudaError_t.
extern "C" int cl_merge_fused(const void* val, int val_kind, const float* std,
                              const float* icrf, const float* icrf_diff,
                              int bits, const float* inv_t, long long B,
                              int N, int H, int W, int C, int reference,
                              float inv_max_dn, float* out_val,
                              float* out_std, void* stream, const int* plan) {
  const long long plane = (long long)H * W * C;
  if (B < 0 || B >= (1LL << 31) || N < 1 || C < 1 || bits < 2
      || plane >= (1LL << 31) || val_kind < 0 || val_kind > 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || plane == 0) return 0;
  MergeArgs a;
  a.val = val;
  a.std = std;
  a.tab = icrf;
  a.tab_diff = icrf_diff;
  a.inv_t = inv_t;
  a.out_val = out_val;
  a.out_std = out_std;
  a.B = (int)B;
  a.N = N;
  a.C = C;
  a.plane = (int)plane;
  a.rows = bits;
  a.max_dn = bits - 1;
  a.inv_max_dn = inv_max_dn;
  a.reference = reference;
  const FusedPlan p = *reinterpret_cast<const FusedPlan*>(plan);
  a.off_invt = p.off_invt;
  if (!plan_fits(p, a, val_kind == 1 ? 1 : 4))
    return (int)cudaErrorInvalidValue;
  switch (val_kind) {
    case 0: return dispatch<float>(a, p, stream);
    case 1: return dispatch<uint8_t>(a, p, stream);
    case 2: return dispatch<int32_t>(a, p, stream);
  }
  return (int)cudaErrorInvalidValue;
}
