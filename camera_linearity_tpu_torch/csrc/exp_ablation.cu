// Ablation kernels E1-E5 of the config-2 kernel experiments for NVIDIA
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (camera_linearity_tpu_torch/csrc/__init__.py).
//
// They replace the Pallas TPU kernels of benchmarks/exp_kernel.py and
// benchmarks/exp_plateau.py:
//
//   cl_exposure_sum  <- E1 exp_kernel.py::ab_dma (:65, pallas_call :70);
//                       E4 exp_kernel.py::make_flat_dma (:173, pallas_call
//                          :225) with extra None, "mod", "round", "exp";
//                       E5 exp_plateau.py::make_dma (:83, pallas_call :102).
//   cl_merge_nolut   <- E2 exp_kernel.py::ab_math (:99, pallas_call :107);
//                       E3 exp_kernel.py::make_flat_invt (:122, pallas_call
//                          :164), dead index or not;
//                       E4 make_flat_dma with extra "math" (1/t = 1).
//
// Both walk an (outer, N, inner) view of a contiguous f32 stack and write
// an (outer, inner) result: cfirst (C, N, 1, P) is outer C and inner P,
// flat (N, L) is outer 1 and inner L, planar (N, C, H, W) is outer 1 and
// inner C*H*W.
//
// cl_exposure_sum: out_val[o, i] = sum over n of val[o, n, i], added in n
// order, and the same for std.  MODE adds E4's extra term to the value:
// MOD  + (i % 3) (i, the index in the row: the flat index in L);
// ROUND + sum_n clamp(rint(255 x), 0, 255), summed as integers;
// EXP  + sum_n exp(-30 (x - 1/2)^2).
//
// cl_merge_nolut: the HDR merge with the ICRF g = x and f' = 1 (no table
// lookup): w = exp(-30 (x - 1/2)^2), dw = -60 (x - 1/2) w,
// val = sum(w x invt) / sum(w), std = sqrt(sum((bracket s invt)^2)) with
// bracket = (dw x + w s) / sum(w) - (dw w x) / sum(w)^2 (exp_kernel.py:92-94
// with dg = s).  invt (N floats) comes by value in the argument struct.
//
// What bounds them on the card: bytes.  At config 2 (6 exposures of
// 1200 x 1920 x 3, f32 value and std) both read 331.78 MB and write
// 55.30 MB: 387.07 MB, 0.1155 ms at 3.35 TB/s.  The merge's ~30 f32
// operations per value and exposure are 0.019 ms at 67 TFLOP/s, the sum's
// far fewer.  The design therefore only streams:
//   * each thread takes 4 consecutive elements of a row (a "quad") and
//     reads them from every exposure as one 16-byte float4 load, with a
//     grid-stride loop over outer x ceil(inner / 4) quads on as many blocks
//     as fit on the SMs at once; neighbouring threads take neighbouring
//     quads, so every load and store is coalesced;
//   * a row whose length is not a multiple of 4, or a base not 16-byte
//     aligned, takes the scalar path for its last quad (or for all);
//   * the exposure axis, a block axis on the TPU, is a loop in the thread:
//     the sum adds the N loads in registers, the merge holds the N values
//     and stds of its quad in registers (N <= 16) and reads each once;
//   * the sum takes its launch from the caller: VEC quads per thread and
//     iteration (1, 2 or 4) and the block size (128, 256 or 512 threads)
//     are the launch sweep, Hopper's counterpart of E5's row-block x
//     dimension_semantics sweep; the merge always runs 256 threads a block,
//     one quad a thread and step (a quad's N values and stds fill its
//     registers already).
// E3's dead index (exp_kernel.py:128-137) is computed and dropped, as on
// the TPU; the compiler removes it.  Rounding is rintf (half to even, as
// jnp.round and torch.round) and the weight uses expf: build without
// -use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 16;        // exposures a thread holds
constexpr int kMaxThreads = 512;
constexpr int kMergeThreads = 256;

enum Mode { kNone = 0, kMod = 1, kRound = 2, kExp = 3 };

struct WalkArgs {
  const float* val;         // (outer, N, inner)
  const float* std;         // (outer, N, inner)
  float* out_val;           // (outer, inner)
  float* out_std;           // (outer, inner)
  long long outer;
  long long inner;
  long long outer_stride;   // elements from row o to row o + 1: N * inner
  long long n_stride;       // elements from exposure n to n + 1: inner
  long long quads;          // quads per row: ceil(inner / 4)
  int N;
  int vec_ok;               // 1: rows and bases allow 16-byte accesses
  float invt[kMaxN];        // merge: 1 / t of each exposure
};

__device__ __forceinline__ float weight(float x) {
  const float d = x - 0.5f;
  return expf(-30.0f * (d * d));
}

// elements e0 .. e0 + cnt - 1 of a row at p; FULL: one 16-byte load
template <bool FULL>
__device__ __forceinline__ void load_quad(const float* p, int cnt,
                                          float (&x)[4]) {
  if (FULL) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = k < cnt ? __ldg(p + k) : 0.0f;
  }
}

template <bool FULL>
__device__ __forceinline__ void store_quad(float* p, int cnt,
                                           const float (&x)[4]) {
  if (FULL) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < cnt) p[k] = x[k];
  }
}

template <int MODE, bool FULL>
__device__ __forceinline__ void sum_quad(const WalkArgs& a, long long o,
                                         long long e0, int cnt) {
  const long long row = o * a.outer_stride + e0;
  float acc_v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc_s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc_w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int acc_i[4] = {0, 0, 0, 0};
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    if (n < a.N) {
      float x[4], s[4];
      load_quad<FULL>(a.val + row + n * a.n_stride, cnt, x);
      load_quad<FULL>(a.std + row + n * a.n_stride, cnt, s);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc_v[k] += x[k];
        acc_s[k] += s[k];
        if (MODE == kRound) {
          const int q = (int)rintf(x[k] * 255.0f);
          acc_i[k] += min(max(q, 0), 255);
        }
        if (MODE == kExp) acc_w[k] += weight(x[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (MODE == kMod) acc_v[k] += (float)((e0 + k) % 3);
    if (MODE == kRound) acc_v[k] += (float)acc_i[k];
    if (MODE == kExp) acc_v[k] += acc_w[k];
  }
  const long long out = o * a.inner + e0;
  store_quad<FULL>(a.out_val + out, cnt, acc_v);
  store_quad<FULL>(a.out_std + out, cnt, acc_s);
}

template <int MAXN, bool DEAD, bool FULL>
__device__ __forceinline__ void merge_quad(const WalkArgs& a, long long o,
                                           long long e0, int cnt) {
  const long long row = o * a.outer_stride + e0;
  float x[MAXN][4], s[MAXN][4];
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    if (n < a.N) {
      load_quad<FULL>(a.val + row + n * a.n_stride, cnt, x[n]);
      load_quad<FULL>(a.std + row + n * a.n_stride, cnt, s[n]);
    }
  }
  float out_v[4], out_s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float w[MAXN];
    float sw = 0.0f;
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      if (n < a.N) {
        w[n] = weight(x[n][k]);
        sw += w[n];
      }
    }
    const float inv_sw = 1.0f / sw;
    const float inv_sw2 = inv_sw * inv_sw;
    float acc_v = 0.0f, acc_s = 0.0f;
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      if (n < a.N) {
        const float xn = x[n][k], sn = s[n][k], wn = w[n];
        const float invt = a.invt[n];
        if (DEAD) {  // exp_kernel.py:128-137: an index nobody reads
          int idx = min(max((int)rintf(xn * 255.0f), 0), 255);
          int hi = idx >> 4;
          hi += (int)((e0 + k) % 3) * 16;
          const int lo = idx & 15;
          (void)hi;
          (void)lo;
        }
        acc_v += wn * xn * invt;
        const float dw = -60.0f * (xn - 0.5f) * wn;
        const float bracket = (dw * xn + wn * sn) * inv_sw
            - (dw * wn * xn) * inv_sw2;
        const float term = bracket * sn * invt;
        acc_s += term * term;
      }
    }
    out_v[k] = acc_v * inv_sw;
    out_s[k] = sqrtf(acc_s);
  }
  const long long out = o * a.inner + e0;
  store_quad<FULL>(a.out_val + out, cnt, out_v);
  store_quad<FULL>(a.out_std + out, cnt, out_s);
}

// the grid-stride walk: quad u is row u / quads, elements 4 (u % quads) ..
template <int MODE, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
exposure_sum_kernel(const WalkArgs a) {
  const long long units = a.outer * a.quads;
  const long long step = (long long)gridDim.x * blockDim.x * VEC;
  for (long long base = (long long)blockIdx.x * blockDim.x * VEC
           + threadIdx.x; base < units; base += step) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const long long u = base + (long long)v * blockDim.x;
      if (u >= units) break;
      const long long o = u / a.quads;
      const long long e0 = (u - o * a.quads) * 4;
      const int cnt = (int)(a.inner - e0 < 4 ? a.inner - e0 : 4);
      if (cnt == 4 && a.vec_ok)
        sum_quad<MODE, true>(a, o, e0, 4);
      else
        sum_quad<MODE, false>(a, o, e0, cnt);
    }
  }
}

template <int MAXN, bool DEAD>
__global__ void __launch_bounds__(kMergeThreads)
merge_nolut_kernel(const WalkArgs a) {
  const long long units = a.outer * a.quads;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < units; u += step) {
    const long long o = u / a.quads;
    const long long e0 = (u - o * a.quads) * 4;
    const int cnt = (int)(a.inner - e0 < 4 ? a.inner - e0 : 4);
    if (cnt == 4 && a.vec_ok)
      merge_quad<MAXN, DEAD, true>(a, o, e0, 4);
    else
      merge_quad<MAXN, DEAD, false>(a, o, e0, cnt);
  }
}

template <typename Kernel>
int launch(Kernel kernel, const WalkArgs& a, int threads, int vec,
           void* stream) {
  const long long units = a.outer * a.quads;
  if (units == 0) return 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long per_block = (long long)threads * vec;
  long long blocks = (units + per_block - 1) / per_block;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > resident) blocks = resident;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

bool valid_launch(int threads, int vec) {
  return (threads == 128 || threads == 256 || threads == 512)
      && (vec == 1 || vec == 2 || vec == 4);
}

WalkArgs make_args(const float* val, const float* std, float* out_val,
                   float* out_std, long long outer, int n, long long inner) {
  WalkArgs a{};
  a.val = val;
  a.std = std;
  a.out_val = out_val;
  a.out_std = out_std;
  a.outer = outer;
  a.inner = inner;
  a.outer_stride = (long long)n * inner;
  a.n_stride = inner;
  a.quads = (inner + 3) / 4;
  a.N = n;
  const uintptr_t bases = (uintptr_t)val | (uintptr_t)std
      | (uintptr_t)out_val | (uintptr_t)out_std;
  a.vec_ok = inner % 4 == 0 && bases % 16 == 0;
  return a;
}

template <int MODE>
int launch_sum(const WalkArgs& a, int threads, int vec, void* stream) {
  switch (vec) {
    case 1: return launch(exposure_sum_kernel<MODE, 1>, a, threads, 1, stream);
    case 2: return launch(exposure_sum_kernel<MODE, 2>, a, threads, 2, stream);
    case 4: return launch(exposure_sum_kernel<MODE, 4>, a, threads, 4, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int MAXN, bool DEAD>
int launch_merge(const WalkArgs& a, void* stream) {
  return launch(merge_nolut_kernel<MAXN, DEAD>, a, kMergeThreads, 1, stream);
}

}  // namespace

// mode: 0 none, 1 mod, 2 round, 3 exp.  Returns a cudaError_t.
extern "C" int cl_exposure_sum(const float* val, const float* std,
                               float* out_val, float* out_std,
                               long long outer, int n, long long inner,
                               int mode, int threads, int vec, void* stream) {
  if (n < 1 || n > kMaxN || !valid_launch(threads, vec))
    return (int)cudaErrorInvalidValue;
  const WalkArgs a = make_args(val, std, out_val, out_std, outer, n, inner);
  switch (mode) {
    case kNone: return launch_sum<kNone>(a, threads, vec, stream);
    case kMod: return launch_sum<kMod>(a, threads, vec, stream);
    case kRound: return launch_sum<kRound>(a, threads, vec, stream);
    case kExp: return launch_sum<kExp>(a, threads, vec, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// invt: n floats in host memory, copied into the kernel's arguments.
// Returns a cudaError_t.
extern "C" int cl_merge_nolut(const float* val, const float* std,
                              const float* invt, float* out_val,
                              float* out_std, long long outer, int n,
                              long long inner, int dead, void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  WalkArgs a = make_args(val, std, out_val, out_std, outer, n, inner);
  for (int i = 0; i < n; ++i) a.invt[i] = invt[i];
  if (n <= 8)
    return dead ? launch_merge<8, true>(a, stream)
                : launch_merge<8, false>(a, stream);
  return dead ? launch_merge<kMaxN, true>(a, stream)
              : launch_merge<kMaxN, false>(a, stream);
}
