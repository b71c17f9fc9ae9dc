// HDR-merge kernel K1 for NVIDIA Hopper (sm_90a), with a plain C interface
// loaded through ctypes (camera_linearity_tpu_torch/csrc/__init__.py).
//
// It replaces the Pallas TPU kernel of camera_linearity_tpu/ops/hdr_pallas2.py:
//
//   K1 cl_merge_fused    <- merge_planar_fused (:473), body _make_kernel
//                           (:142): exact ICRF lookup, 256- or 4096-entry
//                           tables, float [0,1] or integer-DN stacks.
//
// K2 and K3, the merges through base curves, are in hdr_merge_lerp.cu.
//
// Per output element (b, h, w, c), over the N exposures: x is the [0,1]
// value (or DN / max_dn), idx = clamp(rint(x * max_dn)), w = exp(-30 (x -
// 1/2)^2), g = ICRF[idx], f' = ICRF'[idx]; val = sum(w g / t) / sum(w) and,
// with std, std = sqrt(sum((bracket * scale / t)^2)) where bracket =
// (dw g + w dg) / sum(w) - dw w g / sum(w)^2, dg = f' s, and scale is dg
// under compat "reference", s otherwise.  ops/hdr_cuda.py holds the plain
// PyTorch version of the kernel, which the tests compare against.
//
// What bounds them on the card: bytes.  A config-2 merge (6 exposures of
// 1200 x 1920 x 3, f32 value and std) reads 332 MB and writes 55 MB for
// about 40 flops per exposure and element: far below the H100's ratio of
// flops to bytes, so the floor is the time to move 387 MB through HBM.
// The design therefore reads every input once from device memory and
// writes every output once:
//   * one thread per output element of the (B, H, W, C) result, in a
//     grid-stride loop over as many blocks as fit on the SMs at once;
//     neighbouring threads take neighbouring channels and columns, so every
//     load of the (B, N, H, W, C) stack as it lies is coalesced (no planar
//     transpose: on the TPU that was a free relabel, here it is a copy);
//   * the tables sit in shared memory and the lookup is an indexed load
//     (the TPU had no vector gather and used one-hot matrix products);
//   * the exposure axis, a sequential grid axis on the TPU, is a loop in
//     the thread: pass 1 sums the weights, pass 2 accumulates (its re-read
//     of the value hits L1).
// Rounding is rintf (half to even, as jnp.round and torch.round) and the
// weight uses expf; build without -use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct MergeArgs {
  const void* val;        // (B, N, H, W, C): f32 in [0,1], or u8 / i32 DNs
  const float* std;       // (B, N, H, W, C) f32, or null (value-only merge)
  const float* tab;       // (rows, C) ICRF
  const float* tab_diff;  // (rows, C) derivative; read only with std
  const float* inv_t;     // (N,) 1 / exposure time, f32
  float* out_val;         // (B, H, W, C)
  float* out_std;         // (B, H, W, C), or null
  long long B;
  int N, H, W, C;
  int rows;               // table rows (bits)
  int max_dn;             // bits - 1
  float inv_max_dn;       // f32(1 / max_dn): x of an integer DN
  int reference;          // compat "reference" (1) or "corrected" (0)
};

__device__ __forceinline__ void quantize(float v, const MergeArgs& a,
                                         float& x, int& idx) {
  x = v;
  const float m = (float)a.max_dn;
  idx = (int)fminf(fmaxf(rintf(v * m), 0.0f), m);
}

__device__ __forceinline__ void quantize_dn(int dn, const MergeArgs& a,
                                            float& x, int& idx) {
  x = (float)dn * a.inv_max_dn;
  idx = min(max(dn, 0), a.max_dn);
}

__device__ __forceinline__ void quantize(uint8_t v, const MergeArgs& a,
                                         float& x, int& idx) {
  quantize_dn((int)v, a, x, idx);
}

__device__ __forceinline__ void quantize(int32_t v, const MergeArgs& a,
                                         float& x, int& idx) {
  quantize_dn(v, a, x, idx);
}

// table[idx], the exact lookup
__device__ __forceinline__ float lookup(const float* t, int idx, int c,
                                        const MergeArgs& a) {
  return t[idx * a.C + c];
}

// TV: stack element type.
template <typename TV>
__global__ void __launch_bounds__(kThreads) merge_kernel(MergeArgs a) {
  extern __shared__ float smem[];
  const bool use_std = a.std != nullptr;
  const int tab_n = a.rows * a.C;
  float* s_tab = smem;
  float* s_diff = smem + tab_n;
  float* s_invt = smem + (use_std ? 2 : 1) * tab_n;
  for (int i = threadIdx.x; i < tab_n; i += blockDim.x) {
    s_tab[i] = a.tab[i];
    if (use_std) s_diff[i] = a.tab_diff[i];
  }
  for (int i = threadIdx.x; i < a.N; i += blockDim.x) s_invt[i] = a.inv_t[i];
  __syncthreads();

  const TV* val = static_cast<const TV*>(a.val);
  const long long plane = (long long)a.H * a.W * a.C;
  const long long total = a.B * plane;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long b = i / plane;
    const long long r = i - b * plane;          // (h, w, c) within a plane
    const int c = (int)(r % a.C);
    const long long first = b * a.N * plane;    // plane (b, 0)

    // pass 1: sum of weights
    float sw = 0.0f;
    for (int e = 0; e < a.N; ++e) {
      const long long eplane = first + e * plane;
      float x;
      int idx;
      quantize(val[eplane + r], a, x, idx);
      const float d = x - 0.5f;
      sw += expf(-30.0f * (d * d));
    }
    const float inv_sw = 1.0f / sw;
    const float inv_sw2 = inv_sw * inv_sw;

    // pass 2: accumulate value and variance
    float acc_v = 0.0f, acc_s = 0.0f;
    for (int e = 0; e < a.N; ++e) {
      const long long eplane = first + e * plane;
      float x, s = 0.0f;
      int idx;
      quantize(val[eplane + r], a, x, idx);
      if (use_std) s = a.std[eplane + r];
      const float d = x - 0.5f;
      const float wt = expf(-30.0f * (d * d));
      const float g = lookup(s_tab, idx, c, a);
      const float invt = s_invt[e];
      acc_v += wt * g * invt;
      if (use_std) {
        const float dw = -60.0f * d * wt;
        const float dg = lookup(s_diff, idx, c, a) * s;
        const float bracket = (dw * g + wt * dg) * inv_sw
            - (dw * wt * g) * inv_sw2;
        const float term = bracket * (a.reference ? dg : s) * invt;
        acc_s += term * term;
      }
    }
    a.out_val[i] = acc_v * inv_sw;
    if (use_std) a.out_std[i] = sqrtf(acc_s);
  }
}

template <typename TV>
int launch(const MergeArgs& a, void* stream) {
  auto kernel = merge_kernel<TV>;
  const int n_tab = a.std != nullptr ? 2 : 1;
  const size_t smem = (size_t)(n_tab * a.rows * a.C + a.N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = a.B * a.H * a.W * a.C;
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > resident) blocks = resident;
  if (blocks == 0) return 0;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

MergeArgs make_args(const void* val, const float* std, const float* tab,
                    const float* tab_diff, int bits, const float* inv_t,
                    long long B, int N, int H, int W, int C, int reference,
                    float inv_max_dn, float* out_val, float* out_std) {
  MergeArgs a;
  a.val = val;
  a.std = std;
  a.tab = tab;
  a.tab_diff = tab_diff;
  a.inv_t = inv_t;
  a.out_val = out_val;
  a.out_std = out_std;
  a.B = B;
  a.N = N;
  a.H = H;
  a.W = W;
  a.C = C;
  a.rows = bits;
  a.max_dn = bits - 1;
  a.inv_max_dn = inv_max_dn;
  a.reference = reference;
  return a;
}

}  // namespace

// val_kind: 0 f32 [0,1] values, 1 u8 DNs, 2 i32 DNs.  Returns a cudaError_t.
extern "C" int cl_merge_fused(const void* val, int val_kind, const float* std,
                              const float* icrf, const float* icrf_diff,
                              int bits, const float* inv_t, long long B,
                              int N, int H, int W, int C, int reference,
                              float inv_max_dn, float* out_val,
                              float* out_std, void* stream) {
  const MergeArgs a = make_args(val, std, icrf, icrf_diff, bits, inv_t, B, N,
                                H, W, C, reference, inv_max_dn, out_val,
                                out_std);
  switch (val_kind) {
    case 0: return launch<float>(a, stream);
    case 1: return launch<uint8_t>(a, stream);
    case 2: return launch<int32_t>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}
