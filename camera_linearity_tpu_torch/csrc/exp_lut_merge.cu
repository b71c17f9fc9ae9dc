// Kernel experiments E6 and E7 for NVIDIA Hopper (sm_90a): K1's exact-table
// merge on planar stacks, with the stack staged through shared memory by
// bulk copies (E6) or with the tables held in another form (E7).  Plain C
// interface, loaded through ctypes (camera_linearity_tpu_torch/csrc/
// __init__.py).
//
// They replace the Pallas TPU kernels of:
//
//   cl_merge_pipelined  <- E6 benchmarks/exp_manual_pipeline.py::build (:161,
//                          pallas_call :164; body make_kernel :48-158): the
//                          256-entry merge with the operands left in HBM and
//                          (hb, W) row chunks double-buffered through VMEM by
//                          make_async_copy start/wait.
//   cl_merge_table_form <- E7 benchmarks/exp_int8_planes.py::build (:194,
//                          pallas_call :208; kernel_bf16 :127, kernel_int8
//                          :158): the exact 4096-entry merge with its tables
//                          as 3 bf16 parts or 4 byte planes.
//
// Both compute, for each element i of the planar (C, H, W) result over the N
// exposures of (N, C, H, W) f32 value and std stacks, with c the channel of
// i: idx = clamp(rint(x (rows - 1)), 0, rows - 1), w = exp(-30 (x - 1/2)^2),
// dw = -60 (x - 1/2) w, g = ICRF[idx, c], f' = ICRF'[idx, c], dg = f' s;
// val = sum(w g invt) / sum(w), std = sqrt(sum((bracket s invt)^2)) with
// bracket = (dw g + w dg) / sum(w) - dw w g / sum(w)^2 (compat "corrected";
// exp_manual_pipeline.py:105-148, exp_int8_planes.py:86-124).  invt (N
// floats) comes by value in the argument struct.  Each weight is computed
// once, as the merge without a lookup (exp_ablation.cu) computes it; K1
// (hdr_merge.cu) computes it in both passes.  Products and sums are rounded
// one by one (__fmul_rn, __fadd_rn), as the plain PyTorch version
// (ops/lut_merge_cuda.py::merge_planar_plain) rounds them, so that no
// multiply-add the compiler might fuse differs between instances: E7's three
// table forms share the body and give the same bits.
//
// What bounds them on the card: bytes.  At config 2/3 (6 exposures of
// 1200 x 1920 x 3, f32 value and std) both read 331.78 MB and write 55.30
// MB: 387.07 MB a call, 0.1155 ms at 3.35 TB/s; their ~48 f32 operations per
// element and exposure take 0.030 ms at 67 TFLOP/s.  The designs:
//   * E6, a persistent pipeline.  As many blocks as fit on the SMs at once
//     (one to four an SM over config 2's sweep); each walks a contiguous
//     run of chunks of the C*H*W plane index through a ring of STAGES slots
//     in dynamic shared memory, a slot holding one chunk of all N value
//     planes and all N std planes.  One thread fills a slot with 2N 1-D bulk copies
//     (cp.async.bulk ... mbarrier::complete_tx::bytes) that complete on the
//     slot's mbarrier, the Hopper counterpart of make_async_copy and a DMA
//     semaphore; the block's threads wait on the slot's parity, compute both
//     passes from shared memory (one 16-byte load per array and exposure a
//     thread) and store with coalesced 16-byte stores; after a
//     __syncthreads the slot is refilled with the chunk STAGES ahead, so
//     STAGES - 1 chunks are in flight while one is computed.  The 256-entry
//     tables of all channels sit in shared memory as (f, f') pairs,
//     channel-major (6 KB at C = 3): a lookup is one 8-byte indexed load.
//     The chunk and STAGES come from the wrapper's planner
//     (ops/lut_merge_cuda.py::plan_pipeline), the Hopper counterpart of the
//     script's --hb sweep.  Bulk copies need 16-byte aligned addresses and
//     sizes: a stack whose bases are not 16-byte aligned or whose plane is
//     not a multiple of 4 elements (a 37 x 53 crop) takes the scalar route,
//     a grid-stride walk that loads each element from device memory.
//   * E7, the table forms.  A block serves one channel (grid = C x blocks a
//     channel), so it stages only that channel's two 4096-entry tables, in
//     the FORM under test: F32 (K1's tables, 32 KB: the control), BF16X3
//     (each entry as three bf16 parts p0 + p1 + p2, 48 KB; exact, since
//     every residue of an f32 fits 8 bits) or U8X4 (four byte planes,
//     32 KB, the entry rebuilt as b0 | b1 << 8 | b2 << 16 | b3 << 24).  The
//     tables arrive packed in the form, (planes, rows, C) each
//     (ops/lut_merge_cuda.py::pack_table, as the script's pack_int8 packs
//     outside its kernel), and the block copies its channel's planes into
//     shared memory as they are, 16 loads in flight a thread.  The stacks
//     stream through a grid-stride loop of 16-byte loads, a quad of 4
//     elements a thread, all N values and stds of the quad held in
//     registers (N <= 16), exp_ablation.cu's merge walk plus the lookup; a
//     plane that is not a multiple of 4 elements or a misaligned stack takes
//     the scalar path.
// Rounding is rintf (half to even, as jnp.round and torch.round) and the
// weight uses expf: build without -use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 16;            // exposures a thread holds
constexpr int kMaxPipeThreads = 512;  // E6: chunk / 4 threads, chunk <= 2048
constexpr int kThreads = 256;         // E6's scalar route and E7
constexpr int kMaxSmem = 232448;      // shared memory a block may take
constexpr int kStageBatch = 16;       // E7: table loads in flight a thread

enum Form { kF32 = 0, kBF16X3 = 1, kU8X4 = 2 };

// One E6 launch, field for field ops/lut_merge_cuda.py::PipePlan; offsets
// and sizes in bytes.
struct PipePlan {
  int chunk;       // elements of a plane in one slot, a multiple of 128;
                   // chunk / 4 threads a block, one quad each
  int stages;      // slots in the ring
  int bulk;        // 1: bulk copies, 0: the scalar route
  int off_bar;     // the slots' mbarriers, after the tables
  int off_slots;   // slot 0
  int slot_bytes;  // 2 N chunk 4
  int smem;        // the launch's dynamic shared memory
};

struct MergeArgs {
  const float* val;       // (N, C, H, W)
  const float* std;       // (N, C, H, W)
  const void* tab;        // (rows, C) f32 ICRF (E6), or E7's packed form
  const void* tab_diff;   // its derivative, alike
  float* out_val;         // (C, H, W)
  float* out_std;         // (C, H, W)
  long long hw;           // H * W, the elements of a channel's plane
  long long plane;        // C * H * W, from exposure n to n + 1
  int N, C, rows;
  int vec_ok;             // 1: every quad of a plane may be a 16-byte access
  float invt[kMaxN];      // 1 / t of each exposure
  PipePlan p;             // E6's bulk route
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

// bytes (a multiple of 16) from src in device memory to dst in shared
// memory, both 16-byte aligned, completing on the mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar) : "memory");
}

__device__ __forceinline__ float weight(float x) {
  const float d = x - 0.5f;
  return expf(-30.0f * (d * d));
}

__device__ __forceinline__ int table_index(float x, int max_dn) {
  const float m = (float)max_dn;
  return (int)fminf(fmaxf(rintf(x * m), 0.0f), m);
}

// one exposure's terms of an element, rounded as the plain version rounds
__device__ __forceinline__ void accumulate(float x, float s, float w, float g,
                                           float fp, float invt, float inv_sw,
                                           float inv_sw2, float& acc_v,
                                           float& acc_s) {
  acc_v = __fadd_rn(acc_v, __fmul_rn(__fmul_rn(w, g), invt));
  const float dw = __fmul_rn(__fmul_rn(-60.0f, x - 0.5f), w);
  const float dg = __fmul_rn(fp, s);
  const float bracket = __fsub_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(dw, g), __fmul_rn(w, dg)), inv_sw),
      __fmul_rn(__fmul_rn(__fmul_rn(dw, w), g), inv_sw2));
  const float term = __fmul_rn(__fmul_rn(bracket, s), invt);
  acc_s = __fadd_rn(acc_s, __fmul_rn(term, term));
}

// ---------------------------------------------------------------------------
// tables in shared memory
// ---------------------------------------------------------------------------

// E6: every channel's (f, f') pairs, channel-major
struct PairTable {
  const float2* s;
  int rows;
  __device__ __forceinline__ void operator()(int c, int idx, float& g,
                                             float& fp) const {
    const float2 t = s[c * rows + idx];
    g = t.x;
    fp = t.y;
  }
};

__device__ void stage_pairs(float2* s, const MergeArgs& a) {
  for (int i = threadIdx.x; i < a.rows * a.C; i += blockDim.x) {
    const int c = i / a.rows;
    const int r = i - c * a.rows;
    s[i] = make_float2(static_cast<const float*>(a.tab)[r * a.C + c],
                       static_cast<const float*>(a.tab_diff)[r * a.C + c]);
  }
}

// E7's packed tables: each a (planes, rows, C) array of Elem
template <int FORM>
struct Packed {
  using Elem = float;
  static constexpr int planes = 1;
};
template <>
struct Packed<kBF16X3> {  // p0, p1, p2
  using Elem = __nv_bfloat16;
  static constexpr int planes = 3;
};
template <>
struct Packed<kU8X4> {  // byte b of each entry in plane b
  using Elem = unsigned char;
  static constexpr int planes = 4;
};

// E7: one channel's two tables in FORM; tables t = 0 (ICRF), 1 (ICRF'),
// plane p of table t at rows (planes t + p) * rows ...
template <int FORM>
struct FormTable {
  using Elem = typename Packed<FORM>::Elem;
  static constexpr int P = Packed<FORM>::planes;
  const unsigned char* s;
  int rows;

  static int bytes(int rows) { return 2 * P * rows * (int)sizeof(Elem); }

  // kStageBatch loads in flight a thread, then their stores: one load at
  // a time waits out the cache's latency for each of up to 128 entries
  __device__ void stage(unsigned char* dst, const MergeArgs& a, int c) const {
    Elem* d = reinterpret_cast<Elem*>(dst);
    const int total = 2 * P * a.rows;
    for (int i0 = threadIdx.x; i0 < total; i0 += kStageBatch * blockDim.x) {
      Elem v[kStageBatch];
#pragma unroll
      for (int b = 0; b < kStageBatch; ++b) {
        const int i = i0 + b * blockDim.x;
        if (i < total) {
          const int tp = i / a.rows;  // P t + p
          const int r = i - tp * a.rows;
          const int t = tp / P;
          const Elem* src = static_cast<const Elem*>(t ? a.tab_diff : a.tab);
          v[b] = src[((tp - t * P) * a.rows + r) * a.C + c];
        }
      }
#pragma unroll
      for (int b = 0; b < kStageBatch; ++b) {
        const int i = i0 + b * blockDim.x;
        if (i < total) d[i] = v[b];
      }
    }
  }

  __device__ __forceinline__ float entry(int t, int idx) const {
    if (FORM == kF32) return reinterpret_cast<const float*>(s)[t * rows + idx];
    if (FORM == kBF16X3) {
      const __nv_bfloat16* parts = reinterpret_cast<const __nv_bfloat16*>(s);
      return __fadd_rn(__fadd_rn(__bfloat162float(parts[(3 * t) * rows + idx]),
                                 __bfloat162float(
                                     parts[(3 * t + 1) * rows + idx])),
                       __bfloat162float(parts[(3 * t + 2) * rows + idx]));
    }
    const unsigned char* b = s + 4 * t * rows + idx;
    return __uint_as_float((uint32_t)b[0] | (uint32_t)b[rows] << 8
                           | (uint32_t)b[2 * rows] << 16
                           | (uint32_t)b[3 * rows] << 24);
  }

  __device__ __forceinline__ void operator()(int, int idx, float& g,
                                             float& fp) const {
    g = entry(0, idx);
    fp = entry(1, idx);
  }
};

// ---------------------------------------------------------------------------
// the merge of one quad read from device memory (E6's scalar route, E7)
// ---------------------------------------------------------------------------

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
    for (int k = 0; k < 4; ++k) x[k] = k < cnt ? __ldg(p + k) : 0.5f;
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

// elements e0 .. e0 + cnt - 1 of the plane, element k of channel c[k]
template <int MAXN, bool FULL, typename Table>
__device__ __forceinline__ void merge_quad(const MergeArgs& a,
                                           const Table& tab, long long e0,
                                           int cnt, const int (&c)[4]) {
  float x[MAXN][4], s[MAXN][4];
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    if (n < a.N) {
      load_quad<FULL>(a.val + n * a.plane + e0, cnt, x[n]);
      load_quad<FULL>(a.std + n * a.plane + e0, cnt, s[n]);
    }
  }
  const int max_dn = a.rows - 1;
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
        float g, fp;
        tab(c[k], table_index(x[n][k], max_dn), g, fp);
        accumulate(x[n][k], s[n][k], w[n], g, fp, a.invt[n], inv_sw, inv_sw2,
                   acc_v, acc_s);
      }
    }
    out_v[k] = acc_v * inv_sw;
    out_s[k] = sqrtf(acc_s);
  }
  store_quad<FULL>(a.out_val + e0, cnt, out_v);
  store_quad<FULL>(a.out_std + e0, cnt, out_s);
}

// the channels of elements e0 .. e0 + 3 of the plane (a quad may straddle
// two channels when H * W is not a multiple of 4, and up to four when
// H * W < 4); the elements of a last, partial quad past the plane get the
// last channel, so that their unused lookups stay inside the tables
__device__ __forceinline__ void channels(long long e0, const MergeArgs& a,
                                         int (&c)[4]) {
  if (a.hw < 4) {  // the same branch for every thread
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = min((int)((e0 + k) / a.hw), a.C - 1);
    return;
  }
  const int c0 = (int)(e0 / a.hw);
  const long long next = (c0 + 1) * a.hw;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    c[k] = min(c0 + (e0 + k >= next ? 1 : 0), a.C - 1);
}

// ---------------------------------------------------------------------------
// E6
// ---------------------------------------------------------------------------

template <int MAXN>
__global__ void __launch_bounds__(kMaxPipeThreads)
pipelined_kernel(const __grid_constant__ MergeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PipePlan& p = a.p;
  const PairTable tab{reinterpret_cast<const float2*>(smem), a.rows};
  const uint32_t bars = smem_addr(smem + p.off_bar);
  const long long chunks = (a.plane + p.chunk - 1) / p.chunk;
  const long long first = blockIdx.x * chunks / gridDim.x;
  const int count = (int)((blockIdx.x + 1) * chunks / gridDim.x - first);

  // this block's chunk j into slot j % stages (thread 0 only)
  auto fill = [&](int j) {
    const long long start = (first + j) * p.chunk;
    const long long left = a.plane - start;
    const uint32_t bytes = 4u * (uint32_t)(left < p.chunk ? left : p.chunk);
    const int slot = j % p.stages;
    const uint32_t bar = bars + 8 * slot;
    const uint32_t dst = smem_addr(smem + p.off_slots + slot * p.slot_bytes);
    bar_expect(bar, 2u * a.N * bytes);
    for (int n = 0; n < a.N; ++n) {
      bulk_load(dst + 4u * n * p.chunk, a.val + n * a.plane + start, bytes,
                bar);
      bulk_load(dst + 4u * (a.N + n) * p.chunk, a.std + n * a.plane + start,
                bytes, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < p.stages; ++k) bar_init(bars + 8 * k);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < count && j < p.stages; ++j) fill(j);
  }
  stage_pairs(reinterpret_cast<float2*>(smem), a);
  __syncthreads();

  const int q = 4 * threadIdx.x;  // this thread's quad within a chunk
  const int max_dn = a.rows - 1;
  for (int j = 0; j < count; ++j) {
    const int slot = j % p.stages;
    bar_wait(bars + 8 * slot, (uint32_t)(j / p.stages) & 1u);
    const long long start = (first + j) * p.chunk;
    if (start + q < a.plane) {  // the plane is a multiple of 4 elements
      const float* sv = reinterpret_cast<const float*>(
          smem + p.off_slots + slot * p.slot_bytes);
      const float* ss = sv + a.N * p.chunk;
      int c[4];
      channels(start + q, a, c);
      // pass 1: the weights, kept; their sum
      float w[MAXN][4];
      float sw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < MAXN; ++n) {
        if (n < a.N) {
          const float4 v = *reinterpret_cast<const float4*>(sv + n * p.chunk
                                                            + q);
          w[n][0] = weight(v.x);
          w[n][1] = weight(v.y);
          w[n][2] = weight(v.z);
          w[n][3] = weight(v.w);
#pragma unroll
          for (int k = 0; k < 4; ++k) sw[k] += w[n][k];
        }
      }
      float inv_sw[4], inv_sw2[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        inv_sw[k] = 1.0f / sw[k];
        inv_sw2[k] = inv_sw[k] * inv_sw[k];
      }
      // pass 2: value and variance
      float acc_v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float acc_s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < MAXN; ++n) {
        if (n < a.N) {
          const float4 v = *reinterpret_cast<const float4*>(sv + n * p.chunk
                                                            + q);
          const float4 s4 = *reinterpret_cast<const float4*>(ss + n * p.chunk
                                                             + q);
          const float x[4] = {v.x, v.y, v.z, v.w};
          const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float g, fp;
            tab(c[k], table_index(x[k], max_dn), g, fp);
            accumulate(x[k], s[k], w[n][k], g, fp, a.invt[n], inv_sw[k],
                       inv_sw2[k], acc_v[k], acc_s[k]);
          }
        }
      }
      *reinterpret_cast<float4*>(a.out_val + start + q) = make_float4(
          acc_v[0] * inv_sw[0], acc_v[1] * inv_sw[1], acc_v[2] * inv_sw[2],
          acc_v[3] * inv_sw[3]);
      *reinterpret_cast<float4*>(a.out_std + start + q) = make_float4(
          sqrtf(acc_s[0]), sqrtf(acc_s[1]), sqrtf(acc_s[2]), sqrtf(acc_s[3]));
    }
    __syncthreads();  // every thread is done with the slot
    if (threadIdx.x == 0 && j + p.stages < count) {
      // the slot was read through the generic proxy; the copy writes it
      // through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      fill(j + p.stages);
    }
  }
}

// E6's scalar route: a grid-stride walk over the plane's quads, every
// element loaded from device memory
template <int MAXN>
__global__ void __launch_bounds__(kThreads)
scalar_kernel(const __grid_constant__ MergeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  stage_pairs(reinterpret_cast<float2*>(smem), a);
  __syncthreads();
  const PairTable tab{reinterpret_cast<const float2*>(smem), a.rows};
  const long long quads = (a.plane + 3) / 4;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < quads; u += (long long)gridDim.x * blockDim.x) {
    const long long e0 = 4 * u;
    const int cnt = (int)(a.plane - e0 < 4 ? a.plane - e0 : 4);
    int c[4];
    channels(e0, a, c);
    merge_quad<MAXN, false>(a, tab, e0, cnt, c);
  }
}

// ---------------------------------------------------------------------------
// E7
// ---------------------------------------------------------------------------

// block b serves channel b / per_channel and walks that channel's plane;
// for N <= 8 two blocks an SM, so at most 128 registers a thread (the table
// staging's batch would take 152, and halve the blocks)
template <int MAXN, int FORM>
__global__ void __launch_bounds__(kThreads, MAXN <= 8 ? 2 : 1)
table_form_kernel(const __grid_constant__ MergeArgs a, int per_channel) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x / per_channel;
  const int b = blockIdx.x - c * per_channel;
  const FormTable<FORM> tab{smem, a.rows};
  tab.stage(smem, a, c);
  __syncthreads();
  const int cs[4] = {c, c, c, c};
  const long long quads = (a.hw + 3) / 4;
  for (long long u = (long long)b * blockDim.x + threadIdx.x; u < quads;
       u += (long long)per_channel * blockDim.x) {
    const long long e0 = c * a.hw + 4 * u;
    const int cnt = (int)(a.hw - 4 * u < 4 ? a.hw - 4 * u : 4);
    if (cnt == 4 && a.vec_ok)
      merge_quad<MAXN, true>(a, tab, e0, 4, cs);
    else
      merge_quad<MAXN, false>(a, tab, e0, cnt, cs);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// blocks of `threads` with `smem` bytes each that fit on the card at once
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, int smem, long long& blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  return 0;
}

template <int MAXN>
int launch_pipelined(const MergeArgs& a, void* stream) {
  const PipePlan& p = a.p;
  long long resident = 0;
  if (p.bulk) {
    const auto kernel = pipelined_kernel<MAXN>;
    const int threads = p.chunk / 4;
    const int rc = resident_blocks(kernel, threads, p.smem, resident);
    if (rc != 0) return rc;
    const long long chunks = (a.plane + p.chunk - 1) / p.chunk;
    const long long blocks = chunks < resident ? chunks : resident;
    kernel<<<(unsigned)blocks, threads, p.smem, (cudaStream_t)stream>>>(a);
  } else {
    const auto kernel = scalar_kernel<MAXN>;
    const int smem = a.rows * a.C * (int)sizeof(float2);
    const int rc = resident_blocks(kernel, kThreads, smem, resident);
    if (rc != 0) return rc;
    const long long quads = (a.plane + 3) / 4;
    long long blocks = (quads + kThreads - 1) / kThreads;
    if (blocks > resident) blocks = resident;
    kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int MAXN, int FORM>
int launch_table_form(const MergeArgs& a, void* stream) {
  const auto kernel = table_form_kernel<MAXN, FORM>;
  const int smem = FormTable<FORM>::bytes(a.rows);
  long long resident = 0;
  const int rc = resident_blocks(kernel, kThreads, smem, resident);
  if (rc != 0) return rc;
  const long long quads = (a.hw + 3) / 4;
  long long per_channel = resident / a.C;
  const long long needed = (quads + kThreads - 1) / kThreads;
  if (per_channel > needed) per_channel = needed;
  if (per_channel < 1) per_channel = 1;
  kernel<<<(unsigned)(a.C * per_channel), kThreads, smem,
           (cudaStream_t)stream>>>(a, (int)per_channel);
  return (int)cudaGetLastError();
}

bool make_args(MergeArgs& a, const float* val, const float* std,
               const void* tab, const void* tab_diff, const float* invt,
               float* out_val, float* out_std, int n, int c, long long hw,
               int rows) {
  if (n < 1 || n > kMaxN || c < 1 || hw < 1 || (rows != 256 && rows != 4096))
    return false;
  a = MergeArgs{};
  a.val = val;
  a.std = std;
  a.tab = tab;
  a.tab_diff = tab_diff;
  a.out_val = out_val;
  a.out_std = out_std;
  a.hw = hw;
  a.plane = c * hw;
  a.N = n;
  a.C = c;
  a.rows = rows;
  for (int i = 0; i < n; ++i) a.invt[i] = invt[i];
  const uintptr_t bases = (uintptr_t)val | (uintptr_t)std
      | (uintptr_t)out_val | (uintptr_t)out_std;
  a.vec_ok = hw % 4 == 0 && bases % 16 == 0;
  return true;
}

}  // namespace

// E6.  invt: n floats in host memory, copied into the kernel's arguments.
// plan: the PipePlan of ops/lut_merge_cuda.py::plan_pipeline, whose bulk
// field the wrapper set from the stacks' alignment.  Returns a cudaError_t.
extern "C" int cl_merge_pipelined(const float* val, const float* std,
                                  const float* tab, const float* tab_diff,
                                  const float* invt, float* out_val,
                                  float* out_std, int n, int c, long long hw,
                                  int rows, void* stream, const int* plan) {
  MergeArgs a;
  if (!make_args(a, val, std, tab, tab_diff, invt, out_val, out_std, n, c, hw,
                 rows))
    return (int)cudaErrorInvalidValue;
  a.p = *reinterpret_cast<const PipePlan*>(plan);
  const PipePlan& p = a.p;
  if (p.bulk) {
    const uintptr_t bases = (uintptr_t)val | (uintptr_t)std
        | (uintptr_t)out_val | (uintptr_t)out_std;
    const long long tables = (long long)rows * c * sizeof(float2);
    if (a.plane % 4 != 0 || bases % 16 != 0 || p.chunk % 128 != 0
        || p.chunk / 4 > kMaxPipeThreads || p.stages < 1
        || p.off_bar < tables || p.off_bar % 8 != 0
        || p.off_slots < p.off_bar + 8 * p.stages || p.off_slots % 16 != 0
        || p.slot_bytes != 8 * n * p.chunk
        || p.smem < p.off_slots + p.stages * p.slot_bytes
        || p.smem > kMaxSmem)
      return (int)cudaErrorInvalidValue;
  }
  return n <= 8 ? launch_pipelined<8>(a, stream)
                : launch_pipelined<kMaxN>(a, stream);
}

// E7.  form: 0 f32, 1 three bf16 parts, 2 four byte planes; tab and
// tab_diff packed in that form, (rows, C) f32, (3, rows, C) bf16 or
// (4, rows, C) u8.  Returns a cudaError_t.
extern "C" int cl_merge_table_form(const float* val, const float* std,
                                   const void* tab, const void* tab_diff,
                                   const float* invt, float* out_val,
                                   float* out_std, int n, int c, long long hw,
                                   int rows, int form, void* stream) {
  MergeArgs a;
  if (!make_args(a, val, std, tab, tab_diff, invt, out_val, out_std, n, c, hw,
                 rows))
    return (int)cudaErrorInvalidValue;
  const bool small = n <= 8;
  switch (form) {
    case kF32:
      return small ? launch_table_form<8, kF32>(a, stream)
                   : launch_table_form<kMaxN, kF32>(a, stream);
    case kBF16X3:
      return small ? launch_table_form<8, kBF16X3>(a, stream)
                   : launch_table_form<kMaxN, kBF16X3>(a, stream);
    case kU8X4:
      return small ? launch_table_form<8, kU8X4>(a, stream)
                   : launch_table_form<kMaxN, kU8X4>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}
