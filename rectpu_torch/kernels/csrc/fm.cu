// Factorization-machine second-order logit for Hopper (sm_90a), and its
// backward:
//   out[b]      = 0.5 * sum_k((sum_f v[b,f,k])^2 - sum_f v[b,f,k]^2)
//   dv[b, f, k] = g[b] * (S[b,k] - v[b,f,k]),   S[b,k] = sum_f v[b,f,k]
//
// The forward replaces rectpu/ops/fm.py::_fm_fwd_kernel (:271), run by
// fm_cross_pallas (:353) for --fm-impl pallas; the backward replaces
// ::_fm_bwd_kernel (:281), its custom_vjp backward. In the port every fm_impl
// value routes here on the card. As on the TPU, the sums are taken in fp32
// whatever v's type. The forward writes its result in v's type (fm.py:297): a
// bf16 FM logit is rounded to bf16 before the model casts it to fp32
// (models/deep_fm.py:212), and the port keeps that rounding; the flat-layout
// model computes the same logit unrounded in fp32 (fm.py:108-114), which the
// out_is_f32 flag selects. The backward computes g * (S - v) in fp32 and
// writes dv in v's type, as _fm_bwd_kernel does.
//
// What bounds them on this card: bytes. The forward reads B*F*K values once
// and writes B; the backward reads them and g and writes B*F*K. The
// arithmetic (three flops per value) is far below the card's rate. At
// B=8192, F=26, K=64 in bf16 the forward moves 27.3 MB (0.0082 ms at 3.35
// TB/s) and the backward 54.5 MB (0.0163 ms).
//
// Forward design. The TPU kernel reduced a [TB, F, K] block held in VMEM,
// with K on the 128 lanes. Here the forward moves few bytes a row (3.3 KB in
// bf16 at F=26, K=64) and does little with them, so what held the earlier
// kernel back was latency: a warp a row, each lane walking the fields one
// 2-byte load at a time, four in flight. Now a row's bytes are asked for in
// one or two round trips, with tens of KB in flight on every SM, in one of
// three modes that ops/fm.py::fm_fwd_plan picks from the strides and the
// alignment:
// - span / rows (fm_fwd_kernel): the model's looked[..., :K] (rows 130 bytes
//   apart in bf16, so no vector load lines up) and every view that is not
//   "fields". Block j takes tiles j, j + gridDim.x, ... of rows_per_tile rows;
//   thread 0 asks for a whole tile at once by TMA (copy_rows, shared with the
//   backward: one bulk copy of the tile's span when stride_b == F * stride_f,
//   one a row otherwise, windows widened to 16 bytes as below) into its
//   stage; phase 1 forms each (row, k) term from shared memory, four
//   independent sums a thread, and the block's next tile is asked for; phase
//   2 sums a row's terms, a warp a row. The plan sizes the tiles so that the
//   grid holds several blocks an SM even at B=512, each with about one tile,
//   all asked for at once.
// - fields (fm_fwd_vec_kernel): every (row, field) run of K values starts on
//   16 bytes, the fields carry pad between them and a run is at most 32
//   vectors (the fast step's looked[..., :64] of 128 fp32 columns). Staging
//   would copy the pad; instead each lane reads one 16-byte vector of a run
//   straight from device memory, 16 fields before it adds any, and no pad is
//   read.
// - direct (fm_fwd_direct_kernel): a row wider than any stage, or no fields
//   or columns: single values straight from device memory, 16 fields a lane
//   before it adds any.
//
// Forward numerics, the same in every mode and fixed by K alone: for each
// (b, k), S = sum_f v and Q = sum_f v*v over f = 0 .. F-1 in order from
// 0.0f, then the term S*S - Q, each product and sum rounded to fp32 (no
// fused multiply-add); lane j of a warp adds the terms k = j, j+32, ... in
// order from 0.0f, the 32 partials are added by xor shuffles over 16, 8, 4,
// 2, 1 lanes, and 0.5 times the sum is rounded once to out's type. The CPU
// emulation ops/fm.py::fm_fwd_in_order computes the same bits.
//
// Backward design (fm_bwd_kernel). The model's v rows lie K+1 elements
// apart (130 bytes in bf16), so no vector load lines up with them and an
// element-wise kernel moves 2 or 4 bytes an instruction. Instead a
// persistent block stages whole tiles of rows_per_tile consecutive rows in
// shared memory with the Tensor Memory Accelerator (cp.async.bulk, one copy
// a tile when stride_b == F * stride_f: the model's strided view and the
// contiguous [B, F+N, K] of numeric fields are then one contiguous run),
// in a ring of stages whose copies complete on mbarriers, so that the next
// tiles arrive while this one is written. A bulk copy needs 16-byte aligned
// addresses and sizes, so each window is widened down and up to 16-byte
// boundaries; the widened bytes lie in the 16-byte granules of bytes of the
// view, which PyTorch's caching allocator (blocks of 512-byte granularity)
// keeps inside one allocation, and they are never read. Phase 1: the
// block's threads form S[r, k] in fp32 from shared memory, f in order, four
// independent sums a thread, into shared memory. Phase 2: a linear sweep
// over the tile's rows*F*K outputs, contiguous in dv; each thread reads v
// and S from shared memory and writes 16 bytes (8 bf16 or 4 fp32) a store,
// so every store instruction of a warp writes whole 128-byte lines at any
// K; a thread carries its (row, field, column) as counters (no division
// per output). A view with other strides (looked[::2, :, :K]) is staged
// one bulk copy a row; a row wider than a stage is not staged, and one
// thread a (row, k) sums and writes it straight from device memory. The
// tile plan (mode, rows a tile, stages, widened windows) is
// ops/fm.py::fm_bwd_plan, which the CPU tests check.
//
// Numerics: S summed in fp32 over f = 0 .. F-1 in order from 0.0f, then
// g * (S - v) in fp32, rounded once to v's type: bitwise the earlier
// element-wise kernel's on finite inputs (and an in-order emulation's), and
// within a stated tolerance of the plain version, whose fp32 sum runs in
// another order.
//
// Layout: v arrives as a STRIDED view. On the serving and training paths it
// is looked[..., :K] of the [B, F, K+1] fused gather (the last column is the
// linear weight), so the wrapper passes the batch and field strides and
// requires only the innermost stride to be 1; no contiguous copy is made.
// With numeric fields the model concatenates them first, and the
// concatenation is contiguous, which is the same case with stride_f = K. The
// backward writes a dense [B, F, K] dv.
//
// The flat pair (fm_flat_fwd_kernel, fm_flat_bwd_kernel) replaces
// rectpu/ops/fm.py::_fm_flat_fwd_kernel (:146) and ::_fm_flat_bwd_kernel
// (:156), run by fm_cross_flat_pallas (:224) on a lane-packed v2 [B, F*K]:
//   forward:  S[b,k] = sum_f v2[b, f*K+k]   (fp32 sums, STORED in v2's type)
//             out[b] = 0.5 * (sum_k S[b,k]^2 - sum_j v2[b,j]^2)   (fp32)
//   backward: dv2[b, f*K+k] = g[b] * (S[b,k] - v2[b, f*K+k]), fp32 math on
//             the STORED S, written in v2's type.
// Reading the stored (for bf16: rounded) S in the backward, and not the
// forward's fp32 sums, is rectpu's contract (the Pallas forward's s_ref has
// v2's dtype). The [F*K, K] stacked-identity matmul, the batch padding and
// Mosaic's F*K % 128 == 0 are TPU layout devices: these kernels take any
// F*K. Bound: bytes. At B=8192, F=26, K=64 bf16 the forward reads v2 (27.3
// MB) and writes out and S (1.1 MB): 0.0085 ms at 3.35 TB/s; the backward
// reads v2, S and g and writes dv2 (55.6 MB): 0.0166 ms.
//
// Design: one group of G lanes per batch row (G a power of two <= 32, chosen
// by the wrapper to cover a row's vectors), each lane owning
// V consecutive columns k (a 16-byte vector: V = 8 bf16 or 4 fp32) when K %
// V == 0 and the rows are 16-byte aligned, else V = 1. Lane j of the group
// takes the vectors kv = j, j+G, ... of the K/V in a row; for each it walks
// the F fields with one 16-byte load per field, keeping V fp32 sums of S in
// registers, and adds the squares of the values to Q. At K=64 bf16 a row
// takes G = 8 lanes and a warp 4 rows, whose loads of one field are four
// 128-byte segments. The forward stores S as one 16-byte vector per lane and
// reduces sum S^2 and Q over the group by shuffles; the backward loads S
// once per vector and writes each field's dv2 as 16-byte stores.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// V consecutive values of a row as fp32: one 16-byte load when V > 1 (the
// caller guarantees the alignment), else one scalar load.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[V]) {
  if constexpr (V == 1) {
    x[0] = to_float(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = to_float(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&x)[V]) {
  if constexpr (V == 1) {
    *p = from_float<T>(x[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_float<T>(x[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// --- the backward: staged row tiles ------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBwdBarrierBytes = 128;  // the stages' mbarriers, ahead of the stages
constexpr int kBwdMaxStages = kBwdBarrierBytes / 8;
constexpr int kBwdSums = 4;  // independent field sums a thread carries in phase 1
enum BwdMode : int { kBwdSpan = 0, kBwdRows = 1, kBwdDirect = 2 };

struct BwdArgs {
  const void* v;
  const float* g;
  void* dv;
  int n_rows, n_fields, k_dim;
  long long stride_b, stride_f;  // elements
  int mode, rows_per_tile, stages, stage_bytes, slot_bytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One bulk asynchronous copy (TMA) of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from device memory into shared memory, which
// completes on the mbarrier `bar` as a transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `bar` with this parity. A copy that never completes
// (a fault of the plan) traps after some seconds rather than hang the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// Thread 0 starts the copies of `rows` rows of v, the first at byte address
// `first` and each sb bytes after the last, row_bytes from a row's first
// element to its last, into dst: one copy of their whole span (span) or one a
// row, slot_bytes apart; each window widened down and up to 16-byte
// boundaries (see the header), all completing on the mbarrier `bar`. The
// plan's fm_bwd_windows replays these windows.
__device__ void copy_rows(unsigned char* dst, uint64_t* bar, uintptr_t first, int rows,
                          int64_t sb, int row_bytes, bool span, int slot_bytes) {
  const uintptr_t mask = ~static_cast<uintptr_t>(15);
  if (span) {
    const uintptr_t lo = first & mask;
    const uintptr_t hi = (first + (rows - 1) * sb + row_bytes + 15) & mask;
    bar_expect(bar, static_cast<uint32_t>(hi - lo));
    bulk_load(dst, reinterpret_cast<const void*>(lo), static_cast<uint32_t>(hi - lo), bar);
  } else {
    uint32_t total = 0;
    for (int r = 0; r < rows; ++r) {
      const uintptr_t at = first + r * sb;
      total += static_cast<uint32_t>(((at + row_bytes + 15) & mask) - (at & mask));
    }
    bar_expect(bar, total);
    for (int r = 0; r < rows; ++r) {
      const uintptr_t at = first + r * sb;
      const uintptr_t lo = at & mask;
      bulk_load(dst + r * slot_bytes, reinterpret_cast<const void*>(lo),
                static_cast<uint32_t>(((at + row_bytes + 15) & mask) - lo), bar);
    }
  }
}

// Thread 0 starts the copies of this block's local tile i into stage
// i % stages (copy_rows: one copy of the tile's span in kBwdSpan, one a row
// in kBwdRows), completing on the stage's mbarrier.
template <typename T>
__device__ void issue_tile(const BwdArgs& a, unsigned char* stages, uint64_t* bars, int i,
                           int n_tiles, int row_bytes) {
  const int tile = blockIdx.x + i * gridDim.x;
  if (tile >= n_tiles) return;
  const int s = i % a.stages;
  const int64_t b0 = static_cast<int64_t>(tile) * a.rows_per_tile;
  const int rows = static_cast<int>(a.n_rows - b0 < a.rows_per_tile ? a.n_rows - b0
                                                                     : a.rows_per_tile);
  const int64_t sb = a.stride_b * static_cast<int64_t>(sizeof(T));
  // the stage's last reads (generic proxy) come before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  copy_rows(stages + s * a.stage_bytes, &bars[s], reinterpret_cast<uintptr_t>(a.v) + b0 * sb,
            rows, sb, row_bytes, a.mode == kBwdSpan, a.slot_bytes);
}

// dv = g * (S - v) on tiles of rows_per_tile rows staged in shared memory
// (see the header). V: elements a store writes (16 bytes, or 1); KV: K % V
// == 0, so a vector lies in one (row, field) run of K.
template <typename T, int V, bool KV>
__global__ void __launch_bounds__(kBwdThreads) fm_bwd_kernel(BwdArgs a) {
  const int tid = threadIdx.x;
  const int F = a.n_fields, K = a.k_dim;
  const T* v = static_cast<const T*>(a.v);
  T* dv = static_cast<T*>(a.dv);
  if (a.mode == kBwdDirect) {
    // a row wider than a stage: one thread a (row, k), S summed and dv
    // written straight from device memory, in the same order
    const int64_t n = static_cast<int64_t>(a.n_rows) * K;
    for (int64_t p = static_cast<int64_t>(blockIdx.x) * kBwdThreads + tid; p < n;
         p += static_cast<int64_t>(gridDim.x) * kBwdThreads) {
      const int64_t row = p / K;
      const int k = static_cast<int>(p - row * K);
      const T* base = v + row * a.stride_b + k;
      T* dst = dv + row * F * K + k;
      const float gb = a.g[row];
      float s = 0.0f;
      for (int f = 0; f < F; ++f) s += to_float(base[f * a.stride_f]);
      for (int f = 0; f < F; ++f) {
        dst[static_cast<int64_t>(f) * K] = from_float<T>(gb * (s - to_float(base[f * a.stride_f])));
      }
    }
    return;
  }
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stages = smem + kBwdBarrierBytes;
  float* s_sum = reinterpret_cast<float*>(stages + a.stages * a.stage_bytes);
  float* s_g = s_sum + a.rows_per_tile * K;
  constexpr int es = sizeof(T);
  const int tb = a.rows_per_tile;
  const int n_tiles = (a.n_rows + tb - 1) / tb;
  const int sf = static_cast<int>(a.stride_f) * es;  // bytes; a row fits a stage
  const int row_bytes = (F - 1) * sf + K * es;
  const int64_t sb = a.stride_b * es;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(&bars[s])),
                   "r"(1u)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < a.stages; ++i) issue_tile<T>(a, stages, bars, i, n_tiles, row_bytes);
  }
  // this thread's first output of a tile, and the step to its next one, as
  // (row, field, column): 32-bit divisions once, counters after
  int q = tid * V / K;
  const int k0 = tid * V - q * K, r0 = q / F, f0 = q - r0 * F;
  q = kBwdThreads * V / K;
  const int dk = kBwdThreads * V - q * K, dr = q / F, df = q - dr * F;

  for (int i = 0;; ++i) {
    const int tile = blockIdx.x + i * gridDim.x;
    if (tile >= n_tiles) break;
    const unsigned char* st = stages + (i % a.stages) * a.stage_bytes;
    const int64_t b0 = static_cast<int64_t>(tile) * tb;
    const int rows = static_cast<int>(a.n_rows - b0 < tb ? a.n_rows - b0 : tb);
    // the low bits of the tile's first address fix where each row landed
    const uint32_t first = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(v) + b0 * sb);
    const bool span = a.mode == kBwdSpan;
    auto row_at = [&](int r) -> const unsigned char* {
      return st + (span ? static_cast<int>(first & 15) + r * static_cast<int>(sb)
                        : r * a.slot_bytes +
                              static_cast<int>((first + static_cast<uint32_t>(r) *
                                                            static_cast<uint32_t>(sb)) & 15));
    };
    if (tid < rows) s_g[tid] = a.g[b0 + tid];
    bar_wait(&bars[i % a.stages], (i / a.stages) & 1);

    // phase 1: S[r, k] = sum_f v[r, f, k] in fp32, f in order
    const int n_sum = rows * K;
    for (int p0 = tid; p0 < n_sum; p0 += kBwdSums * kBwdThreads) {
      const unsigned char* src[kBwdSums];
      float acc[kBwdSums];
#pragma unroll
      for (int u = 0; u < kBwdSums; ++u) {
        const int p = min(p0 + u * kBwdThreads, n_sum - 1);
        const int r = p / K;
        src[u] = row_at(r) + (p - r * K) * es;
        acc[u] = 0.0f;
      }
#pragma unroll 8
      for (int f = 0; f < F; ++f) {
#pragma unroll
        for (int u = 0; u < kBwdSums; ++u) {
          acc[u] += to_float(*reinterpret_cast<const T*>(src[u] + f * sf));
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdSums; ++u) {
        if (p0 + u * kBwdThreads < n_sum) s_sum[p0 + u * kBwdThreads] = acc[u];
      }
    }
    __syncthreads();

    // phase 2: the tile's rows*F*K outputs, contiguous in dv, V at a time
    T* out = dv + b0 * F * K;
    const int n_out = rows * F * K;
    int r = r0, f = f0, k = k0;
#pragma unroll 2
    for (int e = tid * V; e < n_out; e += kBwdThreads * V) {
      float x[V];
      if constexpr (KV) {
        const T* src = reinterpret_cast<const T*>(row_at(r) + f * sf + k * es);
        const float* sr = s_sum + r * K + k;
        const float gb = s_g[r];
        float sv[V];
        if constexpr (V % 4 == 0) {
#pragma unroll
          for (int j = 0; j < V; j += 4) {
            const float4 s4 = *reinterpret_cast<const float4*>(sr + j);
            sv[j] = s4.x;
            sv[j + 1] = s4.y;
            sv[j + 2] = s4.z;
            sv[j + 3] = s4.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) sv[j] = sr[j];
        }
#pragma unroll
        for (int j = 0; j < V; ++j) x[j] = gb * (sv[j] - to_float(src[j]));
      } else {
        int rr = r, ff = f, kk = k;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          x[j] = 0.0f;
          if (e + j < n_out) {
            const T* src = reinterpret_cast<const T*>(row_at(rr) + ff * sf + kk * es);
            x[j] = s_g[rr] * (s_sum[rr * K + kk] - to_float(*src));
          }
          if (++kk == K) {
            kk = 0;
            if (++ff == F) {
              ff = 0;
              ++rr;
            }
          }
        }
      }
      if (e + V <= n_out) {
        store_vec<T, V>(out + e, x);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (e + j < n_out) out[e + j] = from_float<T>(x[j]);
        }
      }
      k += dk;
      if (k >= K) {
        k -= K;
        ++f;
      }
      f += df;
      if (f >= F) {
        f -= F;
        ++r;
      }
      r += dr;
    }
    __syncthreads();  // every read of this stage is done
    if (tid == 0) issue_tile<T>(a, stages, bars, i + a.stages, n_tiles, row_bytes);
  }
}

// --- the forward -------------------------------------------------------------

constexpr int kFwdThreads = 256;        // a block of the staged modes
constexpr int kFwdDirectThreads = 64;   // a block of the direct and vector modes
constexpr int kFwdBarrierBytes = 128;   // the stage's mbarrier, ahead of the stage
constexpr int kFwdSums = 4;    // independent (row, column) sums a thread carries
constexpr int kFwdGroup = 16;  // fields a lane loads before it adds them
enum FwdMode : int { kFwdSpan = 0, kFwdRows = 1, kFwdFields = 2, kFwdDirect = 3 };

struct FwdArgs {
  const void* v;
  void* out;
  int n_rows, n_fields, k_dim;
  long long stride_b, stride_f;  // elements
  int mode, rows_per_tile, stage_bytes, slot_bytes, group;
};

// Thread 0 starts the bulk copies of this block's local tile i into the
// stage (copy_rows: one copy of the tile's span, or one a row), which
// complete on the stage's mbarrier.
template <typename T>
__device__ void issue_fwd_tile(const FwdArgs& a, unsigned char* stage, uint64_t* bar, int i,
                               int n_tiles) {
  const int tile = blockIdx.x + i * gridDim.x;
  if (tile >= n_tiles) return;
  constexpr int es = sizeof(T);
  const int64_t b0 = static_cast<int64_t>(tile) * a.rows_per_tile;
  const int rows = static_cast<int>(a.n_rows - b0 < a.rows_per_tile ? a.n_rows - b0
                                                                     : a.rows_per_tile);
  const int64_t sb = a.stride_b * es;
  // the stage's last reads (generic proxy) come before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  copy_rows(stage, bar, reinterpret_cast<uintptr_t>(a.v) + b0 * sb, rows, sb,
            ((a.n_fields - 1) * static_cast<int>(a.stride_f) + a.k_dim) * es,
            a.mode == kFwdSpan, a.slot_bytes);
}

// Phase 1 for NC (row, column) pairs p, p + kFwdThreads, ... of a tile: S
// and Q over f in order from 0.0f, each product and sum rounded to fp32 (no
// fused multiply-add), and the term S*S - Q into terms[p]. row_off(r): where
// row r begins in shared memory; sf: bytes from a field to the next there.
template <typename T, int NC, typename RowOff>
__device__ __forceinline__ void fwd_terms(const unsigned char* smem, float* terms, int p, int K,
                                          int F, int sf, RowOff row_off) {
  constexpr int es = sizeof(T);
  int off[NC];
  float s[NC], q[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    const int pu = p + u * kFwdThreads;
    const int r = pu / K;
    off[u] = row_off(r) + (pu - r * K) * es;
    s[u] = 0.0f;
    q[u] = 0.0f;
  }
#pragma unroll 8
  for (int f = 0; f < F; ++f) {
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const float x = to_float(*reinterpret_cast<const T*>(smem + off[u] + f * sf));
      s[u] = __fadd_rn(s[u], x);
      q[u] = __fadd_rn(q[u], __fmul_rn(x, x));
    }
  }
#pragma unroll
  for (int u = 0; u < NC; ++u) terms[p + u * kFwdThreads] = __fsub_rn(__fmul_rn(s[u], s[u]), q[u]);
}

// The staged modes: block j takes tiles j, j + gridDim.x, ... of
// rows_per_tile rows, each copied into its stage in shared memory
// (copy_rows) once the last one's terms are formed; phase 1 forms each (row,
// column) term from shared memory, phase 2 sums a row's terms (see the
// header for the order).
template <typename T, typename TOut>
__global__ void __launch_bounds__(kFwdThreads) fm_fwd_kernel(FwdArgs a) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int F = a.n_fields, K = a.k_dim;
  constexpr int es = sizeof(T);
  TOut* out = static_cast<TOut*>(a.out);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stage = smem + kFwdBarrierBytes;
  float* terms = reinterpret_cast<float*>(stage + a.stage_bytes);  // [rows][K]
  const int tb = a.rows_per_tile;
  const int n_tiles = (a.n_rows + tb - 1) / tb;
  const int64_t sb = a.stride_b * es;
  const int sf = static_cast<int>(a.stride_f) * es;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(1u)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    issue_fwd_tile<T>(a, stage, bar, 0, n_tiles);
  }
  __syncthreads();  // the mbarrier is initialised before any thread waits on it

  for (int i = 0;; ++i) {
    const int tile = blockIdx.x + i * gridDim.x;
    if (tile >= n_tiles) break;
    const int64_t b0 = static_cast<int64_t>(tile) * tb;
    const int rows = static_cast<int>(a.n_rows - b0 < tb ? a.n_rows - b0 : tb);
    // the low bits of the tile's first address fix where a widened window put
    // each row
    const uint32_t first = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(a.v) + b0 * sb);
    auto row_off = [&](int r) -> int {
      if (a.mode == kFwdSpan) {
        return kFwdBarrierBytes + static_cast<int>(first & 15) + r * static_cast<int>(sb);
      }
      return kFwdBarrierBytes + r * a.slot_bytes +
             static_cast<int>((first + static_cast<uint32_t>(r) * static_cast<uint32_t>(sb)) & 15);
    };
    bar_wait(bar, i & 1);

    // phase 1: each (row, column) term; a thread takes the pairs tid, tid +
    // kFwdThreads, ..., up to kFwdSums at once
    const int n_sum = rows * K;
    int p = tid;
    int left = n_sum > tid ? (n_sum - tid + kFwdThreads - 1) / kFwdThreads : 0;
    for (; left >= kFwdSums; left -= kFwdSums, p += kFwdSums * kFwdThreads) {
      fwd_terms<T, kFwdSums>(smem, terms, p, K, F, sf, row_off);
    }
    if (left == 3) fwd_terms<T, 3>(smem, terms, p, K, F, sf, row_off);
    if (left == 2) fwd_terms<T, 2>(smem, terms, p, K, F, sf, row_off);
    if (left == 1) fwd_terms<T, 1>(smem, terms, p, K, F, sf, row_off);
    __syncthreads();  // every read of this stage is done, every term written
    if (tid == 0) issue_fwd_tile<T>(a, stage, bar, i + 1, n_tiles);

    // phase 2: a warp a row; lane j adds the terms k = j, j + 32, ... in
    // order from 0.0f, then xor shuffles over 16, 8, 4, 2, 1 lanes; one
    // rounding to out's type
    for (int r = warp; r < rows; r += kFwdThreads / 32) {
      float sum = 0.0f;
      for (int k = lane; k < K; k += 32) sum = __fadd_rn(sum, terms[r * K + k]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      }
      if (lane == 0) out[b0 + r] = from_float<TOut>(0.5f * sum);
    }
    __syncthreads();  // every term is read before the next tile's are written
  }
}

// The "fields" mode: every (row, field) run of K values starts on 16 bytes,
// so v is read straight from device memory in 16-byte vectors of V = 16 /
// sizeof(T) columns, and no pad is read. `group` lanes take a row (K / V
// rounded up to a power of two, at least C = 32 / V); lane i takes vector i,
// its kFwdGroup fields loaded before any is added. The sum over k keeps the
// staged modes' order: the partial of warp lane j = V*c + e (c < C) is the
// terms k = j, j + 32, ... in order, which are element e of the vectors c, c
// + C, c + 2C, ..., so lane c adds them in that order by shuffles; the xor
// shuffles over 16 ... V lanes become shuffles over lanes c ^ (off / V), and
// those over V/2 ... 1 adds of elements e and e ^ off within a lane.
template <typename T, typename TOut>
__global__ void __launch_bounds__(kFwdDirectThreads) fm_fwd_vec_kernel(FwdArgs a) {
  constexpr int V = 16 / sizeof(T);
  constexpr int C = 32 / V;
  const int tid = threadIdx.x, lane = tid & 31;
  const int F = a.n_fields, K = a.k_dim;
  TOut* out = static_cast<TOut*>(a.out);
  const int group = a.group;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + tid) / group;
  const int i = lane & (group - 1);
  float d[V];
#pragma unroll
  for (int e = 0; e < V; ++e) d[e] = 0.0f;
  if (row < a.n_rows && i * V < K) {
    const T* base = static_cast<const T*>(a.v) + row * a.stride_b + i * V;
    float s[V], q[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s[e] = 0.0f;
      q[e] = 0.0f;
    }
    for (int f0 = 0; f0 < F; f0 += kFwdGroup) {
      uint4 raw[kFwdGroup];
#pragma unroll
      for (int g = 0; g < kFwdGroup; ++g) {
        if (f0 + g < F) raw[g] = __ldg(reinterpret_cast<const uint4*>(base + (f0 + g) * a.stride_f));
      }
#pragma unroll
      for (int g = 0; g < kFwdGroup; ++g) {
        if (f0 + g < F) {
          const T* x = reinterpret_cast<const T*>(&raw[g]);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float xe = to_float(x[e]);
            s[e] = __fadd_rn(s[e], xe);
            q[e] = __fadd_rn(q[e], __fmul_rn(xe, xe));
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) d[e] = __fsub_rn(__fmul_rn(s[e], s[e]), q[e]);
  }
  // the partials: lane c < C adds the terms of lanes c, c + C, ... in order
  const int first = lane - i;  // the row's first lane
  float p[V];
#pragma unroll
  for (int e = 0; e < V; ++e) p[e] = __fadd_rn(0.0f, d[e]);
  for (int m = C; m < group; m += C) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      p[e] = __fadd_rn(p[e], __shfl_sync(0xffffffffu, d[e], first + ((i + m) & (group - 1))));
    }
  }
#pragma unroll
  for (int off = 16; off >= V; off >>= 1) {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = __fadd_rn(p[e], __shfl_xor_sync(0xffffffffu, p[e], off / V));
  }
#pragma unroll
  for (int off = V / 2; off > 0; off >>= 1) {
    float t[V];
#pragma unroll
    for (int e = 0; e < V; ++e) t[e] = __fadd_rn(p[e], p[e ^ off]);
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = t[e];
  }
  if (row < a.n_rows && i == 0) out[row] = from_float<TOut>(0.5f * p[0]);
}

// The direct mode (a row wider than any stage, or no fields or columns): v
// read straight from device memory, `group` lanes a row (a warp from K = 17
// on), lane j taking the columns k = j, j + group, ... two at a time, each
// pair's kFwdGroup fields loaded before any is added. The same order of sums
// (a group's xor shuffles are the warp's with the lanes past K adding zero).
template <typename T, typename TOut>
__global__ void __launch_bounds__(kFwdDirectThreads) fm_fwd_direct_kernel(FwdArgs a) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int F = a.n_fields, K = a.k_dim;
  TOut* out = static_cast<TOut*>(a.out);
  const int group = a.group;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + tid) / group;
  const int j = lane & (group - 1);
  float p = 0.0f;
  if (row < a.n_rows) {
    const T* base = static_cast<const T*>(a.v) + row * a.stride_b;
    for (int k = j; k < K; k += 2 * group) {
      const bool two = k + group < K;
      float s0 = 0.0f, q0 = 0.0f, s1 = 0.0f, q1 = 0.0f;
      for (int f0 = 0; f0 < F; f0 += kFwdGroup) {
        T x0[kFwdGroup], x1[kFwdGroup];
#pragma unroll
        for (int g = 0; g < kFwdGroup; ++g) {
          const T* at = base + (f0 + g) * a.stride_f + k;
          if (f0 + g < F) x0[g] = *at;
          if (f0 + g < F && two) x1[g] = at[group];
        }
#pragma unroll
        for (int g = 0; g < kFwdGroup; ++g) {
          if (f0 + g < F) {
            const float x = to_float(x0[g]);
            s0 = __fadd_rn(s0, x);
            q0 = __fadd_rn(q0, __fmul_rn(x, x));
            if (two) {
              const float y = to_float(x1[g]);
              s1 = __fadd_rn(s1, y);
              q1 = __fadd_rn(q1, __fmul_rn(y, y));
            }
          }
        }
      }
      p = __fadd_rn(p, __fsub_rn(__fmul_rn(s0, s0), q0));
      if (two) p = __fadd_rn(p, __fsub_rn(__fmul_rn(s1, s1), q1));
    }
  }
  // every lane of the warp takes part, rows past n_rows with p = 0
  for (int off = group >> 1; off > 0; off >>= 1) {
    p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
  }
  if (row < a.n_rows && j == 0) out[row] = from_float<TOut>(0.5f * p);
}

template <typename T, int V>
__global__ void fm_flat_fwd_kernel(const T* __restrict__ v2, float* __restrict__ out,
                                   T* __restrict__ s_out, int n_rows, int n_fields,
                                   int k_dim, int64_t stride_b, int group) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int row = warp * (32 / group) + lane / group;
  const int j = lane & (group - 1);
  float sum_s2 = 0.0f;
  float sum_q = 0.0f;
  if (row < n_rows) {
    const T* base = v2 + static_cast<int64_t>(row) * stride_b;
    T* s_row = s_out + static_cast<int64_t>(row) * k_dim;
    for (int k = j * V; k < k_dim; k += group * V) {
      float s[V];
#pragma unroll
      for (int i = 0; i < V; ++i) s[i] = 0.0f;
#pragma unroll 4
      for (int f = 0; f < n_fields; ++f) {
        float x[V];
        load_vec<T, V>(base + static_cast<int64_t>(f) * k_dim + k, x);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += x[i];
          sum_q += x[i] * x[i];
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) sum_s2 += s[i] * s[i];
      store_vec<T, V>(s_row + k, s);
    }
  }
  // every lane of the warp takes part, rows past n_rows with zeros
  for (int off = group >> 1; off > 0; off >>= 1) {
    sum_s2 += __shfl_xor_sync(0xffffffffu, sum_s2, off);
    sum_q += __shfl_xor_sync(0xffffffffu, sum_q, off);
  }
  if (row < n_rows && j == 0) out[row] = 0.5f * (sum_s2 - sum_q);
}

template <typename T, int V>
__global__ void fm_flat_bwd_kernel(const T* __restrict__ v2, const T* __restrict__ s_in,
                                   const float* __restrict__ g, T* __restrict__ dv,
                                   int n_rows, int n_fields, int k_dim, int64_t stride_b,
                                   int group) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int row = warp * (32 / group) + lane / group;
  const int j = lane & (group - 1);
  if (row >= n_rows) return;  // no shuffles below: idle lanes may leave
  const T* base = v2 + static_cast<int64_t>(row) * stride_b;
  T* dst = dv + static_cast<int64_t>(row) * n_fields * k_dim;
  const float gb = g[row];
  for (int k = j * V; k < k_dim; k += group * V) {
    float s[V];
    load_vec<T, V>(s_in + static_cast<int64_t>(row) * k_dim + k, s);
#pragma unroll 4
    for (int f = 0; f < n_fields; ++f) {
      float x[V];
      load_vec<T, V>(base + static_cast<int64_t>(f) * k_dim + k, x);
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = gb * (s[i] - x[i]);
      store_vec<T, V>(dst + static_cast<int64_t>(f) * k_dim + k, x);
    }
  }
}

constexpr int kThreads = 256;

bool bad_group(int group) { return group < 1 || group > 32 || (group & (group - 1)) != 0; }

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      count = 132;
    }
  }
  return count;
}

// A persistent grid for the staged modes: as many blocks as fit on the
// card at once (the plan sizes a block for two an SM), at most one a tile.
template <typename T, int V, bool KV>
int launch_bwd(const BwdArgs& a, int smem, cudaStream_t stream) {
  auto kernel = fm_bwd_kernel<T, V, KV>;
  int blocks;
  if (a.mode == kBwdDirect) {
    smem = 0;
    const int64_t n = static_cast<int64_t>(a.n_rows) * a.k_dim;
    blocks = static_cast<int>(std::min<int64_t>((n + kBwdThreads - 1) / kBwdThreads,
                                                static_cast<int64_t>(sm_count()) * 8));
  } else {
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    int per_sm = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBwdThreads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_tiles = (a.n_rows + a.rows_per_tile - 1) / a.rows_per_tile;
    blocks = std::min(n_tiles, std::max(per_sm, 1) * sm_count());
  }
  kernel<<<blocks, kBwdThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The grid is the plan's: in the staged modes block j takes tiles j, j +
// blocks, ...; in the others a block takes kFwdDirectThreads / group rows.
template <typename T, typename TOut>
int launch_fwd(const FwdArgs& a, int smem, int blocks, cudaStream_t stream) {
  if (a.mode == kFwdFields) {
    fm_fwd_vec_kernel<T, TOut><<<blocks, kFwdDirectThreads, 0, stream>>>(a);
  } else if (a.mode == kFwdDirect) {
    fm_fwd_direct_kernel<T, TOut><<<blocks, kFwdDirectThreads, 0, stream>>>(a);
  } else {
    auto kernel = fm_fwd_kernel<T, TOut>;
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<blocks, kFwdThreads, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

int flat_blocks(int n_rows, int group) {
  const int rows_per_block = (kThreads / 32) * (32 / group);
  return (n_rows + rows_per_block - 1) / rows_per_block;
}

}  // namespace

// v: [n_rows, n_fields, k_dim] with strides (stride_b, stride_f, 1) in
// elements; out: [n_rows] contiguous, in v's type, or fp32 when out_is_f32.
// is_bf16 selects bf16 over fp32 for v. The tile plan comes from
// rectpu_torch/ops/fm.py (fm_fwd_plan): mode 0 copies each tile's span of
// rows_per_tile rows in one bulk copy, mode 1 each row in its own (rows
// slot_bytes apart), into a stage of stage_bytes; smem_bytes the block's
// dynamic shared memory. Mode 2 reads 16-byte vectors
// straight from device memory (v, both strides and a run of k_dim values
// 16-byte multiples), mode 3 single values, `group` lanes a row. `blocks`:
// the grid. Returns a cudaError_t as int (0 = ok).
extern "C" int rectpu_fm_cross(const void* v, void* out, int n_rows, int n_fields, int k_dim,
                               long long stride_b, long long stride_f, int is_bf16,
                               int out_is_f32, int mode, int rows_per_tile, int stage_bytes,
                               int slot_bytes, int smem_bytes, int group, int blocks,
                               void* stream) {
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  const long long es = is_bf16 ? 2 : 4;
  const long long row_bytes = ((n_fields - 1) * stride_f + k_dim) * es;
  const long long r = rows_per_tile;
  const long long rows_per_block = bad_group(group) ? 0 : kFwdDirectThreads / group;
  bool ok = false;
  if (mode == kFwdDirect) {
    ok = rows_per_block > 0 && blocks * rows_per_block >= n_rows;
  } else if (mode == kFwdFields) {
    ok = rows_per_block > 0 && blocks * rows_per_block >= n_rows &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0 && (k_dim * es) % 16 == 0 &&
         (stride_f * es) % 16 == 0 && (n_rows == 1 || (stride_b * es) % 16 == 0) &&
         group >= 32 / (16 / es) && group * (16 / es) >= k_dim;
  } else if (n_fields >= 1 && k_dim >= 1 && rows_per_tile >= 1 && blocks >= 1 &&
             stage_bytes % 16 == 0 && slot_bytes % 16 == 0 &&
             smem_bytes >= kFwdBarrierBytes + stage_bytes + 4 * rows_per_tile * k_dim) {
    if (mode == kFwdSpan) {
      ok = stride_b == n_fields * stride_f && stride_f >= k_dim &&
           (r - 1) * stride_b * es + row_bytes + 15 <= stage_bytes;
    } else if (mode == kFwdRows) {
      ok = row_bytes + 15 <= slot_bytes && r * slot_bytes <= stage_bytes;
    }
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{v,    out,           n_rows,      n_fields,   k_dim, stride_b,
                  stride_f, mode, rows_per_tile, stage_bytes, slot_bytes, group};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch_fwd<float, float>(a, smem_bytes, blocks, s);
  return out_is_f32 ? launch_fwd<__nv_bfloat16, float>(a, smem_bytes, blocks, s)
                    : launch_fwd<__nv_bfloat16, __nv_bfloat16>(a, smem_bytes, blocks, s);
}

// v: [n_rows, n_fields, k_dim] with strides (stride_b, stride_f, 1) in
// elements; g: [n_rows] fp32 contiguous; dv: [n_rows, n_fields, k_dim]
// contiguous, 16-byte aligned, in v's type (is_bf16). The tile plan comes
// from rectpu_torch/ops/fm.py (fm_bwd_plan): mode 0 copies each tile's span
// of rows_per_tile rows in one bulk copy, mode 1 each row in its own (rows
// slot_bytes apart), mode 2 stages nothing; stages of stage_bytes bytes;
// smem_bytes the block's dynamic shared memory; vec 1 for 16-byte stores
// (rows_per_tile * n_fields * k_dim elements are then 16 bytes a multiple).
// Returns a cudaError_t as int (0 = ok).
extern "C" int rectpu_fm_cross_bwd(const void* v, const void* g, void* dv, int n_rows,
                                   int n_fields, int k_dim, long long stride_b,
                                   long long stride_f, int is_bf16, int mode,
                                   int rows_per_tile, int stages, int stage_bytes,
                                   int slot_bytes, int smem_bytes, int vec, void* stream) {
  if (n_rows == 0 || n_fields == 0 || k_dim == 0) return static_cast<int>(cudaSuccess);
  const bool staged = mode == kBwdSpan || mode == kBwdRows;
  if ((!staged && mode != kBwdDirect) ||
      (staged && (rows_per_tile < 1 || rows_per_tile > kBwdThreads || stages < 1 ||
                  stages > kBwdMaxStages || stage_bytes % 16 != 0 || slot_bytes % 16 != 0 ||
                  smem_bytes < kBwdBarrierBytes + stages * stage_bytes +
                                   4 * rows_per_tile * (k_dim + 1))) ||
      (vec && reinterpret_cast<uintptr_t>(dv) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a{v,        static_cast<const float*>(g), dv, n_rows, n_fields, k_dim,
                  stride_b, stride_f, mode, rows_per_tile, stages, stage_bytes, slot_bytes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (!vec) return launch_bwd<__nv_bfloat16, 1, true>(a, smem_bytes, s);
    return k_dim % 8 == 0 ? launch_bwd<__nv_bfloat16, 8, true>(a, smem_bytes, s)
                          : launch_bwd<__nv_bfloat16, 8, false>(a, smem_bytes, s);
  }
  if (!vec) return launch_bwd<float, 1, true>(a, smem_bytes, s);
  return k_dim % 4 == 0 ? launch_bwd<float, 4, true>(a, smem_bytes, s)
                        : launch_bwd<float, 4, false>(a, smem_bytes, s);
}

// v2: [n_rows, n_fields * k_dim] with row stride stride_b (elements) and
// innermost stride 1; out: [n_rows] fp32; s: [n_rows, k_dim] contiguous, in
// v2's type. is_bf16 selects bf16 over fp32. vec: 1 for 16-byte vectors (the
// caller checked k_dim, stride_b and the pointers for them), 0 for scalar
// loads. group: lanes per row, a power of two in [1, 32], covering the
// k_dim / V vectors of a row. Returns a cudaError_t as int (0 = ok).
extern "C" int rectpu_fm_cross_flat(const void* v2, void* out, void* s, int n_rows,
                                    int n_fields, int k_dim, long long stride_b, int group,
                                    int is_bf16, int vec, void* stream) {
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  if (bad_group(group)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = flat_blocks(n_rows, group);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (is_bf16) {
    const auto* x = static_cast<const __nv_bfloat16*>(v2);
    auto* sv = static_cast<__nv_bfloat16*>(s);
    if (vec) {
      fm_flat_fwd_kernel<__nv_bfloat16, 8><<<blocks, kThreads, 0, st>>>(
          x, o, sv, n_rows, n_fields, k_dim, stride_b, group);
    } else {
      fm_flat_fwd_kernel<__nv_bfloat16, 1><<<blocks, kThreads, 0, st>>>(
          x, o, sv, n_rows, n_fields, k_dim, stride_b, group);
    }
  } else {
    const auto* x = static_cast<const float*>(v2);
    auto* sv = static_cast<float*>(s);
    if (vec) {
      fm_flat_fwd_kernel<float, 4><<<blocks, kThreads, 0, st>>>(
          x, o, sv, n_rows, n_fields, k_dim, stride_b, group);
    } else {
      fm_flat_fwd_kernel<float, 1><<<blocks, kThreads, 0, st>>>(
          x, o, sv, n_rows, n_fields, k_dim, stride_b, group);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// v2 and s as for rectpu_fm_cross_flat (s as the forward stored it); g:
// [n_rows] fp32 contiguous; dv: [n_rows, n_fields * k_dim] contiguous, in
// v2's type. Returns a cudaError_t as int.
extern "C" int rectpu_fm_cross_flat_bwd(const void* v2, const void* s, const void* g,
                                        void* dv, int n_rows, int n_fields, int k_dim,
                                        long long stride_b, int group, int is_bf16, int vec,
                                        void* stream) {
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  if (bad_group(group)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = flat_blocks(n_rows, group);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  if (is_bf16) {
    const auto* x = static_cast<const __nv_bfloat16*>(v2);
    const auto* sv = static_cast<const __nv_bfloat16*>(s);
    auto* d = static_cast<__nv_bfloat16*>(dv);
    if (vec) {
      fm_flat_bwd_kernel<__nv_bfloat16, 8><<<blocks, kThreads, 0, st>>>(
          x, sv, gf, d, n_rows, n_fields, k_dim, stride_b, group);
    } else {
      fm_flat_bwd_kernel<__nv_bfloat16, 1><<<blocks, kThreads, 0, st>>>(
          x, sv, gf, d, n_rows, n_fields, k_dim, stride_b, group);
    }
  } else {
    const auto* x = static_cast<const float*>(v2);
    const auto* sv = static_cast<const float*>(s);
    auto* d = static_cast<float*>(dv);
    if (vec) {
      fm_flat_bwd_kernel<float, 4><<<blocks, kThreads, 0, st>>>(
          x, sv, gf, d, n_rows, n_fields, k_dim, stride_b, group);
    } else {
      fm_flat_bwd_kernel<float, 1><<<blocks, kThreads, 0, st>>>(
          x, sv, gf, d, n_rows, n_fields, k_dim, stride_b, group);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
