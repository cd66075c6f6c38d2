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
// Forward design: the TPU kernel reduced a [TB, F, K] block held in VMEM,
// with K on the 128 lanes. Here a group of G lanes (G a power of two <= 32,
// G >= K when K is small, chosen by the wrapper) owns one batch row: lane j
// of the group takes columns k = j, j+G, ..., and for each one loops over
// the F fields, accumulating S = sum_f v and Q = sum_f v^2 in fp32
// registers; it then adds S*S - Q to a per-lane partial. A warp-shuffle
// (xor) reduction within the group sums the partials over k, and the
// group's first lane writes the row. At K=64 a warp owns one row; at K=4 a
// warp packs 8 rows. Each block of 8 warps takes 8 * (32 / G) rows.
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
// Design: one group of G lanes per batch row, as above, but each lane owns
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

template <typename T, typename TOut>
__global__ void fm_fwd_kernel(const T* __restrict__ v, TOut* __restrict__ out,
                              int n_rows, int n_fields, int k_dim,
                              int64_t stride_b, int64_t stride_f, int group) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int row = warp * (32 / group) + lane / group;
  const int k0 = lane & (group - 1);
  float acc = 0.0f;
  if (row < n_rows) {
    const T* base = v + static_cast<int64_t>(row) * stride_b;
    for (int k = k0; k < k_dim; k += group) {
      float s = 0.0f;
      float q = 0.0f;
#pragma unroll 4
      for (int f = 0; f < n_fields; ++f) {
        const float x = to_float(base[static_cast<int64_t>(f) * stride_f + k]);
        s += x;
        q += x * x;
      }
      acc += s * s - q;
    }
  }
  // every lane of the warp takes part, rows past n_rows with acc = 0
  for (int off = group >> 1; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (row < n_rows && k0 == 0) out[row] = from_float<TOut>(0.5f * acc);
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

// Thread 0 starts the copies of this block's local tile i into stage
// i % stages: one copy of the tile's whole span (kBwdSpan) or one a row
// (kBwdRows), each window widened down and up to 16-byte boundaries (see the
// header), all completing on the stage's mbarrier.
template <typename T>
__device__ void issue_tile(const BwdArgs& a, unsigned char* stages, uint64_t* bars, int i,
                           int n_tiles, int row_bytes) {
  const int tile = blockIdx.x + i * gridDim.x;
  if (tile >= n_tiles) return;
  const int s = i % a.stages;
  unsigned char* dst = stages + s * a.stage_bytes;
  const int64_t b0 = static_cast<int64_t>(tile) * a.rows_per_tile;
  const int rows = static_cast<int>(a.n_rows - b0 < a.rows_per_tile ? a.n_rows - b0
                                                                     : a.rows_per_tile);
  const int64_t sb = a.stride_b * static_cast<int64_t>(sizeof(T));
  const uintptr_t first = reinterpret_cast<uintptr_t>(a.v) + b0 * sb;
  const uintptr_t mask = ~static_cast<uintptr_t>(15);
  // the stage's last reads (generic proxy) come before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (a.mode == kBwdSpan) {
    const uintptr_t lo = first & mask;
    const uintptr_t hi = (first + (rows - 1) * sb + row_bytes + 15) & mask;
    bar_expect(&bars[s], static_cast<uint32_t>(hi - lo));
    bulk_load(dst, reinterpret_cast<const void*>(lo), static_cast<uint32_t>(hi - lo), &bars[s]);
  } else {
    uint32_t total = 0;
    for (int r = 0; r < rows; ++r) {
      const uintptr_t at = first + r * sb;
      total += static_cast<uint32_t>(((at + row_bytes + 15) & mask) - (at & mask));
    }
    bar_expect(&bars[s], total);
    for (int r = 0; r < rows; ++r) {
      const uintptr_t at = first + r * sb;
      const uintptr_t lo = at & mask;
      bulk_load(dst + r * a.slot_bytes, reinterpret_cast<const void*>(lo),
                static_cast<uint32_t>(((at + row_bytes + 15) & mask) - lo), &bars[s]);
    }
  }
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

int flat_blocks(int n_rows, int group) {
  const int rows_per_block = (kThreads / 32) * (32 / group);
  return (n_rows + rows_per_block - 1) / rows_per_block;
}

}  // namespace

// v: [n_rows, n_fields, k_dim] with strides (stride_b, stride_f, 1) in
// elements; out: [n_rows] contiguous, in v's type, or fp32 when out_is_f32.
// is_bf16 selects bf16 over fp32 for v. group: lanes per row, a power of two
// in [1, 32]. Returns a cudaError_t as int (0 = ok).
extern "C" int rectpu_fm_cross(const void* v, void* out, int n_rows, int n_fields,
                               int k_dim, long long stride_b, long long stride_f,
                               int group, int is_bf16, int out_is_f32, void* stream) {
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  if (group < 1 || group > 32 || (group & (group - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows_per_block = (kThreads / 32) * (32 / group);
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && !out_is_f32) {
    fm_fwd_kernel<__nv_bfloat16, __nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        n_rows, n_fields, k_dim, stride_b, stride_f, group);
  } else if (is_bf16) {
    fm_fwd_kernel<__nv_bfloat16, float><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), n_rows, n_fields,
        k_dim, stride_b, stride_f, group);
  } else {
    fm_fwd_kernel<float, float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(v), static_cast<float*>(out), n_rows, n_fields,
        k_dim, stride_b, stride_f, group);
  }
  return static_cast<int>(cudaGetLastError());
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
