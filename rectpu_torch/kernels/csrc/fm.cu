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
// and writes B; the backward reads them (twice, the second time from L1/L2)
// and writes B*F*K. The arithmetic (three flops per value) is far below the
// card's rate. At B=4096, F=26, K=64 that is 6.8 MB in bf16 for the forward
// and 13.6 MB for the backward.
//
// Design: the TPU kernel reduced a [TB, F, K] block held in VMEM, with K on
// the 128 lanes. Here a group of G lanes (G a power of two <= 32, G >= K
// when K is small, chosen by the wrapper) owns one batch row: lane j of the
// group takes columns k = j, j+G, ..., and for each one loops over the F
// fields, accumulating S = sum_f v and Q = sum_f v^2 in fp32 registers; it
// then adds S*S - Q to a per-lane partial. A warp-shuffle (xor) reduction
// within the group sums the partials over k, and the group's first lane
// writes the row. At K=64 a warp owns one row and each field's 64 values
// are two coalesced loads; at K=4 a warp packs 8 rows, so narrow embeddings
// do not leave 28 of 32 lanes idle. Each block of 8 warps takes a tile of
// 8 * (32 / G) rows. The backward keeps the same lane grouping and field
// order for S, then walks the fields again and writes each dv value; the
// stores of a warp land on neighbouring columns of one field (coalesced).
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

template <typename T>
__global__ void fm_bwd_kernel(const T* __restrict__ v, const float* __restrict__ g,
                              T* __restrict__ dv, int n_rows, int n_fields, int k_dim,
                              int64_t stride_b, int64_t stride_f, int group) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int row = warp * (32 / group) + lane / group;
  const int k0 = lane & (group - 1);
  if (row >= n_rows) return;  // no shuffles below: idle lanes may leave
  const T* base = v + static_cast<int64_t>(row) * stride_b;
  T* dst = dv + static_cast<int64_t>(row) * n_fields * k_dim;
  const float gb = g[row];
  for (int k = k0; k < k_dim; k += group) {
    float s = 0.0f;
#pragma unroll 4
    for (int f = 0; f < n_fields; ++f) s += to_float(base[static_cast<int64_t>(f) * stride_f + k]);
#pragma unroll 4
    for (int f = 0; f < n_fields; ++f) {
      const float x = to_float(base[static_cast<int64_t>(f) * stride_f + k]);
      dst[static_cast<int64_t>(f) * k_dim + k] = from_float<T>(gb * (s - x));
    }
  }
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

// v as for rectpu_fm_cross; g: [n_rows] fp32 contiguous; dv: [n_rows,
// n_fields, k_dim] contiguous, in v's type. Returns a cudaError_t as int.
extern "C" int rectpu_fm_cross_bwd(const void* v, const void* g, void* dv, int n_rows,
                                   int n_fields, int k_dim, long long stride_b,
                                   long long stride_f, int group, int is_bf16,
                                   void* stream) {
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  if (group < 1 || group > 32 || (group & (group - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows_per_block = (kThreads / 32) * (32 / group);
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  if (is_bf16) {
    fm_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(v), gf, static_cast<__nv_bfloat16*>(dv), n_rows,
        n_fields, k_dim, stride_b, stride_f, group);
  } else {
    fm_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(v), gf, static_cast<float*>(dv), n_rows, n_fields, k_dim,
        stride_b, stride_f, group);
  }
  return static_cast<int>(cudaGetLastError());
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
