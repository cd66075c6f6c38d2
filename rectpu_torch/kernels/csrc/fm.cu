// Factorization-machine second-order logit for Hopper (sm_90a):
//   out[b] = 0.5 * sum_k((sum_f v[b,f,k])^2 - sum_f v[b,f,k]^2)
//
// Replaces rectpu/ops/fm.py::_fm_fwd_kernel (:271), run by fm_cross_pallas
// (:353) for exports trained with --fm-impl pallas; in the port every fm_impl
// value routes here on the card. As on the TPU, the sums are taken in fp32
// whatever v's type, and the result is written in v's type (fm.py:297): a
// bf16 FM logit is rounded to bf16 before the model casts it to fp32
// (models/deep_fm.py:212), and the port keeps that rounding.
//
// What bounds it on this card: bytes. It reads B*F*K values once and writes
// B; the arithmetic (three flops per value) is far below the card's rate.
// At B=4096, F=26, K=64 that is 6.8 MB in bf16.
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
// 8 * (32 / G) rows.
//
// Layout: v arrives as a STRIDED view. On the serving path it is
// looked[..., :K] of the [B, F, K+1] fused gather (the last column is the
// linear weight), so the wrapper passes the batch and field strides and
// requires only the innermost stride to be 1; no contiguous copy is made.
// With numeric fields the model concatenates them first, and the
// concatenation is contiguous, which is the same case with stride_f = K.

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

template <typename T>
__global__ void fm_fwd_kernel(const T* __restrict__ v, T* __restrict__ out,
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
  if (row < n_rows && k0 == 0) out[row] = from_float<T>(0.5f * acc);
}

constexpr int kThreads = 256;

}  // namespace

// v: [n_rows, n_fields, k_dim] with strides (stride_b, stride_f, 1) in
// elements; out: [n_rows] contiguous, same type. is_bf16 selects bf16 over
// fp32. group: lanes per row, a power of two in [1, 32]. Returns a
// cudaError_t as int (0 = ok).
extern "C" int rectpu_fm_cross(const void* v, void* out, int n_rows, int n_fields,
                               int k_dim, long long stride_b, long long stride_f,
                               int group, int is_bf16, void* stream) {
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  if (group < 1 || group > 32 || (group & (group - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows_per_block = (kThreads / 32) * (32 / group);
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    fm_fwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        n_rows, n_fields, k_dim, stride_b, stride_f, group);
  } else {
    fm_fwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(v), static_cast<float*>(out), n_rows, n_fields,
        k_dim, stride_b, stride_f, group);
  }
  return static_cast<int>(cudaGetLastError());
}
