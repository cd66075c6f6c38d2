// DLRM pairwise-dot interaction for Hopper (sm_90a):
//   out[b, p] = sum_k v[b, i_p, k] * v[b, j_p, k],   v = flat[b].reshape(n, K)
// over the upper triangle (i_p, j_p) of the n x n dot matrix in np.triu_indices
// order, the diagonal included only for arch_interaction_itself. The sums are
// fp32 and the output is [B, P] fp32 whatever the input type.
//
// Replaces two TPU kernels that compute this function:
//   - rectpu/ops/interaction.py::_fwd_kernel (:55), interact_pallas's "vpu"
//     variant: each product exact in fp32 (the input is widened first);
//   - ::_fwd_kernel_mxu (:77), the "mxu" variant: each product is rounded to
//     the input's type (:87, :98) before the fp32 block-ones reduction on the
//     matrix unit. The round_products flag selects these numerics; for an fp32
//     input it only keeps nvcc from fusing the product into the sum.
// On the TPU the pairs were grouped by left field so that one widened multiply
// fed many lane reductions, and the batch was padded to 256-row blocks and the
// output to 128 lanes for VMEM. None of that carries over: rows are not padded,
// the output is written at its real width P.
//
// What bounds it on this card: bytes. It reads B*n*K input values once and
// writes B*P fp32 outputs; the arithmetic is K multiply-adds per output. At
// the DLRM shape (B=8192, n=26, K=64, bf16, P=325) that is 27.3 MB read and
// 10.6 MB written, 0.011 ms at 3.35 TB/s, against 0.35 GFLOP.
//
// Design: a block of 256 threads takes a few rows (as many as fit 48 KB of
// shared memory, at most 8). It stages each row's n vectors in shared memory
// as fp32 with a row stride of K+1 (odd), so that the 32 lanes of a warp,
// which take 32 neighbouring pairs and hence mostly one left vector i and 32
// different right vectors j, read 32 different banks (the left vector is a
// broadcast). Each thread then walks the (row, pair) items of the block, one
// K-long dot product each, and writes its output; neighbouring threads write
// neighbouring outputs of a row (coalesced). The pair list (i << 16 | j) comes
// from the wrapper, built once per (n, itself). The staging loads are
// coalesced reads of the contiguous [rows, n*K] slab, which is what lets a
// numeric vector appended by the model (n = F+1) cost nothing extra.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowsPerBlock = 8;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// one product with the rounding of the "mxu" variant: to the input's type
template <typename T>
__device__ __forceinline__ float rounded_product(float a, float b);
template <>
__device__ __forceinline__ float rounded_product<float>(float a, float b) {
  return __fmul_rn(a, b);  // rounded to fp32, never contracted into an FMA
}
template <>
__device__ __forceinline__ float rounded_product<__nv_bfloat16>(float a, float b) {
  // a and b are bf16 values, so a*b is exact in fp32; round it once to bf16
  return __bfloat162float(__float2bfloat16(a * b));
}

template <typename T, bool kRound>
__global__ void __launch_bounds__(kThreads)
interact_kernel(const T* __restrict__ flat, const int* __restrict__ pairs,
                float* __restrict__ out, int n_rows, int n_vec, int k_dim, int n_pairs,
                int rows_per_block) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n_rows - row0);
  const int width = n_vec * k_dim;
  const int ld = k_dim + 1;
  const T* src = flat + static_cast<int64_t>(row0) * width;
  for (int idx = threadIdx.x; idx < rows * width; idx += kThreads) {
    const int r = idx / width;
    const int c = idx - r * width;
    const int f = c / k_dim;
    const int kk = c - f * k_dim;
    smem[(r * n_vec + f) * ld + kk] = to_float(src[idx]);
  }
  __syncthreads();
  float* dst = out + static_cast<int64_t>(row0) * n_pairs;
  for (int idx = threadIdx.x; idx < rows * n_pairs; idx += kThreads) {
    const int r = idx / n_pairs;
    const int p = idx - r * n_pairs;
    const int ij = __ldg(pairs + p);
    const float* a = smem + (r * n_vec + (ij >> 16)) * ld;
    const float* b = smem + (r * n_vec + (ij & 0xffff)) * ld;
    float acc = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < k_dim; ++kk) {
      if (kRound) {
        acc += rounded_product<T>(a[kk], b[kk]);
      } else {
        acc = fmaf(a[kk], b[kk], acc);
      }
    }
    dst[idx] = acc;
  }
}

template <typename T, bool kRound>
int launch(const void* flat, const void* pairs, void* out, int n_rows, int n_vec, int k_dim,
           int n_pairs, cudaStream_t stream) {
  const int64_t row_bytes = static_cast<int64_t>(n_vec) * (k_dim + 1) * sizeof(float);
  if (row_bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int rows_per_block = static_cast<int>(kDefaultSmem / row_bytes);
  rows_per_block = rows_per_block < 1 ? 1 : rows_per_block;
  rows_per_block = rows_per_block > kMaxRowsPerBlock ? kMaxRowsPerBlock : rows_per_block;
  const int smem = static_cast<int>(rows_per_block * row_bytes);
  auto kernel = interact_kernel<T, kRound>;
  if (smem > kDefaultSmem) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(flat), static_cast<const int*>(pairs), static_cast<float*>(out),
      n_rows, n_vec, k_dim, n_pairs, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// flat: [n_rows, n_vec * k_dim] contiguous, fp32 or bf16 (is_bf16); pairs:
// [n_pairs] int32 (i << 16 | j), on the device; out: [n_rows, n_pairs] fp32
// contiguous. round_products rounds each product to the input's type before
// the fp32 sum. Returns a cudaError_t as int (0 = ok).
extern "C" int rectpu_interact(const void* flat, const void* pairs, void* out, int n_rows,
                               int n_vec, int k_dim, int n_pairs, int is_bf16,
                               int round_products, void* stream) {
  if (n_rows == 0 || n_pairs == 0) return static_cast<int>(cudaSuccess);
  if (n_vec < 1 || n_vec > 0xffff || k_dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return round_products
               ? launch<__nv_bfloat16, true>(flat, pairs, out, n_rows, n_vec, k_dim, n_pairs, s)
               : launch<__nv_bfloat16, false>(flat, pairs, out, n_rows, n_vec, k_dim, n_pairs, s);
  }
  return round_products
             ? launch<float, true>(flat, pairs, out, n_rows, n_vec, k_dim, n_pairs, s)
             : launch<float, false>(flat, pairs, out, n_rows, n_vec, k_dim, n_pairs, s);
}
