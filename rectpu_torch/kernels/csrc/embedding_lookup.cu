// Embedding-row gather for Hopper (sm_90a): out[r, :] = table[ids[r], :].
//
// Replaces rectpu/ops/embedding.py::_fwd_kernel (:70), the Pallas kernel that
// lookup_pallas (:170) runs for every field of the ml-100k table on the TPU
// serving path (embedding_impl "auto" resolves to "split", and every
// ml-100k field is under split_threshold). On the TPU the gather is a one-hot
// matmul, onehot(ids tile) @ table, because the matrix unit is what the TPU
// has plenty of. One nonzero per one-hot row times an fp32 accumulate gives
// the table value exactly, so a plain gather computes the same function bit
// for bit; that is what this kernel does. An id outside [0, V) yields a zero
// row, as the one-hot form does (no column of the one-hot row matches).
//
// What bounds it on this card: bytes. No arithmetic at all. The served table
// is [4224, 65] (~1.1 MB in fp32, half that in bf16) and stays in the 50 MB
// L2 after its first touch; the B*26 rows x 65 columns output is written
// once to device memory, and that write is the bound (B=4096: 6.9 MB in
// fp32, 3.5 MB in bf16).
//
// Design: one warp per output row, a grid-stride loop over rows. The warp
// reads the row's id once (one broadcast load), then its 32 lanes copy
// neighbouring columns, 32 at a time, so each store instruction of the warp
// writes one contiguous span (128 bytes in fp32, 64 in bf16) and the write
// that bounds the kernel is coalesced. The row width W = 65 is odd, so rows
// do not start on 16-byte boundaries and vector loads would not line up;
// element-wise copies avoid that question, at the cost of a third column
// pass in which one lane of 32 works. No index arithmetic divides: a first
// version mapped a flat element index to (row, column) with a 64-bit
// division per element, which the card emulates in software (PERF.md has
// both versions' times). The kernel moves raw bit patterns (uint32
// for fp32, uint16 for bf16), so it is bitwise exact by construction and one
// template serves both types. The launch is asynchronous on the caller's
// stream, and the entry point returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int64_t kMaxBlocks = 132 * 16;  // 132 SMs; at most 16 x 8 warps each in flight

template <typename Bits>
__global__ void lookup_rows_kernel(const Bits* __restrict__ table,
                                   const int32_t* __restrict__ ids,
                                   Bits* __restrict__ out, int64_t n_ids,
                                   int32_t n_table_rows, int32_t width) {
  const int lane = threadIdx.x;  // blockDim = (32, kWarpsPerBlock)
  const int64_t row_stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.y;
       row < n_ids; row += row_stride) {
    const int32_t id = __ldg(ids + row);
    Bits* dst = out + row * width;
    if (id >= 0 && id < n_table_rows) {
      const Bits* src = table + static_cast<int64_t>(id) * width;
#pragma unroll 4
      for (int c = lane; c < width; c += kWarp) dst[c] = __ldg(src + c);
    } else {
#pragma unroll 4
      for (int c = lane; c < width; c += kWarp) dst[c] = Bits(0);
    }
  }
}

}  // namespace

// table [n_table_rows, width] row-major, ids [n_ids] int32, out [n_ids, width].
// elem_bytes is 4 (fp32) or 2 (bf16). Returns a cudaError_t as int (0 = ok).
extern "C" int rectpu_lookup_rows(const void* table, const void* ids, void* out,
                                  long long n_ids, int n_table_rows, int width,
                                  int elem_bytes, void* stream) {
  if (n_ids == 0 || width == 0) return static_cast<int>(cudaSuccess);
  int64_t blocks = (n_ids + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 block(kWarp, kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* id_ptr = static_cast<const int32_t*>(ids);
  if (elem_bytes == 4) {
    lookup_rows_kernel<uint32_t><<<static_cast<unsigned>(blocks), block, 0, s>>>(
        static_cast<const uint32_t*>(table), id_ptr, static_cast<uint32_t*>(out),
        n_ids, n_table_rows, width);
  } else if (elem_bytes == 2) {
    lookup_rows_kernel<uint16_t><<<static_cast<unsigned>(blocks), block, 0, s>>>(
        static_cast<const uint16_t*>(table), id_ptr, static_cast<uint16_t*>(out),
        n_ids, n_table_rows, width);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
