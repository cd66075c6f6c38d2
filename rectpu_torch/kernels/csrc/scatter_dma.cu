// Row SET into a slab, in place, for Hopper (sm_90a):
//   slab[rows[i], :] = vals[i, :]   for every i with 0 <= rows[i] < v_valid
// Rows at or past v_valid (the sentinels of a deduplicated update list) and
// negative rows are dropped. It is a set, not an add: no arithmetic touches
// the values, so the result is bit for bit the source rows.
//
// Replaces rectpu/ops/scatter_dma.py::_rmw_kernel (:49), run by
// scatter_rows_dma (:206) for the sparse fast step's lazy-Adam update
// (scatter_backend="dma"). On the TPU the slab's (8, 128) HBM tiling admits
// only 8-row-aligned windows, so that kernel reads a window, selects the
// updated rows into it and writes it back, with an SMEM table of per-window
// sources planned outside the kernel. None of that carries over: device
// memory here takes a write of any row at any byte offset.
//
// Design: one warp per update row. The valid rows are unique, so no two
// warps write the same slab row and no atomics are needed. The row is copied
// in the widest vector its byte width and both base addresses allow (16, 8,
// 4, 2 or 1 bytes), so fp32 and bf16 slabs of any width take the same
// kernel, down to a [V, 1] leaf.
//
// What bounds it on this card: bytes. Each valid update reads its val row
// and writes one slab row, plus 4 bytes of row id; at the fast step's full
// width (25,088 rows of a [6,000,640, 128] fp32 table and of the [.., 256]
// m|v slab) that is ~77 MB per step, 0.023 ms at 3.35 TB/s.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int64_t kMaxBlocks = 132 * 32;

template <typename V>
__global__ void set_rows_kernel(const int32_t* __restrict__ rows, const V* __restrict__ vals,
                                V* __restrict__ slab, int64_t n, int32_t v_valid,
                                int64_t row_vecs) {
  const int lane = threadIdx.x;  // blockDim = (32, kWarpsPerBlock)
  const int64_t warp_stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.y; i < n;
       i += warp_stride) {
    const int32_t r = rows[i];  // the same for every lane: a broadcast
    if (r < 0 || r >= v_valid) continue;
    const V* src = vals + i * row_vecs;
    V* dst = slab + static_cast<int64_t>(r) * row_vecs;
    for (int64_t c = lane; c < row_vecs; c += kWarp) dst[c] = __ldg(src + c);
  }
}

template <typename V>
cudaError_t launch(const int32_t* rows, const void* vals, void* slab, int64_t n,
                   int32_t v_valid, int64_t row_bytes, cudaStream_t s) {
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  set_rows_kernel<V><<<static_cast<unsigned>(blocks), dim3(kWarp, kWarpsPerBlock), 0, s>>>(
      rows, static_cast<const V*>(vals), static_cast<V*>(slab), n, v_valid,
      row_bytes / static_cast<int64_t>(sizeof(V)));
  return cudaGetLastError();
}

}  // namespace

// rows [n] int32, vals [n, row_bytes] and slab [v_rows, row_bytes] (as bytes:
// the caller's dtype does not matter to a copy), all contiguous on one
// device; the caller guarantees v_valid <= v_rows. Returns a cudaError_t as
// int.
extern "C" int rectpu_set_rows(const void* rows, const void* vals, void* slab, long long n,
                               int v_valid, long long row_bytes, void* stream) {
  if (n == 0 || row_bytes == 0) return static_cast<int>(cudaSuccess);
  if (n < 0 || row_bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const uintptr_t align = reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(slab) |
                          static_cast<uintptr_t>(row_bytes);
  cudaError_t err;
  if (align % 16 == 0) {
    err = launch<uint4>(r, vals, slab, n, v_valid, row_bytes, s);
  } else if (align % 8 == 0) {
    err = launch<uint2>(r, vals, slab, n, v_valid, row_bytes, s);
  } else if (align % 4 == 0) {
    err = launch<uint32_t>(r, vals, slab, n, v_valid, row_bytes, s);
  } else if (align % 2 == 0) {
    err = launch<uint16_t>(r, vals, slab, n, v_valid, row_bytes, s);
  } else {
    err = launch<uint8_t>(r, vals, slab, n, v_valid, row_bytes, s);
  }
  return static_cast<int>(err);
}
