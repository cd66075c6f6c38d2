// Dense row scatter-add for Hopper (sm_90a):
//   out = zeros([v_rows, W], out_type); out[ids[r], :] += upd[r, :]
// with every collision sum taken in fp32 and rounded once to out_type.
//
// Replaces three TPU kernels that compute this one function:
//   - rectpu/ops/scatter_rows.py::_scatter_tile_kernel (:78) and
//     ::_scatter_tile_kernel_resident (:123), run by scatter_rows_dense (:154)
//     for the flat-layout DeepFM backward (scatter_impl="mxu");
//   - rectpu/ops/embedding.py::_bwd_kernel (:81), the backward of
//     lookup_pallas (dtable = onehot^T @ g, fp32 accumulation).
// On the TPU the scatter is a sorted stream cut into per-tile one-hot matmuls
// because the matrix unit is what the TPU has plenty of; the tiles, the
// resident/repacked split and the transposed output exist for VMEM and the
// (8, 128) layout. None of that carries over. Ids outside [0, v_rows) add
// nothing (DROP_SENTINEL, negative ids, the one-hot rule of _bwd_kernel).
//
// What bounds it on this card: bytes. It reads R ids and R*W update values and
// writes all v_rows*W outputs; the arithmetic is one add per update value. At
// the flagship table (311,296 x 65, bf16 out) with R = 8192*26 bf16 updates
// that is 69 MB, 0.021 ms at 3.35 TB/s; most output rows are zeros.
//
// Determinism: the sums run in an order fixed by the data, never by the
// schedule, so two launches give the same bits (rectpu's training is bitwise
// reproducible run to run; fp32 atomics would break that). The wrapper sorts
// (id, position) stably first, as rectpu sorts outside its Pallas call
// (scatter_rows.py:221). Then:
//   1. chunk pass: the sorted stream is cut into fixed chunks of `chunk`
//      positions, one warp per chunk, lanes on neighbouring columns
//      (coalesced row reads of `upd` through the sort permutation). The warp
//      walks its chunk in order and sums each run of equal ids. A run that is
//      a whole segment (all updates of its row) is written to `out` at once;
//      a run cut by a chunk edge is written as an fp32 partial (the chunk's
//      first or last run). The warp also records each segment's [start, end)
//      where the segment starts or ends.
//   2. finish pass: one warp per output row. An empty segment is written as
//      zeros; a segment that spans chunks sums its partials in chunk order.
// The trap this avoids: ml-100k has fields of 2-3 rows (gender, 19 genre
// flags), so at B = 4096 one table row receives 2,000-4,000 updates. One
// warp summing such a segment serially would take milliseconds; cut into
// 32-position chunks it is summed by ~100 warps at once and the partials by
// one warp in ~100 adds.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kColGroups = 4;  // columns handled per pass of a warp: 4 x 32
constexpr int64_t kMaxBlocks = 132 * 16;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ bool valid_id(int32_t id, int32_t v_rows) {
  return id >= 0 && id < v_rows;
}

// A finished run [s, e) of id `id` inside chunk c: write it out whole, or as
// the chunk's first/last partial; record the segment's ends it contains.
template <typename TOut>
__device__ __forceinline__ void flush_run(const int32_t* __restrict__ ids, int64_t n,
                                          int32_t id, int64_t s, int64_t e, int64_t c,
                                          int col_base, int width, const float* acc,
                                          TOut* __restrict__ out,
                                          float* __restrict__ part_first,
                                          float* __restrict__ part_last,
                                          int32_t* __restrict__ seg) {
  const int lane = threadIdx.x;
  const bool starts = (s == 0) || ids[s - 1] != id;
  const bool ends = (e == n) || ids[e] != id;
  if (col_base == 0 && lane == 0) {
    if (starts) seg[2 * static_cast<int64_t>(id)] = static_cast<int32_t>(s);
    if (ends) seg[2 * static_cast<int64_t>(id) + 1] = static_cast<int32_t>(e);
  }
#pragma unroll
  for (int j = 0; j < kColGroups; ++j) {
    const int col = col_base + j * kWarp + lane;
    if (col < width) {
      if (starts && ends) {
        store_f(out + static_cast<int64_t>(id) * width + col, acc[j]);
      } else {
        // a run cut at the chunk's start is its first run, one cut at its
        // end its last; a run cut at both covers the chunk and is both
        if (!starts) part_first[c * width + col] = acc[j];
        if (!ends) part_last[c * width + col] = acc[j];
      }
    }
  }
}

template <typename TIn, typename TOut>
__global__ void scatter_chunk_kernel(const int32_t* __restrict__ ids,
                                     const int64_t* __restrict__ order,
                                     const TIn* __restrict__ upd, TOut* __restrict__ out,
                                     float* __restrict__ part_first,
                                     float* __restrict__ part_last,
                                     int32_t* __restrict__ seg, int64_t n, int32_t v_rows,
                                     int width, int chunk, int64_t n_chunks) {
  const int lane = threadIdx.x;  // blockDim = (32, kWarpsPerBlock)
  const int64_t warp_stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.y;
       c < n_chunks; c += warp_stride) {
    const int64_t lo = c * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    for (int col_base = 0; col_base < width; col_base += kColGroups * kWarp) {
      float acc[kColGroups];
#pragma unroll
      for (int j = 0; j < kColGroups; ++j) acc[j] = 0.0f;
      int32_t cur = ids[lo];
      int64_t run_start = lo;
      for (int64_t r = lo; r < hi; ++r) {
        const int32_t id = ids[r];  // the same for every lane: a broadcast
        if (id != cur) {
          if (valid_id(cur, v_rows)) {
            flush_run(ids, n, cur, run_start, r, c, col_base, width, acc, out, part_first,
                      part_last, seg);
          }
#pragma unroll
          for (int j = 0; j < kColGroups; ++j) acc[j] = 0.0f;
          cur = id;
          run_start = r;
        }
        if (valid_id(id, v_rows)) {
          const TIn* src = upd + order[r] * width;
#pragma unroll
          for (int j = 0; j < kColGroups; ++j) {
            const int col = col_base + j * kWarp + lane;
            if (col < width) acc[j] += load_f(src + col);
          }
        }
      }
      if (valid_id(cur, v_rows)) {
        flush_run(ids, n, cur, run_start, hi, c, col_base, width, acc, out, part_first,
                  part_last, seg);
      }
    }
  }
}

template <typename TOut>
__global__ void scatter_finish_kernel(const int32_t* __restrict__ seg,
                                      const float* __restrict__ part_first,
                                      const float* __restrict__ part_last,
                                      TOut* __restrict__ out, int32_t v_rows, int width,
                                      int chunk) {
  const int lane = threadIdx.x;
  const int64_t warp_stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.y;
       row < v_rows; row += warp_stride) {
    const int64_t s = seg[2 * row];
    const int64_t e = seg[2 * row + 1];
    TOut* dst = out + row * width;
    if (e <= s) {  // no update touched this row
      for (int col = lane; col < width; col += kWarp) store_f(dst + col, 0.0f);
      continue;
    }
    const int64_t c_first = s / chunk;
    const int64_t c_last = (e - 1) / chunk;
    if (c_first == c_last) continue;  // a whole run of one chunk: written by the chunk pass
    for (int col = lane; col < width; col += kWarp) {
      float acc = part_last[c_first * width + col];
      for (int64_t c = c_first + 1; c <= c_last; ++c) acc += part_first[c * width + col];
      store_f(dst + col, acc);
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const int32_t* ids, const int64_t* order, const void* upd, void* out,
                   float* part_first, float* part_last, int32_t* seg, int64_t n,
                   int32_t v_rows, int width, int chunk, cudaStream_t s) {
  const dim3 block(kWarp, kWarpsPerBlock);
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  if (n_chunks > 0) {
    int64_t blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    scatter_chunk_kernel<TIn, TOut><<<static_cast<unsigned>(blocks), block, 0, s>>>(
        ids, order, static_cast<const TIn*>(upd), static_cast<TOut*>(out), part_first,
        part_last, seg, n, v_rows, width, chunk, n_chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  int64_t blocks = (static_cast<int64_t>(v_rows) + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  scatter_finish_kernel<TOut><<<static_cast<unsigned>(blocks), block, 0, s>>>(
      seg, part_first, part_last, static_cast<TOut*>(out), v_rows, width, chunk);
  return cudaGetLastError();
}

}  // namespace

// ids_sorted [n] int32 and order [n] int64: a stable sort of the ids and the
// positions it took them from. upd [n_upd, width] (indexed through order),
// out [v_rows, width], part_first/part_last [ceil(n / chunk), width] fp32
// scratch, seg [v_rows, 2] int32 scratch, all contiguous on one device.
// in_bf16/out_bf16 select bf16 over fp32. Returns a cudaError_t as int.
extern "C" int rectpu_scatter_rows(const void* ids_sorted, const void* order, const void* upd,
                                   void* out, void* part_first, void* part_last, void* seg,
                                   long long n, int v_rows, int width, int chunk, int in_bf16,
                                   int out_bf16, void* stream) {
  if (v_rows == 0 || width == 0) return static_cast<int>(cudaSuccess);
  if (chunk < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* seg_i = static_cast<int32_t*>(seg);
  // every segment starts empty ([0, 0)); the chunk pass fills the touched ones
  cudaError_t err = cudaMemsetAsync(seg_i, 0, sizeof(int32_t) * 2 * static_cast<size_t>(v_rows), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t* ids = static_cast<const int32_t*>(ids_sorted);
  const int64_t* ord = static_cast<const int64_t*>(order);
  float* pf = static_cast<float*>(part_first);
  float* pl = static_cast<float*>(part_last);
  if (in_bf16 && out_bf16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(ids, ord, upd, out, pf, pl, seg_i, n, v_rows,
                                               width, chunk, s);
  } else if (in_bf16) {
    err = launch<__nv_bfloat16, float>(ids, ord, upd, out, pf, pl, seg_i, n, v_rows, width,
                                       chunk, s);
  } else if (out_bf16) {
    err = launch<float, __nv_bfloat16>(ids, ord, upd, out, pf, pl, seg_i, n, v_rows, width,
                                       chunk, s);
  } else {
    err = launch<float, float>(ids, ord, upd, out, pf, pl, seg_i, n, v_rows, width, chunk, s);
  }
  return static_cast<int>(err);
}
