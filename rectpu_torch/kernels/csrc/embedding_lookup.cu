// Embedding-row gather for Hopper (sm_90a): out[r, :] = table[ids[r], :],
// optionally rounding an fp32 table's rows to bf16 on the way; and its
// dequantizing mode for int8 serving tables, out[r, :] = float(q[ids[r], :]) *
// s[ids[r]] in fp32 or rounded once to bf16 (rectpu_lookup_rows_int8).
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
// Numerics: bitwise. Rows are moved as raw bit patterns (uint32 for fp32,
// uint16 for bf16). With an fp32 table and a bf16 output each element is
// rounded by __float2bfloat16, the intrinsic PyTorch's own CUDA cast uses
// (c10::BFloat16 on sm_80+), so the result is bitwise
// table.to(torch.bfloat16)[ids], NaN and infinities included: rectpu's
// gather_dtype cast (lookup_split, :267) folded into the gather, which saves
// the model a pass over the whole table each step.
//
// The int8 mode (rectpu_torch/serve/quant.py: a per-row symmetric int8 table
// and its fp32 scales) computes rectpu's dequant_lookup (rectpu/serve/quant.py:
// 53-62), an fp32 product of the int8 value and its row's scale, followed by
// the cast to the compute dtype in lookup_fields (rectpu/models/base.py:
// 324-337): one IEEE fp32 multiply (nothing to fuse into an FMA) and at most
// one round to nearest even, so it is bitwise the plain
// (q[ids].float() * s[ids, None]).to(dtype). It takes the tile path (or the
// rows path for a row too wide for a tile): an int8 row of K+1 = 65 bytes is
// not 16-byte aligned, and the vector path moves 16-byte chunks as they are.
//
// What bounds it on this card: bytes. No arithmetic at all: the ids, the
// rows read (at most the table) and the output written once.
//
// Design. The ops/embedding.py plan (lookup_plan, checked by the CPU tests)
// picks one of three paths:
// - "vector" (the row is a 16-byte multiple in the table and in out: the
//   fast step's 128- and 256-wide fp32 rows): lanes_per_row lanes copy a
//   row 16 bytes a lane, straight from device memory to device memory, each
//   lane with kVecRows rows (and up to two chunks of each) in flight; the
//   ids of a warp's next rows are loaded while its rows are copied.
// - "tile" (narrow or unaligned rows: W = 65, 5, 1): a persistent block
//   takes tiles of rows_per_tile rows, whose output is one contiguous span of
//   a multiple of 16 bytes. It holds the next tile's ids while it gathers
//   this tile's rows into shared memory, a thread taking 8 neighbouring
//   columns of a row, so every lane works at any W and many rows are in
//   flight at once (16 loads a thread); then it writes the span 16 bytes a
//   thread. The earlier kernel gave each row a warp, which at W = 65 stored
//   64-byte spans from 130-byte offsets, one row in flight a warp, and at
//   W = 5 or 1 left 27 or 31 lanes idle.
// - "rows" (an unaligned row too wide for a tile in shared memory): one warp
//   a row, element by element, as the earlier kernel did.
// No index arithmetic divides in 64 bits (a 64-bit division per element,
// which the card emulates in software, once made this kernel several times
// slower): the tile path divides once a chunk of 8 columns, in 32 bits. The
// launch is
// asynchronous on the caller's stream, and the entry point returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kVecRows = 2;  // rows a lane group copies at once (vector path)
enum Path : int { kVector = 0, kTile = 1, kRows = 2 };

// One element of the table as the output's bits: a copy, or fp32 -> bf16.
template <typename TIn, typename TOut>
__device__ __forceinline__ TOut convert(TIn x) {
  return x;
}
template <>
__device__ __forceinline__ uint16_t convert<float, uint16_t>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

// One element of the table at p as the output's bits; for an int8 table the
// product with its row's scale s, in fp32, then rounded once to the output.
template <typename TIn, typename TOut>
__device__ __forceinline__ TOut load_elem(const TIn* p, float s) {
  return convert<TIn, TOut>(__ldg(p));
}
template <>
__device__ __forceinline__ float load_elem<int8_t, float>(const int8_t* p, float s) {
  return static_cast<float>(__ldg(p)) * s;
}
template <>
__device__ __forceinline__ uint16_t load_elem<int8_t, uint16_t>(const int8_t* p, float s) {
  return __bfloat16_as_ushort(__float2bfloat16(static_cast<float>(__ldg(p)) * s));
}

// The scale of row id of an int8 table (1 for every other table).
template <typename TIn>
__device__ __forceinline__ float row_scale(const float* scales, int32_t id) {
  if constexpr (std::is_same_v<TIn, int8_t>) {
    return __ldg(scales + id);
  } else {
    return 1.0f;
  }
}

// 16 bytes of output from the table: one 16-byte load when TIn and TOut are
// the same size, two fp32 loads rounded to eight bf16 otherwise.
template <typename TIn, typename TOut>
struct Chunk {
  static constexpr int kOut = 16 / sizeof(TOut);                 // output elements
  static constexpr int kLoads = kOut * sizeof(TIn) / 16;         // 16-byte loads
  uint4 raw[kLoads];
  __device__ __forceinline__ void load(const TIn* src) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) raw[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) raw[i] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ uint4 out() const {
    if constexpr (kLoads == 1) {
      return raw[0];
    } else {
      uint4 o;
      uint16_t* e = reinterpret_cast<uint16_t*>(&o);
      const float* x = reinterpret_cast<const float*>(raw);
#pragma unroll
      for (int i = 0; i < kOut; ++i) e[i] = convert<float, uint16_t>(x[i]);
      return o;
    }
  }
};

// The vector path. Lane group `sub` of a warp (lanes_per_row lanes) copies
// rows r0 + sub + u * rows_per_pass, u < U, each 16 bytes a lane in CPL
// chunks (CPL 0: a loop over the row's chunks); every load of a pass is in
// flight before its stores.
template <typename TIn, typename TOut, int U, int CPL>
__global__ void __launch_bounds__(kThreads)
    lookup_vec_kernel(const TIn* __restrict__ table, const int32_t* __restrict__ ids,
                      TOut* __restrict__ out, int64_t n_ids, int32_t n_table_rows,
                      int32_t width, int lanes_per_row) {
  using C = Chunk<TIn, TOut>;
  constexpr int kC = CPL > 0 ? CPL : 1;
  const int chunks = width / C::kOut;  // 16-byte output chunks a row
  const int lane = threadIdx.x & (kWarp - 1);
  const int sub = lane / lanes_per_row, c0 = lane - sub * lanes_per_row;
  const int rows_per_pass = kWarp / lanes_per_row;
  const int64_t rows_per_warp = static_cast<int64_t>(rows_per_pass) * U;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (kThreads / kWarp) * rows_per_warp;
  int64_t r0 = warp * rows_per_warp;
  int32_t id[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t r = r0 + sub + u * rows_per_pass;
    id[u] = r < n_ids ? __ldg(ids + r) : -1;
  }
  for (; r0 < n_ids; r0 += stride) {
    int32_t cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = id[u];
    // the next pass's ids, loaded while this pass's rows are in flight
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t r = r0 + stride + sub + u * rows_per_pass;
      id[u] = r < n_ids ? __ldg(ids + r) : -1;
    }
    for (int cb = c0; cb < chunks; cb += kC * lanes_per_row) {
      C x[U][kC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          const int c = cb + j * lanes_per_row;
          if (c < chunks && cur[u] >= 0 && cur[u] < n_table_rows) {
            x[u][j].load(table + static_cast<int64_t>(cur[u]) * width + c * C::kOut);
          } else {
            x[u][j].zero();
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t r = r0 + sub + u * rows_per_pass;
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          const int c = cb + j * lanes_per_row;
          if (r < n_ids && c < chunks) {
            *reinterpret_cast<uint4*>(out + r * width + c * C::kOut) = x[u][j].out();
          }
        }
      }
    }
  }
}

// The tile path. A persistent block walks tiles of rows_per_tile rows: it
// stores the tile's ids (loaded during the last tile) in shared memory and
// loads the next tile's; its threads gather (row, kTileCols-column chunk)
// pairs, every load of two pairs in flight before their stores, into the
// tile's output in shared memory; then they write that contiguous span 16
// bytes a thread.
constexpr int kTileCols = 8;

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    lookup_tile_kernel(const TIn* __restrict__ table, const float* __restrict__ scales,
                       const int32_t* __restrict__ ids, TOut* __restrict__ out, int64_t n_ids,
                       int32_t n_table_rows, int32_t width, int rows_per_tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_ids = reinterpret_cast<int32_t*>(smem);
  TOut* s_out = reinterpret_cast<TOut*>(smem + (rows_per_tile * 4 + 15) / 16 * 16);
  const int tid = threadIdx.x;
  const int64_t n_tiles = (n_ids + rows_per_tile - 1) / rows_per_tile;
  const int cpr = (width + kTileCols - 1) / kTileCols;  // chunks a row
  int64_t tile = blockIdx.x;
  int32_t next = -1;  // thread t < rows_per_tile (<= kThreads) holds row t's id
  if (tid < rows_per_tile && tile * rows_per_tile + tid < n_ids) {
    next = __ldg(ids + tile * rows_per_tile + tid);
  }
  for (; tile < n_tiles; tile += gridDim.x) {
    const int64_t first = tile * rows_per_tile;
    const int rows = static_cast<int>(n_ids - first < rows_per_tile ? n_ids - first
                                                                    : rows_per_tile);
    __syncthreads();  // the last tile's writes have read s_ids and s_out
    if (tid < rows_per_tile) s_ids[tid] = next;
    const int64_t after = first + static_cast<int64_t>(gridDim.x) * rows_per_tile + tid;
    next = tid < rows_per_tile && after < n_ids ? __ldg(ids + after) : -1;
    __syncthreads();

    const int pairs = rows * cpr;
    for (int p0 = tid; p0 < pairs; p0 += 2 * kThreads) {
      TOut x[2][kTileCols];
      int at[2], n[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = p0 + u * kThreads;
        const int row = p / cpr;
        const int c0 = (p - row * cpr) * kTileCols;
        const int32_t id = p < pairs ? s_ids[row] : -1;
        const bool ok = id >= 0 && id < n_table_rows;
        const TIn* src = table + static_cast<int64_t>(ok ? id : 0) * width + c0;
        const float sc = ok ? row_scale<TIn>(scales, id) : 0.0f;
        at[u] = row * width + c0;
        n[u] = p < pairs ? min(kTileCols, width - c0) : 0;
#pragma unroll
        for (int j = 0; j < kTileCols; ++j) {
          x[u][j] = ok && j < n[u] ? load_elem<TIn, TOut>(src + j, sc) : TOut(0);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int j = 0; j < kTileCols; ++j) {
          if (j < n[u]) s_out[at[u] + j] = x[u][j];
        }
      }
    }
    __syncthreads();

    // the tile's output is one contiguous span; it starts 16-byte aligned (the
    // plan makes rows_per_tile * width * sizeof(TOut) a multiple of 16)
    TOut* dst = out + first * width;
    const int n_out = rows * width;
    const int chunks = n_out * static_cast<int>(sizeof(TOut)) / 16;
    for (int c = tid; c < chunks; c += kThreads) {
      reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(s_out)[c];
    }
    for (int e = chunks * 16 / static_cast<int>(sizeof(TOut)) + tid; e < n_out;
         e += kThreads) {
      dst[e] = s_out[e];
    }
  }
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    lookup_rows_kernel(const TIn* __restrict__ table, const float* __restrict__ scales,
                       const int32_t* __restrict__ ids, TOut* __restrict__ out, int64_t n_ids,
                       int32_t n_table_rows, int32_t width) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / kWarp);
  for (int64_t row = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
       row < n_ids; row += warps) {
    const int32_t id = __ldg(ids + row);
    TOut* dst = out + row * width;
    if (id >= 0 && id < n_table_rows) {
      const TIn* src = table + static_cast<int64_t>(id) * width;
      const float sc = row_scale<TIn>(scales, id);
#pragma unroll 4
      for (int c = lane; c < width; c += kWarp) dst[c] = load_elem<TIn, TOut>(src + c, sc);
    } else {
#pragma unroll 4
      for (int c = lane; c < width; c += kWarp) dst[c] = TOut(0);
    }
  }
}

// The tile path's blocks are persistent (each loads its next tile's ids
// ahead): its grid is at most what the card holds at once.
template <typename... Params, typename... Args>
void resident(void (*kernel)(Params...), int blocks, int smem, cudaStream_t s,
              Args... args) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      sms = 132;
    }
  }
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) ==
          cudaSuccess &&
      per_sm > 0 && blocks > per_sm * sms) {
    blocks = per_sm * sms;
  }
  kernel<<<blocks, kThreads, smem, s>>>(args...);
}

template <typename TIn, typename TOut>
int launch(const void* table, const float* scales, const void* ids, void* out, long long n_ids,
           int n_table_rows, int width, int path, int param, int blocks, int smem,
           cudaStream_t s) {
  const auto* t = static_cast<const TIn*>(table);
  const auto* i = static_cast<const int32_t*>(ids);
  auto* o = static_cast<TOut*>(out);
  if (path == kVector) {
    if constexpr (std::is_same_v<TIn, int8_t>) {
      return static_cast<int>(cudaErrorInvalidValue);  // no vector path for int8 rows
    } else {
      const int chunks = width / Chunk<TIn, TOut>::kOut;
      const int cpl = (chunks + param - 1) / param;  // chunks a lane
      auto kernel = cpl == 1   ? lookup_vec_kernel<TIn, TOut, kVecRows, 1>
                    : cpl == 2 ? lookup_vec_kernel<TIn, TOut, kVecRows, 2>
                               : lookup_vec_kernel<TIn, TOut, kVecRows, 0>;
      kernel<<<blocks, kThreads, 0, s>>>(t, i, o, n_ids, n_table_rows, width, param);
    }
  } else if (path == kTile) {
    resident(lookup_tile_kernel<TIn, TOut>, blocks, smem, s, t, scales, i, o, n_ids,
             n_table_rows, width, param);
  } else {
    lookup_rows_kernel<TIn, TOut><<<blocks, kThreads, 0, s>>>(t, scales, i, o, n_ids,
                                                              n_table_rows, width);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [n_table_rows, width] row-major, ids [n_ids] int32, out [n_ids,
// width], all contiguous. in_bytes / out_bytes: 4 and 4 (fp32), 2 and 2
// (bf16), or 4 and 2 (fp32 rows rounded to bf16). The plan comes from
// rectpu_torch/ops/embedding.py (lookup_plan): path 0 "vector" (param: lanes
// a row, a power of two <= 32; the table, out and both row widths 16-byte
// aligned), 1 "tile"
// (param: rows a tile, at most 256, its output span a 16-byte multiple;
// smem: the block's shared memory), 2 "rows"; blocks: the grid (for the
// tile path, at most what the card holds at once is launched). Returns a
// cudaError_t as int (0 = ok).
extern "C" int rectpu_lookup_rows(const void* table, const void* ids, void* out,
                                  long long n_ids, int n_table_rows, int width, int in_bytes,
                                  int out_bytes, int path, int param, int blocks, int smem,
                                  void* stream) {
  if (n_ids == 0 || width == 0) return static_cast<int>(cudaSuccess);
  const bool bad_vec = path == kVector &&
                       (param < 1 || param > kWarp || (param & (param - 1)) != 0 ||
                        (static_cast<int64_t>(width) * in_bytes) % 16 != 0 ||
                        (static_cast<int64_t>(width) * out_bytes) % 16 != 0 ||
                        reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
                        reinterpret_cast<uintptr_t>(out) % 16 != 0);
  const bool bad_tile =
      path == kTile && (param < 1 || param > kThreads ||
                        (static_cast<int64_t>(param) * width * out_bytes) % 16 != 0 ||
                        reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
                        smem < (param * 4 + 15) / 16 * 16 + param * width * out_bytes ||
                        smem > 48 * 1024);
  if (bad_vec || bad_tile || path < kVector || path > kRows || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bytes == 4 && out_bytes == 4) {
    return launch<uint32_t, uint32_t>(table, nullptr, ids, out, n_ids, n_table_rows, width, path,
                                      param, blocks, smem, s);
  }
  if (in_bytes == 2 && out_bytes == 2) {
    return launch<uint16_t, uint16_t>(table, nullptr, ids, out, n_ids, n_table_rows, width, path,
                                      param, blocks, smem, s);
  }
  if (in_bytes == 4 && out_bytes == 2) {
    return launch<float, uint16_t>(table, nullptr, ids, out, n_ids, n_table_rows, width, path,
                                   param, blocks, smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8 mode: q [n_table_rows, width] int8 row-major, scales
// [n_table_rows] fp32, ids [n_ids] int32, out [n_ids, width] fp32 (out_bytes
// 4) or bf16 (out_bytes 2): out[r, c] = float(q[id, c]) * scales[id], rounded
// once to bf16 for a bf16 out, a zero row for an id outside [0,
// n_table_rows). The plan as above for in_bytes 1, path 1 "tile" or 2 "rows"
// (the vector path is refused). Returns a cudaError_t as int (0 = ok).
extern "C" int rectpu_lookup_rows_int8(const void* q, const void* scales, const void* ids,
                                       void* out, long long n_ids, int n_table_rows,
                                       int width, int out_bytes, int path, int param,
                                       int blocks, int smem, void* stream) {
  if (n_ids == 0 || width == 0) return static_cast<int>(cudaSuccess);
  const bool bad_tile =
      path == kTile && (param < 1 || param > kThreads ||
                        (static_cast<int64_t>(param) * width * out_bytes) % 16 != 0 ||
                        reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
                        smem < (param * 4 + 15) / 16 * 16 + param * width * out_bytes ||
                        smem > 48 * 1024);
  if (bad_tile || (path != kTile && path != kRows) || blocks < 1 ||
      (out_bytes != 4 && out_bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scales);
  if (out_bytes == 4) {
    return launch<int8_t, float>(q, sc, ids, out, n_ids, n_table_rows, width, path, param,
                                 blocks, smem, s);
  }
  return launch<int8_t, uint16_t>(q, sc, ids, out, n_ids, n_table_rows, width, path, param,
                                  blocks, smem, s);
}
