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
// that is 69 MB, 0.021 ms at 3.35 TB/s; most output rows are zeros. What held
// the first design far above that was not the bytes: a library sort of 17
// device operations a call (four 8-bit passes over 32-bit keys, with int64
// positions), output zeros written two bytes a lane, and a serial walk whose
// every position was a dependent ids -> order -> upd load chain.
//
// Determinism: the sums run in an order fixed by the data, never by the
// schedule, so two launches give the same bits (rectpu's training is bitwise
// reproducible run to run; fp32 atomics would break that). The design, one
// call = 4 + P device operations (P = 2 at ml-100k's 6,144 rows, 3 at the
// flagship's 311,296):
//   0. one memset of the sort's small state (digit counts, tile tickets, the
//      look-back words);
//   1. radix_hist_kernel: the digit counts of every pass at once (ids mapped
//      to keys, every id outside [0, v_rows) to the sentinel key v_rows, which
//      sorts last);
//   2. P x radix_pass_kernel: a stable LSD radix sort of (key, position),
//      8 bits a pass, only as many passes as v_rows needs. Each block ranks a
//      4,096-position tile: within a warp by __match_any_sync and popc, in
//      position order; across the warps of the tile by per-warp digit counts;
//      across tiles by decoupled look-back over per-tile digit counts, tiles
//      taken in ticket order. So equal keys keep their position order: the
//      sorted stream is the stable sort the first design took from the library.
//      The first pass's grid has more blocks than tiles: those zero the output
//      by 16-byte stores (40 MB at the flagship) beside the latency-bound sort;
//   3. scatter_sum_kernel: the sorted stream is cut into pieces of `chunk`
//      positions, one warp a (piece, 32-column slice), lanes on neighbouring
//      columns. The warp loads its piece's keys and positions up front, then
//      32 positions' update values at once (no dependent chain). It sums
//      each run of equal keys in position order: a run that is a whole row is
//      written to `out` at once; a run cut by the piece's edge is written as an
//      fp32 partial (the piece's first or last run);
//   4. scatter_finish_kernel: for each run cut by a piece edge, the warp of the
//      piece where it starts finds its last piece (32 piece edges a load) and
//      adds the partials in piece order, all columns at once, then writes the
//      row.
// The trap this avoids: ml-100k has fields of 2-3 rows (gender, 19 genre
// flags), so at B = 4096 one table row receives 2,000-4,000 updates. Cut into
// `chunk`-position pieces such a row is summed by ~100 warps at once and the
// partials by one warp in ~100 adds.
// The dedupe's segment sum (rectpu_segment_sum) is steps 3-4 alone on a
// stream its caller sorted, after a memset of the output: 3 operations.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;  // of the sum kernel: small blocks balance its last wave
constexpr int kSumBlocksPerSm = 6;  // its register budget (80): ptxas spilled at its own pick
constexpr int kBatch = 16;     // pieces whose partials the finish loads before it adds them
constexpr int kFinishCols = 4; // column groups of 32 a lane of the finish adds at once
constexpr int64_t kMaxBlocks = 132 * 16;

constexpr int kRadixBits = 8;
constexpr int kDigits = 1 << kRadixBits;
constexpr int kRadixThreads = 256;  // one thread a digit in the look-back
constexpr int kRadixWarps = kRadixThreads / kWarp;
constexpr int kRadixItems = 16;     // positions a thread ranks
constexpr int kRadixTile = kRadixThreads * kRadixItems;  // 4,096 positions a block
constexpr int kMaxPasses = 4;
constexpr int64_t kHistBlocks = 264;   // at most, for the digit counts and the zeroing
constexpr int kLookBack = 16;       // predecessor tiles read at once in the look-back
// a look-back word: two flag bits over a 30-bit count (the wrapper keeps R < 2^30)
constexpr uint32_t kFlagAggregate = 1u << 30;
constexpr uint32_t kFlagPrefix = 2u << 30;
constexpr uint32_t kCountMask = kFlagAggregate - 1;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ bool valid_key(int32_t key, int32_t v_rows) {
  return static_cast<uint32_t>(key) < static_cast<uint32_t>(v_rows);
}

// an id's sort key: itself inside [0, v_rows), else the sentinel v_rows
__device__ __forceinline__ uint32_t sort_key(int32_t id, int32_t v_rows) {
  return valid_key(id, v_rows) ? static_cast<uint32_t>(id) : static_cast<uint32_t>(v_rows);
}

// Programmatic dependent launch (Hopper): each kernel of a call's chain is
// launched while the one before it still runs and waits (griddepcontrol.wait,
// which returns once the earlier grid has completed and its writes are
// visible) before it reads anything, so the launch latency between the
// chain's kernels overlaps the tail of the kernel before.
__device__ __forceinline__ void chain_wait() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// `chained` false after a memset: only a kernel may be overlapped
template <typename... Params, typename... Args>
cudaError_t launch_chained(bool chained, void (*kernel)(Params...), int64_t grid, dim3 block,
                           cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = chained ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// zero `bytes` (even) at p: 16-byte stores, then the tail in 2-byte stores;
// thread `first` of a grid of `stride` threads
__device__ __forceinline__ void zero_bytes(void* p, int64_t bytes, int64_t first, int64_t stride) {
  const int64_t n16 = bytes / 16;
  uint4* p16 = static_cast<uint4*>(p);
  for (int64_t i = first; i < n16; i += stride) p16[i] = make_uint4(0u, 0u, 0u, 0u);
  if (first < (bytes % 16) / 2) reinterpret_cast<unsigned short*>(p16 + n16)[first] = 0;
}

// --- 1. digit counts of every pass --------------------------------------------

__global__ void __launch_bounds__(kRadixThreads)
radix_hist_kernel(const int32_t* __restrict__ ids, int n, int32_t v_rows, int passes,
                  uint32_t* __restrict__ hist) {
  chain_wait();
  __shared__ uint32_t counts[kMaxPasses][kDigits];
  for (int i = threadIdx.x; i < kMaxPasses * kDigits; i += kRadixThreads) {
    counts[i / kDigits][i % kDigits] = 0;
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRadixThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRadixThreads + threadIdx.x;
  for (int64_t r = first; r < n; r += stride) {
    const uint32_t key = sort_key(ids[r], v_rows);
    for (int p = 0; p < passes; ++p) {
      atomicAdd(&counts[p][(key >> (kRadixBits * p)) & (kDigits - 1)], 1u);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * kDigits; i += kRadixThreads) {
    const uint32_t c = counts[i / kDigits][i % kDigits];
    if (c) atomicAdd(&hist[i], c);
  }
}

// --- 2. one stable pass of the LSD radix sort --------------------------------

__device__ __forceinline__ uint32_t load_volatile(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

__device__ __forceinline__ void store_volatile(uint32_t* p, uint32_t v) {
  *reinterpret_cast<volatile uint32_t*>(p) = v;
}

// Pass `pass` sorts by bits [8 pass, 8 pass + 8) of the key. The first pass
// reads the raw ids (src_keys = ids, positions implicit), later passes the
// previous pass's (key, position) pairs.
__global__ void __launch_bounds__(kRadixThreads)
radix_pass_kernel(const int32_t* __restrict__ src_keys, const int32_t* __restrict__ src_pos,
                  int32_t* __restrict__ dst_keys, int32_t* __restrict__ dst_pos,
                  const uint32_t* __restrict__ hist, uint32_t* __restrict__ ticket,
                  uint32_t* __restrict__ status, int n, int32_t v_rows, int pass, int tiles,
                  void* out, int64_t out_bytes) {
  __shared__ uint32_t warp_counts[kRadixWarps][kDigits];  // then each warp's exclusive base
  __shared__ uint32_t digit_base[kDigits];
  __shared__ uint32_t scan_tmp[kRadixWarps];
  __shared__ int tile_s;
  chain_wait();
  if (static_cast<int>(blockIdx.x) >= tiles) {  // the blocks past the tiles zero the output
    const int64_t zb = static_cast<int64_t>(gridDim.x) - tiles;
    zero_bytes(out, out_bytes, (static_cast<int64_t>(blockIdx.x) - tiles) * kRadixThreads +
                                   threadIdx.x, zb * kRadixThreads);
    return;
  }
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  if (tid == 0) tile_s = static_cast<int>(atomicAdd(ticket, 1u));  // tiles in ticket order
  const uint32_t digit_count = hist[tid];  // this thread's digit in the whole stream
  for (int i = tid; i < kRadixWarps * kDigits; i += kRadixThreads) {
    warp_counts[i / kDigits][i % kDigits] = 0;
  }
  __syncthreads();
  const int tile = tile_s;
  const int shift = kRadixBits * pass;

  // this warp's 512 positions, warp-striped: item i of lane l is position
  // base + 32 i + l, so (i, l) in lexicographic order is position order
  const int base = tile * kRadixTile + warp * (kWarp * kRadixItems);
  uint32_t keys[kRadixItems];
  int32_t pos[kRadixItems];
  uint32_t rank[kRadixItems];
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    const int r = base + i * kWarp + lane;
    keys[i] = 0xffffffffu;  // past the end: ranks nowhere
    pos[i] = r;
    if (r < n) {
      if (pass == 0) {
        keys[i] = sort_key(src_keys[r], v_rows);
      } else {
        keys[i] = static_cast<uint32_t>(src_keys[r]);
        pos[i] = src_pos[r];
      }
    }
  }
  uint32_t* counts = warp_counts[warp];
  const uint32_t lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    const bool in = keys[i] != 0xffffffffu;
    // a lane past the end matches no other lane
    const uint32_t digit = in ? (keys[i] >> shift) & (kDigits - 1) : kDigits + lane;
    const uint32_t peers = __match_any_sync(0xffffffffu, digit);
    const uint32_t before = in ? counts[digit] : 0u;
    __syncwarp();
    if (in && lane == __ffs(peers) - 1) counts[digit] = before + __popc(peers);
    __syncwarp();
    rank[i] = before + __popc(peers & lanes_below);
  }
  __syncthreads();

  // thread `tid` owns digit `tid`: the warps' exclusive bases and the tile's
  // count of the digit
  const int d = tid;
  uint32_t tile_count = 0;
#pragma unroll
  for (int w = 0; w < kRadixWarps; ++w) {
    const uint32_t c = warp_counts[w][d];
    warp_counts[w][d] = tile_count;
    tile_count += c;
  }
  // decoupled look-back: publish this tile's count, add the predecessors'
  // until one carries its inclusive prefix
  uint32_t* my_status = status + static_cast<int64_t>(tile) * kDigits + d;
  uint32_t before_tile = 0;
  if (tile == 0) {
    store_volatile(my_status, kFlagPrefix | tile_count);
  } else {
    store_volatile(my_status, kFlagAggregate | tile_count);
    int j = tile - 1;
    while (true) {
      uint32_t v[kLookBack];
#pragma unroll
      for (int q = 0; q < kLookBack; ++q) {
        v[q] = j - q >= 0 ? load_volatile(status + static_cast<int64_t>(j - q) * kDigits + d)
                          : kFlagPrefix;  // before tile 0: an empty prefix
      }
      int used = 0;
      bool done = false;
#pragma unroll
      for (int q = 0; q < kLookBack; ++q) {
        if (!done && used == q && v[q] != 0u) {
          before_tile += v[q] & kCountMask;
          used = q + 1;
          done = (v[q] & kFlagPrefix) != 0u;
        }
      }
      if (done) break;
      j -= used;  // a tile that has not published yet is read again
    }
    store_volatile(my_status, kFlagPrefix | (before_tile + tile_count));
  }
  // the digit's first output position: the counts of all smaller digits
  // (an exclusive scan of the pass's histogram) plus the earlier tiles'
  const uint32_t h = digit_count;
  uint32_t incl = h;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const uint32_t t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == kWarp - 1) scan_tmp[warp] = incl;
  __syncthreads();
  uint32_t warps_below = 0;
  for (int w = 0; w < warp; ++w) warps_below += scan_tmp[w];
  digit_base[d] = warps_below + incl - h + before_tile;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRadixItems; ++i) {
    if (keys[i] != 0xffffffffu) {
      const uint32_t digit = (keys[i] >> shift) & (kDigits - 1);
      const uint32_t at = digit_base[digit] + counts[digit] + rank[i];
      dst_keys[at] = static_cast<int32_t>(keys[i]);
      dst_pos[at] = pos[i];
    }
  }
}

// --- 3. the sums of a sorted stream, one warp a piece -------------------------

// A finished run of key `key` inside piece c: write column `col` of it out
// whole, or as the piece's first or last partial.
template <typename TOut>
__device__ __forceinline__ void flush_run(int32_t key, bool starts, bool ends, int64_t c,
                                          int col, int width, float acc,
                                          TOut* __restrict__ out, float* __restrict__ part_first,
                                          float* __restrict__ part_last) {
  if (starts && ends) {
    store_f(out + static_cast<int64_t>(key) * width + col, acc);
  } else {
    // a run cut at the piece's start is its first run, one cut at its end its
    // last; a run cut at both covers the piece and is both
    if (!starts) part_first[c * width + col] = acc;
    if (!ends) part_last[c * width + col] = acc;
  }
}

// keys [n] sorted (runs of equal keys; keys outside [0, v_rows) add nothing),
// pos [n] the row of upd each position sums (int32 from the sort, int64 from
// the segment sum's caller). One warp a (piece, 32-column slice): the warp
// loads the piece's keys and rows, then the slice's values of 32 positions at
// once, then walks them in position order.
template <typename TIn, typename TOut, typename TPos>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, kSumBlocksPerSm)
scatter_sum_kernel(const int32_t* __restrict__ keys, const TPos* __restrict__ pos,
                   const TIn* __restrict__ upd, TOut* __restrict__ out,
                   float* __restrict__ part_first, float* __restrict__ part_last, int64_t n,
                   int32_t v_rows, int width, int chunk, int64_t n_pieces) {
  chain_wait();
  const int lane = threadIdx.x;  // blockDim = (32, kWarpsPerBlock)
  const int slices = (width + kWarp - 1) / kWarp;
  const int64_t n_work = n_pieces * slices;
  const int64_t warp_stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t wk = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.y;
       wk < n_work; wk += warp_stride) {
    const int64_t c = wk / slices;
    const int slice = static_cast<int>(wk - c * slices);
    const int col = slice * kWarp + lane;
    const bool in_row = col < width;
    const int64_t lo = c * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    // the piece's first run is cut at its start if the key before the piece
    // is the same, its last run at its end if the key after it is
    const int32_t first_key = keys[lo];
    const bool first_cut = lo > 0 && keys[lo - 1] == first_key;
    const bool last_cut = hi < n && keys[hi] == keys[hi - 1];
    int32_t cur = first_key;
    bool cur_starts = !first_cut;
    float acc = 0.0f;
    for (int64_t s = lo; s < hi; s += kWarp) {
      const int m = static_cast<int>(hi - s < kWarp ? hi - s : kWarp);
      const int32_t my_key = lane < m ? keys[s + lane] : -1;
      const int64_t my_row = lane < m ? static_cast<int64_t>(pos[s + lane]) * width : 0;
      float v[kWarp];  // the slice of 32 positions' update rows, all loads in flight
#pragma unroll
      for (int q = 0; q < kWarp; ++q) {
        const int64_t row = __shfl_sync(0xffffffffu, my_row, q);
        const int32_t key = __shfl_sync(0xffffffffu, my_key, q);
        v[q] = q < m && in_row && valid_key(key, v_rows) ? load_f(upd + row + col) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kWarp; ++q) {
        if (q >= m) break;
        const int32_t key = __shfl_sync(0xffffffffu, my_key, q);
        if (key != cur) {  // warp-uniform: a new run starts here
          if (valid_key(cur, v_rows) && in_row) {
            flush_run(cur, cur_starts, true, c, col, width, acc, out, part_first, part_last);
          }
          acc = 0.0f;
          cur = key;
          cur_starts = true;
        }
        acc += v[q];  // zero past a dropped key's run
      }
    }
    if (valid_key(cur, v_rows) && in_row) {
      flush_run(cur, cur_starts, !last_cut, c, col, width, acc, out, part_first, part_last);
    }
  }
}

// --- 4. runs that cross piece edges ------------------------------------------

// One warp a piece: if the piece's last run is cut by its end and starts in
// it, the warp finds the run's last piece (32 piece edges a load) and adds the
// partials in piece order (this piece's last-run partial, then each later
// piece's first-run partial), lane l on columns l + 32 j, kBatch pieces
// loaded before they are added, then writes the row.
template <typename TOut>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
scatter_finish_kernel(const int32_t* __restrict__ keys, const float* __restrict__ part_first,
                      const float* __restrict__ part_last, TOut* __restrict__ out, int64_t n,
                      int32_t v_rows, int width, int chunk, int64_t n_pieces) {
  chain_wait();
  const int lane = threadIdx.x;
  const int64_t warp_stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.y;
       c < n_pieces; c += warp_stride) {
    const int64_t lo = c * chunk;
    const int64_t hi = lo + chunk;
    if (hi >= n) continue;  // the last piece: nothing after it
    const int32_t key = keys[hi - 1];
    if (keys[hi] != key || !valid_key(key, v_rows)) continue;  // its last run is not cut
    // the run starts in this piece unless the piece is all of it and it
    // started before
    if (lo > 0 && keys[lo] == key && keys[lo - 1] == key) continue;
    int64_t last = -1;
    for (int64_t c0 = c + 1; last < 0; c0 += kWarp) {
      const int64_t cc = c0 + lane;
      const int64_t end = (cc + 1) * chunk;
      const bool ends = cc < n_pieces && (end >= n || keys[end] != key);
      const uint32_t hits = __ballot_sync(0xffffffffu, ends);
      if (hits) last = c0 + __ffs(hits) - 1;
    }
    for (int col_base = 0; col_base < width; col_base += kFinishCols * kWarp) {
      float acc[kFinishCols];
#pragma unroll
      for (int j = 0; j < kFinishCols; ++j) {
        const int col = col_base + j * kWarp + lane;
        acc[j] = col < width ? part_last[c * width + col] : 0.0f;
      }
      for (int64_t p0 = c + 1; p0 <= last; p0 += kBatch) {
        float v[kBatch][kFinishCols];
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
#pragma unroll
          for (int j = 0; j < kFinishCols; ++j) {
            const int col = col_base + j * kWarp + lane;
            v[b][j] = p0 + b <= last && col < width ? part_first[(p0 + b) * width + col] : 0.0f;
          }
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
#pragma unroll
          for (int j = 0; j < kFinishCols; ++j) {
            if (p0 + b <= last) acc[j] += v[b][j];
          }
      }
#pragma unroll
      for (int j = 0; j < kFinishCols; ++j) {
        const int col = col_base + j * kWarp + lane;
        if (col < width) store_f(out + static_cast<int64_t>(key) * width + col, acc[j]);
      }
    }
  }
}

template <typename TIn, typename TOut, typename TPos>
cudaError_t launch_sums(const int32_t* keys, const TPos* pos, const void* upd, void* out,
                        float* part_first, float* part_last, int64_t n, int32_t v_rows,
                        int width, int chunk, bool after_kernel, cudaStream_t s) {
  const int64_t n_pieces = (n + chunk - 1) / chunk;
  if (n_pieces == 0) return cudaSuccess;
  const int slices = (width + kWarp - 1) / kWarp;
  int64_t blocks = (n_pieces * slices + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 block(kWarp, kWarpsPerBlock);
  cudaError_t err = launch_chained(after_kernel, scatter_sum_kernel<TIn, TOut, TPos>, blocks, block, s, keys, pos,
                                   static_cast<const TIn*>(upd), static_cast<TOut*>(out),
                                   part_first, part_last, n, v_rows, width, chunk, n_pieces);
  if (err != cudaSuccess || n_pieces == 1) return err;
  int64_t fin_blocks = (n_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (fin_blocks > kMaxBlocks) fin_blocks = kMaxBlocks;
  return launch_chained(true, scatter_finish_kernel<TOut>, fin_blocks, block, s, keys,
                        static_cast<const float*>(part_first),
                        static_cast<const float*>(part_last), static_cast<TOut*>(out), n, v_rows,
                        width, chunk, n_pieces);
}

int64_t grid_blocks(int64_t work) {
  int64_t blocks = (work + kRadixThreads - 1) / kRadixThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : blocks;
}

template <typename TIn, typename TOut>
cudaError_t launch_scatter(const int32_t* ids, const void* upd, void* out, int32_t* sorted,
                           uint32_t* state, float* part_first, float* part_last, int n,
                           int32_t v_rows, int width, int chunk, int passes, cudaStream_t s) {
  const int tiles = (n + kRadixTile - 1) / kRadixTile;
  uint32_t* hist = state;                    // [passes][256]
  uint32_t* tickets = hist + passes * kDigits;  // [passes]
  uint32_t* status = tickets + passes;       // [passes][tiles][256]
  cudaError_t err = cudaMemsetAsync(
      state, 0, sizeof(uint32_t) * (static_cast<size_t>(passes) * kDigits * (1 + tiles) + passes),
      s);
  if (err != cudaSuccess) return err;
  const int64_t out_bytes = static_cast<int64_t>(v_rows) * width * sizeof(TOut);
  if (n == 0) return cudaMemsetAsync(out, 0, static_cast<size_t>(out_bytes), s);
  const int64_t hist_blocks = grid_blocks(n) < kHistBlocks ? grid_blocks(n) : kHistBlocks;
  err = launch_chained(false, radix_hist_kernel, hist_blocks, dim3(kRadixThreads), s, ids, n,
                       v_rows, passes, hist);
  if (err != cudaSuccess || n == 0) return err;
  // ping-pong: pass p writes buffer p % 2 (keys, then positions)
  int32_t* buf[2][2] = {{sorted, sorted + n}, {sorted + 2 * static_cast<int64_t>(n),
                                               sorted + 3 * static_cast<int64_t>(n)}};
  // the first pass's grid also zeroes the output, beside the sort's tiles
  const int64_t zeroing = grid_blocks(out_bytes / 16) < kHistBlocks ? grid_blocks(out_bytes / 16)
                                                                    : kHistBlocks;
  for (int p = 0; p < passes; ++p) {
    const int32_t* src_keys = p == 0 ? ids : buf[(p + 1) % 2][0];
    const int32_t* src_pos = p == 0 ? nullptr : buf[(p + 1) % 2][1];
    err = launch_chained(true, radix_pass_kernel, tiles + (p == 0 ? zeroing : 0),
                         dim3(kRadixThreads), s, src_keys, src_pos, buf[p % 2][0], buf[p % 2][1],
                         static_cast<const uint32_t*>(hist + p * kDigits), tickets + p,
                         status + static_cast<int64_t>(p) * tiles * kDigits, n, v_rows, p, tiles,
                         out, out_bytes);
    if (err != cudaSuccess) return err;
  }
  const int32_t* keys = buf[(passes - 1) % 2][0];
  const int32_t* pos = buf[(passes - 1) % 2][1];
  return launch_sums<TIn, TOut, int32_t>(keys, pos, upd, out, part_first, part_last, n, v_rows,
                                         width, chunk, true, s);
}

}  // namespace

// ids [n] int32; upd [n, width] fp32 or bf16 (in_bf16); out [v_rows, width]
// fp32 or bf16 (out_bf16), zeroed here; sorted [4, n] int32 scratch (two
// ping-pong buffers of keys and positions); state: passes * 256 * (1 +
// ceil(n / 4096)) + passes int32 scratch, zeroed here; part_first/part_last
// [ceil(n / chunk), width] fp32 scratch; all contiguous on one device.
// passes: 8-bit radix passes, enough for the key v_rows (bit_length(v_rows)
// <= 8 * passes <= 32). Returns a cudaError_t as int.
extern "C" int rectpu_scatter_rows(const void* ids, const void* upd, void* out, void* sorted,
                                   void* state, void* part_first, void* part_last, int n,
                                   int v_rows, int width, int chunk, int passes, int in_bf16,
                                   int out_bf16, void* stream) {
  if (v_rows == 0 || width == 0) return static_cast<int>(cudaSuccess);
  if (chunk < 1 || n < 0 || n >= (1 << 30) || v_rows < 0 || passes < 1 ||
      passes > kMaxPasses || (passes < kMaxPasses && (v_rows >> (kRadixBits * passes)) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* id = static_cast<const int32_t*>(ids);
  int32_t* so = static_cast<int32_t*>(sorted);
  uint32_t* st = static_cast<uint32_t*>(state);
  float* pf = static_cast<float*>(part_first);
  float* pl = static_cast<float*>(part_last);
  cudaError_t err;
  if (in_bf16 && out_bf16) {
    err = launch_scatter<__nv_bfloat16, __nv_bfloat16>(id, upd, out, so, st, pf, pl, n,
                                                       v_rows, width, chunk, passes, s);
  } else if (in_bf16) {
    err = launch_scatter<__nv_bfloat16, float>(id, upd, out, so, st, pf, pl, n, v_rows,
                                               width, chunk, passes, s);
  } else if (out_bf16) {
    err = launch_scatter<float, __nv_bfloat16>(id, upd, out, so, st, pf, pl, n, v_rows,
                                               width, chunk, passes, s);
  } else {
    err = launch_scatter<float, float>(id, upd, out, so, st, pf, pl, n, v_rows, width,
                                       chunk, passes, s);
  }
  return static_cast<int>(err);
}

// seg [n] int32 nondecreasing (segment ordinals; those outside [0, num_out)
// add nothing), order [n] int64 (the row of upd each position sums), upd
// [rows, width] fp32 or bf16 (in_bf16), out [num_out, width] fp32, zeroed
// here; part_first/part_last [ceil(n / chunk), width] fp32 scratch; all
// contiguous on one device. Returns a cudaError_t as int.
extern "C" int rectpu_segment_sum(const void* seg, const void* order, const void* upd,
                                  void* out, void* part_first, void* part_last, long long n,
                                  int num_out, int width, int chunk, int in_bf16,
                                  void* stream) {
  if (num_out == 0 || width == 0) return static_cast<int>(cudaSuccess);
  if (chunk < 1 || n < 0 || num_out < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(float) * static_cast<size_t>(num_out) * static_cast<size_t>(width), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t* keys = static_cast<const int32_t*>(seg);
  const int64_t* pos = static_cast<const int64_t*>(order);
  float* pf = static_cast<float*>(part_first);
  float* pl = static_cast<float*>(part_last);
  err = in_bf16 ? launch_sums<__nv_bfloat16, float, int64_t>(keys, pos, upd, out, pf, pl, n,
                                                             num_out, width, chunk, false, s)
                : launch_sums<float, float, int64_t>(keys, pos, upd, out, pf, pl, n, num_out,
                                                     width, chunk, false, s);
  return static_cast<int>(err);
}
