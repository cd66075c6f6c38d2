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
//     matrix unit. The round_products flag selects these numerics.
// On the TPU the pairs were grouped by left field so that one widened multiply
// fed many lane reductions, and the batch was padded to 256-row blocks and the
// output to 128 lanes for VMEM. None of that carries over: rows are not padded
// in device memory and the output is written at its real width P.
//
// What bounds it on this card: bytes. It reads B*n*K input values once and
// writes B*P fp32 outputs; the arithmetic is K multiply-adds per output. At
// the DLRM shape (B=8192, n=26, K=64, bf16, P=325) that is 27.3 MB read and
// 10.6 MB written, 0.011 ms at 3.35 TB/s, against 0.35 GFLOP.
//
// Design. Persistent blocks of 256 threads (as many as fit the SMs at once)
// walk groups of `rows` batch rows (at most 8). Each group's contiguous
// [rows, n*K] slab is staged in shared memory in the input's own type, with
// 16-byte cp.async copies (plain loads when K or the pointer is not 16-byte
// aligned), into two buffers: the next group's copy is in flight while this
// group is computed. A row's n vectors sit at a stride of K padded to 16 plus
// 16 bytes (ldmatrix reads 8 vectors without a bank conflict; on the ones
// path 64 modulo 128 bytes, so a quarter warp's 16-byte loads of 2
// neighbouring vectors fill one wavefront), rows n..16k-1 and columns
// K..16k-1 are zero, and two batch rows are 16 bytes apart modulo 128 (the
// fp32 path's 8 neighbouring threads read 8 batch rows without a conflict).
// Each group's P outputs a row are gathered in shared memory in triu order and
// written with 16-byte stores. The wrapper lists each path's units of work (a
// run of tiles of the dot matrix G = V V^T in one row of tiles, from the
// diagonal rightwards, the tiles wholly below it skipped); an entry (i, j) of
// G goes to its triu column by closed form (row_base(i) + j), or nowhere.
// Three compute paths, chosen by the wrapper:
//   - gram (bf16, exact products): G on the tensor cores, mma.sync.m16n8k16
//     (bf16 in, fp32 accumulate): a unit is one 16-row tile of G against up
//     to four 8-column tiles, A = V read once a k step by ldmatrix.x4, B =
//     V^T by ldmatrix.x2 (2 units and 24 mma a row at n=26); a warp walks
//     one batch row's units. bf16 products are exact in fp32, so this is the
//     function; the tensor cores truncate their fp32 adds, within the stated
//     2^-23 an add.
//   - ones (bf16, rounded products): the tensor cores sum products that each
//     thread forms in registers with mul.rn.bf16x2 (one rounding of the exact
//     product, the bits of __float2bfloat16(a*b)), against a B fragment of
//     ones: rectpu's block-ones reduction. A unit is 4 i vectors against up
//     to four blocks of 4 j vectors, one mma a block and k step whose 16 A
//     rows are the block's 16 pairs, so a thread loads its two i vectors
//     once a k step and one j vector a block, and a warp takes a unit for
//     two batch rows at once (twice the independent mma chains). The 4 x 4
//     blocks on the triangle's edge hold pairs outside it: 112 mma a row at
//     n=26 for 81 mma of pairs.
//   - tile (fp32, both modes): 4 x 4 register tiles of G on the CUDA cores,
//     16-byte loads, fmaf (exact) or __fmul_rn then __fadd_rn (rounded);
//     never TF32.
// The mma loops are instantiated for each tile count, so no mma sits behind a
// branch: guarded, each mma became a basic block of its own whose load,
// products and mma ran in series.
// Limit: a row's two staging buffers and its P outputs fit one block's 227 KB
// of shared memory (the wrapper raises a ValueError beyond it): at K=64 with
// the diagonal that is n <= 272 (bf16 exact), 256 (bf16 rounded) and 225
// (fp32), far above every DLRM the port trains or serves (n = 26 or 27 at
// bench.py's widths, K=64).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

enum Path { kGram = 0, kOnes = 1, kTile = 2 };

constexpr int kGramPer = 4;  // 8-column tiles a gram unit (UNIT in ops/interaction.py)
constexpr int kOnesPer = 4;  // 4-vector blocks a ones unit

// the wrapper's launch plan (rectpu_torch/ops/interaction.py::plan)
struct Geometry {
  int n_vec, k_dim, n_pairs;
  int diag;     // 1 when the pairs include (i, i)
  int n_pad;    // n rounded up to 16: rows of a staged tile
  int k_pad;    // K rounded up to 16: columns that the compute loops read
  int ld;       // elements from one vector to the next in shared memory
  int rs;       // elements from one batch row's tile to the next
  int rows;     // batch rows a group
  int n_items;  // units of work a batch row
};

// Entry (i, j) of G, j - i >= 1 - diag and j < n, goes to output column
// row_base(i) + j (np.triu_indices order); every other entry goes nowhere.
__device__ __forceinline__ int row_base(int i, const Geometry& g) {
  const int skip = 1 - g.diag;
  return i * (g.n_vec - skip) - i * (i - 1) / 2 - i - skip;
}

__device__ __forceinline__ bool in_triangle(int i, int j, const Geometry& g) {
  return j - i >= 1 - g.diag && j < g.n_vec;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {  // all but the newest group landed
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d[16 x 8] += a[16 x 16] * b[16 x 8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 products, each rounded once to bf16 (round to nearest even)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Where a thread's staging copy c = threadIdx.x + kThreads * i starts in the
// group buffer, and how far one step moves it: element (row, vector, k) of
// the [rows, n, K] slab. Each step adds a fixed (row, vector, k) with one
// carry a level, so the walk needs no division after the first.
struct Walk {
  int r, f, k;
};

__device__ __forceinline__ Walk split(int e, const Geometry& g) {
  const int width = g.n_vec * g.k_dim;
  const int r = e / width;
  const int f = (e - r * width) / g.k_dim;
  return {r, f, e - r * width - f * g.k_dim};
}

__device__ __forceinline__ void advance(Walk& w, const Walk& step, const Geometry& g) {
  w.k += step.k;
  w.f += step.f;
  w.r += step.r;
  if (w.k >= g.k_dim) {
    w.k -= g.k_dim;
    ++w.f;
  }
  if (w.f >= g.n_vec) {
    w.f -= g.n_vec;
    ++w.r;
  }
}

// Copy `rows_here` rows of the contiguous [rows, n*K] slab at src into a
// group buffer: vector f of row r at buf[r * rs + f * ld].
template <typename T, bool kVec>
__device__ __forceinline__ void stage(const T* __restrict__ src, T* buf, int rows_here,
                                      const Geometry& g, const Walk& start, const Walk& step) {
  constexpr int kCh = kVec ? 16 / sizeof(T) : 1;  // elements a copy
  const int len = rows_here * g.n_vec * g.k_dim;
  Walk w = start;
  for (int e = threadIdx.x * kCh; e < len; e += kThreads * kCh) {
    T* dst = buf + w.r * g.rs + w.f * g.ld + w.k;
    if (kVec) {
      cp_async16(dst, src + e);
    } else {
      *dst = src[e];
    }
    advance(w, step, g);
  }
}

// Write a group's outputs (len floats, contiguous in device memory) with
// 16-byte stores between a scalar head and tail.
__device__ __forceinline__ void store_out(const float* outs, float* __restrict__ dst, int len) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
  const int head = min(len, (4 - mis) & 3);
  const int body = (len - head) >> 2;
  for (int e = threadIdx.x; e < head; e += kThreads) dst[e] = outs[e];
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int v = threadIdx.x; v < body; v += kThreads) {
    const float* s = outs + head + 4 * v;
    d4[v] = make_float4(s[0], s[1], s[2], s[3]);
  }
  for (int e = head + 4 * body + threadIdx.x; e < len; e += kThreads) dst[e] = outs[e];
}

// The mma loops below take their tile count as a template argument, so that
// no mma sits behind a branch: a guarded mma is a basic block of its own,
// and the loads, products and mma of one tile then run in series.

// gram, one unit: d[t] += A (16 rows from a_addr) * B (8 rows from b_addr +
// 8t vectors) over the k steps
template <int kTiles>
__device__ __forceinline__ void gram_unit(unsigned a_addr, unsigned b_addr, const Geometry& g,
                                          float (&d)[kGramPer][4]) {
  for (int k0 = 0; k0 < g.k_pad; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, a_addr + k0 * 2);
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      uint32_t b[2];
      ldmatrix_x2(b, b_addr + (t * 8 * g.ld + k0) * 2);
      mma_bf16(d[t], a, b);
    }
  }
}

// gram: unit (i0, j0) = one 16-row tile of G = V V^T against up to 4 of its
// 8-column tiles from j0 (those left of n). A is read once a k step by
// ldmatrix.x4 and feeds the unit's mma; B = V^T by ldmatrix.x2.
__device__ __forceinline__ void compute_gram(const __nv_bfloat16* cur, float* outs,
                                             int rows_here, const int* __restrict__ units,
                                             const Geometry& g) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  // item = unit * rows + row, warp w taking items w, w + kWarps, ...: with 8
  // rows a group, warp w walks every unit of row w
  for (int item = threadIdx.x >> 5; item < g.n_items * g.rows; item += kWarps) {
    const int u = item / g.rows;
    const int r = item - u * g.rows;
    if (r >= rows_here) continue;
    const int code = __ldg(units + u);  // i0 << 16 | j0 << 3 | tiles
    const int i0 = code >> 16;
    const int j0 = (code >> 3) & 0x1fff;
    const int tiles = code & 7;
    const __nv_bfloat16* v = cur + r * g.rs;
    // A rows i0 + (lane & 15), column half (lane >> 4); B rows j0 + (lane & 7),
    // column half (lane >> 3) & 1 (lanes 16-31 give addresses ldmatrix ignores)
    const unsigned a_addr = smem_addr(v + (i0 + (lane & 15)) * g.ld + (lane >> 4) * 8);
    const unsigned b_addr = smem_addr(v + (j0 + (lane & 7)) * g.ld + ((lane >> 3) & 1) * 8);
    float d[kGramPer][4] = {};
    switch (tiles) {
      case 1: gram_unit<1>(a_addr, b_addr, g, d); break;
      case 2: gram_unit<2>(a_addr, b_addr, g, d); break;
      case 3: gram_unit<3>(a_addr, b_addr, g, d); break;
      default: gram_unit<4>(a_addr, b_addr, g, d); break;
    }
    // d[t][0], d[t][1]: G[i0 + gq][j0 + 8t + 2tq + {0, 1}]; [2], [3]: row i0 + gq + 8
    float* o = outs + r * g.n_pairs;
    const int i = i0 + gq;
    float* o_lo = o + row_base(i, g);
    float* o_hi = o + row_base(i + 8, g);
#pragma unroll
    for (int t = 0; t < kGramPer; ++t) {
      if (t < tiles) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 8 * t + 2 * tq + e;
          if (in_triangle(i, j, g)) o_lo[j] = d[t][e];
          if (in_triangle(i + 8, j, g)) o_hi[j] = d[t][2 + e];
        }
      }
    }
  }
}

// ones, one unit for kRows batch rows (rs elements apart): d[r][t] += the
// products of the i vectors at vi (rows gq / 4 and + 2) and the j vector at
// vj + 4t vectors (row gq % 4), summed by mma against ones. The A fragment's
// 16 k slots may hold any 16 of the row's k, as B is all ones: over 32 k a
// lane takes k0 + 8tq + [0, 8) with one 16-byte load a vector (vi, vj point
// at 8tq), the first 4 for one mma and the last 4 for the next; a last 16 k
// take k0 + 4tq + [0, 4). Two rows give each k step twice the independent
// mma chains.
template <int kRows, int kBlocks>
__device__ __forceinline__ void ones_unit(const __nv_bfloat16* vi, const __nv_bfloat16* vj,
                                          const Geometry& g, float (&d)[2][kOnesPer][4]) {
  const uint32_t ones[2] = {0x3F803F80u, 0x3F803F80u};  // bf16 1.0 twice
  int k0 = 0;
  for (; k0 + 32 <= g.k_pad; k0 += 32) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const __nv_bfloat16* ri = vi + r * g.rs + k0;
      const __nv_bfloat16* rj = vj + r * g.rs + k0;
      const uint4 lo = *reinterpret_cast<const uint4*>(ri);
      const uint4 hi = *reinterpret_cast<const uint4*>(ri + 2 * g.ld);
#pragma unroll
      for (int t = 0; t < kBlocks; ++t) {
        const uint4 y = *reinterpret_cast<const uint4*>(rj + 4 * t * g.ld);
        const uint32_t a0[4] = {mul_bf16x2(lo.x, y.x), mul_bf16x2(hi.x, y.x),
                                mul_bf16x2(lo.y, y.y), mul_bf16x2(hi.y, y.y)};
        mma_bf16(d[r][t], a0, ones);
        const uint32_t a1[4] = {mul_bf16x2(lo.z, y.z), mul_bf16x2(hi.z, y.z),
                                mul_bf16x2(lo.w, y.w), mul_bf16x2(hi.w, y.w)};
        mma_bf16(d[r][t], a1, ones);
      }
    }
  }
  if (k0 < g.k_pad) {
    const int at = k0 - 4 * (threadIdx.x & 3);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const __nv_bfloat16* ri = vi + r * g.rs + at;
      const __nv_bfloat16* rj = vj + r * g.rs + at;
      const uint2 lo = *reinterpret_cast<const uint2*>(ri);
      const uint2 hi = *reinterpret_cast<const uint2*>(ri + 2 * g.ld);
#pragma unroll
      for (int t = 0; t < kBlocks; ++t) {
        const uint2 y = *reinterpret_cast<const uint2*>(rj + 4 * t * g.ld);
        const uint32_t a[4] = {mul_bf16x2(lo.x, y.x), mul_bf16x2(hi.x, y.x),
                               mul_bf16x2(lo.y, y.y), mul_bf16x2(hi.y, y.y)};
        mma_bf16(d[r][t], a, ones);
      }
    }
  }
}

template <int kRows>
__device__ __forceinline__ void ones_rows(int blocks, const __nv_bfloat16* vi,
                                          const __nv_bfloat16* vj, const Geometry& g,
                                          float (&d)[2][kOnesPer][4]) {
  switch (blocks) {
    case 1: ones_unit<kRows, 1>(vi, vj, g, d); break;
    case 2: ones_unit<kRows, 2>(vi, vj, g, d); break;
    case 3: ones_unit<kRows, 3>(vi, vj, g, d); break;
    default: ones_unit<kRows, 4>(vi, vj, g, d); break;
  }
}

// ones: unit (i0, j0, blocks) = the 4 vectors i0.. against `blocks` (<= 4)
// blocks of 4 vectors from j0, one mma a block and k step whose A row gq
// (gq + 8) holds the products of pair (i0 + gq / 4 (+ 2), j0 + 4t + gq % 4),
// formed in registers by mul.rn.bf16x2, so a lane loads two i vectors a k
// step and one j vector a block. B is all ones, so every column of D holds
// the rows' sums, and the lanes of a row (tq) share the writes. A warp takes
// a unit for two batch rows at once.
__device__ __forceinline__ void compute_ones(const __nv_bfloat16* cur, float* outs,
                                             int rows_here, const int* __restrict__ units,
                                             const Geometry& g) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int row_pairs = (g.rows + 1) / 2;
  for (int item = threadIdx.x >> 5; item < g.n_items * row_pairs; item += kWarps) {
    const int u = item / row_pairs;
    const int r = 2 * (item - u * row_pairs);
    if (r >= rows_here) continue;
    const int rows = min(2, rows_here - r);
    const int code = __ldg(units + u);
    const int i0 = code >> 16;
    const int j0 = (code >> 3) & 0x1fff;
    const int blocks = code & 7;
    const __nv_bfloat16* v = cur + r * g.rs + 8 * tq;
    const __nv_bfloat16* vi = v + (i0 + (gq >> 2)) * g.ld;
    const __nv_bfloat16* vj = v + (j0 + (gq & 3)) * g.ld;
    float d[2][kOnesPer][4] = {};
    if (rows == 2) {
      ones_rows<2>(blocks, vi, vj, g, d);
    } else {
      ones_rows<1>(blocks, vi, vj, g, d);
    }
    // lane tq writes block tq: rows i (d[.][tq][0]) and i + 2 (d[.][tq][2]),
    // column j0 + 4tq + gq % 4
    const int i = i0 + (gq >> 2);
    const int j = j0 + 4 * tq + (gq & 3);
    const bool lo_in = tq < blocks && in_triangle(i, j, g);
    const bool hi_in = tq < blocks && in_triangle(i + 2, j, g);
    const int c_lo = row_base(i, g) + j;
    const int c_hi = row_base(i + 2, g) + j;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (rr < rows) {
        const float (&e)[kOnesPer][4] = d[rr];
        float* o = outs + (r + rr) * g.n_pairs;
        if (lo_in) o[c_lo] = tq == 0 ? e[0][0] : tq == 1 ? e[1][0] : tq == 2 ? e[2][0] : e[3][0];
        if (hi_in) o[c_hi] = tq == 0 ? e[0][2] : tq == 1 ? e[1][2] : tq == 2 ? e[2][2] : e[3][2];
      }
    }
  }
}

// tile: thread-level 4 x 4 tiles of G in fp32, item = tile * rows + row
template <bool kRound>
__device__ __forceinline__ void compute_tile(const float* cur, float* outs, int rows_here,
                                             const int* __restrict__ tiles, const Geometry& g) {
  for (int item = threadIdx.x; item < g.n_items * g.rows; item += kThreads) {
    const int t = item / g.rows;
    const int r = item - t * g.rows;
    if (r >= rows_here) continue;
    const int code = __ldg(tiles + t);
    const int i0 = code >> 16;
    const int j0 = (code >> 3) & 0x1fff;
    const float* v = cur + r * g.rs;
    float acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = 0.0f;
    for (int k0 = 0; k0 < g.k_pad; k0 += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        a[x] = *reinterpret_cast<const float4*>(v + (i0 + x) * g.ld + k0);
        b[x] = *reinterpret_cast<const float4*>(v + (j0 + x) * g.ld + k0);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          if (kRound) {
            acc[x][y] = __fadd_rn(acc[x][y], __fmul_rn(a[x].x, b[y].x));
            acc[x][y] = __fadd_rn(acc[x][y], __fmul_rn(a[x].y, b[y].y));
            acc[x][y] = __fadd_rn(acc[x][y], __fmul_rn(a[x].z, b[y].z));
            acc[x][y] = __fadd_rn(acc[x][y], __fmul_rn(a[x].w, b[y].w));
          } else {
            acc[x][y] = fmaf(a[x].x, b[y].x, acc[x][y]);
            acc[x][y] = fmaf(a[x].y, b[y].y, acc[x][y]);
            acc[x][y] = fmaf(a[x].z, b[y].z, acc[x][y]);
            acc[x][y] = fmaf(a[x].w, b[y].w, acc[x][y]);
          }
        }
      }
    }
    float* o = outs + r * g.n_pairs;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        if (in_triangle(i0 + x, j0 + y, g)) o[row_base(i0 + x, g) + j0 + y] = acc[x][y];
      }
    }
  }
}

// the ones path is held to 128 registers a thread, two blocks an SM: freer,
// the compiler's schedule of its mma loops ran slower on an H100
template <typename T, int kPath, bool kRound, bool kVec>
__global__ void __launch_bounds__(kThreads, kPath == kOnes ? 2 : 1)
interact_kernel(const T* __restrict__ flat, const int* __restrict__ table,
                float* __restrict__ out, int n_rows, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* bufs = reinterpret_cast<T*>(smem);
  const int buf_elems = g.rows * g.rs;
  float* outs = reinterpret_cast<float*>(bufs + 2 * buf_elems);
  {  // zero both buffers: the padding rows and columns are never copied
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n16 = 2 * buf_elems * static_cast<int>(sizeof(T)) / 16;
    for (int i = threadIdx.x; i < n16; i += kThreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  const int64_t width = static_cast<int64_t>(g.n_vec) * g.k_dim;
  const int n_groups = (n_rows + g.rows - 1) / g.rows;
  constexpr int kCh = kVec ? 16 / sizeof(T) : 1;
  const Walk start = split(threadIdx.x * kCh, g);
  const Walk step = split(kThreads * kCh, g);
  int grp = blockIdx.x;
  if (grp < n_groups) {
    stage<T, kVec>(flat + grp * g.rows * width, bufs, min(g.rows, n_rows - grp * g.rows), g,
                   start, step);
  }
  cp_async_commit();
  for (int it = 0; grp < n_groups; grp += gridDim.x, ++it) {
    const T* cur = bufs + (it & 1) * buf_elems;
    const int next = grp + gridDim.x;
    // the other buffer was last read before the barrier that ended the
    // previous iteration's compute
    if (next < n_groups) {
      stage<T, kVec>(flat + next * g.rows * width, bufs + ((it + 1) & 1) * buf_elems,
                     min(g.rows, n_rows - next * g.rows), g, start, step);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const int rows_here = min(g.rows, n_rows - grp * g.rows);
    if constexpr (kPath == kGram) {
      compute_gram(cur, outs, rows_here, table, g);
    } else if constexpr (kPath == kOnes) {
      compute_ones(cur, outs, rows_here, table, g);
    } else {
      compute_tile<kRound>(cur, outs, rows_here, table, g);
    }
    __syncthreads();
    store_out(outs, out + static_cast<int64_t>(grp) * g.rows * g.n_pairs,
              rows_here * g.n_pairs);
  }
}

template <typename T, int kPath, bool kRound>
int launch(const void* flat, const void* table, void* out, int n_rows, const Geometry& g,
           int smem, cudaStream_t stream) {
  const bool vec = (static_cast<int64_t>(g.k_dim) * sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(flat) & 15) == 0;
  auto kernel = vec ? interact_kernel<T, kPath, kRound, true>
                    : interact_kernel<T, kPath, kRound, false>;
  if (smem > kDefaultSmem) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_groups = (n_rows + g.rows - 1) / g.rows;
  const int blocks = min(n_groups, (per_sm > 0 ? per_sm : 1) * sms);
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const T*>(flat),
                                             static_cast<const int*>(table),
                                             static_cast<float*>(out), n_rows, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// flat: [n_rows, n_vec * k_dim] contiguous, fp32 or bf16 (is_bf16); out:
// [n_rows, n_pairs] fp32 contiguous; itself: the pairs include (i, i). path 0
// (gram, bf16 exact), 1 (ones, bf16 rounded) or 2 (tile, fp32; round_products
// picks the rounding). units: the path's n_items units of work on the
// device, int32 (i0 << 16 | j0 << 3 | tiles). The geometry and smem_bytes
// come from the wrapper's plan. Returns a cudaError_t as int (0 = ok).
extern "C" int rectpu_interact(const void* flat, const void* units, void* out, int n_rows,
                               int n_vec, int k_dim, int n_pairs, int itself, int n_pad,
                               int k_pad, int ld, int rs, int rows, int n_items, int path,
                               int is_bf16, int round_products, int smem_bytes, void* stream) {
  if (n_rows == 0 || n_pairs == 0) return static_cast<int>(cudaSuccess);
  const int es = is_bf16 ? 2 : 4;
  const int64_t need = 2LL * rows * rs * es + 4LL * rows * n_pairs;
  if (n_vec < 1 || n_vec > 0xffff || k_dim < 1 || rows < 1 || n_items < 1 ||
      n_pad < n_vec || n_pad % 16 != 0 || k_pad < k_dim || k_pad % 16 != 0 ||
      ld < k_pad || (ld * es) % 16 != 0 || rs < n_pad * ld || (rs * es) % 16 != 0 ||
      smem_bytes < need || smem_bytes > kMaxSmem ||
      (path == kTile) == (is_bf16 != 0) || (is_bf16 && (path == kOnes) != (round_products != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{n_vec, k_dim, n_pairs, itself ? 1 : 0, n_pad, k_pad, ld, rs, rows, n_items};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == kGram) {
    return launch<__nv_bfloat16, kGram, false>(flat, units, out, n_rows, g, smem_bytes, s);
  }
  if (path == kOnes) {
    return launch<__nv_bfloat16, kOnes, true>(flat, units, out, n_rows, g, smem_bytes, s);
  }
  return round_products ? launch<float, kTile, true>(flat, units, out, n_rows, g, smem_bytes, s)
                        : launch<float, kTile, false>(flat, units, out, n_rows, g, smem_bytes, s);
}
