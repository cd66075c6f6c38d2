// The xDeepFM CIN core for Hopper (sm_90a), two entries:
//   contraction: out[b, o, k] = sum_{h, m} w[h, m, o] * round(x[b, h, k] * y[b, m, k])
//   dw:          dw[h, m, o]  = sum_{b, k} round(x[b, h, k] * y[b, m, k]) * g[b, o, k]
// round() is to x's type; the sums are fp32; the contraction's result is
// rounded to x's type, dw is fp32. These are the numerics of every rectpu form
// (cin_core_xla and both Pallas variants); in fp32 each product of round(x*y)
// with w or g is formed from three TF32 products, within about 3 * 2^-22 of
// it (below).
//
// Replaces three TPU kernels:
//   - rectpu/ops/cin.py::_cin_fwd_kernel (:70) and ::_cin_fwd_kernel_mloop
//     (:88), the contraction, run by _cin_pallas (:136) for the forward and,
//     with the weight axes permuted, for both activation gradients of _cin_bwd
//     (:220): dx = cin(g, y, w^(2,1,0)), dy = cin(g, x, w^(2,0,1));
//   - ::_cin_dw_kernel (:101), the weight gradient (_cin_dw_pallas, :170).
// On the TPU the wrapper transposed every operand to [K, B, *] so the grid
// walked k on the leading axis, padded the batch to 256-row tiles, and the
// "mloop" variant split the product into M rank-2 dots because Mosaic refused
// the [TB, H, M] -> [TB, H*M] collapse; dw accumulated across the sequential
// grid in one output block. None of that carries over: the operands are read
// in place through their strides (the legacy [B, *, K] and the K-major
// [B, K, *] layouts alike), nothing is padded in device memory, and dw is
// reduced in two passes because blocks run in no order.
//
// What bounds it on this card: operations. Read as a matrix product, each
// (b, k) pair is a row r, kr[r, (h, m)] = round(x*y) is an [R, H*M] operand
// that is generated, never stored, and the contraction is kr @ W with W =
// w.reshape(H*M, O). At the xDeepFM shape (B=8192, K=64: R = 524,288; layer 1
// H = M = 26, layer 2 H = 64, M = 26; O = 64) a training step runs 4 such
// products per layer (forward, dx, dy, dw), about 628 GFLOP, 0.64 ms at the
// 989 TFLOP/s bf16 tensor-core peak, while the bytes are a few hundred MB. The
// expansion itself (1.7 GB in bf16 per layer at this shape) never touches
// device memory.
//
// The weight gradient alone (dw) is 111.7 GFLOP at H=64 (0.113 ms at the
// bf16 peak) against ~160 MB of distinct operands (0.05 ms at 3.35 TB/s):
// operations bound it, and the design's job is to keep the tensor cores fed.
//
// Design of the bf16 contraction (cin_mma_kernel, whose note below has the
// details): the first design, below, rebuilt kr[128 x 32] in shared memory
// every 32-column chunk with a division loop per element and loaded each W
// slice by element loads behind two barriers, and sat at 21-24x its bound,
// 17 of a xDeepFM step's 25 busy milliseconds. Now the rows (b, k) are
// mma.sync's M, each warp forms its A fragments in registers from y (held
// across the h loop) and x[r, h], and a persistent block stages its column
// group of W once for ldmatrix.
// Design of the fp32 contraction and dw (cin_tf32_kernel and
// cin_dw_tf32_kernel, whose notes below have the details): the bf16 designs'
// layouts on mma.sync.m16n8k8 in TF32, each fp32 factor split in two TF32
// parts (3xTF32: lo*hi + hi*lo + hi*hi). The first fp32 design, the tile
// kernel below on the CUDA cores, sat at 2.7-9x the 67 TFLOP/s fp32 bound
// and was slower than torch.einsum for dw. The contraction streams the split
// W by h through a ring of cp.async stages (in fp32 it cannot stay in shared
// memory whole); dw splits each staged g chunk once for every warp and sums
// each 64-row chunk from zero on the tensor cores.
// Numerics of the fp32 forms: each product x*y is rounded to fp32, as
// before; its product with w (or g) is within about 3 * 2^-22 of its
// magnitude of the fp32 product (each split is within 2^-22, and every
// TF32 x TF32 partial product is exact in fp32); sums are fp32.
// The tile kernel (the first design): one block of 8 warps computes a
// 128 x 64 output tile (128 rows r by 64 columns o) and walks the reduction
// in chunks of 32: it stages its 128 rows' x[r, :] and y[r, :] in shared
// memory once (transposed, so a warp reads 32 neighbouring rows), then per
// chunk builds kr[128 x 32] in shared memory (each product rounded to x's
// type), loads the matching W[32 x 64] slice, and multiplies them: in bf16
// on the tensor cores through WMMA (m16n16k16, exact, since kr is rounded
// to bf16), in fp32 on the CUDA cores, 8 x 4 outputs a thread. It runs the
// contractions the mma.sync plans refuse, in either type: M > 64 (y's m
// values would not fit in registers), and in bf16 no column group of W that
// fits in shared memory.
// Design of dw in bf16 (cin_dw_mma_kernel, whose note below has the details):
// building kr^T in shared memory behind four barriers a 32-row chunk, with a
// scalar load, a division and a modulo for every staged element, had held it
// at 61x its bound. Now each warp forms its A fragments of mma.sync.m16n8k16
// in registers from x and y (one h and 32 m a warp, so one g fragment feeds
// two A fragments and 64 fp32 accumulators stay in registers), and 64-row
// chunks are staged by cp.async in three buffers, copies overlapping the
// mma, with one barrier a chunk.
// Both dw forms write one fp32 tile a slice to a partial buffer [slices, O,
// H*M]; a second kernel sums the partials of each element in slice order. The
// slicing (fixed 4,096-row slices) depends on the shape only, so two launches
// give the same bits (no atomics).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps
constexpr int kTileRows = 128;
constexpr int kTileCols = 64;
constexpr int kDepth = 32;
constexpr int kLdc = kTileRows + 8;  // the fp32 output tile, column-major [64][136]
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

// leading dimensions of the A [128 x 32] and B [32 x 64] tiles in shared memory
template <typename T>
struct Ld;
template <>
struct Ld<__nv_bfloat16> {  // multiples of 8 elements (16 bytes), as WMMA needs
  static constexpr int a = kDepth + 8;
  static constexpr int b = kTileCols + 8;
};
template <>
struct Ld<float> {
  static constexpr int a = kDepth + 1;      // odd: the two half-warps' rows hit other banks
  static constexpr int b = kTileCols + 4;   // a multiple of 4: float4 reads
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// x*y rounded to T: exact for two bf16 values in fp32, then one rounding
template <typename T>
__device__ __forceinline__ T rounded_product(T a, T b) {
  return from_float<T>(__fmul_rn(to_float(a), to_float(b)));
}

// C[128 x 64] += A[128 x 32] (row-major, Ld<T>::a) * B[32 x 64] (row-major,
// Ld<T>::b); warp w owns rows [16w, 16w + 16)
template <typename T>
struct TileMma;

template <>
struct TileMma<__nv_bfloat16> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kTileCols / 16];

  __device__ void zero() {
#pragma unroll
    for (int c = 0; c < kTileCols / 16; ++c) wmma::fill_fragment(acc[c], 0.0f);
  }

  __device__ void step(const __nv_bfloat16* a_tile, const __nv_bfloat16* b_tile) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_tile + warp * 16 * Ld<__nv_bfloat16>::a + kk,
                             Ld<__nv_bfloat16>::a);
#pragma unroll
      for (int c = 0; c < kTileCols / 16; ++c) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, b_tile + kk * Ld<__nv_bfloat16>::b + c * 16,
                               Ld<__nv_bfloat16>::b);
        wmma::mma_sync(acc[c], a, b, acc[c]);
      }
    }
  }

  // the tile, column-major: c_tile[col * kLdc + row]
  __device__ void store(float* c_tile) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int c = 0; c < kTileCols / 16; ++c) {
      wmma::store_matrix_sync(c_tile + c * 16 * kLdc + warp * 16, acc[c], kLdc,
                              wmma::mem_col_major);
    }
  }
};

template <>
struct TileMma<float> {
  float acc[8][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  }

  // lane l takes rows 16w + (l / 16) * 8 + [0, 8) and columns (l % 16) * 4 + [0, 4)
  __device__ void step(const float* a_tile, const float* b_tile) {
    const int lane = threadIdx.x & 31;
    const int row0 = (threadIdx.x >> 5) * 16 + (lane >> 4) * 8;
    const int col0 = (lane & 15) * 4;
#pragma unroll 4
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(b_tile + kk * Ld<float>::b + col0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = a_tile[(row0 + i) * Ld<float>::a + kk];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
  }

  __device__ void store(float* c_tile) {
    const int lane = threadIdx.x & 31;
    const int row0 = (threadIdx.x >> 5) * 16 + (lane >> 4) * 8;
    const int col0 = (lane & 15) * 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) c_tile[(col0 + c) * kLdc + row0 + i] = acc[i][c];
  }
};

__host__ __device__ inline int align128(int v) { return (v + 127) & ~127; }

// byte offsets of the shared-memory regions
struct Layout {
  int a, b, c, xs, ys, idx, total;
};

// contraction: A, B, C tiles; x^T [H][128], y^T [M][128]; two int64 row bases
template <typename T>
__host__ __device__ inline Layout contraction_layout(int h_dim, int m_dim) {
  Layout l;
  l.a = 0;
  l.b = l.a + align128(kTileRows * Ld<T>::a * static_cast<int>(sizeof(T)));
  l.c = l.b + align128(kDepth * Ld<T>::b * static_cast<int>(sizeof(T)));
  l.xs = l.c + align128(kTileCols * kLdc * static_cast<int>(sizeof(float)));
  l.ys = l.xs + align128(h_dim * kTileRows * static_cast<int>(sizeof(T)));
  l.idx = l.ys + align128(m_dim * kTileRows * static_cast<int>(sizeof(T)));
  l.total = l.idx + 2 * kTileRows * static_cast<int>(sizeof(int64_t));
  return l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cin_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ w,
           T* __restrict__ out, int n_b, int h_dim, int m_dim, int o_dim, int k_dim,
           int64_t sxb, int64_t sxh, int64_t sxk, int64_t syb, int64_t sym, int64_t syk,
           int64_t sob, int64_t soo, int64_t sok) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = contraction_layout<T>(h_dim, m_dim);
  T* a_tile = reinterpret_cast<T*>(smem + l.a);
  T* b_tile = reinterpret_cast<T*>(smem + l.b);
  float* c_tile = reinterpret_cast<float*>(smem + l.c);
  T* xs = reinterpret_cast<T*>(smem + l.xs);
  T* ys = reinterpret_cast<T*>(smem + l.ys);
  int64_t* row_x = reinterpret_cast<int64_t*>(smem + l.idx);
  int64_t* row_y = row_x + kTileRows;

  const int tid = threadIdx.x;
  const int64_t n_rows = static_cast<int64_t>(n_b) * k_dim;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int o0 = blockIdx.y * kTileCols;
  const int hm = h_dim * m_dim;
  const T zero = from_float<T>(0.0f);

  for (int rr = tid; rr < kTileRows; rr += kThreads) {
    const int64_t r = r0 + rr;
    const int64_t b = r / k_dim;
    const int64_t k = r - b * k_dim;
    row_x[rr] = r < n_rows ? b * sxb + k * sxk : -1;
    row_y[rr] = r < n_rows ? b * syb + k * syk : -1;
  }
  __syncthreads();
  // x^T [h][row] and y^T [m][row]; the walk follows the unit stride
  for (int i = tid; i < h_dim * kTileRows; i += kThreads) {
    const bool rows_fast = sxk <= sxh;
    const int rr = rows_fast ? i % kTileRows : i / h_dim;
    const int hh = rows_fast ? i / kTileRows : i % h_dim;
    xs[hh * kTileRows + rr] = row_x[rr] >= 0 ? x[row_x[rr] + hh * sxh] : zero;
  }
  for (int i = tid; i < m_dim * kTileRows; i += kThreads) {
    const bool rows_fast = syk <= sym;
    const int rr = rows_fast ? i % kTileRows : i / m_dim;
    const int mm = rows_fast ? i / kTileRows : i % m_dim;
    ys[mm * kTileRows + rr] = row_y[rr] >= 0 ? y[row_y[rr] + mm * sym] : zero;
  }
  __syncthreads();

  TileMma<T> mma;
  mma.zero();
  const int rr = tid % kTileRows;  // the A row this thread builds
  const int jj0 = tid / kTileRows;  // its first column; then every kThreads / kTileRows-th
  constexpr int kColStep = kThreads / kTileRows;
  for (int j0 = 0; j0 < hm; j0 += kDepth) {
    int j = j0 + jj0;
    int hh = j / m_dim;
    int mm = j - hh * m_dim;
    for (int jj = jj0; jj < kDepth; jj += kColStep) {
      a_tile[rr * Ld<T>::a + jj] =
          j < hm ? rounded_product(xs[hh * kTileRows + rr], ys[mm * kTileRows + rr]) : zero;
      j += kColStep;
      mm += kColStep;
      while (mm >= m_dim) {
        mm -= m_dim;
        ++hh;
      }
    }
    for (int i = tid; i < kDepth * kTileCols; i += kThreads) {
      const int jj = i / kTileCols;
      const int c = i % kTileCols;
      const int jw = j0 + jj;
      const int o = o0 + c;
      b_tile[jj * Ld<T>::b + c] =
          (jw < hm && o < o_dim) ? w[static_cast<int64_t>(jw) * o_dim + o] : zero;
    }
    __syncthreads();
    mma.step(a_tile, b_tile);
    __syncthreads();
  }
  mma.store(c_tile);
  __syncthreads();

  const bool rows_fast = sok <= soo;
  for (int i = tid; i < kTileRows * kTileCols; i += kThreads) {
    const int r_local = rows_fast ? i % kTileRows : i / kTileCols;
    const int c = rows_fast ? i / kTileRows : i % kTileCols;
    const int64_t r = r0 + r_local;
    const int o = o0 + c;
    if (r < n_rows && o < o_dim) {
      const int64_t b = r / k_dim;
      const int64_t k = r - b * k_dim;
      out[b * sob + o * soo + k * sok] = from_float<T>(c_tile[c * kLdc + r_local]);
    }
  }
}

// dw[j, o] = sum over slices, in slice order, of partial[slice, o, j]
__global__ void __launch_bounds__(kThreads)
cin_dw_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw, int slices,
                  int o_dim, int hm) {
  const int64_t n = static_cast<int64_t>(o_dim) * hm;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n) return;
  float s = 0.0f;
  for (int sl = 0; sl < slices; ++sl) s += partial[sl * n + t];
  const int64_t o = t / hm;
  const int64_t j = t - o * hm;
  dw[j * o_dim + o] = s;
}

// --- the bf16 weight gradient on mma.sync -----------------------------------
//
// Block (h-block, m-block, o-block; slice) owns dw[h0 + 8) x [m0 + 32) x
// [o0 + 64) over its slice's rows; warp w owns h = h0 + w, all 32 m (M padded
// with zero rows in shared memory) and all 64 o: two m16 A fragments by eight
// n8 B fragments, 64 fp32 accumulators a thread. Per 16 rows r a thread reads
// x[r, h] and y[r, m] for 4 neighbouring r (8-byte loads) and forms its A
// fragments in registers as mul.rn.bf16x2 products (rectpu's rounding of
// x*y), so kr never touches shared memory; each B fragment (g, also 4
// neighbouring r) feeds both A fragments. The fragments' 16 k slots hold the
// 16 rows in a permuted order, the same for A and B, so the sum is unchanged.
// Rows are staged as [field][row] tiles of kDwChunk rows in kDwStages
// buffers, the copy of chunk c + 2 in flight while chunk c is multiplied:
// 16-byte cp.async copies when every operand's k stride is 1 and K, its
// strides and pointer keep 8-row runs 16-byte aligned (zero-filled past the
// slice's end; the wrapper copies an operand such as the model's y =
// looked[..., :K], rows K+1 apart, into that form), element loads otherwise.
constexpr int kDwChunk = 64;              // rows (b, k) a stage
constexpr int kDwStages = 3;
constexpr int kDwPitch = kDwChunk + 16;   // 160 bytes: 32 modulo 128, no bank conflict
constexpr int kDwH = 8, kDwM = 32, kDwO = 64;
constexpr int kDwStageElems = (kDwH + kDwM + kDwO) * kDwPitch;
constexpr int kDwSmem = kDwStages * kDwStageElems * 2;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or 16 zero bytes when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
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

// one operand of a block: its first field, strides in elements, the fields
// it stages and the first [field][row] row they take in a stage
struct DwOperand {
  const __nv_bfloat16* p;
  int64_t sb, sf, sk;
  int n_f, row0;
};

__device__ __forceinline__ void dw_stage(const DwOperand (&ops)[3], __nv_bfloat16* dst,
                                         int64_t r0, int64_t row_end, int k_dim, bool vec) {
  const int tid = threadIdx.x;
  if (!vec) {  // element loads: this thread's row rr, fields tid / 64 + 4i
    const int rr = tid & (kDwChunk - 1);
    const bool ok = r0 + rr < row_end;
    const int r = ok ? static_cast<int>(r0 + rr) : 0;
    const int b = r / k_dim;
    const int k = r - b * k_dim;
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const __nv_bfloat16* src = ops[o].p + b * ops[o].sb + k * ops[o].sk;
      __nv_bfloat16* d = dst + ops[o].row0 * kDwPitch + rr;
      for (int f = tid / kDwChunk; f < ops[o].n_f; f += kThreads / kDwChunk) {
        d[f * kDwPitch] = ok ? src[f * ops[o].sf] : __float2bfloat16(0.0f);
      }
    }
    return;
  }
  // 16-byte copies: this thread's 8-row run q, fields tid / 8 + 32i
  constexpr int kRuns = kDwChunk / 8;
  const int q = tid & (kRuns - 1);
  const bool ok = r0 + 8 * q < row_end;  // a run is whole: the row count is a multiple of 8
  const int r = ok ? static_cast<int>(r0 + 8 * q) : 0;
  const int b = r / k_dim;
  const int k = r - b * k_dim;
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const __nv_bfloat16* src = ops[o].p + b * ops[o].sb + k;
    __nv_bfloat16* d = dst + ops[o].row0 * kDwPitch + 8 * q;
    for (int f = tid / kRuns; f < ops[o].n_f; f += kThreads / kRuns) {
      cp_async16(d + f * kDwPitch, src + f * ops[o].sf, ok);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
cin_dw_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
                  const __nv_bfloat16* __restrict__ g, float* __restrict__ partial, int n_b,
                  int h_dim, int m_dim, int o_dim, int k_dim, int64_t sxb, int64_t sxh,
                  int64_t sxk, int64_t syb, int64_t sym, int64_t syk, int64_t sgb,
                  int64_t sgo, int64_t sgk, int slice_rows, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem);
  const int n_hb = (h_dim + kDwH - 1) / kDwH;
  const int n_mb = (m_dim + kDwM - 1) / kDwM;
  const int hb = blockIdx.x % n_hb;
  const int mb = (blockIdx.x / n_hb) % n_mb;
  const int ob = blockIdx.x / (n_hb * n_mb);
  const int h0 = hb * kDwH, m0 = mb * kDwM, o0 = ob * kDwO;
  const int slice = blockIdx.y;
  const DwOperand ops[3] = {
      {x + h0 * sxh, sxb, sxh, sxk, min(kDwH, h_dim - h0), 0},
      {y + m0 * sym, syb, sym, syk, min(kDwM, m_dim - m0), kDwH},
      {g + o0 * sgo, sgb, sgo, sgk, min(kDwO, o_dim - o0), kDwH + kDwM}};
  {  // zero every stage: padded rows (m, o, h past the extents) are never staged
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < kDwSmem / 16; i += kThreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const int64_t n_rows = static_cast<int64_t>(n_b) * k_dim;
  const int64_t row_begin = static_cast<int64_t>(slice) * slice_rows;
  const int64_t row_end = min(n_rows, row_begin + slice_rows);
  const int n_chunks =
      row_end > row_begin ? static_cast<int>((row_end - row_begin + kDwChunk - 1) / kDwChunk) : 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const bool active = h0 + warp < h_dim;  // warp-uniform
  float acc[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][f][e] = 0.0f;

#pragma unroll
  for (int c = 0; c < kDwStages - 1; ++c) {
    if (c < n_chunks) {
      dw_stage(ops, st + c * kDwStageElems, row_begin + c * kDwChunk, row_end, k_dim, vec);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int c = 0; c < n_chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kDwStages - 2) : "memory");
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1's buffer
    const int cn = c + kDwStages - 1;
    if (cn < n_chunks) {
      dw_stage(ops, st + (cn % kDwStages) * kDwStageElems,
               row_begin + static_cast<int64_t>(cn) * kDwChunk, row_end, k_dim, vec);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (!active) continue;
    const __nv_bfloat16* buf = st + (c % kDwStages) * kDwStageElems;
    const __nv_bfloat16* xs = buf + warp * kDwPitch + 4 * tq;
    const __nv_bfloat16* ys = buf + (kDwH + gq) * kDwPitch + 4 * tq;
    const __nv_bfloat16* gs = buf + (kDwH + kDwM + gq) * kDwPitch + 4 * tq;
#pragma unroll
    for (int r = 0; r < kDwChunk; r += 16) {
      // rows r + 4tq + [0, 4): k slots 2tq, 2tq + 1 take the first two, slots
      // 2tq + 8, 2tq + 9 the other two (A and B alike)
      const uint2 xv = *reinterpret_cast<const uint2*>(xs + r);
      uint2 yv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        yv[i] = *reinterpret_cast<const uint2*>(ys + i * 8 * kDwPitch + r);
      }
      // fragment a: rows m0 + 16a + gq (regs 0, 2) and + 8 (regs 1, 3)
      uint32_t fa[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        fa[a][0] = mul_bf16x2(xv.x, yv[2 * a].x);
        fa[a][1] = mul_bf16x2(xv.x, yv[2 * a + 1].x);
        fa[a][2] = mul_bf16x2(xv.y, yv[2 * a].y);
        fa[a][3] = mul_bf16x2(xv.y, yv[2 * a + 1].y);
      }
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const uint2 gv = *reinterpret_cast<const uint2*>(gs + f * 8 * kDwPitch + r);
        const uint32_t fb[2] = {gv.x, gv.y};
        mma_bf16(acc[0][f], fa[0], fb);
        mma_bf16(acc[1][f], fa[1], fb);
      }
    }
  }
  if (!active) return;
  // partial[slice, o, h * M + m]; acc[a][f]: m = m0 + 16a + gq (+8 for
  // elements 2, 3), o = o0 + 8f + 2tq (+1 for elements 1, 3)
  const int hm = h_dim * m_dim;
  const int h = h0 + warp;
  float* dst = partial + static_cast<int64_t>(slice) * o_dim * hm + h * m_dim;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int f = 0; f < 8; ++f) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 16 * a + gq + 8 * (e >> 1);
        const int o = o0 + 8 * f + 2 * tq + (e & 1);
        if (m < m_dim && o < o_dim) dst[static_cast<int64_t>(o) * hm + m] = acc[a][f][e];
      }
    }
  }
}

// --- the bf16 contraction on mma.sync ---------------------------------------
//
// out[r, o] = sum_{h, m} round(x[r, h] * y[r, m]) * W[h, m, o] over rows r =
// (b, k), as a product whose M dimension is the rows, whose reduction is
// (h, m) with m zero-padded to MP (32 or 64) inside each h, and whose N
// dimension is o, in groups of 8 NT columns.
//   - A in registers: in mma.sync.m16n8k16's A layout a thread holds rows g
//     and g + 8 of a 16-row tile (g = lane / 4) and reduction columns 2t, 2t+1,
//     2t+8, 2t+9 (t = lane % 4). With the reduction in (h, m) order and m
//     padded to MP, those columns are the same m for every h, so the thread
//     loads its y[r, m] once a row tile and keeps them across the whole h
//     loop; each h then costs one x[r, h] a row and MP/16 x 4 mul.rn.bf16x2
//     (the product rounded to bf16 exactly as rectpu rounds it). Padding m
//     (26 -> 32) wastes 19 % of the mma; the flat (h, m) order would not, but
//     its columns change with every step, so y could not stay in registers.
//   - B from shared memory: the wrapper packs W per call as [group][8 NT
//     o][H * MP] (zeros past M and O); a persistent block stages its group's
//     slice once, rows 16 bytes longer than H * MP so ldmatrix's eight rows
//     hit eight bank groups, and walks many row tiles. A group holds as many
//     columns as fit in shared memory with the x tiles (at most 8 NT = 64;
//     all 64 at H' = 26, 32 at H' = 64: two groups at O' = 64, and at M' = 64
//     two groups of 16 for O' = 26), so the A fragments are built once a
//     group.
//   - A warp owns 32 rows (two m16 tiles, so each B fragment feeds two mma)
//     and all 8 NT columns: 8 NT fp32 accumulators a thread. Its rows' x[r, :]
//     are staged as [h][32] in shared memory in two buffers: the next tile's
//     by 16-byte cp.async while this tile multiplies, where each h of a tile
//     is 64 contiguous, aligned bytes (K a multiple of 32, k unit stride; the
//     wrapper copies the model's x0 = looked[..., :K] into that form), else by
//     element loads, eight in flight, before the tile. The next tile's y
//     values are loaded into registers while this tile multiplies. The tile
//     is rounded through shared memory so that out is written by neighbouring
//     lanes on neighbouring addresses in either layout.
// No staging waits inside the h loop: the first version staged x by one
// dependent element load at a time and sat at 10 % of the tensor cores.
constexpr int kCinWarps = 8;
constexpr int kCinThreads = kCinWarps * 32;
constexpr int kCinRows = 32;        // rows a warp owns
constexpr int kCinWPad = 8;         // elements past H * MP in each staged W row
constexpr int kCinOutPitch = 40;    // the rounded tile [8 NT][40]: lanes t hit other banks
constexpr int kCinBatch = 8;        // element loads in flight when x is staged by elements

// a warp's shared memory in elements: two x tiles and the rounded output tile
__host__ __device__ inline int cin_warp_elems(int h_dim, int nt) {
  return 2 * h_dim * kCinRows + 8 * nt * kCinOutPitch;
}

__host__ __device__ inline int cin_w_bytes(int h_dim, int mp, int nt) {
  return align128(8 * nt * (h_dim * mp + kCinWPad) * 2);
}

__host__ __device__ inline int cin_mma_smem(int h_dim, int mp, int nt) {
  return cin_w_bytes(h_dim, mp, nt) + kCinWarps * cin_warp_elems(h_dim, nt) * 2;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t bf16_bits(const __nv_bfloat16* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p));
}

// where row r starts in an operand with batch stride sb and k stride sk, or
// -1 past the last row
__device__ __forceinline__ int64_t row_base(int64_t r, int64_t n_rows, int k_dim, int64_t sb,
                                            int64_t sk) {
  if (r >= n_rows) return -1;
  const int64_t b = r / k_dim;
  return b * sb + (r - b * k_dim) * sk;
}

// this thread's y values of the tile at r0, packed in pairs of neighbouring
// m: [16-row tile][k16 step][A register]
template <int MP>
__device__ __forceinline__ void load_y(uint32_t (&yv)[2][MP / 16][4],
                                       const __nv_bfloat16* __restrict__ y, int64_t r0,
                                       int64_t n_rows, int k_dim, int m_dim, int64_t syb,
                                       int64_t sym, int64_t syk) {
  const int lane = threadIdx.x & 31;
  const int64_t yb = row_base(r0 + lane, n_rows, k_dim, syb, syk);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int64_t base_a = __shfl_sync(0xffffffffu, yb, 16 * mt + (lane >> 2));
    const int64_t base_b = __shfl_sync(0xffffffffu, yb, 16 * mt + (lane >> 2) + 8);
#pragma unroll
    for (int ks = 0; ks < MP / 16; ++ks) {
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {
        const int64_t base = reg & 1 ? base_b : base_a;
        const int m = 16 * ks + 2 * (lane & 3) + 8 * (reg >> 1);
        const uint32_t lo = base >= 0 && m < m_dim ? bf16_bits(y + base + m * sym) : 0u;
        const uint32_t hi =
            base >= 0 && m + 1 < m_dim ? bf16_bits(y + base + (m + 1) * sym) : 0u;
        yv[mt][ks][reg] = lo | (hi << 16);
      }
    }
  }
}

// the next tile's x by 16-byte copies: h of rows r0 .. r0 + 31 is 64
// contiguous bytes at row_base(r0) + h * sxh
__device__ __forceinline__ void stage_x_async(__nv_bfloat16* xs, const __nv_bfloat16* x,
                                              int64_t base, int h_dim, int64_t sxh) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < h_dim * 4; i += 32) {
    const int hh = i >> 2;
    const int q = i & 3;
    cp_async16(xs + hh * kCinRows + 8 * q, x + base + hh * sxh + 8 * q, true);
  }
}

// this tile's x by element loads, kCinBatch in flight, in the order of the
// unit stride
__device__ __forceinline__ void stage_x_elements(__nv_bfloat16* xs, const __nv_bfloat16* x,
                                                 int64_t xb, int h_dim, int64_t sxh,
                                                 bool rows_fast) {
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < h_dim * kCinRows; i0 += 32 * kCinBatch) {
    __nv_bfloat16 v[kCinBatch];
#pragma unroll
    for (int u = 0; u < kCinBatch; ++u) {
      const int i = i0 + 32 * u + lane;
      const int rr = rows_fast ? i % kCinRows : i / h_dim;
      const int hh = rows_fast ? i / kCinRows : i % h_dim;
      const bool in = i0 + 32 * u < h_dim * kCinRows;  // warp-uniform
      const int64_t base = __shfl_sync(0xffffffffu, xb, in ? rr : 0);
      v[u] = in && base >= 0 ? x[base + hh * sxh] : __float2bfloat16(0.0f);
    }
#pragma unroll
    for (int u = 0; u < kCinBatch; ++u) {
      const int i = i0 + 32 * u + lane;
      if (i0 + 32 * u < h_dim * kCinRows) {
        const int rr = rows_fast ? i % kCinRows : i / h_dim;
        const int hh = rows_fast ? i / kCinRows : i % h_dim;
        xs[hh * kCinRows + rr] = v[u];
      }
    }
  }
}

template <int MP, int NT>
__global__ void __launch_bounds__(kCinThreads, 1)
cin_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
               const __nv_bfloat16* __restrict__ wp, __nv_bfloat16* __restrict__ out, int n_b,
               int h_dim, int m_dim, int o_dim, int k_dim, int64_t sxb, int64_t sxh,
               int64_t sxk, int64_t syb, int64_t sym, int64_t syk, int64_t sob, int64_t soo,
               int64_t sok, int n_groups, bool vec) {
  constexpr int kCols = 8 * NT;
  constexpr int kSteps = MP / 16;  // k16 steps an h
  extern __shared__ __align__(128) unsigned char smem[];
  const int hmp = h_dim * MP;
  const int pitch = hmp + kCinWPad;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  __nv_bfloat16* region = reinterpret_cast<__nv_bfloat16*>(smem + cin_w_bytes(h_dim, MP, NT)) +
                          warp * cin_warp_elems(h_dim, NT);
  __nv_bfloat16* os = region + 2 * h_dim * kCinRows;  // the rounded output tile
  const int group = blockIdx.x % n_groups;

  {  // this block's W slice, 16 bytes a copy
    const uint4* src = reinterpret_cast<const uint4*>(wp + static_cast<int64_t>(group) * kCols * hmp);
    const int per_row = hmp / 8;
    for (int i = threadIdx.x; i < kCols * per_row; i += kCinThreads) {
      const int row = i / per_row;
      *reinterpret_cast<uint4*>(ws + row * pitch + (i - row * per_row) * 8) = src[i];
    }
  }
  __syncthreads();

  const int64_t n_rows = static_cast<int64_t>(n_b) * k_dim;
  const int64_t n_tiles = (n_rows + kCinRows - 1) / kCinRows;
  const int64_t tile_stride = static_cast<int64_t>(gridDim.x / n_groups) * kCinWarps;
  const bool x_rows_fast = sxk <= sxh;
  const bool out_rows_fast = sok <= soo;
  // ldmatrix: lane l gives row 8 (q / 2) + l % 8 of column block q % 2 (q = l / 8)
  const __nv_bfloat16* b_lane =
      ws + (8 * ((lane >> 4) & 1) + (lane & 7)) * pitch + 8 * ((lane >> 3) & 1);

  int64_t tile = static_cast<int64_t>(blockIdx.x / n_groups) * kCinWarps + warp;
  uint32_t yn[2][kSteps][4];  // the next tile's y values
  if (tile < n_tiles) {
    load_y<MP>(yn, y, tile * kCinRows, n_rows, k_dim, m_dim, syb, sym, syk);
    if (vec) {
      stage_x_async(region, x, __shfl_sync(0xffffffffu, row_base(tile * kCinRows + lane, n_rows,
                                                                 k_dim, sxb, sxk), 0),
                    h_dim, sxh);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  int buf = 0;
  for (; tile < n_tiles; tile += tile_stride) {
    const int64_t r0 = tile * kCinRows;
    const int64_t next = tile + tile_stride;
    __nv_bfloat16* xs = region + buf * h_dim * kCinRows;
    uint32_t yv[2][kSteps][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) yv[mt][ks][reg] = yn[mt][ks][reg];
    if (vec) {
      if (next < n_tiles) {
        stage_x_async(region + (buf ^ 1) * h_dim * kCinRows, x,
                      __shfl_sync(0xffffffffu, row_base(next * kCinRows + lane, n_rows, k_dim,
                                                        sxb, sxk), 0),
                      h_dim, sxh);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile's copies are in
    } else {
      stage_x_elements(xs, x, row_base(r0 + lane, n_rows, k_dim, sxb, sxk), h_dim, sxh,
                       x_rows_fast);
    }
    __syncwarp();
    if (next < n_tiles) load_y<MP>(yn, y, next * kCinRows, n_rows, k_dim, m_dim, syb, sym, syk);

    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

    for (int h = 0; h < h_dim; ++h) {
      uint32_t xa[2], xb8[2];  // x[r, h] of rows g and g + 8, in both halves
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t a = bf16_bits(xs + h * kCinRows + 16 * mt + g);
        const uint32_t b = bf16_bits(xs + h * kCinRows + 16 * mt + g + 8);
        xa[mt] = a | (a << 16);
        xb8[mt] = b | (b << 16);
      }
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t fa[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          fa[mt][0] = mul_bf16x2(yv[mt][ks][0], xa[mt]);
          fa[mt][1] = mul_bf16x2(yv[mt][ks][1], xb8[mt]);
          fa[mt][2] = mul_bf16x2(yv[mt][ks][2], xa[mt]);
          fa[mt][3] = mul_bf16x2(yv[mt][ks][3], xb8[mt]);
        }
        const __nv_bfloat16* bp = b_lane + h * MP + 16 * ks;
        if constexpr (NT == 1) {
          uint32_t fb[2];
          ldmatrix_x2(fb, bp);
          mma_bf16(acc[0][0], fa[0], fb);
          mma_bf16(acc[1][0], fa[1], fb);
        } else {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t fb[4];
            ldmatrix_x4(fb, bp + 16 * np * pitch);
            mma_bf16(acc[0][2 * np], fa[0], fb);
            mma_bf16(acc[1][2 * np], fa[1], fb);
            mma_bf16(acc[0][2 * np + 1], fa[0], fb + 2);
            mma_bf16(acc[1][2 * np + 1], fa[1], fb + 2);
          }
        }
      }
    }

    // the tile rounded to bf16 -> os as [column][row], then out
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * mt + g + 8 * (e >> 1);
          const int col = 8 * nt + 2 * t + (e & 1);
          os[col * kCinOutPitch + row] = __float2bfloat16(acc[mt][nt][e]);
        }
    __syncwarp();
    const int64_t ob = row_base(r0 + lane, n_rows, k_dim, sob, sok);
    const int o0 = group * kCols;
    for (int i = lane; i < kCols * kCinRows; i += 32) {
      const int rr = out_rows_fast ? i % kCinRows : i / kCols;
      const int cc = out_rows_fast ? i / kCinRows : i % kCols;
      const int64_t base = __shfl_sync(0xffffffffu, ob, rr);
      if (base >= 0 && o0 + cc < o_dim) out[base + (o0 + cc) * soo] = os[cc * kCinOutPitch + rr];
    }
    __syncwarp();  // every lane is done with xs and os
    if (vec) buf ^= 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// --- fp32 on mma.sync: 3xTF32 ------------------------------------------------
//
// fp32 operands go through the tensor cores as three TF32 products. Each fp32
// value v (a product x*y rounded to fp32, a W or a g value) is split as hi =
// tf32(v), lo = tf32(v - hi) (cvt.rna: round to nearest, ties away; v - hi is
// exact in fp32), so v = hi + lo within 2^-22 |v|; a product a*b is formed as
// lo_a*hi_b + hi_a*lo_b + hi_a*hi_b (the small ones first), each exact in
// fp32, within about 3 * 2^-22 |a*b| of the fp32 product. The sums are the
// tensor cores' fp32 sums (mma.sync.m16n8k8, tf32 in, fp32 accumulate).

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// lo = tf32(v - hi) by the same rounding without cvt's test for infinities
// and NaN (ptxas emits FSETP, IADD, LOP3 for cvt.rna.tf32.f32): v - hi is
// finite wherever hi is
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = (__float_as_uint(__fsub_rn(v, __uint_as_float(hi))) + 0x1000u) & 0xffffe000u;
}

// d[16 x 8] += a[16 x 8] * b[8 x 8], tf32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b as lo_a * hi_b + hi_a * lo_b + hi_a * hi_b
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* a_hi, const uint32_t* a_lo,
                                           const uint32_t* b_hi, const uint32_t* b_lo) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// 4 bytes from src, or 4 zero bytes when !full (an element copy, cached in L1)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// --- the fp32 contraction -----------------------------------------------------
//
// The bf16 kernel's layout (rows r = (b, k) as the mma's M, the reduction in
// (h, m) order with m zero-padded to MP, o in groups of 8 NT columns; a warp
// owns 32 rows, two m16 tiles, and keeps their y[r, m] in registers across
// the h loop), on m16n8k8 and 3xTF32: per h and k8 step a thread forms its
// 8 products x[r, h] * y[r, m] (rounded to fp32, as rectpu rounds them) and
// splits them, and each split B fragment feeds six mma.sync.
//   - k slots: the step's slots t and t + 4 of thread t (the mma's layout)
//     hold m = 8 ks + 2t and 2t + 1, for A and B alike, so a thread's B
//     values are neighbours in memory.
//   - W: its split hi and lo planes take 16 KB (MP = 32) or 32 KB (MP = 64)
//     per h for 64 columns, 1 MB at H' = 64, so the W of a group cannot stay
//     in shared memory as it does in bf16. The wrapper packs W per call as
//     [group][h][8 NT o][MP / 2][hi, hi, lo, lo] (ops/cin.py::
//     pack_weight_tf32), and each block streams it by h through a ring of
//     kTfStages stages by 16-byte cp.async, from L2 (W is read by every
//     block). A stage also holds x[r, h] of the block's 256 rows, copied
//     element by element (4-byte cp.async: any strides, zero past the last
//     row). One barrier a stage; the copies of h + 1 .. h + 3 are in flight
//     while h multiplies. A block holds every column of its group (all 64
//     at O' <= 64), so each A fragment is formed once.
//   - A staged W row is 2 MP + 16 floats: a thread reads hi and lo of its two
//     m with one 16-byte load, and the 8 lanes of a quarter-warp hit 8
//     distinct 16-byte bank groups.
//   - out is written from the accumulators: 8 neighbouring rows (legacy) or
//     2 neighbouring columns (K-major) fill a 32-byte sector.
//   - m is padded, h is not, so the wrapper hands over x and y in the order
//     with fewer padded products (ops/cin.py::swap_tf32: H' = 64, M' = 26
//     runs as 26 h by 64 m, 19 % fewer mma; x*y rounds the same either way).
constexpr int kTfStages = 4;
constexpr int kTfRows = kCinWarps * kCinRows;  // 256 rows a block

__host__ __device__ inline int tf32_stage_floats(int mp, int nt) {
  return 8 * nt * (2 * mp + 16) + kTfRows;
}

__host__ __device__ inline int cin_tf32_smem(int mp, int nt) {
  return kTfStages * tf32_stage_floats(mp, nt) * static_cast<int>(sizeof(float));
}

template <int MP, int NT>
__global__ void __launch_bounds__(kCinThreads, 1)
cin_tf32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ wp, float* __restrict__ out, int n_b, int h_dim,
                int m_dim, int o_dim, int k_dim, int64_t sxb, int64_t sxh, int64_t sxk,
                int64_t syb, int64_t sym, int64_t syk, int64_t sob, int64_t soo, int64_t sok,
                int n_groups) {
  constexpr int kCols = 8 * NT;
  constexpr int kSteps = MP / 8;       // k8 steps an h
  constexpr int kPitch = 2 * MP + 16;  // floats a staged W row
  constexpr int kWFloats = kCols * kPitch;
  constexpr int kStage = kWFloats + kTfRows;
  constexpr int kRuns = MP / 2;        // 16-byte runs a packed W row
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int group = blockIdx.x % n_groups;
  const int64_t n_rows = static_cast<int64_t>(n_b) * k_dim;
  const int64_t n_tiles = (n_rows + kTfRows - 1) / kTfRows;
  const int64_t first = blockIdx.x / n_groups;
  const int64_t tile_stride = gridDim.x / n_groups;
  if (first >= n_tiles) return;  // block-uniform
  const int64_t n_steps = ((n_tiles - 1 - first) / tile_stride + 1) * h_dim;
  const float* wg = wp + static_cast<int64_t>(group) * h_dim * kCols * 2 * MP;

  // the producer: step s = (tile, h) of this block, staged into slot s % kTfStages
  int64_t p_tile = first;
  int p_h = 0;
  int64_t p_base = row_base(p_tile * kTfRows + threadIdx.x, n_rows, k_dim, sxb, sxk);
  auto stage = [&](int64_t s) {
    float* dst = ring + static_cast<int>(s % kTfStages) * kStage;
    const float* src = wg + static_cast<int64_t>(p_h) * kCols * 2 * MP;
    for (int i = threadIdx.x; i < kCols * kRuns; i += kCinThreads) {
      const int row = i / kRuns;
      cp_async16(dst + row * kPitch + 4 * (i - row * kRuns), src + 4 * i, true);
    }
    cp_async4(dst + kWFloats + threadIdx.x, p_base >= 0 ? x + p_base + p_h * sxh : x,
              p_base >= 0);
    if (++p_h == h_dim) {
      p_h = 0;
      p_tile += tile_stride;
      p_base = row_base(p_tile * kTfRows + threadIdx.x, n_rows, k_dim, sxb, sxk);
    }
  };
#pragma unroll
  for (int s = 0; s < kTfStages - 1; ++s) {
    if (s < n_steps) stage(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  float acc[2][NT][4];
  float yv[2][kSteps][4];  // [m16 tile][k8 step][A register]: y of this thread's rows
  int64_t tile = first;
  int h = 0;
  for (int64_t s = 0; s < n_steps; ++s) {
    const int64_t r0 = tile * kTfRows + warp * kCinRows;
    if (h == 0) {
      const int64_t yb = row_base(r0 + lane, n_rows, k_dim, syb, syk);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int64_t base_a = __shfl_sync(0xffffffffu, yb, 16 * mt + g);
        const int64_t base_b = __shfl_sync(0xffffffffu, yb, 16 * mt + g + 8);
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
          for (int reg = 0; reg < 4; ++reg) {
            const int64_t base = reg & 1 ? base_b : base_a;
            const int m = 8 * ks + 2 * t + (reg >> 1);
            yv[mt][ks][reg] = base >= 0 && m < m_dim ? y[base + m * sym] : 0.0f;
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
      }
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kTfStages - 2) : "memory");
    __syncthreads();  // step s is in; every warp is done with step s - 1's slot
    if (s + kTfStages - 1 < n_steps) stage(s + kTfStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const float* buf = ring + static_cast<int>(s % kTfStages) * kStage;
    const float* xs = buf + kWFloats + warp * kCinRows;
    float xv[2][2];  // x[r, h] of rows g and g + 8 of each m16 tile
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      xv[mt][0] = xs[16 * mt + g];
      xv[mt][1] = xs[16 * mt + g + 8];
    }
    const float* b_lane = buf + g * kPitch + 4 * t;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      // A registers: rows g (0, 2) and g + 8 (1, 3); m = 8 ks + 2t (0, 1) and + 1 (2, 3)
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) {
          split_tf32(__fmul_rn(xv[mt][reg & 1], yv[mt][ks][reg]), a_hi[mt][reg], a_lo[mt][reg]);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float4 wv = *reinterpret_cast<const float4*>(b_lane + nt * 8 * kPitch + 16 * ks);
        const uint32_t b_hi[2] = {__float_as_uint(wv.x), __float_as_uint(wv.y)};
        const uint32_t b_lo[2] = {__float_as_uint(wv.z), __float_as_uint(wv.w)};
        mma_3xtf32(acc[0][nt], a_hi[0], a_lo[0], b_hi, b_lo);
        mma_3xtf32(acc[1][nt], a_hi[1], a_lo[1], b_hi, b_lo);
      }
    }

    if (++h == h_dim) {  // the tile is done: acc[mt][nt] holds rows 16 mt + g (+8 for
                         // elements 2, 3), columns 8 nt + 2t (+1 for elements 1, 3)
      const int64_t ob = row_base(r0 + lane, n_rows, k_dim, sob, sok);
      const int o0 = group * kCols;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int64_t base = __shfl_sync(0xffffffffu, ob, 16 * mt + g + 8 * half);
          if (base < 0) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int o = o0 + 8 * nt + 2 * t + e;
              if (o < o_dim) out[base + o * soo] = acc[mt][nt][2 * half + e];
            }
        }
      h = 0;
      tile += tile_stride;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// --- the fp32 weight gradient -------------------------------------------------
//
// cin_dw_mma_kernel's layout on m16n8k8 and 3xTF32: block (h-block, m-block,
// o-block; slice) owns dw[h0 + 8) x [m0 + 32) x [o0 + 64) over its slice's
// rows, warp w owns h = h0 + w, all 32 m and all 64 o; per 8 rows r a thread
// forms its 8 products x[r, h] * y[r, m] (rounded to fp32) and splits them,
// and splits each g fragment once for the two A fragments it feeds (six
// mma.sync). k slots t and t + 4 of thread t hold rows 2t and 2t + 1 of the
// 8, for A and B alike (8-byte loads). Rows are staged as [field][row]
// tiles of kDwChunk rows in kDwStages buffers by cp.async: 16-byte copies
// of 4-row runs where every operand's runs are 16 bytes, aligned
// (ops/cin.py::dw_operands copies an operand such as the model's y =
// looked[..., :K] into that form), 4-byte copies otherwise.
// The tensor cores truncate their fp32 sums rather than round them, a bias
// that grows with the length of a chain of mma on one accumulator (3 a k8
// step here, where bf16 has 1 a k16 step), so each 64-row chunk is summed
// from zero on the tensor cores (24 mma a chain) and the chunks by fp32 adds
// rounded to nearest.
constexpr int kDwTfPitch = kDwChunk + 8;  // 288 bytes: 32 modulo 128, no bank conflict
constexpr int kDwTfStageFloats = (kDwH + kDwM + kDwO) * kDwTfPitch;
constexpr int kDwTfSplitPitch = 2 * kDwChunk + 16;  // g split: [o][row pair][hi hi lo lo]
constexpr int kDwTfRingSmem = kDwStages * kDwTfStageFloats * static_cast<int>(sizeof(float));
constexpr int kDwTfSmem = kDwTfRingSmem + kDwO * kDwTfSplitPitch * static_cast<int>(sizeof(float));

struct DwOperandF32 {
  const float* p;
  int64_t sb, sf, sk;
  int n_f, row0;
};

__device__ __forceinline__ void dw_stage_f32(const DwOperandF32 (&ops)[3], float* dst, int64_t r0,
                                             int64_t row_end, int k_dim, bool vec) {
  const int tid = threadIdx.x;
  if (!vec) {  // 4-byte copies: this thread's row rr, fields tid / 64 + 4i
    const int rr = tid & (kDwChunk - 1);
    const bool ok = r0 + rr < row_end;
    const int r = ok ? static_cast<int>(r0 + rr) : 0;
    const int b = r / k_dim;
    const int k = r - b * k_dim;
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const float* src = ops[o].p + b * ops[o].sb + k * ops[o].sk;
      float* d = dst + ops[o].row0 * kDwTfPitch + rr;
      for (int f = tid / kDwChunk; f < ops[o].n_f; f += kThreads / kDwChunk) {
        cp_async4(d + f * kDwTfPitch, src + f * ops[o].sf, ok);
      }
    }
    return;
  }
  // 16-byte copies: this thread's 4-row run q, fields tid / 16 + 16i
  constexpr int kRuns = kDwChunk / 4;
  const int q = tid & (kRuns - 1);
  const bool ok = r0 + 4 * q < row_end;  // a run is whole: the row count is a multiple of 4
  const int r = ok ? static_cast<int>(r0 + 4 * q) : 0;
  const int b = r / k_dim;
  const int k = r - b * k_dim;
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const float* src = ops[o].p + b * ops[o].sb + k;
    float* d = dst + ops[o].row0 * kDwTfPitch + 4 * q;
    for (int f = tid / kRuns; f < ops[o].n_f; f += kThreads / kRuns) {
      cp_async16(d + f * kDwTfPitch, src + f * ops[o].sf, ok);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
cin_dw_tf32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ g, float* __restrict__ partial, int n_b,
                   int h_dim, int m_dim, int o_dim, int k_dim, int64_t sxb, int64_t sxh,
                   int64_t sxk, int64_t syb, int64_t sym, int64_t syk, int64_t sgb,
                   int64_t sgo, int64_t sgk, int slice_rows, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem);
  const int n_hb = (h_dim + kDwH - 1) / kDwH;
  const int n_mb = (m_dim + kDwM - 1) / kDwM;
  const int hb = blockIdx.x % n_hb;
  const int mb = (blockIdx.x / n_hb) % n_mb;
  const int ob = blockIdx.x / (n_hb * n_mb);
  const int h0 = hb * kDwH, m0 = mb * kDwM, o0 = ob * kDwO;
  const int slice = blockIdx.y;
  const DwOperandF32 ops[3] = {
      {x + h0 * sxh, sxb, sxh, sxk, min(kDwH, h_dim - h0), 0},
      {y + m0 * sym, syb, sym, syk, min(kDwM, m_dim - m0), kDwH},
      {g + o0 * sgo, sgb, sgo, sgk, min(kDwO, o_dim - o0), kDwH + kDwM}};
  {  // zero every stage: padded rows (m, o, h past the extents) are never staged
    float4* z = reinterpret_cast<float4*>(smem);
    for (int i = threadIdx.x; i < kDwTfSmem / 16; i += kThreads) {
      z[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  __syncthreads();

  const int64_t n_rows = static_cast<int64_t>(n_b) * k_dim;
  const int64_t row_begin = static_cast<int64_t>(slice) * slice_rows;
  const int64_t row_end = min(n_rows, row_begin + slice_rows);
  const int n_chunks =
      row_end > row_begin ? static_cast<int>((row_end - row_begin + kDwChunk - 1) / kDwChunk) : 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const bool active = h0 + warp < h_dim;  // warp-uniform
  float acc[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][f][e] = 0.0f;

#pragma unroll
  for (int c = 0; c < kDwStages - 1; ++c) {
    if (c < n_chunks) {
      dw_stage_f32(ops, st + c * kDwTfStageFloats, row_begin + c * kDwChunk, row_end, k_dim, vec);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int c = 0; c < n_chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kDwStages - 2) : "memory");
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1's buffer
    const int cn = c + kDwStages - 1;
    if (cn < n_chunks) {
      dw_stage_f32(ops, st + (cn % kDwStages) * kDwTfStageFloats,
                   row_begin + static_cast<int64_t>(cn) * kDwChunk, row_end, k_dim, vec);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* buf = st + (c % kDwStages) * kDwTfStageFloats;
    // g of the chunk split once for every warp: gsplit[o][pair j] = hi, hi,
    // lo, lo of rows 2j and 2j + 1
    float* gsplit = st + kDwTfRingSmem / 4;
    for (int i = threadIdx.x; i < kDwO * kDwChunk / 2; i += kThreads) {
      const int o = i / (kDwChunk / 2);
      const int j = i - o * (kDwChunk / 2);
      const float2 v =
          *reinterpret_cast<const float2*>(buf + (kDwH + kDwM + o) * kDwTfPitch + 2 * j);
      uint32_t hi0, lo0, hi1, lo1;
      split_tf32(v.x, hi0, lo0);
      split_tf32(v.y, hi1, lo1);
      *reinterpret_cast<uint4*>(gsplit + o * kDwTfSplitPitch + 4 * j) =
          make_uint4(hi0, hi1, lo0, lo1);
    }
    __syncthreads();  // gsplit is whole
    if (!active) continue;
    const float* xs = buf + warp * kDwTfPitch + 2 * tq;
    const float* ys = buf + (kDwH + gq) * kDwTfPitch + 2 * tq;
    const float* gp = gsplit + gq * kDwTfSplitPitch + 4 * tq;
    float part[2][8][4];  // this chunk's sums, from zero
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int f = 0; f < 8; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[a][f][e] = 0.0f;
#pragma unroll 2
    for (int r = 0; r < kDwChunk; r += 8) {
      const float2 xv = *reinterpret_cast<const float2*>(xs + r);
      float2 yv[4];  // m = m0 + gq + 8i
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        yv[i] = *reinterpret_cast<const float2*>(ys + i * 8 * kDwTfPitch + r);
      }
      // fragment a: m = m0 + 16a + gq (regs 0, 2) and + 8 (regs 1, 3); rows
      // 2tq (regs 0, 1) and 2tq + 1 (regs 2, 3) of the 8
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        split_tf32(__fmul_rn(xv.x, yv[2 * a].x), a_hi[a][0], a_lo[a][0]);
        split_tf32(__fmul_rn(xv.x, yv[2 * a + 1].x), a_hi[a][1], a_lo[a][1]);
        split_tf32(__fmul_rn(xv.y, yv[2 * a].y), a_hi[a][2], a_lo[a][2]);
        split_tf32(__fmul_rn(xv.y, yv[2 * a + 1].y), a_hi[a][3], a_lo[a][3]);
      }
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const uint4 gv = *reinterpret_cast<const uint4*>(gp + f * 8 * kDwTfSplitPitch + 2 * r);
        const uint32_t b_hi[2] = {gv.x, gv.y};
        const uint32_t b_lo[2] = {gv.z, gv.w};
        mma_3xtf32(part[0][f], a_hi[0], a_lo[0], b_hi, b_lo);
        mma_3xtf32(part[1][f], a_hi[1], a_lo[1], b_hi, b_lo);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int f = 0; f < 8; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][f][e] = __fadd_rn(acc[a][f][e], part[a][f][e]);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (!active) return;
  // partial[slice, o, h * M + m]; acc[a][f]: m = m0 + 16a + gq (+8 for
  // elements 2, 3), o = o0 + 8f + 2tq (+1 for elements 1, 3)
  const int hm = h_dim * m_dim;
  const int h = h0 + warp;
  float* dst = partial + static_cast<int64_t>(slice) * o_dim * hm + h * m_dim;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int f = 0; f < 8; ++f) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 16 * a + gq + 8 * (e >> 1);
        const int o = o0 + 8 * f + 2 * tq + (e & 1);
        if (m < m_dim && o < o_dim) dst[static_cast<int64_t>(o) * hm + m] = acc[a][f][e];
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int launch_cin(const void* x, const void* y, const void* w, void* out, int n_b, int h_dim,
               int m_dim, int o_dim, int k_dim, const int64_t* s, cudaStream_t stream) {
  const int smem = contraction_layout<T>(h_dim, m_dim).total;
  cudaError_t err = allow_smem(cin_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_rows = static_cast<int64_t>(n_b) * k_dim;
  const dim3 grid(static_cast<unsigned>((n_rows + kTileRows - 1) / kTileRows),
                  static_cast<unsigned>((o_dim + kTileCols - 1) / kTileCols));
  cin_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(w),
      static_cast<T*>(out), n_b, h_dim, m_dim, o_dim, k_dim, s[0], s[1], s[2], s[3], s[4],
      s[5], s[6], s[7], s[8]);
  return static_cast<int>(cudaGetLastError());
}

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

template <int MP, int NT>
int launch_cin_mma_t(const void* x, const void* y, const void* wp, void* out, int n_b,
                     int h_dim, int m_dim, int o_dim, int k_dim, const int64_t* s, int n_groups,
                     bool vec, cudaStream_t stream) {
  const int smem = cin_mma_smem(h_dim, MP, NT);
  cudaError_t err = allow_smem(cin_mma_kernel<MP, NT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_tiles = (static_cast<int64_t>(n_b) * k_dim + kCinRows - 1) / kCinRows;
  int64_t per_group = (n_tiles + kCinWarps - 1) / kCinWarps;
  const int64_t fill = sm_count() / n_groups > 0 ? sm_count() / n_groups : 1;
  if (per_group > fill) per_group = fill;
  cin_mma_kernel<MP, NT><<<static_cast<unsigned>(per_group * n_groups), kCinThreads, smem,
                           stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(wp), static_cast<__nv_bfloat16*>(out), n_b, h_dim,
      m_dim, o_dim, k_dim, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], n_groups,
      vec);
  return static_cast<int>(cudaGetLastError());
}

template <int MP>
int launch_cin_mma_mp(int nt, const void* x, const void* y, const void* wp, void* out, int n_b,
                      int h_dim, int m_dim, int o_dim, int k_dim, const int64_t* s,
                      int n_groups, bool vec, cudaStream_t stream) {
  switch (nt) {
    case 1: return launch_cin_mma_t<MP, 1>(x, y, wp, out, n_b, h_dim, m_dim, o_dim, k_dim, s, n_groups, vec, stream);
    case 2: return launch_cin_mma_t<MP, 2>(x, y, wp, out, n_b, h_dim, m_dim, o_dim, k_dim, s, n_groups, vec, stream);
    case 4: return launch_cin_mma_t<MP, 4>(x, y, wp, out, n_b, h_dim, m_dim, o_dim, k_dim, s, n_groups, vec, stream);
    case 8: return launch_cin_mma_t<MP, 8>(x, y, wp, out, n_b, h_dim, m_dim, o_dim, k_dim, s, n_groups, vec, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

cudaError_t launch_dw_sum(const void* partial, void* dw, int slices, int o_dim, int hm,
                          cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(o_dim) * hm;
  cin_dw_sum_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                      stream>>>(static_cast<const float*>(partial), static_cast<float*>(dw),
                                slices, o_dim, hm);
  return cudaGetLastError();
}

// fp32: the 3xTF32 mma.sync kernel
int launch_dw_fp32(const void* x, const void* y, const void* g, void* partial, void* dw,
                   int n_b, int h_dim, int m_dim, int o_dim, int k_dim, const int64_t* s,
                   int slices, int slice_rows, bool vec, cudaStream_t stream) {
  cudaError_t err = allow_smem(cin_dw_tf32_kernel, kDwTfSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies only where every 4-row run of every operand is 16 bytes,
  // aligned (ops/cin.py::dw_operands lays them out so)
  auto runs = [k_dim](const void* p, int64_t sb, int64_t sf, int64_t sk) {
    return sk == 1 && k_dim % 4 == 0 && sb % 4 == 0 && sf % 4 == 0 &&
           (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  if (vec && !(runs(x, s[0], s[1], s[2]) && runs(y, s[3], s[4], s[5]) &&
               runs(g, s[6], s[7], s[8]))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = static_cast<int64_t>((h_dim + kDwH - 1) / kDwH) *
                        ((m_dim + kDwM - 1) / kDwM) * ((o_dim + kDwO - 1) / kDwO);
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(slices));
  cin_dw_tf32_kernel<<<grid, kThreads, kDwTfSmem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const float*>(g),
      static_cast<float*>(partial), n_b, h_dim, m_dim, o_dim, k_dim, s[0], s[1], s[2], s[3],
      s[4], s[5], s[6], s[7], s[8], slice_rows, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dw_sum(partial, dw, slices, o_dim, h_dim * m_dim, stream));
}

template <int MP, int NT>
int launch_cin_tf32_t(const void* x, const void* y, const void* wp, void* out, int n_b,
                      int h_dim, int m_dim, int o_dim, int k_dim, const int64_t* s, int n_groups,
                      cudaStream_t stream) {
  const int smem = cin_tf32_smem(MP, NT);
  cudaError_t err = allow_smem(cin_tf32_kernel<MP, NT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_tiles = (static_cast<int64_t>(n_b) * k_dim + kTfRows - 1) / kTfRows;
  const int64_t fill = sm_count() / n_groups > 0 ? sm_count() / n_groups : 1;
  const int64_t per_group = n_tiles < fill ? n_tiles : fill;
  cin_tf32_kernel<MP, NT><<<static_cast<unsigned>(per_group * n_groups), kCinThreads, smem,
                            stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const float*>(wp),
      static_cast<float*>(out), n_b, h_dim, m_dim, o_dim, k_dim, s[0], s[1], s[2], s[3], s[4],
      s[5], s[6], s[7], s[8], n_groups);
  return static_cast<int>(cudaGetLastError());
}

template <int MP>
int launch_cin_tf32_mp(int nt, const void* x, const void* y, const void* wp, void* out, int n_b,
                       int h_dim, int m_dim, int o_dim, int k_dim, const int64_t* s,
                       int n_groups, cudaStream_t stream) {
  switch (nt) {
    case 1: return launch_cin_tf32_t<MP, 1>(x, y, wp, out, n_b, h_dim, m_dim, o_dim, k_dim, s, n_groups, stream);
    case 2: return launch_cin_tf32_t<MP, 2>(x, y, wp, out, n_b, h_dim, m_dim, o_dim, k_dim, s, n_groups, stream);
    case 4: return launch_cin_tf32_t<MP, 4>(x, y, wp, out, n_b, h_dim, m_dim, o_dim, k_dim, s, n_groups, stream);
    case 8: return launch_cin_tf32_t<MP, 8>(x, y, wp, out, n_b, h_dim, m_dim, o_dim, k_dim, s, n_groups, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16: the mma.sync kernel
int launch_dw_bf16(const void* x, const void* y, const void* g, void* partial, void* dw,
                   int n_b, int h_dim, int m_dim, int o_dim, int k_dim, const int64_t* s,
                   int slices, int slice_rows, bool vec, cudaStream_t stream) {
  cudaError_t err = allow_smem(cin_dw_mma_kernel, kDwSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies only where every 8-row run of every operand is 16 bytes,
  // aligned (ops/cin.py::dw_operands lays them out so)
  auto runs = [k_dim](const void* p, int64_t sb, int64_t sf, int64_t sk) {
    return sk == 1 && k_dim % 8 == 0 && sb % 8 == 0 && sf % 8 == 0 &&
           (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  if (vec && !(runs(x, s[0], s[1], s[2]) && runs(y, s[3], s[4], s[5]) &&
               runs(g, s[6], s[7], s[8]))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = static_cast<int64_t>((h_dim + kDwH - 1) / kDwH) *
                        ((m_dim + kDwM - 1) / kDwM) * ((o_dim + kDwO - 1) / kDwO);
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(slices));
  cin_dw_mma_kernel<<<grid, kThreads, kDwSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(g), static_cast<float*>(partial), n_b, h_dim, m_dim,
      o_dim, k_dim, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], slice_rows, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dw_sum(partial, dw, slices, o_dim, h_dim * m_dim, stream));
}

}  // namespace

// The tile kernel (shapes the mma.sync plans refuse).
// x: [n_b, h_dim, k_dim] with strides (sxb, sxh, sxk) in elements; y: [n_b,
// m_dim, k_dim] with (syb, sym, syk); both fp32 or both bf16 (is_bf16). w:
// [h_dim * m_dim, o_dim] contiguous, in the same type. out: [n_b, o_dim, k_dim]
// addressed by (sob, soo, sok), in the same type. Returns a cudaError_t as int.
extern "C" int rectpu_cin(const void* x, const void* y, const void* w, void* out, int n_b,
                          int h_dim, int m_dim, int o_dim, int k_dim, long long sxb,
                          long long sxh, long long sxk, long long syb, long long sym,
                          long long syk, long long sob, long long soo, long long sok,
                          int is_bf16, void* stream) {
  if (n_b == 0 || o_dim == 0 || k_dim == 0) return static_cast<int>(cudaSuccess);
  if (h_dim < 1 || m_dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t s[9] = {sxb, sxh, sxk, syb, sym, syk, sob, soo, sok};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_cin<__nv_bfloat16>(x, y, w, out, n_b, h_dim, m_dim, o_dim, k_dim, s, st)
                 : launch_cin<float>(x, y, w, out, n_b, h_dim, m_dim, o_dim, k_dim, s, st);
}

// The bf16 contraction on mma.sync. x, y, out as for rectpu_cin, bf16; wp:
// W packed by ops/cin.py::pack_weight, [n_groups][8 nt][h_dim * mp] bf16
// contiguous, zero past m_dim and o_dim; mp 32 or 64 (>= m_dim), nt 1, 2, 4
// or 8 with n_groups * 8 * nt >= o_dim. copy16: stage x by 16-byte copies
// (ops/cin.py::contraction_operand: k_dim a multiple of 32, x's k stride 1,
// its other strides and pointer 16-byte aligned). Returns a cudaError_t as int.
extern "C" int rectpu_cin_mma(const void* x, const void* y, const void* wp, void* out, int n_b,
                              int h_dim, int m_dim, int o_dim, int k_dim, long long sxb,
                              long long sxh, long long sxk, long long syb, long long sym,
                              long long syk, long long sob, long long soo, long long sok,
                              int mp, int nt, int n_groups, int copy16, void* stream) {
  if (n_b == 0 || o_dim == 0 || k_dim == 0) return static_cast<int>(cudaSuccess);
  if (h_dim < 1 || m_dim < 1 || m_dim > mp || n_groups < 1 ||
      static_cast<int64_t>(n_groups) * 8 * nt < o_dim ||
      (reinterpret_cast<uintptr_t>(wp) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = copy16 != 0;
  if (vec && !(sxk == 1 && k_dim % kCinRows == 0 && sxb % 8 == 0 && sxh % 8 == 0 &&
               (reinterpret_cast<uintptr_t>(x) & 15) == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t s[9] = {sxb, sxh, sxk, syb, sym, syk, sob, soo, sok};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mp == 32) {
    return launch_cin_mma_mp<32>(nt, x, y, wp, out, n_b, h_dim, m_dim, o_dim, k_dim, s,
                                 n_groups, vec, st);
  }
  if (mp == 64) {
    return launch_cin_mma_mp<64>(nt, x, y, wp, out, n_b, h_dim, m_dim, o_dim, k_dim, s,
                                 n_groups, vec, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fp32 contraction on mma.sync (3xTF32). x, y, out as for rectpu_cin,
// fp32, any strides; wp: W split and packed by ops/cin.py::pack_weight_tf32,
// [n_groups][h_dim][8 nt][mp / 2][4] fp32 contiguous (hi, hi, lo, lo of two
// neighbouring m), zero past m_dim and o_dim; mp 32 or 64 (>= m_dim), nt 1,
// 2, 4 or 8 with n_groups * 8 * nt >= o_dim. Returns a cudaError_t as int.
extern "C" int rectpu_cin_tf32(const void* x, const void* y, const void* wp, void* out,
                               int n_b, int h_dim, int m_dim, int o_dim, int k_dim,
                               long long sxb, long long sxh, long long sxk, long long syb,
                               long long sym, long long syk, long long sob, long long soo,
                               long long sok, int mp, int nt, int n_groups, void* stream) {
  if (n_b == 0 || o_dim == 0 || k_dim == 0) return static_cast<int>(cudaSuccess);
  if (h_dim < 1 || m_dim < 1 || m_dim > mp || n_groups < 1 ||
      static_cast<int64_t>(n_groups) * 8 * nt < o_dim ||
      (reinterpret_cast<uintptr_t>(wp) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t s[9] = {sxb, sxh, sxk, syb, sym, syk, sob, soo, sok};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mp == 32) {
    return launch_cin_tf32_mp<32>(nt, x, y, wp, out, n_b, h_dim, m_dim, o_dim, k_dim, s,
                                  n_groups, st);
  }
  if (mp == 64) {
    return launch_cin_tf32_mp<64>(nt, x, y, wp, out, n_b, h_dim, m_dim, o_dim, k_dim, s,
                                  n_groups, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, y as for rectpu_cin; g: [n_b, o_dim, k_dim] with (sgb, sgo, sgk), same
// type. partial: [slices, o_dim, h_dim * m_dim] fp32 scratch; dw: [h_dim,
// m_dim, o_dim] fp32 contiguous. Slice s reduces rows (b, k) with
// b * k_dim + k in [s * slice_rows, (s + 1) * slice_rows), slice_rows a
// multiple of 32. copy16: stage x, y and g with 16-byte copies
// (ops/cin.py::dw_operands; else element copies). bf16 runs
// cin_dw_mma_kernel, fp32 cin_dw_tf32_kernel. Returns a cudaError_t as int.
extern "C" int rectpu_cin_dw(const void* x, const void* y, const void* g, void* partial,
                             void* dw, int n_b, int h_dim, int m_dim, int o_dim, int k_dim,
                             long long sxb, long long sxh, long long sxk, long long syb,
                             long long sym, long long syk, long long sgb, long long sgo,
                             long long sgk, int slices, int slice_rows, int copy16,
                             int is_bf16, void* stream) {
  if (h_dim < 1 || m_dim < 1 || o_dim < 1 || slices < 1 || slice_rows < 1 ||
      slice_rows % kDepth != 0 ||
      static_cast<int64_t>(slices) * slice_rows < static_cast<int64_t>(n_b) * k_dim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t s[9] = {sxb, sxh, sxk, syb, sym, syk, sgb, sgo, sgk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dw_bf16(x, y, g, partial, dw, n_b, h_dim, m_dim, o_dim, k_dim, s,
                                  slices, slice_rows, copy16 != 0, st)
                 : launch_dw_fp32(x, y, g, partial, dw, n_b, h_dim, m_dim, o_dim, k_dim, s,
                                  slices, slice_rows, copy16 != 0, st);
}
