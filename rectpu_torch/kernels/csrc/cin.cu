// The xDeepFM CIN core for Hopper (sm_90a), two entries:
//   contraction: out[b, o, k] = sum_{h, m} w[h, m, o] * round(x[b, h, k] * y[b, m, k])
//   dw:          dw[h, m, o]  = sum_{b, k} round(x[b, h, k] * y[b, m, k]) * g[b, o, k]
// round() is to x's type; the sums are fp32; the contraction's result is
// rounded to x's type, dw is fp32. These are the numerics of every rectpu form
// (cin_core_xla and both Pallas variants).
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
// Design: one block of 8 warps computes a 128 x 64 output tile (contraction:
// 128 rows r by 64 columns o; dw: 128 (h, m) by 64 o) and walks the reduction
// in chunks of 32.
//   - contraction: the block stages its 128 rows' x[r, :] and y[r, :] in
//     shared memory once (transposed, so a warp reads 32 neighbouring rows),
//     then per chunk builds kr[128 x 32] in shared memory (each product
//     rounded to x's type) and loads the matching W[32 x 64] slice, and
//     multiplies them.
//   - dw: block (s, j-tile, o-tile) reduces rows [s*slice_rows, ...) of its
//     slice: per chunk of 32 rows it stages x, y and g, builds kr^T[128 x 32]
//     and multiplies it with g[32 x 64]. Its fp32 tile goes to a partial
//     buffer [slices, O, H*M]; a second kernel sums the partials of each
//     element in slice order. The slicing depends on the shape only, so two
//     launches give the same bits (no atomics).
//   - the product of the two shared-memory tiles: for bf16, tensor cores
//     through WMMA (m16n16k16, bf16 in, fp32 accumulate), which matches the
//     numerics exactly, since kr is already rounded to bf16; for fp32, fp32
//     FMAs on the CUDA cores, 8 x 4 outputs a thread (TF32 would round the
//     operands). wgmma and TMA are later work.

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

// dw: A, B, C tiles; x^T [<=128 h][32], y^T [M][32]; the tile's (h, m) pairs
// as two int32 tables, then three int64 row bases
template <typename T>
__host__ __device__ inline Layout dw_layout(int m_dim) {
  Layout l;
  l.a = 0;
  l.b = l.a + align128(kTileRows * Ld<T>::a * static_cast<int>(sizeof(T)));
  l.c = l.b + align128(kDepth * Ld<T>::b * static_cast<int>(sizeof(T)));
  l.xs = l.c + align128(kTileCols * kLdc * static_cast<int>(sizeof(float)));
  l.ys = l.xs + align128(kTileRows * kDepth * static_cast<int>(sizeof(T)));
  l.idx = l.ys + align128(m_dim * kDepth * static_cast<int>(sizeof(T)));
  l.total = l.idx + 2 * kTileRows * static_cast<int>(sizeof(int)) +
            3 * kDepth * static_cast<int>(sizeof(int64_t));
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
cin_dw_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ g,
              float* __restrict__ partial, int n_b, int h_dim, int m_dim, int o_dim,
              int k_dim, int64_t sxb, int64_t sxh, int64_t sxk, int64_t syb, int64_t sym,
              int64_t syk, int64_t sgb, int64_t sgo, int64_t sgk, int slice_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = dw_layout<T>(m_dim);
  T* a_tile = reinterpret_cast<T*>(smem + l.a);
  T* b_tile = reinterpret_cast<T*>(smem + l.b);
  float* c_tile = reinterpret_cast<float*>(smem + l.c);
  T* xs = reinterpret_cast<T*>(smem + l.xs);
  T* ys = reinterpret_cast<T*>(smem + l.ys);
  int* h_of = reinterpret_cast<int*>(smem + l.idx);  // local h (from h_lo), -1 past H*M
  int* m_of = h_of + kTileRows;
  int64_t* row_x = reinterpret_cast<int64_t*>(m_of + kTileRows);
  int64_t* row_y = row_x + kDepth;
  int64_t* row_g = row_y + kDepth;

  const int tid = threadIdx.x;
  const int64_t n_rows = static_cast<int64_t>(n_b) * k_dim;
  const int slice = blockIdx.x;
  const int j0 = blockIdx.y * kTileRows;
  const int o0 = blockIdx.z * kTileCols;
  const int hm = h_dim * m_dim;
  const int h_lo = j0 / m_dim;
  const int h_hi = min(h_dim - 1, (j0 + kTileRows - 1) / m_dim);
  const int n_h = h_hi - h_lo + 1;  // at most kTileRows
  const T zero = from_float<T>(0.0f);
  const int64_t row_begin = static_cast<int64_t>(slice) * slice_rows;
  const int64_t row_end = min(n_rows, row_begin + slice_rows);

  for (int jj = tid; jj < kTileRows; jj += kThreads) {
    const int j = j0 + jj;
    h_of[jj] = j < hm ? j / m_dim - h_lo : -1;
    m_of[jj] = j < hm ? j % m_dim : 0;
  }

  TileMma<T> mma;
  mma.zero();
  for (int64_t c0 = row_begin; c0 < row_end; c0 += kDepth) {
    if (tid < kDepth) {
      const int64_t r = c0 + tid;
      const int64_t b = r / k_dim;
      const int64_t k = r - b * k_dim;
      const bool ok = r < row_end;
      row_x[tid] = ok ? b * sxb + k * sxk : -1;
      row_y[tid] = ok ? b * syb + k * syk : -1;
      row_g[tid] = ok ? b * sgb + k * sgk : -1;
    }
    __syncthreads();
    for (int i = tid; i < n_h * kDepth; i += kThreads) {
      const bool rows_fast = sxk <= sxh;
      const int rr = rows_fast ? i % kDepth : i / n_h;
      const int hh = rows_fast ? i / kDepth : i % n_h;
      xs[hh * kDepth + rr] = row_x[rr] >= 0 ? x[row_x[rr] + (h_lo + hh) * sxh] : zero;
    }
    for (int i = tid; i < m_dim * kDepth; i += kThreads) {
      const bool rows_fast = syk <= sym;
      const int rr = rows_fast ? i % kDepth : i / m_dim;
      const int mm = rows_fast ? i / kDepth : i % m_dim;
      ys[mm * kDepth + rr] = row_y[rr] >= 0 ? y[row_y[rr] + mm * sym] : zero;
    }
    for (int i = tid; i < kDepth * kTileCols; i += kThreads) {
      const bool rows_fast = sgk <= sgo;
      const int rr = rows_fast ? i % kDepth : i / kTileCols;
      const int c = rows_fast ? i / kDepth : i % kTileCols;
      const int o = o0 + c;
      b_tile[rr * Ld<T>::b + c] =
          (row_g[rr] >= 0 && o < o_dim) ? g[row_g[rr] + o * sgo] : zero;
    }
    __syncthreads();
    // kr^T [128 (h, m)][32 rows]
    for (int i = tid; i < kTileRows * kDepth; i += kThreads) {
      const int rr = i % kDepth;
      const int jj = i / kDepth;
      const int hh = h_of[jj];
      a_tile[jj * Ld<T>::a + rr] =
          hh >= 0 ? rounded_product(xs[hh * kDepth + rr], ys[m_of[jj] * kDepth + rr]) : zero;
    }
    __syncthreads();
    mma.step(a_tile, b_tile);
    __syncthreads();
  }
  mma.store(c_tile);
  __syncthreads();
  // partial[slice, o, j], j fastest
  for (int i = tid; i < kTileRows * kTileCols; i += kThreads) {
    const int jj = i % kTileRows;
    const int c = i / kTileRows;
    const int j = j0 + jj;
    const int o = o0 + c;
    if (j < hm && o < o_dim) {
      partial[(static_cast<int64_t>(slice) * o_dim + o) * hm + j] = c_tile[c * kLdc + jj];
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

template <typename T>
int launch_dw(const void* x, const void* y, const void* g, void* partial, void* dw, int n_b,
              int h_dim, int m_dim, int o_dim, int k_dim, const int64_t* s, int slices,
              int slice_rows, cudaStream_t stream) {
  const int smem = dw_layout<T>(m_dim).total;
  cudaError_t err = allow_smem(cin_dw_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hm = h_dim * m_dim;
  const dim3 grid(static_cast<unsigned>(slices),
                  static_cast<unsigned>((hm + kTileRows - 1) / kTileRows),
                  static_cast<unsigned>((o_dim + kTileCols - 1) / kTileCols));
  cin_dw_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(g),
      static_cast<float*>(partial), n_b, h_dim, m_dim, o_dim, k_dim, s[0], s[1], s[2], s[3],
      s[4], s[5], s[6], s[7], s[8], slice_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(o_dim) * hm;
  cin_dw_sum_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                      stream>>>(static_cast<const float*>(partial), static_cast<float*>(dw),
                                slices, o_dim, hm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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

// x, y as for rectpu_cin; g: [n_b, o_dim, k_dim] with (sgb, sgo, sgk), same
// type. partial: [slices, o_dim, h_dim * m_dim] fp32 scratch; dw: [h_dim,
// m_dim, o_dim] fp32 contiguous. Slice s reduces rows (b, k) with
// b * k_dim + k in [s * slice_rows, (s + 1) * slice_rows), slice_rows a
// multiple of 32. Returns a cudaError_t as int.
extern "C" int rectpu_cin_dw(const void* x, const void* y, const void* g, void* partial,
                             void* dw, int n_b, int h_dim, int m_dim, int o_dim, int k_dim,
                             long long sxb, long long sxh, long long sxk, long long syb,
                             long long sym, long long syk, long long sgb, long long sgo,
                             long long sgk, int slices, int slice_rows, int is_bf16,
                             void* stream) {
  if (h_dim < 1 || m_dim < 1 || o_dim < 1 || slices < 1 || slice_rows < 1 ||
      slice_rows % kDepth != 0 ||
      static_cast<int64_t>(slices) * slice_rows < static_cast<int64_t>(n_b) * k_dim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t s[9] = {sxb, sxh, sxk, syb, sym, syk, sgb, sgo, sgk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dw<__nv_bfloat16>(x, y, g, partial, dw, n_b, h_dim, m_dim, o_dim,
                                            k_dim, s, slices, slice_rows, st)
                 : launch_dw<float>(x, y, g, partial, dw, n_b, h_dim, m_dim, o_dim, k_dim, s,
                                    slices, slice_rows, st);
}
