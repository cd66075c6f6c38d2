// One Adam step over an embedding table for Hopper (sm_90a), in place:
//   m' = b1*m + (1-b1)*g            stored first (bf16 by stochastic rounding,
//   v' = b2*v + (1-b2)*g*g           by round to nearest, or fp32)
//   p' = p - lr_t * m'' / (sqrt(v'') + eps)   from the STORED slots m'', v''
// with lr_t = lr*sqrt(1-b2^t)/(1-b1^t) computed by the caller (passed by
// value, or in device memory for a step replayed from a CUDA graph), eps outside
// the square root (TF's Adam), and a bf16 p rounded stochastically.
//
// Replaces rectpu/ops/fused_adam.py::_adam_tile_kernel (:51), run by
// fused_adam_table (:99) for the [V, W] leaves that adam(fused_leaves=...)
// names. Same arithmetic, in the same order, as that kernel and as
// optimizers.adam's tree-map update (:192-224): fp32 math whatever the storage
// types; the slots are stored before the parameter step reads them back; the
// stochastic rounding adds the low 16 bits of a murmur hash of the flat index
// row*W + col (uint32) seeded with t (t + 2^30 for a bf16 parameter) and
// truncates (fused_adam.py:37-48). The index is the element's in the global
// table: a shard of rows [r0, r0 + V) passes idx_base = r0*W mod 2^32, since
// rectpu keys the update of a sharded table on the global array's iota
// (optimizers.py:65); a whole table passes 0. The 1-b complements arrive as
// fp32 values of Python-float differences: 1 - f32(0.9) computed here would
// be 0.10000002, not f32(0.1).
//
// Contraction: every multiply, add, divide and square root is written with a
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, ...), so nvcc fuses no
// multiply-add into an FMA. Each operation then rounds exactly as the plain
// PyTorch version's separate elementwise ops do, and the two agree bit for
// bit; the kernel is bitwise deterministic run to run by construction (no
// reduction, no atomics).
//
// What bounds it on this card: bytes. One pass reads p, m, v and g and writes
// p, m and v; the arithmetic is ~12 flops per element. At the flagship table
// (311,296 x 65: fp32 p, bf16 m and v, bf16 g) that is 18 bytes per element,
// 364 MB, 0.109 ms at 3.35 TB/s.
//
// Design: the TPU kernel swept [W, TR] tiles of the transposed table so the
// 65-wide rows were not padded to 128 lanes. Here the four tensors are read
// as flat contiguous arrays: thread i of the grid-stride loop takes element
// i, so a warp's loads and stores cover 32 neighbouring elements of each
// array (coalesced whatever W is), and the flat index plus idx_base is the
// SR counter directly. The storage types are run-time flags, uniform across
// the grid.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

enum Store { kF32 = 0, kBf16 = 1, kBf16Sr = 2 };

__device__ __forceinline__ float load(const void* base, bool bf16, int64_t i) {
  if (bf16) {
    return __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(base)[i]) << 16);
  }
  return static_cast<const float*>(base)[i];
}

__device__ __forceinline__ uint32_t sr_noise(uint32_t idx, uint32_t seed) {
  uint32_t h = idx * 2654435761u + seed * 0x9E3779B9u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return h & 0xFFFFu;
}

// bf16 bits of x rounded to nearest even, as torch's .to(bfloat16) (a NaN
// becomes its canonical quiet NaN)
__device__ __forceinline__ uint32_t bf16_rne_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FC0u;
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

// Store x in `kind` at base[i]; return the stored value as fp32.
__device__ __forceinline__ float store(void* base, int kind, int64_t i, float x, uint32_t idx,
                                       uint32_t seed) {
  if (kind == kF32) {
    static_cast<float*>(base)[i] = x;
    return x;
  }
  uint32_t hi;
  if (kind == kBf16Sr) {
    hi = (__float_as_uint(x) + sr_noise(idx, seed)) >> 16;
  } else {
    hi = bf16_rne_bits(x);
  }
  static_cast<uint16_t*>(base)[i] = static_cast<uint16_t>(hi);
  return __uint_as_float(hi << 16);
}

// lr_t_dev / t_dev, when not null, hold lr_t and t in device memory (a step
// captured in a CUDA graph reads them there; the values passed are then unused)
__global__ void adam_kernel(void* __restrict__ p, void* __restrict__ m, void* __restrict__ v,
                            const void* __restrict__ g, int64_t n, float lr_t_arg, float beta1,
                            float omb1, float beta2, float omb2, float eps, uint32_t t_arg,
                            uint32_t idx_base, const float* __restrict__ lr_t_dev,
                            const long long* __restrict__ t_dev, int p_kind, int m_kind,
                            int v_kind, int g_bf16) {
  const float lr_t = lr_t_dev != nullptr ? *lr_t_dev : lr_t_arg;
  const uint32_t t = t_dev != nullptr ? static_cast<uint32_t>(*t_dev) : t_arg;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t idx = idx_base + static_cast<uint32_t>(i);  // global row*W + col, mod 2^32
    const float gf = load(g, g_bf16, i);
    const float m_new = __fadd_rn(__fmul_rn(beta1, load(m, m_kind != kF32, i)),
                                  __fmul_rn(omb1, gf));
    const float v_new = __fadd_rn(__fmul_rn(beta2, load(v, v_kind != kF32, i)),
                                  __fmul_rn(__fmul_rn(omb2, gf), gf));
    // optimizers.adam seeds both slots' draws with t
    const float m_h = store(m, m_kind, i, m_new, idx, t);
    const float v_h = store(v, v_kind, i, v_new, idx, t);
    const float step = __fdiv_rn(__fmul_rn(lr_t, m_h), __fadd_rn(__fsqrt_rn(v_h), eps));
    const float p_new = __fsub_rn(load(p, p_kind != kF32, i), step);
    store(p, p_kind, i, p_new, idx, t + (1u << 30));
  }
}

}  // namespace

// p, m, v, g: n contiguous elements each on one device, updated in place (p,
// m, v). *_kind: 0 fp32, 1 bf16 rounded to nearest, 2 bf16 rounded
// stochastically (a bf16 p is always 2). g_bf16: g is bf16, else fp32. t: the
// step counter after its increment. idx_base: the global flat index of
// element 0 (mod 2^32; 0 for a whole table). lr_t_dev / t_dev: null, or one
// fp32 / int64 in device memory that replaces lr_t / t. Returns a cudaError_t as int
// (0 = ok).
extern "C" int rectpu_fused_adam(void* p, void* m, void* v, const void* g, long long n,
                                 float lr_t, float beta1, float omb1, float beta2, float omb2,
                                 float eps, unsigned int t, unsigned int idx_base,
                                 const float* lr_t_dev,
                                 const long long* t_dev, int p_kind, int m_kind, int v_kind,
                                 int g_bf16, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (p_kind < kF32 || p_kind > kBf16Sr || m_kind < kF32 || m_kind > kBf16Sr ||
      v_kind < kF32 || v_kind > kBf16Sr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, m, v, g, n, lr_t, beta1, omb1, beta2, omb2, eps, t, idx_base, lr_t_dev, t_dev, p_kind,
      m_kind, v_kind, g_bf16);
  return static_cast<int>(cudaGetLastError());
}
