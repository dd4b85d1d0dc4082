// Radix-2 NTT over the BN254 scalar field Fr, stage-blocked in shared
// memory: a transform of 2^log_n elements is ceil(log_n / t) launches of
// one pass kernel (t = the tile's log, 11 on the main path), not log_n
// stages of elementwise launches.
//
// Replaces kernel B1 as the TPU package's NTT runs it: zkpoa_tpu/ops/ntt.py
// `_ntt_impl` :76 (the bit-reversal gather, then per stage one batched
// `mont_mul` of the odd half by the stage twiddles and an add/sub pair,
// each through zkpoa_tpu/ops/pallas_field.py:297 `mont_mul_tpu` and its
// add/sub helpers), and `ntt` :94's final 1/n product.
//
// Schedule (decimation in time, as the JAX package: bit-reversed input,
// stage s joins elements i and i + 2^s within blocks of 2^(s+1), with the
// twiddle w^(j n / 2^(s+1)) for j = i mod 2^s). A pass runs stages
// s0 .. s0 + w - 1 on groups of 2^w elements at stride 2^s0 (index i =
// h 2^(s0+w) + m 2^s0 + l, m < 2^w); a block takes one h and C = 2^log_c
// consecutive l, so a tile of 2^(w + log_c) <= 2^t elements, whose rows of
// C elements are contiguous in memory. Pass 0 (s0 = 0, C = 1) reads its
// tile through the bit reversal, __brev(i) >> (32 - log_n), with no index
// tensor, and writes out of place; later passes read and write the same
// elements in place. The last pass multiplies each output by a scale
// before it stores it: none, one constant (1/n of an inverse transform) or
// a table of n values (the quotient's coset powers g^i with 1/n and, on the
// way back, g^-i with 1/n and 1/Z(g) folded in; ops/ntt.py builds them).
// Twiddles are read from the one cached table of n/2 powers w^k by index.
// A batch of independent transforms (the JAX package's leading axes: the
// stacked operands of batch proving, the rows and columns of the four-step
// transform) runs in the same launches: transform b starts at element
// b * stride, the grid's second dimension runs over the transforms (folded
// into the first past its 65,535 limit), and all share the twiddles and the
// scale, indexed by the position inside the transform. A batch of one is
// the single transform's launch.
//
// What bounds it: the products, n/2 log_n Montgomery products a transform
// (a 2^21 transform is 22M products, 0.34 ms of int32 issue at 256
// operations a product), against 2 x 64 MB of device traffic per pass.
// The tile lives in shared memory limb-major ([8][tile] words), so the 32
// lanes of a warp reading 32 elements hit 32 banks; 2^11 elements are 64 KB
// of dynamic shared memory, three blocks an SM. Every butterfly's output
// is the canonical residue (field.cuh), so the limbs equal those of the
// per-stage route and of the plain versions in ops/ntt.py.
#include "field.cuh"

namespace zk {

constexpr int NTT_MAX_TILE_LOG = 11;
constexpr int NTT_THREADS = 256;

__device__ __forceinline__ fe smem_load(const uint32_t* s, uint32_t tile, uint32_t k) {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = s[j * tile + k];
  return r;
}

__device__ __forceinline__ void smem_store(uint32_t* s, uint32_t tile, uint32_t k, const fe& x) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j * tile + k] = x.v[j];
}

// scale_mode: 0 none, 1 scale[0] for every element, 2 scale[i]
__global__ void __launch_bounds__(NTT_THREADS)
ntt_pass_kernel(const uint32_t* in, uint32_t* out, const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ scale, int log_n, int s0, int w, int log_c,
                int first, int scale_mode, size_t stride) {
  extern __shared__ uint32_t sm[];
  const uint32_t tile = 1u << (w + log_c);
  const uint32_t cmask = (1u << log_c) - 1;
  const int lb_bits = s0 - log_c;
  const int log_blocks = log_n - w - log_c;  // blocks a transform
  const size_t lin = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const uint32_t bx = (uint32_t)(lin & ((1u << log_blocks) - 1));
  const size_t off = (lin >> log_blocks) * stride * 8;  // this transform's first limb
  in += off;
  out += off;
  const uint32_t lb = bx & ((1u << lb_bits) - 1);
  const uint32_t h = bx >> lb_bits;
  const uint32_t l0 = lb << log_c;
  const uint32_t base = (h << (s0 + w)) | l0;
  for (uint32_t k = threadIdx.x; k < tile; k += blockDim.x) {
    const uint32_t i = base | ((k >> log_c) << s0) | (k & cmask);
    const uint32_t src = first ? (log_n ? __brev(i) >> (32 - log_n) : 0u) : i;
    smem_store(sm, tile, k, fe_load(in + (size_t)src * 8));
  }
  __syncthreads();
  for (int r = 0; r < w; ++r) {
    const int s = s0 + r;
    const uint32_t rmask = (1u << r) - 1;
    for (uint32_t q = threadIdx.x; q < (tile >> 1); q += blockDim.x) {
      const uint32_t c = q & cmask, bq = q >> log_c;
      const uint32_t m_lo = ((bq >> r) << (r + 1)) | (bq & rmask);
      const uint32_t k_lo = (m_lo << log_c) | c;
      const uint32_t k_hi = k_lo + (1u << (r + log_c));
      const uint32_t j = ((bq & rmask) << s0) | l0 | c;  // i mod 2^s
      const fe t = fe_load(tw + ((size_t)j << (log_n - 1 - s)) * 8);
      const fe u = smem_load(sm, tile, k_lo);
      const fe v = fe_mul<FR>(smem_load(sm, tile, k_hi), t);
      smem_store(sm, tile, k_lo, fe_add<FR>(u, v));
      smem_store(sm, tile, k_hi, fe_sub<FR>(u, v));
    }
    __syncthreads();
  }
  for (uint32_t k = threadIdx.x; k < tile; k += blockDim.x) {
    const uint32_t i = base | ((k >> log_c) << s0) | (k & cmask);
    fe x = smem_load(sm, tile, k);
    if (scale_mode == 1) x = fe_mul<FR>(x, fe_load(scale));
    else if (scale_mode == 2) x = fe_mul<FR>(x, fe_load(scale + (size_t)i * 8));
    fe_store(out + (size_t)i * 8, x);
  }
}

}  // namespace zk

// One pass of `batch` transforms, transform b at element b * stride:
// stages s0 .. s0 + w - 1 over tiles of 2^(w + log_c) elements (ops/ntt.py
// `ntt_passes` gives the schedule). first: read `in` through the bit
// reversal (else in == out, in place); last pass: scale_mode 1 or 2
// multiplies by scale[0] or scale[i], i the position inside the transform.
extern "C" int zk_ntt_pass(const void* in, void* out, const void* tw, const void* scale,
                           int log_n, int s0, int w, int log_c, int first, int scale_mode,
                           long long batch, long long stride, void* stream) {
  if (log_n < 0 || log_n > 28 || s0 < 0 || w < 0 || log_c < 0 || log_c > s0 ||
      w + log_c > zk::NTT_MAX_TILE_LOG || s0 + w > log_n || scale_mode < 0 || scale_mode > 2 ||
      (first && s0 != 0) || batch < 1 || stride < (1ll << log_n))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)32 << (w + log_c);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(zk::ntt_pass_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         32 << zk::NTT_MAX_TILE_LOG);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const unsigned blocks = 1u << (log_n - w - log_c);
  dim3 grid(blocks, (unsigned)batch);
  if (batch > 65535) {  // the grid's second dimension: fold the batch into the first
    if ((long long)blocks * batch > 0x7fffffffll) return (int)cudaErrorInvalidValue;
    grid = dim3((unsigned)(blocks * batch), 1);
  }
  const int half = (1 << (w + log_c)) >> 1;
  const int threads = half < 32 ? 32 : (half > zk::NTT_THREADS ? zk::NTT_THREADS : half);
  zk::ntt_pass_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(scale), log_n, s0, w, log_c,
      first, scale_mode, (size_t)stride);
  return (int)cudaGetLastError();
}
