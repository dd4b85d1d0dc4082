// Variable-base scalar multiplication for BN254 G1 and G2: the per-lane
// ladder [k_i] P_i (K1) and one butterfly stage of the group NTT that
// turns powers-of-tau points into Lagrange points (K2).
//
// Replaces, on the ceremony path (prover/ptau.py):
//   K1 zkpoa_tpu/ops/curve_jax.py:264 `scalar_mul_batch`: a 254-step
//      fori_loop whose every step launched B4 (`jac_double_tpu`,
//      pallas_field.py:386) and B3 (`jac_add_tpu`, :362) over the whole
//      batch and selected the sum per lane;
//   K2 the stage body of zkpoa_tpu/prover/ptau.py:190-217 `lagrange_g1`:
//      that ladder on the twiddled half, two B3 adds and a B1 negation.
// Here one thread owns one lane and runs the whole ladder in registers
// with curve.cuh's formulas: one launch a call, not 508 a stage.
//
// The ladder is MSB-first double-then-add from the scalar's top set bit,
// branching on each bit where the TPU added on every bit and selected.
// Both give the same limbs: before the top bit the accumulator is the
// all-zero infinity, whose doubling is all zero again, and curve.cuh's
// add of a point to infinity returns the point itself. The plain twin
// (`ops/curve.py` `scalar_mul_plain`) runs the full select loop and so
// agrees limb for limb. Scalars are plain (not Montgomery) 8 x 32-bit
// limbs; bits at or above n_bits are ignored, as the TPU loop never reads
// them.
//
// What bounds it: the SMs' integer multiply-add rate. A G1 step is a
// doubling (7 Fq products) and, where the lane's bit is set, a unified
// add (16); the lanes of a warp hold unrelated scalars (twiddles,
// R1CS coefficients), so nearly every step runs both, about 23 products,
// 5.8k a 254-bit ladder. A broadcast scalar (the 1/m scale, a phase-2
// contribution) keeps the warp together and skips the adds of zero bits.
// The bytes (a point and a scalar in, a point out) are negligible. G1
// inlines the formulas (one thread a lane, no stack frame); G2 calls
// curve.cuh's out-of-line Fq2 formulas, as every G2 kernel here does,
// because inlined they cost minutes of ptxas time. A stage of K2 gives
// each butterfly one thread: it loads u and v, runs the ladder on v with
// the twiddle w^j, and writes u + v' and u - v' over u and v (in place:
// no two threads touch one index). Simple and correct first; a windowed
// ladder is later work.
#include "curve.cuh"

namespace zk {

constexpr int SM_THREADS = 128;  // threads a block of both kernels

// [k] p, MSB first over bits n_bits - 1 .. 0 of the plain scalar k.
template <class G>
__device__ __forceinline__ Jac<G> ladder(const Jac<G>& p, const fe& k, int n_bits) {
  Jac<G> acc = jac_inf<G>();
  bool started = false;
#pragma unroll 1
  for (int j = 7; j >= 0; --j) {
    const int lo = 32 * j;
    if (lo >= n_bits) continue;
    uint32_t w = k.v[j];
    if (n_bits - lo < 32) w &= (1u << (n_bits - lo)) - 1u;
    if (!started && w == 0) continue;
#pragma unroll 1
    for (int b = 31; b >= 0; --b) {
      if (started) acc = jac_double<G>(acc);
      if ((w >> b) & 1u) {
        acc = started ? jac_add<G>(acc, p) : p;
        started = true;
      }
    }
  }
  return acc;
}

template <class G>
__global__ void __launch_bounds__(SM_THREADS)
    scalar_mul_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                      const uint32_t* __restrict__ pz, const uint32_t* __restrict__ scalars,
                      int n_bits, long long n, uint32_t* ox, uint32_t* oy, uint32_t* oz) {
  const long long i = (long long)blockIdx.x * SM_THREADS + threadIdx.x;
  if (i >= n) return;
  const Jac<G> p = jac_load<G>(px, py, pz, i);
  jac_store<G>(ox, oy, oz, i, ladder<G>(p, fe_load(scalars + i * 8), n_bits));
}

// Butterfly b of the stage with half = 2^log_half: u = b's index in its
// block of 2 half, v = u + half, twiddle tw[b mod half].
template <class G>
__global__ void __launch_bounds__(SM_THREADS)
    ntt_stage_kernel(uint32_t* x, uint32_t* y, uint32_t* z, const uint32_t* __restrict__ tw,
                     int log_half, long long n_bfly) {
  const long long b = (long long)blockIdx.x * SM_THREADS + threadIdx.x;
  if (b >= n_bfly) return;
  const long long j = b & ((1ll << log_half) - 1);
  const long long iu = ((b >> log_half) << (log_half + 1)) + j;
  const long long iv = iu + (1ll << log_half);
  const Jac<G> u = jac_load<G>(x, y, z, iu);
  Jac<G> t = ladder<G>(jac_load<G>(x, y, z, iv), fe_load(tw + j * 8), 254);
  const Jac<G> lo = jac_add<G>(u, t);
  t.y = G::neg(t.y);
  const Jac<G> hi = jac_add<G>(u, t);
  jac_store<G>(x, y, z, iu, lo);
  jac_store<G>(x, y, z, iv, hi);
}

inline long long sm_blocks(long long n) { return (n + SM_THREADS - 1) / SM_THREADS; }

}  // namespace zk

using u32 = uint32_t;
#define C32(p) static_cast<const u32*>(p)
#define M32(p) static_cast<u32*>(p)

// group: 1 = G1, 2 = G2. Points [n] Jacobian, scalars [n, 8] plain u32
// limbs, out [n] Jacobian (may not alias the points).
extern "C" int zk_scalar_mul(int group, const void* px, const void* py, const void* pz,
                             const void* scalars, int n_bits, long long n, void* ox, void* oy,
                             void* oz, void* stream) {
  if (n <= 0) return 0;
  if (n_bits <= 0 || n_bits > 256) return (int)cudaErrorInvalidValue;
  const long long blocks = zk::sm_blocks(n);
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (group == 1)
    zk::scalar_mul_kernel<zk::G1Field><<<(unsigned)blocks, zk::SM_THREADS, 0, s>>>(
        C32(px), C32(py), C32(pz), C32(scalars), n_bits, n, M32(ox), M32(oy), M32(oz));
  else if (group == 2)
    zk::scalar_mul_kernel<zk::G2Field><<<(unsigned)blocks, zk::SM_THREADS, 0, s>>>(
        C32(px), C32(py), C32(pz), C32(scalars), n_bits, n, M32(ox), M32(oy), M32(oz));
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// One stage over points [2 n_bfly] Jacobian, in place; tw [2^log_half, 8]
// plain twiddle limbs.
extern "C" int zk_group_ntt_stage(int group, void* x, void* y, void* z, const void* tw,
                                  int log_half, long long n_bfly, void* stream) {
  if (n_bfly <= 0) return 0;
  if (log_half < 0 || (1ll << log_half) > n_bfly || n_bfly % (1ll << log_half))
    return (int)cudaErrorInvalidValue;
  const long long blocks = zk::sm_blocks(n_bfly);
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (group == 1)
    zk::ntt_stage_kernel<zk::G1Field><<<(unsigned)blocks, zk::SM_THREADS, 0, s>>>(
        M32(x), M32(y), M32(z), C32(tw), log_half, n_bfly);
  else if (group == 2)
    zk::ntt_stage_kernel<zk::G2Field><<<(unsigned)blocks, zk::SM_THREADS, 0, s>>>(
        M32(x), M32(y), M32(z), C32(tw), log_half, n_bfly);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
