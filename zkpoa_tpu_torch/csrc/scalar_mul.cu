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
// One thread (G2: three, below) owns one lane and runs the whole ladder
// with curve.cuh's formulas: one launch a call, not 508 a stage.
//
// The ladder is a signed fixed window of LW bits (Booth recoding): digit i
// of k is bits i LW .. i LW + LW - 2 plus bit i LW - 1 minus 2^(LW-1) times
// bit i LW + LW - 1, in [-2^(LW-1), 2^(LW-1)], and sum_i d_i 2^(LW i) = k;
// a digit reads LW + 1 bits of k and nothing else, so it is computed where
// it is used. Each lane first builds its multiples 1 P .. 2^(LW-1) P
// (2e P by a doubling of e P, (2e+1) P = 2e P + P), then from the top digit
// any lane of the warp needs runs LW doublings and one unified add of
// +-table[|d|] per window (-d negates y). The trip counts are the same in
// every lane of a warp, whatever its scalar; a lane skips only the add of a
// zero digit. Before a lane's own top digit its accumulator is the all-zero
// infinity, whose doubling is all zero again, and curve.cuh's add to it
// returns the addend itself, so the limbs do not depend on where the warp
// starts. The plain twin (`ops/curve.py` `ladder_plain`) repeats the same
// table, digits and add order in int64 and agrees limb for limb. The unified
// add covers acc == +-table[|d|] (a doubling, or infinity), which a scalar
// that wraps mod r can reach.
//
// Scalars a warp shares: K1 takes one scalar for every lane (stride 0: the
// 1/m scale, a phase-2 contribution) or a scalar a lane (ptau.py sorts the
// wire entries by coefficient, so neighbouring lanes and warps mostly share
// one); the zero-digit branch is then uniform. K2 reads its twiddle's
// digits, recoded once per domain (`ops/curve.py` `booth_digits`), and maps
// butterfly t to twiddle j = t mod half of block t / half, so a warp takes
// 32 consecutive twiddles: the window keeps their
// control flow together. The mappings that give a warp one twiddle across
// 32 blocks wherever a stage has that many (1: j = t / nb; 2: groups of 32
// blocks, the next warp the next twiddle) measured 1.1-2.3x slower on
// those stages, most where neighbouring warps hold different twiddles:
// a warp that skips a zero digit's add drifts from the others through a
// loop body of fully unrolled carry chains (our reading: instruction
// fetch; there is no profiler to show it) (PERF.md §6).
//
// What bounds it: the SMs' integer multiply-add rate. A G1 window is LW
// doublings (7 Fq products each) and an add (16); G2 16 and 44. The bytes
// (a point and a scalar in, a point out) are negligible. A lane builds only
// the multiples up to the largest |digit| of its warp (a twiddle of 1 needs
// none but P). The multiples sit in one column of dynamic shared memory per
// thread (768 B a G1 thread at LW = 4: two blocks of 128 an SM). G1
// inlines the formulas (one thread a lane); G2 runs three threads a lane
// (row_accum.cuh `G2Tri`, a component of every Fq2 value each, the
// formulas inlined, no stack frame). This design measured fastest on the
// full stages and the 1/m scales, nearly all of a setup's ladder time,
// against the multiples in local memory (1.25-1.4x slower despite more
// resident warps), LW = 5 (one block an SM) and LW = 3 (a third more
// adds), and G2 on one thread a lane through curve.cuh's out-of-line Fq2
// formulas (slower at every G2 shape) (PERF.md §6).
#include "row_accum.cuh"

namespace zk {

constexpr int LW = 4;                  // window bits (ops/field_kernels.py LADDER_W)
constexpr int LH = 1 << (LW - 1);      // multiples a lane keeps: 1 P .. LH P
constexpr int L_THREADS = 128;         // threads a block
// shared memory a thread: its multiples, 3 coordinates of 8 words (G1, and
// G2's one Fq component a thread): 768 B, 96 KB a block
constexpr size_t L_SMEM = (size_t)LH * 3 * 8 * sizeof(uint32_t);
static_assert(L_SMEM * L_THREADS <= 232448, "a block's multiples exceed 227 KB");

__device__ __forceinline__ void col_store(uint32_t* s, int st, const fe& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j * st] = a.v[j];
}
__device__ __forceinline__ void col_load(const uint32_t* s, int st, fe& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a.v[j] = s[j * st];
}

extern __shared__ uint32_t ladder_smem[];

// A lane's (thread's part of its) multiples e P, e = 1 .. LH: this
// thread's column of shared memory, word k of entry e.
template <class F>
struct Multiples {
  static_assert(sizeof(typename F::T) == 8 * sizeof(uint32_t), "one Fq element a thread");
  static constexpr int C = 8;
  __device__ __forceinline__ uint32_t* at(int e) const {
    return ladder_smem + (size_t)(e - 1) * 3 * C * blockDim.x + threadIdx.x;
  }
  __device__ __forceinline__ Jac<F> get(int e) const {
    const uint32_t* s = at(e);
    const int st = blockDim.x;
    Jac<F> p;
    col_load(s, st, p.x);
    col_load(s + C * st, st, p.y);
    col_load(s + 2 * C * st, st, p.z);
    return p;
  }
  __device__ __forceinline__ void put(int e, const Jac<F>& p) {
    uint32_t* s = at(e);
    const int st = blockDim.x;
    col_store(s, st, p.x);
    col_store(s + C * st, st, p.y);
    col_store(s + 2 * C * st, st, p.z);
  }
};

// Digit i of the plain scalar k, bits at or above n_bits read as 0.
__device__ __forceinline__ int scalar_digit(const fe& k, int i, int n_bits) {
  const int pos = i * LW - 1;  // the bit below the window: the borrow
  const uint32_t mask = (2u << LW) - 1u;
  uint32_t v;
  if (pos < 0) {
    v = (k.v[0] << 1) & mask;
  } else {
    const int wi = pos >> 5;
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // selects, not a dynamically indexed (local) array
      lo = j == wi ? k.v[j] : lo;
      hi = j == wi + 1 ? k.v[j] : hi;
    }
    v = (uint32_t)(((((uint64_t)hi) << 32) | lo) >> (pos & 31)) & mask;
  }
  const int keep = n_bits - pos;  // bits of the window below n_bits
  if (keep <= LW) v &= (1u << max(keep, 0)) - 1u;
  return (int)((v >> 1) & (LH - 1)) + (int)(v & 1u) - (int)(v >> LW) * LH;
}

// [k] p for digits digit(0 .. nd - 1) of k. Every thread of the warp calls
// it (the warp's top digit is a vote); threads that are not `active` (no
// lane, or G2 lanes 30 and 31 of a warp) return after the vote.
template <class F, class Digit>
__device__ __forceinline__ Jac<F> window_ladder(const Jac<F>& p, int nd, bool active,
                                                Digit digit) {
  // the warp's top non-zero digit and its largest |digit|: the multiples
  // above it are not built (a twiddle of 1 needs none but P)
  int top = -1, most = 0;
  if (active) {
#pragma unroll 1
    for (int i = nd - 1; i >= 0; --i) {
      const int d = digit(i);
      top = (top < 0 && d != 0) ? i : top;
      most = max(most, abs(d));
    }
  }
  top = __reduce_max_sync(FULL_WARP, top);
  most = __reduce_max_sync(FULL_WARP, most);
  Jac<F> acc = jac_inf<F>();
  if (!active || top < 0) return acc;
  Multiples<F> tab;
  tab.put(1, p);
#pragma unroll 1
  for (int e = 2; e <= most; ++e)
    tab.put(e, (e & 1) ? jac_add<F>(tab.get(e - 1), p) : jac_double<F>(tab.get(e >> 1)));
#pragma unroll 1
  for (int i = top; i >= 0; --i) {
    if (i != top) {
#pragma unroll 1
      for (int b = 0; b < LW; ++b) acc = jac_double<F>(acc);
    }
    const int d = digit(i);
    if (d != 0) {
      Jac<F> q = tab.get(d < 0 ? -d : d);
      if (d < 0) q.y = F::neg(q.y);
      acc = jac_add<F>(acc, q);
    }
  }
  return acc;
}

// K1: lane i gets [scalars[i * stride ..]] P_i (stride 8, or 0: one scalar)
template <class F>
__global__ void __launch_bounds__(L_THREADS)
    scalar_mul_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                      const uint32_t* __restrict__ pz, const uint32_t* __restrict__ scalars,
                      int stride, int n_bits, long long n, uint32_t* ox, uint32_t* oy,
                      uint32_t* oz) {
  const RowLane<F> me;
  const bool live = me.active && me.lane < n;
  fe k = fe_zero();
  Jac<F> p = jac_inf<F>();
  if (live) {
    k = fe_load(scalars + me.lane * stride);
    p = jac_load<F>(px, py, pz, me.lane);
  }
  const Jac<F> r = window_ladder<F>(p, n_bits / LW + 1, live,
                                    [&](int i) { return scalar_digit(k, i, n_bits); });
  if (live) jac_store<F>(ox, oy, oz, me.lane, r);
}

// K2: butterfly t of a stage with half = 2^log_half is twiddle j = t mod
// half of block t / half (a warp takes consecutive twiddles of one block):
// u = block 2 half + j, v = u + half; digits row j (nd int8, row stride
// dstride), in place.
template <class F>
__global__ void __launch_bounds__(L_THREADS)
    ntt_stage_kernel(uint32_t* x, uint32_t* y, uint32_t* z, const int8_t* __restrict__ digits,
                     long long dstride, int nd, int log_half, long long n_bfly) {
  const RowLane<F> me;
  const bool live = me.active && me.lane < n_bfly;
  const long long j = me.lane & ((1ll << log_half) - 1);
  const long long blk = me.lane >> log_half;
  const long long iu = (blk << (log_half + 1)) + j;
  const long long iv = iu + (1ll << log_half);
  Jac<F> t = jac_inf<F>();
  if (live) t = jac_load<F>(x, y, z, iv);
  const int8_t* row = digits + j * dstride;
  t = window_ladder<F>(t, nd, live, [&](int i) { return (int)row[i]; });
  if (!live) return;
  const Jac<F> u = jac_load<F>(x, y, z, iu);
  const Jac<F> lo = jac_add<F>(u, t);
  t.y = F::neg(t.y);
  const Jac<F> hi = jac_add<F>(u, t);
  jac_store<F>(x, y, z, iu, lo);
  jac_store<F>(x, y, z, iv, hi);
}

// A block's dynamic shared memory is above the default 48 KB.
template <class K>
inline cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(L_SMEM * L_THREADS));
}

template <class F>
inline long long lane_blocks(long long lanes) {
  const long long per_block = (long long)L_THREADS / 32 * RowLane<F>::PER_WARP;
  return (lanes + per_block - 1) / per_block;
}

template <class F>
int launch_scalar_mul(const void* px, const void* py, const void* pz, const void* scalars,
                      int stride, int n_bits, long long n, void* ox, void* oy, void* oz,
                      cudaStream_t s) {
  const long long blocks = lane_blocks<F>(n);
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  auto kernel = scalar_mul_kernel<F>;
  const cudaError_t e = allow_smem(kernel);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, L_THREADS, L_SMEM * L_THREADS, s>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
      static_cast<const uint32_t*>(pz), static_cast<const uint32_t*>(scalars), stride, n_bits, n,
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz));
  return (int)cudaGetLastError();
}

template <class F>
int launch_stage(void* x, void* y, void* z, const void* digits, long long dstride, int nd,
                 int log_half, long long n_bfly, cudaStream_t s) {
  const long long blocks = lane_blocks<F>(n_bfly);
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  auto kernel = ntt_stage_kernel<F>;
  const cudaError_t e = allow_smem(kernel);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, L_THREADS, L_SMEM * L_THREADS, s>>>(
      static_cast<uint32_t*>(x), static_cast<uint32_t*>(y), static_cast<uint32_t*>(z),
      static_cast<const int8_t*>(digits), dstride, nd, log_half, n_bfly);
  return (int)cudaGetLastError();
}

}  // namespace zk

// group: 1 = G1, 2 = G2. Points [n] Jacobian, scalars plain u32 limbs,
// [n, 8] (stride 8) or one [8] for every lane (stride 0); out [n] Jacobian
// (may not alias the points).
extern "C" int zk_scalar_mul(int group, const void* px, const void* py, const void* pz,
                             const void* scalars, int stride, int n_bits, long long n, void* ox,
                             void* oy, void* oz, void* stream) {
  if (n <= 0) return 0;
  if (n_bits <= 0 || n_bits > 256 || (stride != 0 && stride != 8))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (group == 1)
    return zk::launch_scalar_mul<zk::G1Field>(px, py, pz, scalars, stride, n_bits, n, ox, oy,
                                              oz, s);
  if (group != 2) return (int)cudaErrorInvalidValue;
  return zk::launch_scalar_mul<zk::G2Tri>(px, py, pz, scalars, stride, n_bits, n, ox, oy, oz, s);
}

// One stage over points [2 n_bfly] Jacobian, in place; digits [2^log_half,
// nd] int8 signed window digits of the twiddles (row stride dstride).
extern "C" int zk_group_ntt_stage(int group, void* x, void* y, void* z, const void* digits,
                                  long long dstride, int nd, int log_half, long long n_bfly,
                                  void* stream) {
  if (n_bfly <= 0) return 0;
  if (log_half < 0 || log_half > 40 || (1ll << log_half) > n_bfly ||
      n_bfly % (1ll << log_half) || nd <= 0 || dstride < nd)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (group == 1)
    return zk::launch_stage<zk::G1Field>(x, y, z, digits, dstride, nd, log_half, n_bfly, s);
  if (group != 2) return (int)cudaErrorInvalidValue;
  return zk::launch_stage<zk::G2Tri>(x, y, z, digits, dstride, nd, log_half, n_bfly, s);
}
