// Fixed-base scalar multiplication k_i * base for BN254 G1 and G2 (setup),
// on the row-accumulation core (row_accum.cuh).
//
// Replaces kernel B8 of the TPU package: zkpoa_tpu/ops/curve_jax.py:369
// `fixed_base_mul_batch_pallas` -> `_fb_fold_pallas` :407 ->
// msm_pallas.py `_accum_group` :990 (`pallas_call` :1016). The TPU version
// gathered a [nwin, K, N] stream of table points into device memory, ran
// it through the bucket kernel with per-lane exception flags, and fell
// back to an XLA fold when any lane was flagged. Here one lane owns one
// scalar: row j of its sequence is table[j][digit_j] (digit j of the
// scalar's limbs, 8 bits), absent when the digit is 0 or the entry is not
// valid, and the core mixed-adds the rows window by window from infinity.
// The table is 32 x 256 points (512 KiB for G1, 1 MiB for G2) and stays
// resident in the 50 MB L2, so nothing is materialised. Near the top
// window the partial sum can wrap mod r, so P == Q and P == -Q occur; the
// core's unified mixed add doubles and returns infinity in-kernel, and
// nothing is flagged or repaired.
//
// The fold is the plain version `curve.py` `fixed_base_plain` step for
// step (same formula, same order), so the limbs agree exactly.
//
// What bounds it: the multiply-add rate of the SMs (up to 32 mixed adds of
// 11 Fq products per G1 scalar, of 11 Fq2 products per G2 scalar); the
// bytes are 32 B of scalar in and 96 B (G1) / 192 B (G2) of point out per
// scalar. G1 runs a thread a scalar. G2 runs a thread a scalar (setup's
// chunks of up to 2^20 scalars fill the card many times over) or, when
// that would leave the card underfilled, three threads a scalar
// (row_accum.cuh `g2_triples`: a launch that one wave of triples carries,
// such as setup's few-point launches). A warp whose scalars all have a zero
// digit in a window skips that window by vote.
#include "row_accum.cuh"

namespace zk {

constexpr int FB_WINDOW = 8;
constexpr int FB_ROW = 1 << FB_WINDOW;

template <class F>
__global__ void __launch_bounds__(ROW_THREADS)
    fixed_base_kernel(const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
                      const uint8_t* __restrict__ tvalid, const uint32_t* __restrict__ scalars,
                      int nwin, long long n, uint32_t* ox, uint32_t* oy, uint32_t* oz) {
  const RowLane<F> me;
  const bool live = me.active && me.lane < n;
  const uint32_t* s = scalars + (live ? me.lane : 0) * 8;
  const Jac<F> acc = row_accum<F>(tx, ty, live ? nwin : 0, me.active, [&](int j) -> long long {
    const int bit = j * FB_WINDOW;
    const uint32_t d = (s[bit >> 5] >> (bit & 31)) & (FB_ROW - 1);
    const long long row = (long long)j * FB_ROW + d;
    return d != 0 && tvalid[row] ? row : -1;
  });
  if (live) jac_store<F>(ox, oy, oz, me.lane, acc);
}

template <class F>
int launch_fixed_base(const void* tx, const void* ty, const void* tvalid, const void* scalars,
                      int nwin, long long n, void* ox, void* oy, void* oz, cudaStream_t s) {
  const long long blocks = row_blocks<F>(n);
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  fixed_base_kernel<F><<<(unsigned)blocks, ROW_THREADS, 0, s>>>(
      static_cast<const uint32_t*>(tx), static_cast<const uint32_t*>(ty),
      static_cast<const uint8_t*>(tvalid), static_cast<const uint32_t*>(scalars), nwin, n,
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz));
  return (int)cudaGetLastError();
}

}  // namespace zk

// group: 1 = G1, 2 = G2. Table [>= nwin, 256] affine points with a valid
// mask; scalars [n, 8] plain u32 limbs; out [n] Jacobian points.
extern "C" int zk_fixed_base(int group, const void* tx, const void* ty, const void* tvalid,
                             const void* scalars, int nwin, long long n, void* ox, void* oy,
                             void* oz, void* stream) {
  if (n <= 0) return 0;
  if (nwin <= 0 || nwin > 32) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (group == 1)
    return zk::launch_fixed_base<zk::G1Field>(tx, ty, tvalid, scalars, nwin, n, ox, oy, oz, s);
  if (group != 2) return (int)cudaErrorInvalidValue;
  if (zk::g2_triples(n, zk::fixed_base_kernel<zk::G2Field>, zk::fixed_base_kernel<zk::G2Tri>))
    return zk::launch_fixed_base<zk::G2Tri>(tx, ty, tvalid, scalars, nwin, n, ox, oy, oz, s);
  return zk::launch_fixed_base<zk::G2Field>(tx, ty, tvalid, scalars, nwin, n, ox, oy, oz, s);
}
