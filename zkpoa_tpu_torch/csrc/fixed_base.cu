// Fixed-base scalar multiplication k_i * base for BN254 G1 and G2 (setup).
//
// Replaces kernel B8 of the TPU package: zkpoa_tpu/ops/curve_jax.py:369
// `fixed_base_mul_batch_pallas` -> `_fb_fold_pallas` :407 ->
// msm_pallas.py `_accum_group` :990 (`pallas_call` :1016). The TPU version
// gathered a [nwin, K, N] stream of table points into device memory, ran
// it through the bucket kernel with per-lane exception flags, and fell
// back to an XLA fold when any lane was flagged. Here one thread owns one
// scalar: its Jacobian accumulator stays in registers while it walks the
// ceil(n_bits / 8) windows, reads digit j from the scalar's limbs, skips a
// zero digit and mixed-adds the affine table[j][digit] straight from
// device memory. The table is 32 x 256 points (512 KiB for G1, 1 MiB for
// G2) and stays resident in the 50 MB L2, so nothing is materialised.
// Near the top window the partial sum can wrap mod r, so P == Q and
// P == -Q occur; curve.cuh's unified mixed add doubles and returns
// infinity in-kernel, and nothing is flagged or repaired.
//
// The fold is the plain version `curve.py` `fixed_base_plain` step for
// step (same formula, same order), so the limbs agree exactly.
//
// What bounds it: the multiply-add rate of the SMs (up to 32 mixed adds of
// 11 Fq products per G1 scalar, 30 Fq products per G2 mixed add); the
// bytes are 32 B of scalar in and 96 B (G1) / 192 B (G2) of point out per
// thread. Simple correct version; speed is later work.
#include "curve.cuh"

namespace zk {

constexpr int FB_WINDOW = 8;
constexpr int FB_ROW = 1 << FB_WINDOW;

template <class G>
__global__ void fixed_base_kernel(const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
                                  const uint8_t* __restrict__ tvalid,
                                  const uint32_t* __restrict__ scalars, int nwin, long long n,
                                  uint32_t* ox, uint32_t* oy, uint32_t* oz) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* s = scalars + i * 8;
  Jac<G> acc = jac_inf<G>();
  for (int j = 0; j < nwin; ++j) {
    const int bit = j * FB_WINDOW;
    const uint32_t d = (s[bit >> 5] >> (bit & 31)) & (FB_ROW - 1);
    if (d == 0) continue;
    const long long row = (long long)j * FB_ROW + d;
    if (!tvalid[row]) continue;
    acc = jac_add_affine<G>(acc, G::load(tx + row * G::WORDS), G::load(ty + row * G::WORDS));
  }
  jac_store<G>(ox, oy, oz, i, acc);
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
  const int t = 128;
  const unsigned blocks = (unsigned)((n + t - 1) / t);
  auto px = static_cast<const uint32_t*>(tx);
  auto py = static_cast<const uint32_t*>(ty);
  auto pv = static_cast<const uint8_t*>(tvalid);
  auto ps = static_cast<const uint32_t*>(scalars);
  auto qx = static_cast<uint32_t*>(ox);
  auto qy = static_cast<uint32_t*>(oy);
  auto qz = static_cast<uint32_t*>(oz);
  if (group == 1)
    zk::fixed_base_kernel<zk::G1Field><<<blocks, t, 0, s>>>(px, py, pv, ps, nwin, n, qx, qy, qz);
  else if (group == 2)
    zk::fixed_base_kernel<zk::G2Field><<<blocks, t, 0, s>>>(px, py, pv, ps, nwin, n, qx, qy, qz);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
