// Pippenger bucket accumulation for BN254 G1 and G2.
//
// Replaces kernels B5 and B6 of the TPU package:
//   B5 zkpoa_tpu/ops/msm_pallas.py:1309 `_accum_group_step_pk` ->
//      `_accum_group_kernel_xy` :1208 -> `_k_jac_madd_noexcept` :265 (G1),
//   B6 msm_pallas.py:1549 `_accum_group_step_pk2` -> `_k_jac_madd_noexcept_fp2`
//      :1396 (G2),
// and computes what the sibling sites B5a-B5d (:1251, :1016, :885, :390)
// compute. The TPU ran lockstep rounds over a materialized [rounds, lanes]
// stream of pre-gathered points, with top-window alias blocks to even out
// the rounds, and flagged P == Q lanes for a host repair. Here each
// (window, bucket) lane is one thread that walks its own slice
// [starts[b], starts[b+1]) of the window's sorted index list and reads its
// points by index. A lane with fewer points simply stops early, so there
// is nothing to balance; P == Q becomes an in-kernel doubling and P == -Q
// infinity, so nothing is flagged or repaired.
//
// order[w, k] holds a sign-encoded scalar index e: index e (add +P) when
// e < n, index e - n (add -P) otherwise. Table row = index - offset (the
// c-query covers only the private-wire suffix of the witness); rows out of
// range or marked invalid are skipped.
//
// What bounds it: per lane, a chain of dependent mixed adds (latency of
// the multiply-add chain at low occupancy: there are only nw * nb lanes)
// and the latency of the random 64-byte (G1) / 128-byte (G2) point
// gathers. Simple correct version; speed is later work.
#include "curve.cuh"

namespace zk {

template <class G>
__global__ void msm_accum_kernel(const uint32_t* __restrict__ xs, const uint32_t* __restrict__ ys,
                                 const uint8_t* __restrict__ valid, long long offset,
                                 long long n_rows, const int32_t* __restrict__ order,
                                 const int32_t* __restrict__ starts, int nw, int nb, long long n,
                                 uint32_t* ox, uint32_t* oy, uint32_t* oz) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (long long)nw * nb) return;
  const int w = (int)(lane / nb);
  const int b = (int)(lane % nb);
  const int32_t* ord = order + (long long)w * n;
  const int32_t s0 = starts[(long long)w * (nb + 1) + b];
  const int32_t s1 = starts[(long long)w * (nb + 1) + b + 1];
  Jac<G> acc = jac_inf<G>();
  for (int32_t k = s0; k < s1; ++k) {
    const long long e = ord[k];
    const bool neg = e >= n;
    const long long row = (neg ? e - n : e) - offset;
    if (row < 0 || row >= n_rows) continue;
    if (valid != nullptr && !valid[row]) continue;
    typename G::T x = G::load(xs + row * G::WORDS);
    typename G::T y = G::load(ys + row * G::WORDS);
    if (neg) y = G::neg(y);
    acc = jac_add_affine<G>(acc, x, y);
  }
  jac_store<G>(ox, oy, oz, lane, acc);
}

}  // namespace zk

// group: 1 = G1, 2 = G2. Output buckets [nw * nb] Jacobian points.
extern "C" int zk_msm_accum(int group, const void* xs, const void* ys, const void* valid,
                            long long offset, long long n_rows, const void* order,
                            const void* starts, int nw, int nb, long long n, void* ox, void* oy,
                            void* oz, void* stream) {
  const long long lanes = (long long)nw * nb;
  if (lanes <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int t = 64;
  const unsigned blocks = (unsigned)((lanes + t - 1) / t);
  auto px = static_cast<const uint32_t*>(xs);
  auto py = static_cast<const uint32_t*>(ys);
  auto pv = static_cast<const uint8_t*>(valid);
  auto po = static_cast<const int32_t*>(order);
  auto ps = static_cast<const int32_t*>(starts);
  auto qx = static_cast<uint32_t*>(ox);
  auto qy = static_cast<uint32_t*>(oy);
  auto qz = static_cast<uint32_t*>(oz);
  if (group == 1)
    zk::msm_accum_kernel<zk::G1Field><<<blocks, t, 0, s>>>(px, py, pv, offset, n_rows, po, ps,
                                                           nw, nb, n, qx, qy, qz);
  else if (group == 2)
    zk::msm_accum_kernel<zk::G2Field><<<blocks, t, 0, s>>>(px, py, pv, offset, n_rows, po, ps,
                                                           nw, nb, n, qx, qy, qz);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
