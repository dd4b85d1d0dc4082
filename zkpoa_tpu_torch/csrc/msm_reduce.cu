// Weighted bucket reduction for BN254 G1 and G2 MSMs: per window,
// T_w = sum_j (j + 1) * B_j over its nb buckets.
//
// Replaces kernel B7 of the TPU package: zkpoa_tpu/ops/msm_pallas.py:666
// (`_weighted_reduce_pallas` :649 -> `_reduce_scan_kernel` :578, step table
// `_reduce_step_table` :529), which ran two masked-roll suffix scans over
// the whole [K, nb] window held in VMEM, after folding the top window's
// alias blocks; the TPU package reduced G2 in XLA (`_reduce_packed_g2`
// :1594), here the same kernel serves both groups. There are no alias
// blocks to fold, because the port's buckets are plain signed windows.
//
// Two passes of running sums, with the buckets cut into S segments of
// L = nb / S:
//   pass 1, one thread per (window, segment): from the top bucket of the
//     segment down, run += B_j and tot += run, giving
//     tot_s = sum_{j in s} (j - sL + 1) B_j and run_s = sum_{j in s} B_j;
//   pass 2, one thread per window: T = sum_s tot_s + L * sum_s s * run_s,
//     the second sum again by running sums over segments and the factor L
//     (a power of two) by log2(L) doublings.
// Horner across windows stays outside (point kernels B3/B4).
//
// What bounds it: the chain of 2L + 3S dependent full adds per window;
// with L ~ S ~ sqrt(nb) that is ~100 adds at nb = 1024 instead of 2 nb.
// Simple correct version; speed is later work.
#include "curve.cuh"

namespace zk {

template <class G>
__global__ void reduce_segments_kernel(const uint32_t* bx, const uint32_t* by, const uint32_t* bz,
                                       int nw, int nb, int seg_len, uint32_t* tx, uint32_t* ty,
                                       uint32_t* tz, uint32_t* sx, uint32_t* sy, uint32_t* sz) {
  const int n_seg = nb / seg_len;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nw * n_seg) return;
  const int w = t / n_seg;
  const int s = t % n_seg;
  Jac<G> run = jac_inf<G>();
  Jac<G> tot = jac_inf<G>();
  for (int j = seg_len - 1; j >= 0; --j) {
    const long long lane = (long long)w * nb + (long long)s * seg_len + j;
    run = jac_add<G>(run, jac_load<G>(bx, by, bz, lane));
    tot = jac_add<G>(tot, run);
  }
  jac_store<G>(tx, ty, tz, t, tot);
  jac_store<G>(sx, sy, sz, t, run);
}

template <class G>
__global__ void reduce_windows_kernel(const uint32_t* tx, const uint32_t* ty, const uint32_t* tz,
                                      const uint32_t* sx, const uint32_t* sy, const uint32_t* sz,
                                      int nw, int n_seg, int log_seg_len, uint32_t* ox,
                                      uint32_t* oy, uint32_t* oz) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nw) return;
  Jac<G> acc = jac_inf<G>();
  for (int s = 0; s < n_seg; ++s) acc = jac_add<G>(acc, jac_load<G>(tx, ty, tz, (long long)w * n_seg + s));
  Jac<G> run = jac_inf<G>();
  Jac<G> wsum = jac_inf<G>();
  for (int s = n_seg - 1; s >= 1; --s) {
    run = jac_add<G>(run, jac_load<G>(sx, sy, sz, (long long)w * n_seg + s));
    wsum = jac_add<G>(wsum, run);
  }
  for (int k = 0; k < log_seg_len; ++k) wsum = jac_double<G>(wsum);
  jac_store<G>(ox, oy, oz, w, jac_add<G>(acc, wsum));
}

}  // namespace zk

// group: 1 = G1, 2 = G2. Buckets [nw * nb]; scratch t*, s* [nw * nb / seg_len];
// output [nw] window totals.
extern "C" int zk_msm_reduce(int group, const void* bx, const void* by, const void* bz, int nw,
                             int nb, int seg_len, void* tx, void* ty, void* tz, void* sx,
                             void* sy, void* sz, void* ox, void* oy, void* oz, void* stream) {
  if (nw <= 0) return 0;
  if (seg_len <= 0 || nb % seg_len != 0 || (seg_len & (seg_len - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int n_seg = nb / seg_len;
  int log_len = 0;
  while ((1 << log_len) < seg_len) ++log_len;
  const int t = 32;
  const unsigned b1 = (unsigned)((nw * n_seg + t - 1) / t);
  const unsigned b2 = (unsigned)((nw + t - 1) / t);
#define U(p) static_cast<uint32_t*>(p)
#define CU(p) static_cast<const uint32_t*>(p)
  if (group == 1) {
    zk::reduce_segments_kernel<zk::G1Field><<<b1, t, 0, s>>>(CU(bx), CU(by), CU(bz), nw, nb,
                                                             seg_len, U(tx), U(ty), U(tz), U(sx),
                                                             U(sy), U(sz));
    zk::reduce_windows_kernel<zk::G1Field><<<b2, t, 0, s>>>(CU(tx), CU(ty), CU(tz), CU(sx),
                                                            CU(sy), CU(sz), nw, n_seg, log_len,
                                                            U(ox), U(oy), U(oz));
  } else if (group == 2) {
    zk::reduce_segments_kernel<zk::G2Field><<<b1, t, 0, s>>>(CU(bx), CU(by), CU(bz), nw, nb,
                                                             seg_len, U(tx), U(ty), U(tz), U(sx),
                                                             U(sy), U(sz));
    zk::reduce_windows_kernel<zk::G2Field><<<b2, t, 0, s>>>(CU(tx), CU(ty), CU(tz), CU(sx),
                                                            CU(sy), CU(sz), nw, n_seg, log_len,
                                                            U(ox), U(oy), U(oz));
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef U
#undef CU
  return (int)cudaGetLastError();
}
