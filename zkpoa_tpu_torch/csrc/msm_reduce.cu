// Weighted bucket reduction for BN254 G1 and G2 MSMs: per window,
// T_w = sum_j (j + 1) * B_j over its nb buckets, for every window of every
// MSM of one window size in one launch.
//
// Replaces kernel B7 of the TPU package: zkpoa_tpu/ops/msm_pallas.py:666
// (`_weighted_reduce_pallas` :649 -> `_reduce_scan_kernel` :578, step table
// `_reduce_step_table` :529), which ran two masked-roll suffix scans over
// the whole [K, nb] window held in VMEM, after folding the top window's
// alias blocks; the TPU package reduced G2 in XLA (`_reduce_packed_g2`
// :1594), here the same kernel serves both groups. There are no alias
// blocks to fold, because the port's buckets are plain signed windows.
//
// What bounds it: not its operations (about 2 nb full adds a window), but
// the depth of the chain of dependent full adds times one add's latency.
// The design cuts that depth: one block of T threads per window (`ops/msm.py`
// `msm_many` hands it the windows of all MSMs with the same c, 4 x 24 = 96
// for a prove's G1 MSMs), thread t taking the L = nb / T buckets
// [tL, tL + L):
//   1. top bucket first, run += B_j and tot += run: run_t = sum B_j and
//      tot_t = sum (j - tL + 1) B_j (2L adds);
//   2. T_w = sum_t tot_t + L sum_{t>=1} S_t, S_t = sum_{u>=t} run_u: a
//      Hillis-Steele suffix scan in shared memory, S_t += S_{t+d} for
//      d = 1, 2, ..., T/2 (log2 T adds);
//   3. v_t = tot_t + L S_t (v_0 = tot_0) by log2 L doublings and one add;
//   4. a halving tree v_t += v_{t+h}, h = T/2, ..., 1 (log2 T adds).
// The chain is 2L + 2 log2 T + 1 adds and log2 L doublings: 25 adds and 2
// doublings at nb = 1024, T = 256, against about 158 adds for the earlier
// two-pass version. A G2 point is 192 bytes, so the block's array is
// 48 KB at T = 256 (opted in above the default where it exceeds it).
// Horner across windows stays outside (point kernels B3/B4).
#include "curve.cuh"

namespace zk {

constexpr int REDUCE_MAX_THREADS = 256;

template <class G>
__global__ void __launch_bounds__(REDUCE_MAX_THREADS)
    msm_reduce_kernel(const uint32_t* __restrict__ bx, const uint32_t* __restrict__ by,
                      const uint32_t* __restrict__ bz, int nb, int log_seg, uint32_t* ox,
                      uint32_t* oy, uint32_t* oz) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const long long w = blockIdx.x;
  const int seg = 1 << log_seg;
  uint32_t* px = smem;
  uint32_t* py = smem + T * G::WORDS;
  uint32_t* pz = smem + 2 * T * G::WORDS;

  Jac<G> run = jac_inf<G>();
  Jac<G> tot = jac_inf<G>();
  const long long first = w * nb + (long long)t * seg;
  for (int j = seg - 1; j >= 0; --j) {
    run = jac_add<G>(run, jac_load<G>(bx, by, bz, first + j));
    tot = jac_add<G>(tot, run);
  }
  Jac<G> s = run;
  for (int d = 1; d < T; d <<= 1) {
    jac_store<G>(px, py, pz, t, s);
    __syncthreads();
    Jac<G> o;
    if (t + d < T) o = jac_load<G>(px, py, pz, t + d);
    __syncthreads();
    if (t + d < T) s = jac_add<G>(s, o);
  }
  Jac<G> v = tot;
  if (t > 0) {
    for (int k = 0; k < log_seg; ++k) s = jac_double<G>(s);
    v = jac_add<G>(tot, s);
  }
  for (int h = T / 2; h >= 1; h >>= 1) {
    if (t >= h && t < 2 * h) jac_store<G>(px, py, pz, t, v);
    __syncthreads();
    if (t < h) v = jac_add<G>(v, jac_load<G>(px, py, pz, t + h));
  }
  if (t == 0) jac_store<G>(ox, oy, oz, w, v);
}

template <class G>
int launch_reduce(const void* bx, const void* by, const void* bz, int nw, int nb, int threads,
                  void* ox, void* oy, void* oz, cudaStream_t s) {
  int log_seg = 0;
  while ((threads << log_seg) < nb) ++log_seg;
  const size_t smem = (size_t)3 * threads * G::WORDS * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(msm_reduce_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  msm_reduce_kernel<G><<<(unsigned)nw, threads, smem, s>>>(
      static_cast<const uint32_t*>(bx), static_cast<const uint32_t*>(by),
      static_cast<const uint32_t*>(bz), nb, log_seg, static_cast<uint32_t*>(ox),
      static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz));
  return (int)cudaGetLastError();
}

}  // namespace zk

// group: 1 = G1, 2 = G2. Buckets [nw * nb] (the windows of one or more
// MSMs back to back); threads per window a power of two <= 256 dividing nb;
// output [nw] window totals.
extern "C" int zk_msm_reduce(int group, const void* bx, const void* by, const void* bz, int nw,
                             int nb, int threads, void* ox, void* oy, void* oz, void* stream) {
  if (nw <= 0) return 0;
  if (threads <= 0 || threads > zk::REDUCE_MAX_THREADS || (threads & (threads - 1)) != 0 ||
      nb % threads != 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (group == 1) return zk::launch_reduce<zk::G1Field>(bx, by, bz, nw, nb, threads, ox, oy, oz, s);
  if (group == 2) return zk::launch_reduce<zk::G2Field>(bx, by, bz, nw, nb, threads, ox, oy, oz, s);
  return (int)cudaErrorInvalidValue;
}
