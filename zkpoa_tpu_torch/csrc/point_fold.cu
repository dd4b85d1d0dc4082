// Segmented fold of Jacobian lane arrays for BN254 G1 and G2: each block
// sums its chunk of `chunk` consecutive lanes to one point by a halving
// tree of unified adds, so n_out * chunk lanes become n_out sums in one
// launch. The heavy-value sums (ops/msm.py `tree_sum_many`) fold the lane
// arrays of every (table, heavy value) segment of a group with at most two
// launches: chunks of each segment's W lanes, then the chunk sums of each
// segment.
//
// Replaces, for the heavy-value sums, the point kernel B3 of the TPU package
// (zkpoa_tpu/ops/pallas_field.py:321 `_point_call` -> `jac_add_tpu` :362) as
// the JAX package folds its lanes with it (zkpoa_tpu/ops/msm_pallas.py:1928
// `_lane_fold`, one masked-roll halving step per add launch, :1947
// `_tree_sum_subset`).
//
// What bounds it: the adds' int32 operations at full width (16 Fq products
// a G1 add), but on the main path most lanes of the narrow segments are at
// infinity and an add with infinity returns at once; the chain is log2 W
// adds. Design: T = chunk / 2 threads a block; thread t adds lanes t and
// t + T as it loads them, then halving levels h = T/2, ..., 1 add v_t and
// v_{t+h} through shared memory, one barrier a level. The add order is
// that of the plain version (`fold_plain`): halving within each chunk,
// lower lane first. A G2 point is 192 bytes, so its chunks are half as
// wide (ops/msm.py FOLD_CHUNK) and the block's array stays at 24 KB.
#include "curve.cuh"

namespace zk {

constexpr int FOLD_MAX_THREADS = 256;

template <class G>
__global__ void __launch_bounds__(FOLD_MAX_THREADS)
    point_fold_kernel(const uint32_t* __restrict__ ix, const uint32_t* __restrict__ iy,
                      const uint32_t* __restrict__ iz, uint32_t* ox, uint32_t* oy,
                      uint32_t* oz) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const long long first = (long long)blockIdx.x * 2 * T;
  uint32_t* px = smem;
  uint32_t* py = smem + T * G::WORDS;
  uint32_t* pz = smem + 2 * T * G::WORDS;
  Jac<G> v = jac_add<G>(jac_load<G>(ix, iy, iz, first + t), jac_load<G>(ix, iy, iz, first + t + T));
  for (int h = T / 2; h >= 1; h >>= 1) {
    if (t >= h && t < 2 * h) jac_store<G>(px, py, pz, t, v);
    __syncthreads();
    if (t < h) v = jac_add<G>(v, jac_load<G>(px, py, pz, t + h));
  }
  if (t == 0) jac_store<G>(ox, oy, oz, blockIdx.x, v);
}

template <class G>
int launch_fold(const void* ix, const void* iy, const void* iz, long long n_out, int chunk,
                void* ox, void* oy, void* oz, cudaStream_t s) {
  const int threads = chunk / 2;
  const size_t smem = (size_t)3 * threads * G::WORDS * sizeof(uint32_t);
  point_fold_kernel<G><<<(unsigned)n_out, threads, smem, s>>>(
      static_cast<const uint32_t*>(ix), static_cast<const uint32_t*>(iy),
      static_cast<const uint32_t*>(iz), static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy),
      static_cast<uint32_t*>(oz));
  return (int)cudaGetLastError();
}

}  // namespace zk

// group: 1 = G1, 2 = G2. Lanes [n_out * chunk] in, sums [n_out] out; chunk
// a power of two from 2 to 2 * FOLD_MAX_THREADS.
extern "C" int zk_point_fold(int group, const void* ix, const void* iy, const void* iz,
                             long long n_out, int chunk, void* ox, void* oy, void* oz,
                             void* stream) {
  if (n_out <= 0) return 0;
  if (chunk < 2 || chunk > 2 * zk::FOLD_MAX_THREADS || (chunk & (chunk - 1)) != 0 ||
      n_out >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (group == 1) return zk::launch_fold<zk::G1Field>(ix, iy, iz, n_out, chunk, ox, oy, oz, s);
  if (group == 2) return zk::launch_fold<zk::G2Field>(ix, iy, iz, n_out, chunk, ox, oy, oz, s);
  return (int)cudaErrorInvalidValue;
}
