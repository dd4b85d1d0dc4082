// Pippenger bucket accumulation for BN254 G1 and G2, as balanced bucket
// pieces.
//
// Replaces kernels B5 and B6 of the TPU package:
//   B5 zkpoa_tpu/ops/msm_pallas.py:1309 `_accum_group_step_pk` ->
//      `_accum_group_kernel_xy` :1208 -> `_k_jac_madd_noexcept` :265 (G1),
//   B6 msm_pallas.py:1549 `_accum_group_step_pk2` -> `_k_jac_madd_noexcept_fp2`
//      :1396 (G2),
// and computes what the sibling sites B5a-B5d (:1251, :1016, :885, :390)
// compute. The TPU ran lockstep rounds over a materialized [rounds, lanes]
// stream of pre-gathered points, with top-window alias blocks to even out
// the rounds, and flagged P == Q lanes for a host repair. Here P == Q is an
// in-kernel doubling and P == -Q infinity, so nothing is flagged or
// repaired.
//
// What bounds it: the integer multiply-add work of the mixed adds (11
// Montgomery products each, 256 int32 operations a product), if enough
// warps are resident to hide the latency of each thread's dependent
// multiply-add chains and of its random 64-byte (G1) / 128-byte (G2) point
// reads. One thread per (window, bucket) would give only nw * nb threads
// (24,576 at c = 11: six warps an SM), and the launch would last as long
// as the longest bucket's run. The design:
//   * pieces: the plan cuts every bucket's run into pieces of at most K
//     entries (`ops/msm.py` `piece_table`); msm_piece_kernel gives each
//     piece one thread, which sums its entries with mixed adds from
//     infinity. About nw (N / K + nb) threads, all with the same work, and
//     no thread waits on the longest bucket;
//   * coalesced indices: a warp's 32 pieces stage their entries of the
//     sorted index list in shared memory, lane i loading entry i of a
//     piece (K consecutive words), before any add;
//   * next point in flight: while entry k is added, entry k + 1's x and y
//     rows are already on their way into a per-thread two-slot ring in
//     shared memory (cp.async, 16 bytes a copy, one commit group per
//     entry), with its valid byte in a register;
//   * combine: msm_combine_kernel adds each bucket's piece sums with full
//     adds (16 products; in G1 the next sum is loaded before the current
//     add), in levels (`ops/msm.py` `combine_levels`): while a bucket has
//     more than F = 8 sums, one thread adds each run of F of them in order;
//     the last level gives each (window, bucket) one thread for its at
//     most F sums. So a fan-in-F tree, not one chain per bucket: a chain
//     of F per level, 8 + 7 = 15 adds at 2^20 points, c = 11, K = 32
//     (52 pieces in the longest bucket), where a thread per bucket would
//     chain 52, and a bucket of thousands of entries (the witness MSMs'
//     small values) adds a level, not a chain of hundreds.
// Tensor cores are not used: no tensor-core path computes 256-bit modular
// products exactly at this size (the integer MMA takes 8-bit operands with
// 32-bit sums, so a 32 x 32-bit limb product would cost 16 MMA products
// plus carry handling outside the unit).
//
// order[w, k] holds a sign-encoded scalar index e: index e (add +P) when
// e < n, index e - n (add -P) otherwise. Table row = index - offset (the
// c-query covers only the private-wire suffix of the witness); rows out of
// range or marked invalid are skipped, so a piece of skipped rows and an
// empty bucket both come out as infinity.
#include "curve.cuh"

namespace zk {

constexpr int ACC_THREADS = 128;  // threads per block of msm_piece_kernel

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {  // all but the newest group done
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start fetching entry e's rows into slot (x at slot, y at slot + WORDS);
// returns whether the row is in range, and its valid byte via v.
template <class G>
__device__ __forceinline__ bool fetch_entry(int32_t e, long long n, long long offset,
                                            long long n_rows, const uint32_t* xs,
                                            const uint32_t* ys, const uint8_t* valid,
                                            uint32_t* slot, bool& neg, uint8_t& v) {
  neg = e >= n;
  const long long row = (neg ? e - n : e) - offset;
  if (row < 0 || row >= n_rows) return false;
  v = valid[row];
#pragma unroll
  for (int q = 0; q < G::WORDS; q += 4) {
    cp_async16(slot + q, xs + row * G::WORDS + q);
    cp_async16(slot + G::WORDS + q, ys + row * G::WORDS + q);
  }
  return true;
}

// Shared memory: per thread a two-slot ring of x|y rows (4 WORDS words),
// then per thread its piece's K entries.
template <class G>
__global__ void __launch_bounds__(ACC_THREADS)
    msm_piece_kernel(const uint32_t* __restrict__ xs, const uint32_t* __restrict__ ys,
                     const uint8_t* __restrict__ valid, long long offset, long long n_rows,
                     const int32_t* __restrict__ order, long long n,
                     const int32_t* __restrict__ piece_start, const int32_t* __restrict__ piece_end,
                     long long n_pieces, int K, uint32_t* sx, uint32_t* sy, uint32_t* sz) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem + threadIdx.x * 4 * G::WORDS;
  int32_t* entries = reinterpret_cast<int32_t*>(smem + ACC_THREADS * 4 * G::WORDS);
  const long long piece = (long long)blockIdx.x * ACC_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int32_t s0 = 0, len = 0;
  if (piece < n_pieces) {
    s0 = piece_start[piece];
    len = piece_end[piece] - s0;
    if (len < 0 || len > K) __trap();  // a table from another plan: refuse, never overrun
  }
  // stage the warp's entries: slot t is entry t % K of lane t / K's piece
  int32_t* warp_entries = entries + (threadIdx.x & ~31) * K;
  for (int t = lane; t < 32 * K; t += 32) {
    const int owner = t / K;
    const int j = t - owner * K;
    const int32_t os = __shfl_sync(0xffffffffu, s0, owner);
    const int32_t ol = __shfl_sync(0xffffffffu, len, owner);
    if (j < ol) warp_entries[t] = order[os + j];
  }
  __syncwarp();
  const int32_t* mine = warp_entries + lane * K;

  Jac<G> acc = jac_inf<G>();
  bool ok = false, neg = false;
  uint8_t v = 0;
  if (len > 0) ok = fetch_entry<G>(mine[0], n, offset, n_rows, xs, ys, valid, ring, neg, v);
  cp_async_commit();
  for (int k = 0; k < len; ++k) {
    bool ok_next = false, neg_next = false;
    uint8_t v_next = 0;
    if (k + 1 < len)
      ok_next = fetch_entry<G>(mine[k + 1], n, offset, n_rows, xs, ys, valid,
                               ring + ((k + 1) & 1) * 2 * G::WORDS, neg_next, v_next);
    cp_async_commit();
    cp_async_wait_prior();
    if (ok && v) {
      const uint32_t* slot = ring + (k & 1) * 2 * G::WORDS;
      typename G::T x = G::load(slot);
      typename G::T y = G::load(slot + G::WORDS);
      if (neg) y = G::neg(y);
      acc = jac_add_affine<G>(acc, x, y);
    }
    ok = ok_next;
    neg = neg_next;
    v = v_next;
  }
  if (piece < n_pieces) jac_store<G>(sx, sy, sz, piece, acc);
}

template <class G>
__global__ void msm_combine_kernel(const uint32_t* __restrict__ ix, const uint32_t* __restrict__ iy,
                                   const uint32_t* __restrict__ iz, long long n_in,
                                   const int32_t* __restrict__ group_start,
                                   const int32_t* __restrict__ group_end, long long n_groups,
                                   uint32_t* ox, uint32_t* oy, uint32_t* oz) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_groups) return;
  const int32_t p0 = group_start[g];
  const int32_t p1 = group_end[g];
  if (p0 < 0 || p1 < p0 || p1 > n_in) __trap();  // a table from another plan
  Jac<G> acc = jac_inf<G>();
  if constexpr (G::WORDS == 8) {  // G1: the next sum in registers during the add
    if (p0 < p1) {
      Jac<G> next = jac_load<G>(ix, iy, iz, p0);
      for (int32_t p = p0; p < p1; ++p) {
        const Jac<G> cur = next;
        if (p + 1 < p1) next = jac_load<G>(ix, iy, iz, p + 1);
        acc = jac_add<G>(acc, cur);
      }
    }
  } else {  // G2: a second 192-byte point across the out-of-line add spills
    for (int32_t p = p0; p < p1; ++p) acc = jac_add<G>(acc, jac_load<G>(ix, iy, iz, p));
  }
  jac_store<G>(ox, oy, oz, g, acc);
}

template <class G>
int launch_pieces(const void* xs, const void* ys, const void* valid, long long offset,
                  long long n_rows, const void* order, long long n, const void* piece_start,
                  const void* piece_end, long long n_pieces, int K, void* sx, void* sy, void* sz,
                  cudaStream_t s) {
  const size_t smem = (size_t)ACC_THREADS * (4 * G::WORDS + K) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(msm_piece_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n_pieces + ACC_THREADS - 1) / ACC_THREADS);
  msm_piece_kernel<G><<<blocks, ACC_THREADS, smem, s>>>(
      static_cast<const uint32_t*>(xs), static_cast<const uint32_t*>(ys),
      static_cast<const uint8_t*>(valid), offset, n_rows, static_cast<const int32_t*>(order), n,
      static_cast<const int32_t*>(piece_start), static_cast<const int32_t*>(piece_end), n_pieces,
      K, static_cast<uint32_t*>(sx), static_cast<uint32_t*>(sy), static_cast<uint32_t*>(sz));
  return (int)cudaGetLastError();
}

template <class G>
int launch_combine(const void* ix, const void* iy, const void* iz, long long n_in,
                   const void* group_start, const void* group_end, long long n_groups, void* ox,
                   void* oy, void* oz, cudaStream_t s) {
  const int t = 128;
  msm_combine_kernel<G><<<(unsigned)((n_groups + t - 1) / t), t, 0, s>>>(
      static_cast<const uint32_t*>(ix), static_cast<const uint32_t*>(iy),
      static_cast<const uint32_t*>(iz), n_in, static_cast<const int32_t*>(group_start),
      static_cast<const int32_t*>(group_end), n_groups, static_cast<uint32_t*>(ox),
      static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz));
  return (int)cudaGetLastError();
}

}  // namespace zk

// group: 1 = G1, 2 = G2. Piece sums s* [n_pieces], Jacobian; pieces hold at
// most K entries.
extern "C" int zk_msm_accum(int group, const void* xs, const void* ys, const void* valid,
                            long long offset, long long n_rows, const void* order, long long n,
                            const void* piece_start, const void* piece_end, long long n_pieces,
                            int K, void* sx, void* sy, void* sz, void* stream) {
  if (K <= 0 || n_pieces < 0) return (int)cudaErrorInvalidValue;
  if (n_pieces == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (group == 1)
    return zk::launch_pieces<zk::G1Field>(xs, ys, valid, offset, n_rows, order, n, piece_start,
                                          piece_end, n_pieces, K, sx, sy, sz, s);
  if (group == 2)
    return zk::launch_pieces<zk::G2Field>(xs, ys, valid, offset, n_rows, order, n, piece_start,
                                          piece_end, n_pieces, K, sx, sy, sz, s);
  return (int)cudaErrorInvalidValue;
}

// One combine level: out[g] = in[group_start[g]] + ... + in[group_end[g] - 1],
// Jacobian, in order; out [n_groups], in [n_in].
extern "C" int zk_msm_combine(int group, const void* ix, const void* iy, const void* iz,
                              long long n_in, const void* group_start, const void* group_end,
                              long long n_groups, void* ox, void* oy, void* oz, void* stream) {
  if (n_groups <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (group == 1)
    return zk::launch_combine<zk::G1Field>(ix, iy, iz, n_in, group_start, group_end, n_groups, ox,
                                           oy, oz, s);
  if (group == 2)
    return zk::launch_combine<zk::G2Field>(ix, iy, iz, n_in, group_start, group_end, n_groups, ox,
                                           oy, oz, s);
  return (int)cudaErrorInvalidValue;
}
