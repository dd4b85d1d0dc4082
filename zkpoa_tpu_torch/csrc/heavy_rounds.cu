// The heavy-value rounds of the MSM for BN254 G1 and G2, on the
// row-accumulation core (row_accum.cuh): every (table, heavy value) segment
// of a group in one launch.
//
// Replaces, for the heavy-value sums, the point kernel B2 of the TPU
// package (zkpoa_tpu/ops/pallas_field.py:321 `_point_call` ->
// `jac_add_affine_tpu` :333 -> `_k_jac_add_affine` :170), as the JAX
// package sums a heavy value's points with it in lockstep rounds
// (zkpoa_tpu/ops/msm_pallas.py:1947 `_tree_sum_subset`). The port ran the
// same rounds as one mixed-add launch per round (up to 9 a group), each
// wrapped in a gather of padded rows and a re-concatenation of the whole
// lane array (ops/msm.py `tree_sum_many` before this kernel).
//
// Segment s has W lanes (W a power of two) and an index run idx_s of
// count_s scalar indices; round r of the old schedule added entry r W + l
// to lane l. Here lane l of segment s walks its rows idx_s[l],
// idx_s[W + l], idx_s[2 W + l], ... in that order (row = index - off_s;
// absent when out of the table's range or not valid) and writes its sum
// once, so the adds and their order are those of the rounds and the limbs
// do not change. The fold (point_fold.cu) then sums each segment's lanes.
//
// What bounds it: the mixed adds' multiply-adds (11 Fq products a G1 add,
// 11 Fq2 products a G2 add) for the entries present, and
// the bytes: 8 B of index and a 64 B (G1) / 128 B (G2) row for each entry,
// S W Jacobian lanes written. Lanes of the narrow segments have no entries
// and vote their warps out of every step at once. The work sits in the
// widest segment's W lanes (up to 9 adds each in a layer-one prove), so G2
// runs three threads a lane (row_accum.cuh, G2Tri), G1 a thread a lane.
//
// The segments and their tables reach the kernel as a parameter struct
// (at most ROUNDS_MAX_SEGS segments over ROUNDS_MAX_TABLES tables a
// launch), so nothing is copied to the device before the launch.
#include "row_accum.cuh"

namespace zk {

constexpr int ROUNDS_MAX_TABLES = 8;
constexpr int ROUNDS_MAX_SEGS = 64;

struct RoundsArgs {
  const uint32_t* xs[ROUNDS_MAX_TABLES];
  const uint32_t* ys[ROUNDS_MAX_TABLES];
  const uint8_t* valid[ROUNDS_MAX_TABLES];
  long long n_rows[ROUNDS_MAX_TABLES];
  const long long* idx[ROUNDS_MAX_SEGS];
  long long off[ROUNDS_MAX_SEGS];
  int count[ROUNDS_MAX_SEGS];
  int table[ROUNDS_MAX_SEGS];
};

template <class F>
__global__ void __launch_bounds__(ROW_THREADS)
    heavy_rounds_kernel(const __grid_constant__ RoundsArgs a, int n_seg, int log_w, uint32_t* ox,
                        uint32_t* oy, uint32_t* oz) {
  const RowLane<F> me;
  const bool live = me.active && me.lane < ((long long)n_seg << log_w);
  const int s = live ? (int)(me.lane >> log_w) : 0;
  const long long l = me.lane & ((1ll << log_w) - 1);
  const int count = live ? a.count[s] : 0;
  const int steps = l < count ? (int)(((count - 1 - l) >> log_w) + 1) : 0;
  const int t = a.table[s];
  const long long* idx = a.idx[s];
  const long long off = a.off[s];
  const long long n_rows = a.n_rows[t];
  const uint8_t* valid = a.valid[t];
  const Jac<F> acc = row_accum<F>(a.xs[t], a.ys[t], steps, me.active, [&](int k) -> long long {
    const long long row = idx[((long long)k << log_w) + l] - off;
    return row >= 0 && row < n_rows && valid[row] ? row : -1;
  });
  if (live) jac_store<F>(ox, oy, oz, me.lane, acc);
}

template <class F>
int launch_rounds(const RoundsArgs& a, int n_seg, int log_w, void* ox, void* oy, void* oz,
                  cudaStream_t s) {
  const long long blocks = row_blocks<F>((long long)n_seg << log_w);
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  heavy_rounds_kernel<F><<<(unsigned)blocks, ROW_THREADS, 0, s>>>(
      a, n_seg, log_w, static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy),
      static_cast<uint32_t*>(oz));
  return (int)cudaGetLastError();
}

}  // namespace zk

// group: 1 = G1, 2 = G2. tables: host array [n_tables][4] of (xs, ys,
// valid, n_rows), affine coordinates [n_rows, WORDS] and a bool mask;
// segs: host array [n_seg][4] of (idx, count, table, off), idx a device
// int64 run of count scalar indices; lanes [n_seg << log_w] out, segment
// by segment.
extern "C" int zk_heavy_rounds(int group, int n_tables, const long long* tables, int n_seg,
                               const long long* segs, int log_w, void* ox, void* oy, void* oz,
                               void* stream) {
  if (n_seg <= 0) return 0;
  if (n_tables <= 0 || n_tables > zk::ROUNDS_MAX_TABLES || n_seg > zk::ROUNDS_MAX_SEGS ||
      log_w < 0 || log_w > 24)
    return (int)cudaErrorInvalidValue;
  zk::RoundsArgs a = {};
  for (int t = 0; t < n_tables; ++t) {
    a.xs[t] = reinterpret_cast<const uint32_t*>(tables[4 * t]);
    a.ys[t] = reinterpret_cast<const uint32_t*>(tables[4 * t + 1]);
    a.valid[t] = reinterpret_cast<const uint8_t*>(tables[4 * t + 2]);
    a.n_rows[t] = tables[4 * t + 3];
    if (a.n_rows[t] < 0) return (int)cudaErrorInvalidValue;
  }
  for (int k = 0; k < n_seg; ++k) {
    const long long count = segs[4 * k + 1], table = segs[4 * k + 2];
    if (count < 0 || count >= (1ll << 31) || table < 0 || table >= n_tables)
      return (int)cudaErrorInvalidValue;
    a.idx[k] = reinterpret_cast<const long long*>(segs[4 * k]);
    a.count[k] = (int)count;
    a.table[k] = (int)table;
    a.off[k] = segs[4 * k + 3];
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (group == 1) return zk::launch_rounds<zk::G1Field>(a, n_seg, log_w, ox, oy, oz, s);
  if (group == 2) return zk::launch_rounds<zk::G2Tri>(a, n_seg, log_w, ox, oy, oz, s);
  return (int)cudaErrorInvalidValue;
}
