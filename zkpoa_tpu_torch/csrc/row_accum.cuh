// Row accumulation: the core that kernel B8 (fixed_base.cu) and the
// heavy-value rounds (heavy_rounds.cu) share. A lane of the launch owns one
// Jacobian accumulator and walks its own sequence of affine table rows,
// "row k of this lane" for k = 0, 1, ..., mixed-adding each present row
// into the accumulator, from infinity, in order. The add is curve.cuh's
// unified mixed add (`jac_add_affine`), so P at infinity, P == Q (a
// doubling) and P == -Q (all-zero coordinates) are handled in the kernel,
// in curve.cuh's exceptional order, and the limbs equal those of the plain
// versions, which repeat the same adds in the same order.
//
// What bounds it: the multiply-add rate of the SMs (11 Fq products a G1
// mixed add, 11 Fq2 products a G2 one), provided enough warps are resident
// to hide each add's dependent chain and the random row reads (64 B a G1
// row, 128 B a G2 row; B8's tables, 512 KiB and 1 MiB, stay in the 50 MB
// L2). The lane layouts (the coordinate-field policy F of a kernel):
//   * G1Field: one thread per lane, the formula inlined (about 90-100
//     registers).
//   * G2Field: one thread per lane carries a Jac<G2> of 96 words through
//     curve.cuh's out-of-line G2 add (a 320-byte stack frame, about 150
//     registers, 3 blocks of 128 threads an SM). Per lane-add it issues the
//     fewest instructions, so it is the layout for launches of many lanes.
//     Inlined here, the add took more registers and ran slower.
//   * G2Tri: three threads carry one lane: thread k of a triple holds
//     component k of every Fq2 value, (c0, c1, c0 + c1). Additions are
//     componentwise, and a Karatsuba product is one Fq product per thread,
//     t_k = a_k b_k, after which two shuffles give each thread the parts
//     its component needs: c0 = t0 - t1, c1 = t2 - t0 - t1,
//     c0 + c1 = t2 - 2 t1. A triple's threads hold a G1-sized state, the
//     formula is inlined into this core only (no stack frame), and a warp
//     holds 10 triples (lanes 30 and 31 idle). It issues more instructions
//     per lane-add than G2Field (33 Fq products for 30, the shuffles, a
//     third component) but runs three threads a lane, so it wins where
//     one-thread lanes would leave the card underfilled: launches that fit
//     in one wave, and the heavy rounds, whose work sits in one segment's
//     2^16 lanes. Every component is the canonical residue, so components
//     0 and 1 are fe2_mul's limbs.
//   * Steps that no lane of a warp adds (a zero digit in every scalar of
//     the warp, lanes past their run) are skipped by a warp vote. Within a
//     step that some lane adds, a lane without a row branches around the
//     add: rows are rarely absent (a zero digit in about one window of a
//     hundred in a layer-one setup), and a select after every add would
//     cost instructions on every add.
#pragma once

#include "curve.cuh"

namespace zk {

constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int ROW_THREADS = 128;  // threads a block of the row-accumulation kernels

__device__ __forceinline__ fe fe_sel(bool c, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = c ? a.v[j] : b.v[j];
  return r;
}

__device__ __forceinline__ fe fe_shfl(unsigned mask, const fe& a, int src) {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = __shfl_sync(mask, a.v[j], src);
  return r;
}

// Fq2 over the three threads of a triple, behind the coordinate-field
// interface of curve.cuh (T is this thread's component). Only the threads
// of lanes 0-29 of a warp call it.
struct G2Tri {
  using T = fe;
  static constexpr int WORDS = 16;  // words of one coordinate in memory: c0, then c1
  __device__ __forceinline__ static int first() { return (threadIdx.x & 31) / 3 * 3; }
  __device__ __forceinline__ static int part() { return (threadIdx.x & 31) - first(); }
  __device__ __forceinline__ static unsigned mask() { return 7u << first(); }
  __device__ __forceinline__ static T load(const uint32_t* p) {
    const int k = part();
    fe a = fe_load(p + (k == 1 ? 8 : 0));
    if (k == 2) a = fe_add<FQ>(a, fe_load(p + 8));
    return a;
  }
  __device__ __forceinline__ static void store(uint32_t* p, const T& a) {
    const int k = part();
    if (k < 2) fe_store(p + 8 * k, a);
  }
  __device__ __forceinline__ static T add(const T& a, const T& b) { return fe_add<FQ>(a, b); }
  __device__ __forceinline__ static T sub(const T& a, const T& b) { return fe_sub<FQ>(a, b); }
  __device__ __forceinline__ static T dbl(const T& a) { return fe_add<FQ>(a, a); }
  __device__ __forceinline__ static T mul(const T& a, const T& b) {
    const int k = part();
    const int f = first();
    const unsigned m = mask();
    const fe t = fe_mul<FQ>(a, b);                   // t_k
    const fe u = fe_shfl(m, t, f + (k == 1 ? 0 : 1));  // t1 on threads 0 and 2, t0 on thread 1
    const fe w = fe_shfl(m, t, f + 2);                 // t2
    const fe x = fe_sel(k == 1, fe_sub<FQ>(w, u), t);  // t0 | t2 - t0 | t2
    const fe y = fe_sel(k == 0, u, fe_sel(k == 1, t, fe_add<FQ>(u, u)));  // t1 | t1 | 2 t1
    return fe_sub<FQ>(x, y);
  }
  __device__ __forceinline__ static T sqr(const T& a) { return mul(a, a); }
  // componentwise: -(c0 + c1) = (-c0) + (-c1)
  __device__ __forceinline__ static T neg(const T& a) { return fe_sub<FQ>(fe_zero(), a); }
  __device__ __forceinline__ static bool is_zero(const T& a) {
    const unsigned b = __ballot_sync(mask(), fe_is_zero(a));
    return ((b >> first()) & 3u) == 3u;  // c0 == 0 and c1 == 0
  }
  __device__ __forceinline__ static T zero() { return fe_zero(); }
  __device__ __forceinline__ static T one() {  // 1 + 0 u: components (1, 0, 1)
    return fe_sel(part() == 1, fe_zero(), fe_one<FQ>());
  }
};

// Threads that carry one lane in the layout F.
template <class F>
struct LaneThreads {
  static constexpr int P = 1;
};

template <>
struct LaneThreads<G2Tri> {
  static constexpr int P = 3;
};

template <class F>
struct RowLane {
  static constexpr int P = LaneThreads<F>::P;
  static constexpr int PER_WARP = 32 / P;  // lanes a warp carries
  long long lane;  // this thread's lane in the launch
  bool active;     // part of a lane (G2: lanes 30 and 31 of a warp are not)
  __device__ __forceinline__ RowLane() {
    const int l = threadIdx.x & 31;
    const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    active = l < PER_WARP * P;
    lane = warp * PER_WARP + (active ? l / P : 0);
  }
};

// Blocks of ROW_THREADS that carry n lanes.
template <class F>
inline long long row_blocks(long long n) {
  const long long threads = (n + RowLane<F>::PER_WARP - 1) / RowLane<F>::PER_WARP * 32;
  return (threads + ROW_THREADS - 1) / ROW_THREADS;
}

// Lanes that one wave of `kernel` (layout F, ROW_THREADS a block) carries
// on the current device: its resident blocks per SM times the SMs.
template <class F, class K>
inline long long wave_lanes(K kernel) {
  int dev = 0, sms = 0, blocks = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, ROW_THREADS, 0) !=
          cudaSuccess)
    return 0;
  return (long long)sms * blocks * (ROW_THREADS / 32) * RowLane<F>::PER_WARP;
}

// G2 lanes take the triple layout when it needs no more waves than one
// thread a lane: a wave of triples carries fewer lanes but finishes them
// sooner than a wave of one-thread lanes, which do more of the work per
// thread.
template <class K1, class K3>
inline bool g2_triples(long long lanes, K1 one_thread, K3 triples) {
  const long long c1 = wave_lanes<G2Field>(one_thread), c3 = wave_lanes<G2Tri>(triples);
  if (c1 <= 0 || c3 <= 0) return false;
  return (lanes + c3 - 1) / c3 <= (lanes + c1 - 1) / c1;
}

// The core: sum of the rows next(0), ..., next(steps - 1) of this lane's
// table (affine xs / ys, WORDS words a coordinate, row-major) by mixed adds
// from infinity, in order; next(k) gives the row to add at step k or -1 to
// add nothing. Every thread of the warp calls it (steps may differ by
// thread: 0 for threads that carry no lane); only active threads add.
template <class F, class Next>
__device__ __forceinline__ Jac<F> row_accum(const uint32_t* tx, const uint32_t* ty, int steps,
                                            bool active, Next next) {
  Jac<F> acc = jac_inf<F>();
  for (int k = 0; __any_sync(FULL_WARP, k < steps); ++k) {
    const long long row = k < steps ? next(k) : -1;
    const bool add = row >= 0;
    if (!__any_sync(FULL_WARP, add)) continue;  // no lane of the warp adds at this step
    if (active && add)  // the same on the three threads of a G2 lane; G2Field: out of line
      acc = jac_add_affine<F>(acc, F::load(tx + row * F::WORDS), F::load(ty + row * F::WORDS));
  }
  return acc;
}

}  // namespace zk
