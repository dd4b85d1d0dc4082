// Horner over windows for BN254 G1 and G2 MSMs: from B7's window totals
// T_w of m MSMs, the m sums sum_w 2^(offset_w) T_w, one block per MSM, in
// one launch per (group, window size).
//
// Replaces, on the main path, the point kernels B4 and B3 of the TPU
// package (zkpoa_tpu/ops/pallas_field.py:321 `_point_call`: `jac_double_tpu`
// :386, `jac_add_tpu` :362) as the JAX package runs Horner through them
// (zkpoa_tpu/ops/msm_pallas.py:501 `_horner_windows`): high window first,
// res = T_top, then for each lower window width_w doublings and one
// unified add res + T_w. The formulas and their operand order are those of
// curve.cuh (dbl-2009-l, the unified add with P == Q as a doubling and
// P == -Q as all-zero coordinates), and every field op returns the
// canonical residue, so the limbs equal those of the plain version
// (ops/msm.py `horner_plain`) and of the elementwise kernels.
//
// What bounds it: neither bytes nor operations (a prove's G1 pass is about
// 8.3k Fq products) but the chain, 244 doublings and 23 adds at c = 11,
// each waiting on the last. The design shortens the chain: one warp per
// MSM computes the independent Montgomery products of each formula level
// in parallel (lane l takes product l; in G2 an Fq2 product is the three
// Fq products of Karatsuba, on three lanes, whose parts one lane per
// product then combines) and the levels exchange values through shared
// memory, one __syncwarp each (two in G2):
//   doubling: {X^2, Y^2, Y Z}, {B^2, (X + B)^2, E^2}, {E (D - X3)}
//   add:      {Z1^2, Z2^2, Y1 Z2, Y2 Z1, Z1 Z2}, {U1, U2, S1, S2},
//             {H^2, R^2, Z1Z2 H}, {H HH, U1 HH}, {R (V - X3), S1 HHH}
// A doubling's chain is 3 products and an add's 5, in G1 and G2 alike
// (one thread ran 7 and 16 in G1, 16 and 44 Fq products in G2). The linear
// steps between levels are recomputed by each lane that needs them. Every
// branch (an operand at infinity, P == Q, P == -Q) reads shared values
// after a barrier, so it is uniform over the warp. The MSM's window totals
// sit in shared memory for the whole chain, and no point crosses an
// out-of-line call, so the G2 formulas' stack frames stay off this path.
#include "curve.cuh"

namespace zk {

constexpr int HORNER_SLOTS = 16;  // product values of one formula

// How a coordinate-field product spreads over lanes: G1 one Fq product,
// G2 the three Fq products of Karatsuba (as fe2_mul in field.cuh).
template <class G>
struct Lanes;

template <>
struct Lanes<G1Field> {
  static constexpr int P = 1;
  __device__ __forceinline__ static void operands(const fe& a, const fe& b, int, fe& pa,
                                                  fe& pb) {
    pa = a;
    pb = b;
  }
  __device__ __forceinline__ static fe value(const fe* t) { return t[0]; }
};

template <>
struct Lanes<G2Field> {
  static constexpr int P = 3;
  __device__ __forceinline__ static void operands(const fe2& a, const fe2& b, int k, fe& pa,
                                                  fe& pb) {
    if (k == 0) {
      pa = a.c0;
      pb = b.c0;
    } else if (k == 1) {
      pa = a.c1;
      pb = b.c1;
    } else {
      pa = fe_add<FQ>(a.c0, a.c1);
      pb = fe_add<FQ>(b.c0, b.c1);
    }
  }
  __device__ __forceinline__ static fe2 value(const fe* t) {
    return {fe_sub<FQ>(t[0], t[1]), fe_sub<FQ>(fe_sub<FQ>(t[2], t[0]), t[1])};
  }
};

// The warp's shared state: the running point and the current formula's
// products (slot k holds its P Fq parts; in G2 also its Fq2 value, combined
// once after its level rather than at every read).
template <class G>
struct Chain {
  using T = typename G::T;
  static constexpr int P = Lanes<G>::P;
  T x, y, z;
  fe part[HORNER_SLOTS * P];
  T v[P > 1 ? HORNER_SLOTS : 1];
  __device__ __forceinline__ T val(int slot) const {
    if constexpr (P > 1)
      return v[slot];
    else
      return part[slot];
  }
};

// One level: products slot0 .. slot0 + NJ - 1 at once, the operands of
// product j from ops(j, a, b); lane l computes part l % P of product l / P,
// then in G2 lane j combines product j's parts.
template <class G, int NJ, class Ops>
__device__ __forceinline__ void level(Chain<G>& s, int slot0, Ops ops) {
  constexpr int P = Lanes<G>::P;
  static_assert(NJ * P <= 32, "a level must fit in one warp");
  const int l = threadIdx.x;
  if (l < NJ * P) {
    typename G::T a, b;
    ops(l / P, a, b);
    fe pa, pb;
    Lanes<G>::operands(a, b, l % P, pa, pb);
    s.part[(slot0 + l / P) * P + l % P] = fe_mul<FQ>(pa, pb);
  }
  __syncwarp();
  if constexpr (P > 1) {
    if (l < NJ) s.v[slot0 + l] = Lanes<G>::value(s.part + (slot0 + l) * P);
    __syncwarp();
  }
}

template <class G>
__device__ __forceinline__ typename G::T triple(const typename G::T& a) {
  return G::add(G::dbl(a), a);
}

// dbl-2009-l on the running point (curve.cuh jac_double_impl). Slots: A 0,
// B 1, YZ 2, C 3, XB2 4, F 5, EDX 6; D = 2 (XB2 - (A + C)), E = 3A.
template <class G>
__device__ __forceinline__ typename G::T dbl_d(const Chain<G>& s) {
  return G::dbl(G::sub(s.val(4), G::add(s.val(0), s.val(3))));
}

template <class G>
__device__ __forceinline__ void chain_double(Chain<G>& s) {
  using T = typename G::T;
  level<G, 3>(s, 0, [&](int j, T& a, T& b) {  // A = X^2, B = Y^2, YZ = Y Z
    a = j == 0 ? s.x : s.y;
    b = j == 0 ? s.x : (j == 1 ? s.y : s.z);
  });
  level<G, 3>(s, 3, [&](int j, T& a, T& b) {  // C = B^2, XB2 = (X + B)^2, F = E^2
    if (j == 0)
      a = s.val(1);
    else if (j == 1)
      a = G::add(s.x, s.val(1));
    else
      a = triple<G>(s.val(0));
    b = a;
  });
  level<G, 1>(s, 6, [&](int, T& a, T& b) {  // EDX = E (D - X3), X3 = F - 2D
    const T d = dbl_d<G>(s);
    a = triple<G>(s.val(0));
    b = G::sub(d, G::sub(s.val(5), G::dbl(d)));
  });
  const int l = threadIdx.x;
  if (l == 0)
    s.x = G::sub(s.val(5), G::dbl(dbl_d<G>(s)));
  else if (l == 1)
    s.y = G::sub(s.val(6), G::dbl(G::dbl(G::dbl(s.val(3)))));
  else if (l == 2)
    s.z = G::dbl(s.val(2));
  __syncwarp();
}

// Unified add res + q (curve.cuh jac_add_impl), q in shared memory. Slots:
// Z1Z1 0, Z2Z2 1, Y1Z2 2, Y2Z1 3, Z1Z2 4, U1 5, U2 6, S1 7, S2 8, HH 9,
// RR 10, Z3 11, HHH 12, V 13, RVX 14, S1H 15.
template <class G>
__device__ __forceinline__ void chain_add(Chain<G>& s, const typename G::T& qx,
                                          const typename G::T& qy, const typename G::T& qz) {
  using T = typename G::T;
  const int l = threadIdx.x;
  if (G::is_zero(s.z)) {  // res at infinity: res = q, even when q is too
    __syncwarp();  // every lane has read res.z
    if (l == 0)
      s.x = qx;
    else if (l == 1)
      s.y = qy;
    else if (l == 2)
      s.z = qz;
    __syncwarp();
    return;
  }
  if (G::is_zero(qz)) return;
  level<G, 5>(s, 0, [&](int j, T& a, T& b) {  // Z1Z1, Z2Z2, Y1Z2, Y2Z1, Z1Z2
    switch (j) {
      case 0: a = s.z; b = s.z; break;
      case 1: a = qz; b = qz; break;
      case 2: a = s.y; b = qz; break;
      case 3: a = qy; b = s.z; break;
      default: a = s.z; b = qz;
    }
  });
  level<G, 4>(s, 5, [&](int j, T& a, T& b) {  // U1, U2, S1, S2
    switch (j) {
      case 0: a = s.x; b = s.val(1); break;
      case 1: a = qx; b = s.val(0); break;
      case 2: a = s.val(2); b = s.val(1); break;
      default: a = s.val(3); b = s.val(0);
    }
  });
  const T h = G::sub(s.val(6), s.val(5));
  const T r = G::sub(s.val(8), s.val(7));
  if (G::is_zero(h)) {
    if (G::is_zero(r)) {  // P == Q
      chain_double<G>(s);
      return;
    }
    if (l == 0)  // P == -Q: all-zero coordinates
      s.x = G::zero();
    else if (l == 1)
      s.y = G::zero();
    else if (l == 2)
      s.z = G::zero();
    __syncwarp();
    return;
  }
  level<G, 3>(s, 9, [&](int j, T& a, T& b) {  // HH = h^2, RR = r^2, Z3 = Z1Z2 h
    a = j == 0 ? h : (j == 1 ? r : s.val(4));
    b = j == 1 ? r : h;
  });
  level<G, 2>(s, 12, [&](int j, T& a, T& b) {  // HHH = h HH, V = U1 HH
    a = j == 0 ? h : s.val(5);
    b = s.val(9);
  });
  level<G, 2>(s, 14, [&](int j, T& a, T& b) {  // RVX = r (V - X3), S1H = S1 HHH
    if (j == 0) {
      a = r;
      b = G::sub(s.val(13), G::sub(G::sub(s.val(10), s.val(12)), G::dbl(s.val(13))));
    } else {
      a = s.val(7);
      b = s.val(12);
    }
  });
  if (l == 0)
    s.x = G::sub(G::sub(s.val(10), s.val(12)), G::dbl(s.val(13)));
  else if (l == 1)
    s.y = G::sub(s.val(14), s.val(15));
  else if (l == 2)
    s.z = s.val(11);
  __syncwarp();
}

// Block b: MSM b, its window totals at rows b * nw .. b * nw + nw - 1.
// Windows below n_signed are c bits wide, the others c - 1 (ops/msm.py
// `windows`).
template <class G>
__global__ void __launch_bounds__(32)
    msm_horner_kernel(const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
                      const uint32_t* __restrict__ tz, int nw, int c, int n_signed,
                      uint32_t* ox, uint32_t* oy, uint32_t* oz) {
  using T = typename G::T;
  extern __shared__ __align__(16) uint32_t smem[];
  Chain<G>& s = *reinterpret_cast<Chain<G>*>(smem);
  uint32_t* raw = smem + sizeof(Chain<G>) / sizeof(uint32_t);
  const T* tot = reinterpret_cast<const T*>(raw);  // [3][nw]: x, y, z of each window
  const int l = threadIdx.x;
  const int words = nw * G::WORDS;
  const long long first = (long long)blockIdx.x * words;
  for (int i = l; i < words; i += 32) {
    raw[i] = tx[first + i];
    raw[words + i] = ty[first + i];
    raw[2 * words + i] = tz[first + i];
  }
  __syncwarp();
  if (l < 3) (l == 0 ? s.x : (l == 1 ? s.y : s.z)) = tot[l * nw + nw - 1];
  __syncwarp();
  for (int w = nw - 2; w >= 0; --w) {
    const int width = w < n_signed ? c : c - 1;
    for (int k = 0; k < width; ++k) chain_double<G>(s);
    chain_add<G>(s, tot[w], tot[nw + w], tot[2 * nw + w]);
  }
  const long long o = (long long)blockIdx.x * G::WORDS;
  if (l == 0)
    G::store(ox + o, s.x);
  else if (l == 1)
    G::store(oy + o, s.y);
  else if (l == 2)
    G::store(oz + o, s.z);
}

template <class G>
int launch_horner(const void* tx, const void* ty, const void* tz, int m, int nw, int c,
                  int n_signed, void* ox, void* oy, void* oz, cudaStream_t s) {
  const size_t smem = sizeof(Chain<G>) + (size_t)3 * nw * G::WORDS * sizeof(uint32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  msm_horner_kernel<G><<<(unsigned)m, 32, smem, s>>>(
      static_cast<const uint32_t*>(tx), static_cast<const uint32_t*>(ty),
      static_cast<const uint32_t*>(tz), nw, c, n_signed, static_cast<uint32_t*>(ox),
      static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz));
  return (int)cudaGetLastError();
}

}  // namespace zk

// group: 1 = G1, 2 = G2. Window totals [m * nw] (MSM by MSM, low window
// first), output [m] Jacobian sums.
extern "C" int zk_msm_horner(int group, const void* tx, const void* ty, const void* tz, int m,
                             int nw, int c, int n_signed, void* ox, void* oy, void* oz,
                             void* stream) {
  if (m <= 0) return 0;
  if (nw <= 0 || c < 2 || c > 16 || n_signed < 0 || n_signed > nw)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (group == 1)
    return zk::launch_horner<zk::G1Field>(tx, ty, tz, m, nw, c, n_signed, ox, oy, oz, s);
  if (group == 2)
    return zk::launch_horner<zk::G2Field>(tx, ty, tz, m, nw, c, n_signed, ox, oy, oz, s);
  return (int)cudaErrorInvalidValue;
}
