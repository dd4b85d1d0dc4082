// Jacobian point formulas on y^2 = x^3 + b (a = 0), templated on the
// coordinate field (G1Field over Fq, G2Field over Fq2).
//
// The formulas are those of zkpoa_tpu/ops/curve_jax.py (jac_double :66,
// jac_add :83, jac_add_affine :125) and of the Pallas bodies
// zkpoa_tpu/ops/pallas_field.py (_k_jac_double :152, _k_jac_add :209,
// _k_jac_add_affine :170). The TPU computes every exceptional case beside
// the generic formula and folds them in with selects, because its vector
// unit has no divergence; a GPU thread branches instead, so the rare cases
// (an operand at infinity, P == Q, P == -Q) cost a divergent branch and
// nothing on the common path. Infinity is z == 0; a P == -Q sum is written
// as all-zero coordinates.
#pragma once

#include "field.cuh"

namespace zk {

template <class G>
struct Jac {
  typename G::T x, y, z;
};

template <class G>
__device__ __forceinline__ Jac<G> jac_inf() {
  return {G::zero(), G::zero(), G::zero()};
}

template <class G>
__device__ __forceinline__ Jac<G> jac_load(const uint32_t* x, const uint32_t* y,
                                           const uint32_t* z, long long i) {
  return {G::load(x + i * G::WORDS), G::load(y + i * G::WORDS), G::load(z + i * G::WORDS)};
}

template <class G>
__device__ __forceinline__ void jac_store(uint32_t* x, uint32_t* y, uint32_t* z,
                                          long long i, const Jac<G>& p) {
  G::store(x + i * G::WORDS, p.x);
  G::store(y + i * G::WORDS, p.y);
  G::store(z + i * G::WORDS, p.z);
}

// The G1 formulas are inlined into every kernel. The G2 ones (three times
// the products, near the 255-register limit) stay out of line, each
// compiled once per translation unit: inlined into the reduction kernels
// they cost ptxas minutes and spilled kilobytes of registers.

// dbl-2009-l; infinity (z = 0) maps to z3 = 0 by itself
template <class G>
__device__ __forceinline__ Jac<G> jac_double_impl(const Jac<G>& p) {
  using T = typename G::T;
  T a = G::sqr(p.x);
  T b = G::sqr(p.y);
  T c = G::sqr(b);
  T d = G::dbl(G::sub(G::sqr(G::add(p.x, b)), G::add(a, c)));
  T e = G::add(G::dbl(a), a);
  T f = G::sqr(e);
  Jac<G> r;
  r.x = G::sub(f, G::dbl(d));
  T c8 = G::dbl(G::dbl(G::dbl(c)));
  r.y = G::sub(G::mul(e, G::sub(d, r.x)), c8);
  r.z = G::dbl(G::mul(p.y, p.z));
  return r;
}

template <class G>
__device__ __forceinline__ Jac<G> jac_double(const Jac<G>& p) {
  return jac_double_impl<G>(p);
}
template <>
inline __device__ __noinline__ Jac<G2Field> jac_double<G2Field>(const Jac<G2Field>& p) {
  return jac_double_impl<G2Field>(p);
}

// unified full add: every input pair, exceptional cases included
template <class G>
__device__ __forceinline__ Jac<G> jac_add_impl(const Jac<G>& p, const Jac<G>& q) {
  using T = typename G::T;
  if (G::is_zero(p.z)) return q;
  if (G::is_zero(q.z)) return p;
  T z1z1 = G::sqr(p.z);
  T z2z2 = G::sqr(q.z);
  T u1 = G::mul(p.x, z2z2);
  T u2 = G::mul(q.x, z1z1);
  T s1 = G::mul(G::mul(p.y, q.z), z2z2);
  T s2 = G::mul(G::mul(q.y, p.z), z1z1);
  T h = G::sub(u2, u1);
  T r = G::sub(s2, s1);
  if (G::is_zero(h)) {
    if (G::is_zero(r)) return jac_double<G>(p);
    return jac_inf<G>();
  }
  T hh = G::sqr(h);
  T hhh = G::mul(h, hh);
  T v = G::mul(u1, hh);
  Jac<G> o;
  o.x = G::sub(G::sub(G::sqr(r), hhh), G::dbl(v));
  o.y = G::sub(G::mul(r, G::sub(v, o.x)), G::mul(s1, hhh));
  o.z = G::mul(G::mul(p.z, q.z), h);
  return o;
}

template <class G>
__device__ __forceinline__ Jac<G> jac_add(const Jac<G>& p, const Jac<G>& q) {
  return jac_add_impl<G>(p, q);
}
template <>
inline __device__ __noinline__ Jac<G2Field> jac_add<G2Field>(const Jac<G2Field>& p,
                                                             const Jac<G2Field>& q) {
  return jac_add_impl<G2Field>(p, q);
}

// unified mixed add of an affine point (z = 1 implied)
template <class G>
__device__ __forceinline__ Jac<G> jac_add_affine_impl(const Jac<G>& p, const typename G::T& xq,
                                                      const typename G::T& yq) {
  using T = typename G::T;
  if (G::is_zero(p.z)) return {xq, yq, G::one()};
  T z1z1 = G::sqr(p.z);
  T u2 = G::mul(xq, z1z1);
  T s2 = G::mul(G::mul(yq, p.z), z1z1);
  T h = G::sub(u2, p.x);
  T r = G::sub(s2, p.y);
  if (G::is_zero(h)) {
    if (G::is_zero(r)) return jac_double<G>(p);
    return jac_inf<G>();
  }
  T hh = G::sqr(h);
  T hhh = G::mul(h, hh);
  T v = G::mul(p.x, hh);
  Jac<G> o;
  o.x = G::sub(G::sub(G::sqr(r), hhh), G::dbl(v));
  o.y = G::sub(G::mul(r, G::sub(v, o.x)), G::mul(p.y, hhh));
  o.z = G::mul(p.z, h);
  return o;
}

template <class G>
__device__ __forceinline__ Jac<G> jac_add_affine(const Jac<G>& p, const typename G::T& xq,
                                                 const typename G::T& yq) {
  return jac_add_affine_impl<G>(p, xq, yq);
}
template <>
inline __device__ __noinline__ Jac<G2Field> jac_add_affine<G2Field>(const Jac<G2Field>& p,
                                                                    const fe2& xq,
                                                                    const fe2& yq) {
  return jac_add_affine_impl<G2Field>(p, xq, yq);
}

}  // namespace zk
