// BN254 field arithmetic for Hopper: 8 x 32-bit limbs, Montgomery form.
//
// Replaces the field core of the Pallas kernels in
// zkpoa_tpu/ops/pallas_field.py (k_mont_mul :51, _k_normalize_reduce :75,
// _k_cond_sub_p :89, k_add_mod / k_sub_mod / k_dbl_mod :102-144), which
// work on 16 x 16-bit limbs held in uint32 because the TPU has no 64-bit
// integer multiply. Here a limb is 32 bits; R = 2^256 in both packages, so
// a value in Montgomery form is the same integer on either side.
//
// What bounds it on the card: a product is 64 32x32-bit multiplies for a.b
// and 64 for the reduction (each a lo and a hi half), so kernels that run
// many products in parallel are bound by the SMs' integer multiply-add
// issue rate, and the chain kernels (Horner, B7, the fold) by one product's
// latency. The carries therefore run on the hardware carry flag: every
// add, subtract and multiply-accumulate row is one PTX carry chain
// (add.cc / addc / sub.cc / subc / mad.lo.cc / madc.hi.cc), each whole
// chain inside one asm block (the flag does not survive between blocks).
// The product is CIOS by rows of b; each row a.b_i and each reduction row
// m.p is split into its even and odd partial products (limbs 0, 2, 4, 6
// and 1, 3, 5, 7), two chains whose steps depend on each other only
// limb by limb, so ptxas can run them interleaved instead of one 64-bit
// dependent chain per row.
//
// Contracts, which every kernel relies on for bit-identical limbs: fe_mul
// takes any a, b with a.b < 2^256 p (so one operand may be any 256-bit
// value) and returns the canonical residue; fe_add and fe_sub take
// canonical operands and return the canonical residue; fe_reduce_once
// takes a value below 2p. (CIOS row invariant: with t < a + p before a
// row, t + a b_i + m p < 2^32 (a + p) < 2^289, ten words, and the shifted
// t is again below a + p < 2^257; at the end t < (a b + R p) / R < 2p.)
//
// Layout in memory: one element is 8 consecutive uint32 words, least
// significant first (a torch int32 tensor [..., 8] holding the bit
// pattern). An Fq2 element c0 + c1*u (u^2 = -1) is 16 words: c0 then c1.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace zk {

enum { FQ = 0, FR = 1 };

template <int F>
struct Mod;

// Limbs as constant expressions, so that after unrolling each reaches the
// multiply-adds as an immediate operand.
template <>
struct Mod<FQ> {
  static constexpr uint32_t N0 = 0xe4866389u;  // -q^-1 mod 2^32
  __device__ __forceinline__ static constexpr uint32_t p(int i) {
    return i == 0 ? 0xd87cfd47u : i == 1 ? 0x3c208c16u : i == 2 ? 0x6871ca8du
         : i == 3 ? 0x97816a91u : i == 4 ? 0x8181585du : i == 5 ? 0xb85045b6u
         : i == 6 ? 0xe131a029u : 0x30644e72u;
  }
  __device__ __forceinline__ static constexpr uint32_t one(int i) {  // 2^256 mod q
    return i == 0 ? 0xc58f0d9du : i == 1 ? 0xd35d438du : i == 2 ? 0xf5c70b3du
         : i == 3 ? 0x0a78eb28u : i == 4 ? 0x7879462cu : i == 5 ? 0x666ea36fu
         : i == 6 ? 0x9a07df2fu : 0x0e0a77c1u;
  }
};

template <>
struct Mod<FR> {
  static constexpr uint32_t N0 = 0xefffffffu;  // -r^-1 mod 2^32
  __device__ __forceinline__ static constexpr uint32_t p(int i) {
    return i == 0 ? 0xf0000001u : i == 1 ? 0x43e1f593u : i == 2 ? 0x79b97091u
         : i == 3 ? 0x2833e848u : i == 4 ? 0x8181585du : i == 5 ? 0xb85045b6u
         : i == 6 ? 0xe131a029u : 0x30644e72u;
  }
  __device__ __forceinline__ static constexpr uint32_t one(int i) {  // 2^256 mod r
    return i == 0 ? 0x4ffffffbu : i == 1 ? 0xac96341cu : i == 2 ? 0x9f60cd29u
         : i == 3 ? 0x36fc7695u : i == 4 ? 0x7879462eu : i == 5 ? 0x666ea36fu
         : i == 6 ? 0x9a07df2fu : 0x0e0a77c1u;
  }
};

struct fe {
  uint32_t v[8];
};

__device__ __forceinline__ fe fe_load(const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 a = q[0], b = q[1];
  fe r;
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
  return r;
}

__device__ __forceinline__ void fe_store(uint32_t* p, const fe& r) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(r.v[0], r.v[1], r.v[2], r.v[3]);
  q[1] = make_uint4(r.v[4], r.v[5], r.v[6], r.v[7]);
}

__device__ __forceinline__ fe fe_zero() {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = 0;
  return r;
}

template <int F>
__device__ __forceinline__ fe fe_one() {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = Mod<F>::one(j);
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc |= a.v[j];
  return acc == 0;
}

// ---- carry chains (each one asm block) ----

// s = a + b mod 2^256; returns the carry out
__device__ __forceinline__ uint32_t add8_cc(fe& s, const fe& a, const fe& b) {
  uint32_t c;
  asm("add.cc.u32  %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32    %8, 0, 0;"
      : "=r"(s.v[0]), "=r"(s.v[1]), "=r"(s.v[2]), "=r"(s.v[3]), "=r"(s.v[4]), "=r"(s.v[5]),
        "=r"(s.v[6]), "=r"(s.v[7]), "=r"(c)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  return c;
}

// d = a - b mod 2^256; returns 0 or 0xffffffff (a borrow out)
__device__ __forceinline__ uint32_t sub8_cc(fe& d, const fe& a, const fe& b) {
  uint32_t m;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, 0, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]), "=r"(d.v[4]), "=r"(d.v[5]),
        "=r"(d.v[6]), "=r"(d.v[7]), "=r"(m)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  return m;
}

template <int F>
__device__ __forceinline__ fe fe_modulus() {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = Mod<F>::p(j);
  return r;
}

// t[0..9] += (x0, x2, x4, x6 at limbs 0, 2, 4, 6) * y: the even partial
// products, lo halves at even and hi halves at odd limbs, one chain from
// limb 0 into t[8], t[9]
__device__ __forceinline__ void mac_even(uint32_t (&t)[10], uint32_t x0, uint32_t x2,
                                         uint32_t x4, uint32_t x6, uint32_t y) {
  asm("mad.lo.cc.u32  %0, %10, %14, %0;\n\t"
      "madc.hi.cc.u32 %1, %10, %14, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %14, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %14, %3;\n\t"
      "madc.lo.cc.u32 %4, %12, %14, %4;\n\t"
      "madc.hi.cc.u32 %5, %12, %14, %5;\n\t"
      "madc.lo.cc.u32 %6, %13, %14, %6;\n\t"
      "madc.hi.cc.u32 %7, %13, %14, %7;\n\t"
      "addc.cc.u32    %8, %8, 0;\n\t"
      "addc.u32       %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(x0), "r"(x2), "r"(x4), "r"(x6), "r"(y));
}

// t[1..9] += (x1, x3, x5, x7 at limbs 1, 3, 5, 7) * y: the odd partial
// products, lo halves at odd and hi halves at even limbs, one chain from
// limb 1 into t[9]
__device__ __forceinline__ void mac_odd(uint32_t (&t)[10], uint32_t x1, uint32_t x3,
                                        uint32_t x5, uint32_t x7, uint32_t y) {
  asm("mad.lo.cc.u32  %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32       %8, %8, 0;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8]), "+r"(t[9])
      : "r"(x1), "r"(x3), "r"(x5), "r"(x7), "r"(y));
}

// value = a + hi * 2^256 < 2p  ->  value mod p
template <int F>
__device__ __forceinline__ fe fe_reduce_once(const fe& a, uint32_t hi) {
  fe d;
  const uint32_t borrow = sub8_cc(d, a, fe_modulus<F>());
  const bool use_d = (hi != 0) || (borrow == 0);
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = use_d ? d.v[j] : a.v[j];
  return r;
}

// a + b as a 256-bit integer, not reduced: below 2p for canonical a and b
// (2p < 2^256), an operand a product accepts (a.b < 2^256 p while the
// other factor is below 2p too, as 4p < 2^256)
__device__ __forceinline__ fe fe_add_lazy(const fe& a, const fe& b) {
  fe s;
  add8_cc(s, a, b);
  return s;
}

template <int F>
__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe s;
  const uint32_t carry = add8_cc(s, a, b);
  return fe_reduce_once<F>(s, carry);
}

template <int F>
__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe d;
  const uint32_t mask = sub8_cc(d, a, b);  // all ones when a < b: add p back
  fe pm;
#pragma unroll
  for (int j = 0; j < 8; ++j) pm.v[j] = Mod<F>::p(j) & mask;
  fe r;
  add8_cc(r, d, pm);
  return r;
}

// CIOS Montgomery product a*b*2^-256 mod p. Inputs need only a*b < 2^256*p
// (one operand may be any 256-bit value); the output is fully reduced.
template <int F>
__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t bi = b.v[i];
    mac_even(t, a.v[0], a.v[2], a.v[4], a.v[6], bi);
    mac_odd(t, a.v[1], a.v[3], a.v[5], a.v[7], bi);
    const uint32_t m = t[0] * Mod<F>::N0;
    mac_even(t, Mod<F>::p(0), Mod<F>::p(2), Mod<F>::p(4), Mod<F>::p(6), m);
    mac_odd(t, Mod<F>::p(1), Mod<F>::p(3), Mod<F>::p(5), Mod<F>::p(7), m);
#pragma unroll
    for (int j = 0; j < 9; ++j) t[j] = t[j + 1];  // t[0] is 0 mod 2^32: shift a word out
    t[9] = 0;
  }
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = t[j];
  return fe_reduce_once<F>(r, t[8]);
}

// ---- Fq2 = Fq[u] / (u^2 + 1) ----

struct fe2 {
  fe c0, c1;
};

__device__ __forceinline__ fe2 fe2_load(const uint32_t* p) {
  fe2 r;
  r.c0 = fe_load(p);
  r.c1 = fe_load(p + 8);
  return r;
}

__device__ __forceinline__ void fe2_store(uint32_t* p, const fe2& r) {
  fe_store(p, r.c0);
  fe_store(p + 8, r.c1);
}

__device__ __forceinline__ fe2 fe2_add(const fe2& a, const fe2& b) {
  return {fe_add<FQ>(a.c0, b.c0), fe_add<FQ>(a.c1, b.c1)};
}

__device__ __forceinline__ fe2 fe2_sub(const fe2& a, const fe2& b) {
  return {fe_sub<FQ>(a.c0, b.c0), fe_sub<FQ>(a.c1, b.c1)};
}

// Karatsuba: 3 base-field products; the sums a0 + a1, b0 + b1 stay
// unreduced (each below 2p, so their product is below 4p^2 < 2^256 p)
__device__ __forceinline__ fe2 fe2_mul(const fe2& a, const fe2& b) {
  fe t0 = fe_mul<FQ>(a.c0, b.c0);
  fe t1 = fe_mul<FQ>(a.c1, b.c1);
  fe t2 = fe_mul<FQ>(fe_add_lazy(a.c0, a.c1), fe_add_lazy(b.c0, b.c1));  // < 4p^2
  return {fe_sub<FQ>(t0, t1), fe_sub<FQ>(fe_sub<FQ>(t2, t0), t1)};
}

// (a0 + a1)(a0 - a1), 2 a0 a1: 2 base-field products (a0 + a1 unreduced,
// below 2p: the product is below 2p^2)
__device__ __forceinline__ fe2 fe2_sqr(const fe2& a) {
  fe c0 = fe_mul<FQ>(fe_add_lazy(a.c0, a.c1), fe_sub<FQ>(a.c0, a.c1));
  fe t = fe_mul<FQ>(a.c0, a.c1);
  return {c0, fe_add<FQ>(t, t)};
}

// ---- the two coordinate fields behind one interface, for the curve code ----

struct G1Field {  // BN254 G1: coordinates in Fq
  using T = fe;
  static constexpr int WORDS = 8;
  __device__ __forceinline__ static T load(const uint32_t* p) { return fe_load(p); }
  __device__ __forceinline__ static void store(uint32_t* p, const T& a) { fe_store(p, a); }
  __device__ __forceinline__ static T add(const T& a, const T& b) { return fe_add<FQ>(a, b); }
  __device__ __forceinline__ static T sub(const T& a, const T& b) { return fe_sub<FQ>(a, b); }
  __device__ __forceinline__ static T dbl(const T& a) { return fe_add<FQ>(a, a); }
  __device__ __forceinline__ static T mul(const T& a, const T& b) { return fe_mul<FQ>(a, b); }
  __device__ __forceinline__ static T sqr(const T& a) { return fe_mul<FQ>(a, a); }
  __device__ __forceinline__ static T neg(const T& a) { return fe_sub<FQ>(fe_zero(), a); }
  __device__ __forceinline__ static bool is_zero(const T& a) { return fe_is_zero(a); }
  __device__ __forceinline__ static T zero() { return fe_zero(); }
  __device__ __forceinline__ static T one() { return fe_one<FQ>(); }
};

struct G2Field {  // BN254 G2 (the twist): coordinates in Fq2
  using T = fe2;
  static constexpr int WORDS = 16;
  __device__ __forceinline__ static T load(const uint32_t* p) { return fe2_load(p); }
  __device__ __forceinline__ static void store(uint32_t* p, const T& a) { fe2_store(p, a); }
  __device__ __forceinline__ static T add(const T& a, const T& b) { return fe2_add(a, b); }
  __device__ __forceinline__ static T sub(const T& a, const T& b) { return fe2_sub(a, b); }
  __device__ __forceinline__ static T dbl(const T& a) { return fe2_add(a, a); }
  __device__ __forceinline__ static T mul(const T& a, const T& b) { return fe2_mul(a, b); }
  __device__ __forceinline__ static T sqr(const T& a) { return fe2_sqr(a); }
  __device__ __forceinline__ static T neg(const T& a) {
    return {fe_sub<FQ>(fe_zero(), a.c0), fe_sub<FQ>(fe_zero(), a.c1)};
  }
  __device__ __forceinline__ static bool is_zero(const T& a) {
    return fe_is_zero(a.c0) && fe_is_zero(a.c1);
  }
  __device__ __forceinline__ static T zero() { return {fe_zero(), fe_zero()}; }
  __device__ __forceinline__ static T one() { return {fe_one<FQ>(), fe_zero()}; }
};

}  // namespace zk
