// BN254 field arithmetic for Hopper: 8 x 32-bit limbs, Montgomery form.
//
// Replaces the field core of the Pallas kernels in
// zkpoa_tpu/ops/pallas_field.py (k_mont_mul :51, _k_normalize_reduce :75,
// _k_cond_sub_p :89, k_add_mod / k_sub_mod / k_dbl_mod :102-144), which
// work on 16 x 16-bit limbs held in uint32 because the TPU has no 64-bit
// integer multiply. Here a limb is 32 bits and each partial product is one
// 32x32->64 multiply (IMAD.WIDE); R = 2^256 in both packages, so a value
// in Montgomery form is the same integer on either side.
//
// What bounds it on the card: the integer multiply-add throughput of the
// SMs (a product is 64 wide multiply-adds for a.b plus 64 for the
// reduction) and, in the point formulas built on it, register pressure.
// This is the simple correct version: plain C++ carry handling through
// 64-bit intermediates, no inline PTX carry chains; speed is left to later
// work.
//
// Layout in memory: one element is 8 consecutive uint32 words, least
// significant first (a torch int32 tensor [..., 8] holding the bit
// pattern). An Fq2 element c0 + c1*u (u^2 = -1) is 16 words: c0 then c1.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace zk {

static __constant__ uint32_t FQ_P[8] = {
    0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
static __constant__ uint32_t FQ_ONE[8] = {  // 2^256 mod q
    0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
    0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
static __constant__ uint32_t FR_P[8] = {
    0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
static __constant__ uint32_t FR_ONE[8] = {  // 2^256 mod r
    0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
    0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};

enum { FQ = 0, FR = 1 };

template <int F>
struct Mod;

template <>
struct Mod<FQ> {
  static constexpr uint32_t N0 = 0xe4866389u;  // -q^-1 mod 2^32
  __device__ __forceinline__ static uint32_t p(int i) { return FQ_P[i]; }
  __device__ __forceinline__ static uint32_t one(int i) { return FQ_ONE[i]; }
};

template <>
struct Mod<FR> {
  static constexpr uint32_t N0 = 0xefffffffu;  // -r^-1 mod 2^32
  __device__ __forceinline__ static uint32_t p(int i) { return FR_P[i]; }
  __device__ __forceinline__ static uint32_t one(int i) { return FR_ONE[i]; }
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

// value = a + hi * 2^256 < 2p  ->  value mod p
template <int F>
__device__ __forceinline__ fe fe_reduce_once(const fe& a, uint32_t hi) {
  fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t s = (uint64_t)a.v[j] - Mod<F>::p(j) - borrow;
    d.v[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool use_d = (hi != 0) || (borrow == 0);
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = use_d ? d.v[j] : a.v[j];
  return r;
}

template <int F>
__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe s;
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t t = (uint64_t)a.v[j] + b.v[j] + carry;
    s.v[j] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  return fe_reduce_once<F>(s, carry);
}

template <int F>
__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t s = (uint64_t)a.v[j] - b.v[j] - borrow;
    d.v[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const uint32_t mask = 0u - borrow;  // add p back when a < b
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t t = (uint64_t)d.v[j] + (Mod<F>::p(j) & mask) + carry;
    d.v[j] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  return d;
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
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c = (uint64_t)t[j] + (uint64_t)a.v[j] * b.v[i] + (c >> 32);
      t[j] = (uint32_t)c;
    }
    c = (uint64_t)t[8] + (c >> 32);
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * Mod<F>::N0;
    c = (uint64_t)t[0] + (uint64_t)m * Mod<F>::p(0);
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c = (uint64_t)t[j] + (uint64_t)m * Mod<F>::p(j) + (c >> 32);
      t[j - 1] = (uint32_t)c;
    }
    c = (uint64_t)t[8] + (c >> 32);
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
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

// Karatsuba: 3 base-field products
__device__ __forceinline__ fe2 fe2_mul(const fe2& a, const fe2& b) {
  fe t0 = fe_mul<FQ>(a.c0, b.c0);
  fe t1 = fe_mul<FQ>(a.c1, b.c1);
  fe t2 = fe_mul<FQ>(fe_add<FQ>(a.c0, a.c1), fe_add<FQ>(b.c0, b.c1));
  return {fe_sub<FQ>(t0, t1), fe_sub<FQ>(fe_sub<FQ>(t2, t0), t1)};
}

// (a0 + a1)(a0 - a1), 2 a0 a1: 2 base-field products
__device__ __forceinline__ fe2 fe2_sqr(const fe2& a) {
  fe c0 = fe_mul<FQ>(fe_add<FQ>(a.c0, a.c1), fe_sub<FQ>(a.c0, a.c1));
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
