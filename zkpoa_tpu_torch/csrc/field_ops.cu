// Elementwise BN254 field kernels: Montgomery product, modular add and
// modular subtract over Fq or Fr.
//
// Replaces kernel B1 of the TPU package: zkpoa_tpu/ops/pallas_field.py:297
// (`mont_mul_tpu` :282, body `k_mont_mul` :51 with `_k_normalize_reduce`
// :75 and `_k_cond_sub_p` :89) and its add/sub helpers (:102-144). The TPU
// kernel tiled the batch limb-major into [16, 512] blocks so each limb row
// filled the vector lanes; here one thread owns one element and reads its
// 32 bytes with two 16-byte loads, neighbouring threads on neighbouring
// elements.
//
// What bounds it: device-memory bandwidth for add/sub (96 bytes moved per
// element) and the SMs' 32-bit multiply-add rate for the product (128 wide
// multiply-adds per element, on the carry chains of field.cuh).
//
// `b` broadcasts in one of three modes, chosen per launch: b_n = n
// (elementwise), b_n = 1 (one scalar for every element) or cyclic, element
// i using b[i % b_n] (b_n divides n; a table repeated over a batch, as
// Poseidon's MDS matrix and round constants). Indices are 32-bit: the
// launcher takes n < 2^31, and only the cyclic mode pays for a modulo.
#include "field.cuh"

namespace zk {

template <int F, int OP>
__global__ void field_binop_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                   uint32_t* __restrict__ out, uint32_t n, uint32_t b_n) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t j = b_n == n ? i : b_n == 1 ? 0u : i % b_n;
  fe x = fe_load(a + (size_t)i * 8);
  fe y = fe_load(b + (size_t)j * 8);
  fe r;
  if (OP == 0) {
    r = fe_mul<F>(x, y);
  } else if (OP == 1) {
    r = fe_add<F>(x, y);
  } else {
    r = fe_sub<F>(x, y);
  }
  fe_store(out + (size_t)i * 8, r);
}

template <int F>
static cudaError_t launch_binop(int op, const uint32_t* a, const uint32_t* b, uint32_t* out,
                                uint32_t n, uint32_t b_n, cudaStream_t s) {
  const uint32_t threads = 256;
  const uint32_t blocks = (n + threads - 1) / threads;
  if (op == 0) field_binop_kernel<F, 0><<<blocks, threads, 0, s>>>(a, b, out, n, b_n);
  else if (op == 1) field_binop_kernel<F, 1><<<blocks, threads, 0, s>>>(a, b, out, n, b_n);
  else if (op == 2) field_binop_kernel<F, 2><<<blocks, threads, 0, s>>>(a, b, out, n, b_n);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// Latency probe, on no path: one thread, x = x * b over Fq `steps` times,
// each product waiting on the last. Its time over `steps` is one Montgomery
// product's latency, the unit of the chain bounds of B7, the Horner kernel
// and the fold (chip_smoke.py phase 3).
__global__ void mont_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                  uint32_t* __restrict__ out, long long steps) {
  fe x = fe_load(a);
  const fe y = fe_load(b);
  for (long long i = 0; i < steps; ++i) x = fe_mul<FQ>(x, y);
  fe_store(out, x);
}

}  // namespace zk

extern "C" int zk_mont_chain(const void* a, const void* b, void* out, long long steps,
                             void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  zk::mont_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), steps);
  return (int)cudaGetLastError();
}

// field: 0 = Fq, 1 = Fr; op: 0 = Montgomery product, 1 = add, 2 = subtract
extern "C" int zk_field_binop(int field, int op, const void* a, const void* b, void* out,
                              long long n, long long b_n, void* stream) {
  if (n <= 0) return 0;
  if (n >= (1ll << 31) || b_n <= 0 || b_n > n || n % b_n != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const uint32_t*>(a);
  auto pb = static_cast<const uint32_t*>(b);
  auto po = static_cast<uint32_t*>(out);
  const uint32_t un = (uint32_t)n, ub = (uint32_t)b_n;
  if (field == zk::FQ) return (int)zk::launch_binop<zk::FQ>(op, pa, pb, po, un, ub, s);
  if (field == zk::FR) return (int)zk::launch_binop<zk::FR>(op, pa, pb, po, un, ub, s);
  return (int)cudaErrorInvalidValue;
}
