// Elementwise BN254 point kernels, G1 (over Fq) and G2 (over Fq2):
// unified mixed add, unified full add and doubling in Jacobian coordinates.
//
// Replaces kernels B2, B3 and B4 of the TPU package, the three point
// kernels behind the shared site zkpoa_tpu/ops/pallas_field.py:321
// (`_point_call`):
//   B2 `jac_add_affine_tpu` :333 -> `_k_jac_add_affine` :170
//   B3 `jac_add_tpu`        :362 -> `_k_jac_add` :209
//   B4 `jac_double_tpu`     :386 -> `_k_jac_double` :152
// The TPU versions exist for G1 only (G2 ran as plain XLA); here both
// groups share one template. The TPU computed the doubling beside every
// add and selected it per lane; a thread here branches to it only when
// P == Q.
//
// What bounds it: the SMs' 32-bit multiply-add rate (a G1 mixed add is 11
// field products of 128 wide multiply-adds each; G2 triples that) and
// register pressure, which the G2 formulas push towards the 255-register
// limit (ptxas reports registers and spills at build time). One thread per
// point, no shared memory. Simple correct version; speed is later work.
#include "curve.cuh"

namespace zk {

template <class G>
__global__ void add_kernel(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                           const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                           uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<G> p = jac_load<G>(x1, y1, z1, i);
  Jac<G> q = jac_load<G>(x2, y2, z2, i);
  jac_store<G>(ox, oy, oz, i, jac_add<G>(p, q));
}

template <class G>
__global__ void add_affine_kernel(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                                  const uint32_t* xq, const uint32_t* yq, const uint8_t* valid,
                                  uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<G> p = jac_load<G>(x1, y1, z1, i);
  if (valid[i]) {
    p = jac_add_affine<G>(p, G::load(xq + i * G::WORDS), G::load(yq + i * G::WORDS));
  }
  jac_store<G>(ox, oy, oz, i, p);
}

template <class G>
__global__ void double_kernel(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                              uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  jac_store<G>(ox, oy, oz, i, jac_double<G>(jac_load<G>(x, y, z, i)));
}

static inline long long grid_for(long long n, int threads) { return (n + threads - 1) / threads; }

}  // namespace zk

using u32 = uint32_t;
#define C32(p) static_cast<const u32*>(p)
#define M32(p) static_cast<u32*>(p)

// group: 1 = G1, 2 = G2
extern "C" int zk_point_add(int group, const void* x1, const void* y1, const void* z1,
                            const void* x2, const void* y2, const void* z2, void* ox, void* oy,
                            void* oz, long long n, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int t = 128;
  if (group == 1)
    zk::add_kernel<zk::G1Field><<<zk::grid_for(n, t), t, 0, s>>>(
        C32(x1), C32(y1), C32(z1), C32(x2), C32(y2), C32(z2), M32(ox), M32(oy), M32(oz), n);
  else if (group == 2)
    zk::add_kernel<zk::G2Field><<<zk::grid_for(n, t), t, 0, s>>>(
        C32(x1), C32(y1), C32(z1), C32(x2), C32(y2), C32(z2), M32(ox), M32(oy), M32(oz), n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int zk_point_add_affine(int group, const void* x1, const void* y1, const void* z1,
                                   const void* xq, const void* yq, const void* valid, void* ox,
                                   void* oy, void* oz, long long n, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const uint8_t*>(valid);
  const int t = 128;
  if (group == 1)
    zk::add_affine_kernel<zk::G1Field><<<zk::grid_for(n, t), t, 0, s>>>(
        C32(x1), C32(y1), C32(z1), C32(xq), C32(yq), v, M32(ox), M32(oy), M32(oz), n);
  else if (group == 2)
    zk::add_affine_kernel<zk::G2Field><<<zk::grid_for(n, t), t, 0, s>>>(
        C32(x1), C32(y1), C32(z1), C32(xq), C32(yq), v, M32(ox), M32(oy), M32(oz), n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int zk_point_double(int group, const void* x, const void* y, const void* z, void* ox,
                               void* oy, void* oz, long long n, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int t = 128;
  if (group == 1)
    zk::double_kernel<zk::G1Field><<<zk::grid_for(n, t), t, 0, s>>>(
        C32(x), C32(y), C32(z), M32(ox), M32(oy), M32(oz), n);
  else if (group == 2)
    zk::double_kernel<zk::G2Field><<<zk::grid_for(n, t), t, 0, s>>>(
        C32(x), C32(y), C32(z), M32(ox), M32(oy), M32(oz), n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
