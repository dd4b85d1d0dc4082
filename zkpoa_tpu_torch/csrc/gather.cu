// Row gathers out[i, :] = tab[idx[i], :] of int32 tables (the MSM stage
// harness, zkpoa_tpu_torch/experiments/msm_stages.py).
//
// Replaces the three Pallas gather kernels of the JAX package's harness,
// experiments/msm_stages.py:
//   E1 `vmem_gather` (pallas_call :91, body `_vmem_gather_kernel` :77): the
//      table resident in VMEM, one dynamic row read per output row, indices
//      in SMEM;
//   E2 `vmem_take` (:110, body :102): the same as one vectorised jnp.take
//      on the VMEM table;
//   E3 `dma_gather` (:150, body :121): one HBM -> VMEM DMA per row through
//      an 8-deep ring of buffers and DMA semaphores.
//
// What bounds them on this card: bytes. Each output row is written once
// (M W 4 bytes), the indices read once (4 M) and each distinct indexed row
// read once (D W 4, D <= min(T, M)), so at 3.35 TB/s a gather of 2^20 rows
// of 64 B is about 30-40 us. E1 and E2 also read the whole table into
// every block's shared memory, T W 4 bytes per block from L2, which is
// more than the rows themselves at the harness's shapes; that
// is the VMEM design carried over, not a way to win on a GPU, whose L2
// already holds a table this small.
//
// Designs:
//   E1 gather_smem_rows: each block stages the table in dynamic shared
//      memory (opt-in above 48 KB, at most 227 KB a block), then one thread
//      per output row copies its row word by word (grid-stride over rows).
//   E2 gather_smem_vec: the same staged table; output rows are written
//      warp-cooperatively, one 16-byte uint4 per lane, so a warp stores 512
//      contiguous bytes per instruction (8 rows of 64 B). Needs W % 4 == 0.
//   E3 gather_async: each warp owns a contiguous range of output rows and
//      an 8-stage ring of row buffers in shared memory. Lane 0 copies row
//      idx[i] into stage i % 8 with a TMA bulk copy (cp.async.bulk) that
//      completes on that stage's mbarrier (the counterpart of
//      make_async_copy and its DMA semaphore); the warp waits for stage i,
//      stores it with 16-byte lanes, and lane 0 starts the copy of row
//      i + 8 into the freed stage. Needs W % 4 == 0 and a 16-byte aligned table.
//
// An index outside [0, T) traps, as torch's own index_select asserts on
// the device. The plain version is `ops/gather.py` `gather_rows_plain`
// (tab.index_select(0, idx)); the results are equal bit for bit. Simple
// correct versions; speed is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace zk {

constexpr int SMEM_THREADS = 256;  // E1/E2 block size
constexpr int RING = 8;            // E3 stages per warp (the TPU's DEPTH)
constexpr int ASYNC_WARPS = 4;     // E3 warps per block

__device__ __forceinline__ void check_row(int r, long long T) {
  if (r < 0 || (long long)r >= T) __trap();
}

// The whole table [T * W words] into this block's shared memory.
__device__ void stage_table(uint4* s4, const uint32_t* __restrict__ tab, long long words) {
  uint32_t* s = reinterpret_cast<uint32_t*>(s4);
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(tab) & 15) == 0) {
    const long long v = words >> 2;
    const uint4* t4 = reinterpret_cast<const uint4*>(tab);
    for (long long k = threadIdx.x; k < v; k += blockDim.x) s4[k] = t4[k];
    done = v << 2;
  }
  for (long long k = done + threadIdx.x; k < words; k += blockDim.x) s[k] = tab[k];
  __syncthreads();
}

__global__ void gather_smem_rows_kernel(const uint32_t* __restrict__ tab,
                                        const int* __restrict__ idx, long long T, int W,
                                        long long M, uint32_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  stage_table(smem, tab, T * W);
  const uint32_t* s = reinterpret_cast<const uint32_t*>(smem);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < M; i += stride) {
    const int r = idx[i];
    check_row(r, T);
    const uint32_t* src = s + (long long)r * W;
    uint32_t* dst = out + i * W;
    for (int k = 0; k < W; ++k) dst[k] = src[k];
  }
}

__global__ void gather_smem_vec_kernel(const uint32_t* __restrict__ tab,
                                       const int* __restrict__ idx, long long T, int W,
                                       long long M, uint4* __restrict__ out) {
  extern __shared__ uint4 smem[];
  stage_table(smem, tab, T * W);
  const int R = W >> 2;  // uint4 per row
  const long long chunks = M * R;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < chunks; c += stride) {
    const long long i = c / R;
    const int part = (int)(c - i * R);
    const int r = idx[i];
    check_row(r, T);
    out[c] = smem[(long long)r * R + part];
  }
}

// --- mbarrier and bulk-copy helpers (PTX, sm_90) -----------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Waits for the phase of `bar` with this parity to complete. A copy that
// never lands (a fault in the ring's bookkeeping) traps after about 2^34
// cycles (~10 s) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - t0 > (1ll << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One row from device memory into a ring stage; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__global__ void gather_async_kernel(const uint32_t* __restrict__ tab, const int* __restrict__ idx,
                                     long long T, int W, long long M, long long rows_per_warp,
                                     uint4* __restrict__ out) {
  extern __shared__ uint4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int R = W >> 2;
  const uint32_t row_bytes = (uint32_t)W * 4;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + warp * RING;
  uint4* ring = smem + ASYNC_WARPS * RING / 2 + (long long)warp * RING * R;
  const long long lo = ((long long)blockIdx.x * ASYNC_WARPS + warp) * rows_per_warp;
  const long long hi = lo + rows_per_warp < M ? lo + rows_per_warp : M;
  if (lo >= hi) return;  // no block-wide barrier below: a warp may leave alone
  if (lane == 0) {
    for (int s = 0; s < RING; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < RING && lo + s < hi; ++s) {
      const int r = idx[lo + s];
      check_row(r, T);
      bulk_load(ring + s * R, tab + (long long)r * W, row_bytes, &bar[s]);
    }
  }
  __syncwarp();
  for (long long i = lo; i < hi; ++i) {
    const long long k = i - lo;
    const int s = (int)(k % RING);
    mbar_wait(&bar[s], (uint32_t)((k / RING) & 1));
    for (int p = lane; p < R; p += 32) out[i * R + p] = ring[s * R + p];
    __syncwarp();  // every lane has read stage s before it is refilled
    if (lane == 0 && i + RING < hi) {
      const int r = idx[i + RING];
      check_row(r, T);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_load(ring + s * R, tab + (long long)r * W, row_bytes, &bar[s]);
    }
  }
}

static int device_attr(cudaDeviceAttr attr, int* value) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(value, attr, dev);
  return (int)err;
}

// Blocks of `kernel` that fill the card once: SMs x resident blocks per SM.
static int resident_blocks(const void* kernel, int threads, size_t smem, long long* blocks) {
  int sms = 0, per_sm = 0;
  int err = device_attr(cudaDevAttrMultiProcessorCount, &sms);
  if (err) return err;
  if (smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
    if (err) return err;
  }
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err) return err;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  *blocks = (long long)sms * per_sm;
  return 0;
}

static int launch_smem(bool vec, const void* tab, const void* idx, long long T, int W, long long M,
                void* out, void* stream) {
  if (M <= 0) return 0;
  if (T <= 0 || W <= 0 || (vec && W % 4 != 0)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)T * W * 4;
  int optin = 0;
  int err = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &optin);
  if (err) return err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  const void* kernel =
      vec ? (const void*)gather_smem_vec_kernel : (const void*)gather_smem_rows_kernel;
  long long fill = 0;
  err = resident_blocks(kernel, SMEM_THREADS, smem, &fill);
  if (err) return err;
  const long long work = vec ? M * (W / 4) : M;
  long long blocks = (work + SMEM_THREADS - 1) / SMEM_THREADS;
  if (blocks > fill) blocks = fill;
  auto s = static_cast<cudaStream_t>(stream);
  auto pt = static_cast<const uint32_t*>(tab);
  auto pi = static_cast<const int*>(idx);
  if (vec)
    gather_smem_vec_kernel<<<(unsigned)blocks, SMEM_THREADS, smem, s>>>(pt, pi, T, W, M,
                                                                        static_cast<uint4*>(out));
  else
    gather_smem_rows_kernel<<<(unsigned)blocks, SMEM_THREADS, smem, s>>>(
        pt, pi, T, W, M, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // namespace zk

// tab [T, W] int32 (read as u32), idx [M] int32 in [0, T), out [M, W].
// E1: the table staged in shared memory, one thread per output row.
extern "C" int zk_gather_smem_rows(const void* tab, const void* idx, long long T, int W,
                                   long long M, void* out, void* stream) {
  return zk::launch_smem(false, tab, idx, T, W, M, out, stream);
}

// E2: the staged table, 16-byte lanes writing whole warps of rows. W % 4 == 0.
extern "C" int zk_gather_smem_vec(const void* tab, const void* idx, long long T, int W,
                                  long long M, void* out, void* stream) {
  return zk::launch_smem(true, tab, idx, T, W, M, out, stream);
}

// E3: per-row TMA bulk copies through an 8-stage ring per warp. W % 4 == 0,
// tab and out 16-byte aligned.
extern "C" int zk_gather_async(const void* tab, const void* idx, long long T, int W, long long M,
                               void* out, void* stream) {
  using namespace zk;
  if (M <= 0) return 0;
  if (T <= 0 || W <= 0 || W % 4 != 0 || (reinterpret_cast<uintptr_t>(tab) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * ASYNC_WARPS;
  const size_t smem = (size_t)ASYNC_WARPS * RING * (8 + (size_t)W * 4);
  int optin = 0;
  int err = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &optin);
  if (err) return err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  long long fill = 0;
  err = resident_blocks((const void*)gather_async_kernel, threads, smem, &fill);
  if (err) return err;
  // spread the rows over every resident warp of the card
  const long long warps = fill * ASYNC_WARPS;
  const long long rows_per_warp = (M + warps - 1) / warps;
  const long long n_warps = (M + rows_per_warp - 1) / rows_per_warp;
  const long long blocks = (n_warps + ASYNC_WARPS - 1) / ASYNC_WARPS;
  gather_async_kernel<<<(unsigned)blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tab), static_cast<const int*>(idx), T, W, M, rows_per_warp,
      static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}
