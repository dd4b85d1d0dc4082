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
// of 64 B is about 30-40 us. A table of the harness's E1/E2 size (2^11-2^13
// rows of 64 B) sits in the 50 MB L2, which gives the VMEM residency the
// TPU kernels arrange: E1 and E2 read the table where it lies.
//
// Designs:
//   E1 gather_rows: no staging, any row width W and any table size. A warp
//      takes SR = max(1, 32 ROWS_LOADS / R) consecutive output rows a step,
//      where a row is R pieces: 16-byte pieces (R = W / 4) when W % 4 == 0
//      and the table and output are 16-byte aligned, else 4-byte words
//      (R = W). The step's SR R pieces are contiguous in `out`, and lane l
//      moves pieces l, l + 32, ...: piece u is piece u % R of row u / R, read
//      through the read-only path from the row its index names (lanes on one
//      row read one index), ROWS_LOADS loads issued before their streaming
//      stores. So every warp store is 32 consecutive pieces, whatever W.
//   E2 gather_vec: no staging. A warp takes 32 K output rows a step (K = 1
//      for rows of 16 words or more, 2 or 4 for narrower rows, so that a
//      lane has at least 4 loads a step): each lane reads K of the step's
//      indices (coalesced) and checks them, and __shfl_sync hands each
//      index to the lanes that copy its row. A lane issues VEC_LOADS
//      independent 16-byte loads through the read-only path (ld.global.nc:
//      the table is cache-resident) before it stores them; consecutive lanes
//      store consecutive 16 bytes of the step's contiguous output, with the
//      streaming hint (st.global.cs) so the output does not evict the table
//      from L2. Needs W % 4 == 0 and a 16-byte aligned table.
//   E3 gather_async: stages of S = 32 rows through the copy engine (TMA
//      bulk copies). A stage is S consecutive output rows; each warp walks
//      the stages s = warp, warp + warps, ... through a ring of `depth`
//      stages in shared memory. Loading a stage: lane l < S reads
//      idx[S s + l] (coalesced), checks it and issues the cp.async.bulk of
//      that row into slot l; all the stage's copies complete on one
//      mbarrier, armed once by lane 0 with expect_tx = rows x row bytes (a
//      partial last stage arms the rows it holds). Writing a stage: its rows
//      are contiguous in `out`, so lane 0 stores the whole stage with one
//      cp.async.bulk.global.shared::cta.bulk_group (2 KB at W = 16, 16 KB at
//      W = 128) and commits it as a bulk group; the slot of the previous
//      stage is refilled once `cp.async.bulk.wait_group.read 1` says its
//      store has read it. The ring holds at least 16 KB of loads a warp in
//      flight (depth = 16 KB / stage bytes + 1, 2 to 8 stages), so every SM
//      keeps more than the ~26 KB that Little's law asks for (3.35 TB/s x
//      ~1 us of latency over 132 SMs). Rows of up to 224 words fit 4 warps
//      a block with 32-row stages; wider rows take fewer warps a block (down
//      to 1), then fewer rows a stage (down to 1), so a two-stage ring fits
//      the block's shared memory up to rows of 29052 words (`async_plan`).
//      The grid comes from the work: one warp a stage up to the card's
//      resident warps, which then walk several stages each. Bulk stores
//      measured equal to or 6-7 % faster than a warp's 16-byte register
//      stores at both harness shapes, so they are the one path. Needs
//      W % 4 == 0 and a 16-byte aligned table and output.
//
// Launch path: the card's SM count and shared-memory limits, and each
// kernel's registers, are read once per device (std::call_once), and the
// dynamic shared-memory opt-in of E3 is set then to the card's limit.
// Blocks per SM come from those numbers without a runtime call, so a later
// call makes cudaGetDevice (to pick the cached entry), the launch and
// cudaGetLastError, and no other CUDA runtime call.
//
// An index outside [0, T) traps, as torch's own index_select asserts on
// the device. The plain version is `ops/gather.py` `gather_rows_plain`
// (tab.index_select(0, idx)); the results are equal bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace zk {

constexpr int ROWS_THREADS = 128;  // E1 block size
constexpr int ROWS_LOADS = 4;      // E1 loads a lane issues before its stores
constexpr int VEC_THREADS = 128;   // E2 block size
constexpr int VEC_LOADS = 4;       // E2 16-byte loads a lane issues before its stores
constexpr int ASYNC_WARPS = 4;     // E3 most warps per block
constexpr int STAGE_ROWS = 32;     // E3 most rows a stage: one per lane
constexpr int RING_BYTES = 16384;  // E3 bytes of loads a warp keeps in flight, at least
constexpr int RING_MAX = 8;        // E3 most stages a ring

__device__ __forceinline__ void check_row(int r, long long T) {
  if (r < 0 || (long long)r >= T) __trap();
}

// --- E1 ------------------------------------------------------------------------

// V: uint4 (16-byte pieces) or uint32_t (words); R pieces a row, SR rows a
// warp step.
template <typename V>
__global__ void __launch_bounds__(ROWS_THREADS)
    gather_rows_kernel(const V* __restrict__ tab, const int* __restrict__ idx, long long T, int R,
                       int SR, long long M, V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * ROWS_THREADS + threadIdx.x) >> 5;
  const long long warps = (long long)gridDim.x * (ROWS_THREADS / 32);
  for (long long base = warp * SR; base < M; base += warps * SR) {
    const int n = (M - base < SR ? (int)(M - base) : SR) * R;  // pieces this step
    V* dst = out + base * R;
    for (int u0 = 0; u0 < n; u0 += 32 * ROWS_LOADS) {
      V v[ROWS_LOADS];
#pragma unroll
      for (int t = 0; t < ROWS_LOADS; ++t) {
        const int u = u0 + 32 * t + lane;
        if (u < n) {
          const int i = u / R;
          const int r = __ldg(idx + base + i);
          check_row(r, T);
          v[t] = __ldg(tab + (long long)r * R + (u - i * R));
        }
      }
#pragma unroll
      for (int t = 0; t < ROWS_LOADS; ++t) {
        const int u = u0 + 32 * t + lane;
        if (u < n) __stcs(dst + u, v[t]);
      }
    }
  }
}

// --- E2 ------------------------------------------------------------------------

// RC: 16-byte pieces a row when known at compile time (4: W = 16), else 0
// and r_arg. Item j of a lane in a step is piece c = 32 j + lane of the
// step's output, row c / R; that row's index sits in register j / R of lane
// (c / R) % 32, and j / R is the same on every lane (32 (j % R) + lane <
// 32 R), so one shuffle with a warp-uniform register fetches it.
template <int RC>
__global__ void __launch_bounds__(VEC_THREADS)
    gather_vec_kernel(const uint4* __restrict__ tab, const int* __restrict__ idx, long long T,
                      int r_arg, int K, long long M, uint4* __restrict__ out) {
  const int R = RC ? RC : r_arg;
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * VEC_THREADS + threadIdx.x) >> 5;
  const long long warps = (long long)gridDim.x * (VEC_THREADS / 32);
  const int rows = 32 * K;
  const int items = K * R;  // pieces a lane moves a step
  for (long long base = warp * rows; base < M; base += warps * rows) {
    int held[4] = {0, 0, 0, 0};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const long long i = base + 32 * t + lane;
      if (t < K && i < M) {
        held[t] = __ldg(idx + i);
        check_row(held[t], T);
      }
    }
    uint4* dst = out + base * R;
    for (int j0 = 0; j0 < items; j0 += VEC_LOADS) {
      uint4 v[VEC_LOADS];
#pragma unroll
      for (int u = 0; u < VEC_LOADS; ++u) {
        const int j = j0 + u, c = 32 * j + lane, r = c / R, t = j / R;
        const int mine = t == 0 ? held[0] : t == 1 ? held[1] : t == 2 ? held[2] : held[3];
        const int row = __shfl_sync(0xffffffffu, mine, r & 31);
        if (j < items && base + r < M) v[u] = __ldg(tab + (long long)row * R + (c - r * R));
      }
#pragma unroll
      for (int u = 0; u < VEC_LOADS; ++u) {
        const int j = j0 + u, c = 32 * j + lane, r = c / R;
        if (j < items && base + r < M) __stcs(dst + c, v[u]);
      }
    }
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

// The one arrival of a stage's phase, with the bytes its copies will bring.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One row from device memory into a stage slot; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A whole stage from shared to device memory, as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// Orders this thread's view of shared memory (generic proxy) before later
// bulk copies (async proxy) that touch it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- E3 ------------------------------------------------------------------------

// Stage s of the output (rows S s ...) into `slot`, completing on `bar`.
// The arrival comes before the copies (a __syncwarp between), so the phase
// cannot complete on part of the bytes.
__device__ __forceinline__ void load_stage(const uint32_t* __restrict__ tab,
                                           const int* __restrict__ idx, long long T, int W,
                                           long long M, int S, long long s, uint4* slot,
                                           uint64_t* bar, int lane) {
  const long long base = s * S;
  const long long left = M - base;
  const int rows = left < S ? (int)left : S;
  const uint32_t row_bytes = (uint32_t)W * 4;
  int r = 0;
  if (lane < rows) {
    r = idx[base + lane];
    check_row(r, T);
  }
  if (lane == 0) mbar_expect(bar, (uint32_t)rows * row_bytes);
  __syncwarp();
  if (lane < rows) bulk_load(slot + lane * (W >> 2), tab + (long long)r * W, row_bytes, bar);
}

// S rows a stage (at most 32), blockDim.x / 32 warps a block. Shared
// memory: [warps][depth] mbarriers (rounded up to 16 bytes), then
// [warps][depth] stages of S rows.
__global__ void __launch_bounds__(ASYNC_WARPS * 32)
    gather_async_kernel(const uint32_t* __restrict__ tab, const int* __restrict__ idx, long long T,
                        int W, long long M, int S, int depth, uint4* __restrict__ out) {
  extern __shared__ uint4 smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int R = W >> 2;
  const int stage_pieces = S * R;
  const long long stages = (M + S - 1) / S;
  const long long first = (long long)blockIdx.x * warps + warp;
  const long long stride = (long long)gridDim.x * warps;
  if (first >= stages) return;  // no block-wide barrier below: a warp may leave alone
  const long long mine = (stages - first + stride - 1) / stride;  // stages first + k stride
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + warp * depth;
  uint4* ring = smem + (warps * depth + 1) / 2 + (long long)warp * depth * stage_pieces;
  if (lane == 0) {
    for (int s = 0; s < depth; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  for (int k = 0; k < depth && k < mine; ++k)
    load_stage(tab, idx, T, W, M, S, first + k * stride, ring + k * stage_pieces, &bar[k], lane);
  for (long long k = 0; k < mine; ++k) {
    const int slot = (int)(k % depth);
    const long long base = (first + k * stride) * S;
    const long long left = M - base;
    const int rows = left < S ? (int)left : S;
    mbar_wait(&bar[slot], (uint32_t)((k / depth) & 1));
    // The stage was written by the async proxy and its completion observed
    // through the mbarrier; the fence orders that before the store's read.
    if (lane == 0) {
      fence_proxy_async();
      bulk_store(out + base * R, ring + slot * stage_pieces, (uint32_t)rows * R * 16);
    }
    // Refill the previous stage's slot once its store (one bulk group back)
    // has read it: lane 0 waits, the __syncwarp in load_stage releases the
    // other lanes' copies after that wait.
    const long long prev = k - 1;
    if (prev >= 0 && prev + depth < mine) {
      if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load_stage(tab, idx, T, W, M, S, first + (prev + depth) * stride,
                 ring + (int)(prev % depth) * stage_pieces, &bar[prev % depth], lane);
    }
  }
  // the stores must have read shared memory, and landed, before the block exits
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// E3's layout for rows of W words under `optin` bytes of shared memory a
// block: 4 warps a block and 32-row stages where a ring of them fits (W up
// to 224), else fewer warps (down to 1), then fewer rows a stage (down to
// 1). Mirrored by ops/gather.py `async_plan`.
struct AsyncPlan {
  int warps, rows, depth;
  size_t smem;
};

static AsyncPlan async_plan(int W, size_t optin) {
  AsyncPlan p{ASYNC_WARPS, STAGE_ROWS, 0, 0};
  for (;;) {
    const size_t stage = (size_t)p.rows * W * 4;
    const size_t d = (RING_BYTES + stage - 1) / stage + 1;
    p.depth = d < 2 ? 2 : d > RING_MAX ? RING_MAX : (int)d;
    p.smem = ((size_t)p.warps * p.depth + 1) / 2 * 16 + (size_t)p.warps * p.depth * stage;
    if (p.smem <= optin || (p.warps == 1 && p.rows == 1)) return p;
    if (p.warps > 1)
      p.warps /= 2;
    else
      p.rows /= 2;
  }
}

// --- the launch path: queried once per device -----------------------------------

enum Kernel { ROWS16, ROWS4, VEC4, VEC, ASYNC, N_KERNELS };

const void* const KERNEL_FN[N_KERNELS] = {
    (const void*)gather_rows_kernel<uint4>, (const void*)gather_rows_kernel<uint32_t>,
    (const void*)gather_vec_kernel<4>,      (const void*)gather_vec_kernel<0>,
    (const void*)gather_async_kernel,
};

struct GatherDevice {
  int err;  // the first call's error, returned by every later call
  int sms, optin, smem_per_sm, reserved, threads_per_sm, blocks_per_sm, regs_per_sm;
  int regs[N_KERNELS];  // registers a thread of each kernel
};

constexpr int MAX_DEVICES = 64;
static GatherDevice g_device[MAX_DEVICES];
static std::once_flag g_once[MAX_DEVICES];

static int query(int dev, GatherDevice* d) {
  const struct {
    cudaDeviceAttr attr;
    int* value;
  } attrs[] = {
      {cudaDevAttrMultiProcessorCount, &d->sms},
      {cudaDevAttrMaxSharedMemoryPerBlockOptin, &d->optin},
      {cudaDevAttrMaxSharedMemoryPerMultiprocessor, &d->smem_per_sm},
      {cudaDevAttrReservedSharedMemoryPerBlock, &d->reserved},
      {cudaDevAttrMaxThreadsPerMultiProcessor, &d->threads_per_sm},
      {cudaDevAttrMaxBlocksPerMultiprocessor, &d->blocks_per_sm},
      {cudaDevAttrMaxRegistersPerMultiprocessor, &d->regs_per_sm},
  };
  for (const auto& a : attrs) {
    const cudaError_t err = cudaDeviceGetAttribute(a.value, a.attr, dev);
    if (err != cudaSuccess) return (int)err;
  }
  for (int k = 0; k < N_KERNELS; ++k) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, KERNEL_FN[k]);
    if (err == cudaSuccess && k == ASYNC)
      err = cudaFuncSetAttribute(KERNEL_FN[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 d->optin);
    if (err != cudaSuccess) return (int)err;
    d->regs[k] = fa.numRegs;
  }
  return 0;
}

// The cached entry of the current device (queried on its first use).
static int device(const GatherDevice** out) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  std::call_once(g_once[dev], [dev] { g_device[dev].err = query(dev, &g_device[dev]); });
  *out = &g_device[dev];
  return g_device[dev].err;
}

// Blocks of kernel k resident on the card with `threads` threads and `smem`
// dynamic bytes each, by threads, blocks, registers (256 a warp at a time)
// and shared memory; at least 1 a SM (a launch that cannot fit is refused
// by the launch itself).
static long long fill(const GatherDevice& d, Kernel k, int threads, size_t smem) {
  const int warp_regs = (d.regs[k] * 32 + 255) / 256 * 256;
  long long n = d.threads_per_sm / threads;
  if (n > d.blocks_per_sm) n = d.blocks_per_sm;
  if (warp_regs > 0 && d.regs_per_sm / (warp_regs * (threads / 32)) < n)
    n = d.regs_per_sm / (warp_regs * (threads / 32));
  if (smem > 0 && (long long)(d.smem_per_sm / (smem + d.reserved)) < n)
    n = (long long)(d.smem_per_sm / (smem + d.reserved));
  return (long long)d.sms * (n > 0 ? n : 1);
}

static long long min_ll(long long a, long long b) { return a < b ? a : b; }

}  // namespace zk

// tab [T, W] int32 (read as u32), idx [M] int32 in [0, T), out [M, W].
// E1: a warp a step of contiguous output rows, lanes across the step's
// pieces; 16-byte pieces where W and both pointers allow, else words.
extern "C" int zk_gather_rows(const void* tab, const void* idx, long long T, int W, long long M,
                              void* out, void* stream) {
  using namespace zk;
  if (M <= 0) return 0;
  if (T <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const GatherDevice* d = nullptr;
  const int err = device(&d);
  if (err) return err;
  const bool vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(tab) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int R = vec ? W / 4 : W;
  const int SR = R >= 32 * ROWS_LOADS ? 1 : 32 * ROWS_LOADS / R;
  const long long warps = (M + SR - 1) / SR;
  const long long blocks = min_ll((warps + ROWS_THREADS / 32 - 1) / (ROWS_THREADS / 32),
                                  fill(*d, vec ? ROWS16 : ROWS4, ROWS_THREADS, 0));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    gather_rows_kernel<uint4><<<(unsigned)blocks, ROWS_THREADS, 0, st>>>(
        static_cast<const uint4*>(tab), static_cast<const int*>(idx), T, R, SR, M,
        static_cast<uint4*>(out));
  else
    gather_rows_kernel<uint32_t><<<(unsigned)blocks, ROWS_THREADS, 0, st>>>(
        static_cast<const uint32_t*>(tab), static_cast<const int*>(idx), T, R, SR, M,
        static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// E2: a vector gather from the cache-resident table. W % 4 == 0, tab and
// out 16-byte aligned.
extern "C" int zk_gather_vec(const void* tab, const void* idx, long long T, int W, long long M,
                             void* out, void* stream) {
  using namespace zk;
  if (M <= 0) return 0;
  if (T <= 0 || W <= 0 || W % 4 != 0 || (reinterpret_cast<uintptr_t>(tab) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  const GatherDevice* d = nullptr;
  const int err = device(&d);
  if (err) return err;
  const int R = W / 4;
  const int K = R >= VEC_LOADS ? 1 : (VEC_LOADS + R - 1) / R;
  const Kernel k = R == 4 ? VEC4 : VEC;
  const long long warps = (M + 32 * K - 1) / (32 * K);
  const long long blocks =
      min_ll((warps + VEC_THREADS / 32 - 1) / (VEC_THREADS / 32), fill(*d, k, VEC_THREADS, 0));
  void (*kernel)(const uint4*, const int*, long long, int, int, long long, uint4*) =
      k == VEC4 ? gather_vec_kernel<4> : gather_vec_kernel<0>;
  kernel<<<(unsigned)blocks, VEC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(tab), static_cast<const int*>(idx), T, R, K, M,
      static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

// E3: stages of up to 32 rows by TMA bulk copies through a ring per warp,
// each stage written back by one bulk store. W % 4 == 0, tab and out
// 16-byte aligned.
extern "C" int zk_gather_async(const void* tab, const void* idx, long long T, int W, long long M,
                               void* out, void* stream) {
  using namespace zk;
  if (M <= 0) return 0;
  if (T <= 0 || W <= 0 || W % 4 != 0 || (reinterpret_cast<uintptr_t>(tab) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  const GatherDevice* d = nullptr;
  const int err = device(&d);
  if (err) return err;
  const AsyncPlan p = async_plan(W, (size_t)d->optin);
  if (p.smem > (size_t)d->optin) return (int)cudaErrorInvalidValue;
  // one warp a stage, up to the warps resident on the card
  const long long stages = (M + p.rows - 1) / p.rows;
  const long long warps = min_ll(stages, fill(*d, ASYNC, 32 * p.warps, p.smem) * p.warps);
  const long long blocks = (warps + p.warps - 1) / p.warps;
  gather_async_kernel<<<(unsigned)blocks, 32 * p.warps, p.smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tab), static_cast<const int*>(idx), T, W, M, p.rows, p.depth,
      static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}
