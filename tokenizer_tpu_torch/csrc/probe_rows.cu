// Pair-table probe through [n_rows, 128] planes, two ways, for Hopper (sm_90a).
// Plain C interface for ctypes.
//
// Replaces, on the card, two Pallas probe experiments of the JAX package:
//   K3 tokenizer_tpu/ops/exp_pallas_dma.py  probe_pallas_dma  -> _dma_kernel   (row DMA)
//   K4 tokenizer_tpu/ops/exp_pallas_dma.py  probe_pallas_vmem -> _vmem_kernel  (resident rows)
// Both compute PairTable.lookup: slot s of the table lives at plane[s >> 7][s & 127]
// of the three planes key_left, key_right, values (table_planes_2d); a probe
// hashes (left, right) to its home slot and walks max_probes slots, comparing
// the full key, stopping at an empty slot (key_left == -1).  Like the Pallas
// kernels, both run all max_probes rounds (a hit or an empty slot only stops
// the updates), so each round moves a whole row of each plane, as the
// symmetric comparison of the experiment asks (exp_pallas_dma.py:226-232).
//
// What bounds them: a round moves three 512-byte rows (1.5 KB) to use 12
// bytes, and the rounds of one pair form a dependent chain of max_probes
// row reads (9 for gpt2, 12 for cl100k_synth).  The tables (6.3 and 12.6 MB)
// fit in the H100's 50 MB L2, so the chain's latency, not DRAM bandwidth,
// sets the time.  The design spends one warp per pair, so that a row is one
// coalesced 512-byte transfer, and keeps many warps in flight to hide the
// chain.
//
// K3 tt_probe_rows_async, the counterpart of make_async_copy + DMA semaphore:
// each round, lane 0 of the warp issues three bulk asynchronous copies
// (cp.async.bulk, the Tensor Memory Accelerator's 1-D form) of the rows from
// global into the warp's shared-memory slot, completing on the warp's
// mbarrier with a 1,536-byte transaction count; the warp waits on the
// barrier's phase and reads the lane from shared memory.
//
// K4 tt_probe_rows_resident: the level of an H100 that can hold a 6-13 MB
// table next to the SMs is L2, not shared memory (227 KB a block), so the
// launch carries an access-policy window that marks the three planes
// persisting (cudaLaunchKernelEx + cudaLaunchAttributeAccessPolicyWindow;
// the stream's own attributes are left alone).  The window holds only within
// the set-aside that tt_l2_persist_set reserves.  Measured on one H100 80GB
// HBM3 (700 W limit) with 256 MB of other traffic between calls, the
// set-aside keeps the table: gpt2's [16, 128] tile took 5.0 us of device
// time with it and 6.5 us without (3.8 us warm).  Each row is read as one
// warp-coalesced int4 load, lane i holding slots 4i..4i+3, and the pair's
// lane is resolved with __shfl_sync: the warp form of the vreg-local
// _lane_select.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRank = 0x7FFFFFFF;
constexpr int kLanes = 128;         // slots per row
constexpr int kWarpsPerBlock = 8;   // one pair per warp
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr unsigned kRowBytes = kLanes * sizeof(int);

__device__ __forceinline__ uint32_t home_slot(int left, int right, int slot_bits) {
  uint32_t h = ((uint32_t)left * 0x85EBCA6Bu) ^ ((uint32_t)right * 0xC2B2AE35u);
  h ^= h >> 16;
  return (h * 0x9E3779B9u) >> (32 - slot_bits);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bulk_row_copy(void* dst, const void* src, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(kRowBytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the barrier's phase of this parity to complete.  A copy that
// never lands traps (an error the launch's caller sees) instead of hanging.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

__global__ void __launch_bounds__(kThreads)
    probe_rows_async_kernel(const int* __restrict__ kl, const int* __restrict__ kr,
                            const int* __restrict__ vv, int slot_bits, int max_probes,
                            const int* __restrict__ left, const int* __restrict__ right,
                            int* __restrict__ out, long long n) {
  __shared__ alignas(128) int rows[kWarpsPerBlock][3][kLanes];
  __shared__ alignas(8) uint64_t bars[kWarpsPerBlock];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long e = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (e >= n) return;  // whole warps leave; no block-wide barrier follows
  uint64_t* bar = &bars[warp];
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  const int l = left[e], r = right[e];
  const bool valid = l >= 0 && r >= 0;
  uint32_t slot = home_slot(valid ? l : 0, valid ? r : 0, slot_bits);
  const uint32_t mask = (1u << slot_bits) - 1u;
  bool live = valid;
  int res = kMaxRank;
  for (int p = 0; p < max_probes; ++p) {
    const size_t row = (size_t)(slot >> 7) * kLanes;
    if (lane == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_addr(bar)), "r"(3 * kRowBytes) : "memory");
      bulk_row_copy(rows[warp][0], kl + row, bar);
      bulk_row_copy(rows[warp][1], kr + row, bar);
      bulk_row_copy(rows[warp][2], vv + row, bar);
    }
    wait_phase(bar, (uint32_t)(p & 1));
    const int t = slot & (kLanes - 1);
    const int k_l = rows[warp][0][t], k_r = rows[warp][1][t];
    const bool hit = live && k_l == l && k_r == r;
    if (hit) res = rows[warp][2][t];
    live = live && k_l != -1 && !hit;
    slot = (slot + 1u) & mask;
    __syncwarp();  // every lane has read the slot before the next round overwrites it
  }
  if (lane == 0) out[e] = res;
}

__device__ __forceinline__ int lane_of(const int4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// One int4 per lane covers the 512-byte row; slot t sits in lane t >> 2,
// component t & 3.
__device__ __forceinline__ int row_select(const int* __restrict__ plane, size_t row,
                                          int lane, int t) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(plane + row) + lane);
  return __shfl_sync(0xFFFFFFFFu, lane_of(v, t & 3), t >> 2);
}

__global__ void __launch_bounds__(kThreads)
    probe_rows_resident_kernel(const int* __restrict__ kl, const int* __restrict__ kr,
                               const int* __restrict__ vv, int slot_bits, int max_probes,
                               const int* __restrict__ left, const int* __restrict__ right,
                               int* __restrict__ out, long long n) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long e = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (e >= n) return;
  const int l = left[e], r = right[e];
  const bool valid = l >= 0 && r >= 0;
  uint32_t slot = home_slot(valid ? l : 0, valid ? r : 0, slot_bits);
  const uint32_t mask = (1u << slot_bits) - 1u;
  bool live = valid;
  int res = kMaxRank;
  for (int p = 0; p < max_probes; ++p) {
    const size_t row = (size_t)(slot >> 7) * kLanes;
    const int t = slot & (kLanes - 1);
    const int k_l = row_select(kl, row, lane, t);
    const int k_r = row_select(kr, row, lane, t);
    const int v = row_select(vv, row, lane, t);
    const bool hit = live && k_l == l && k_r == r;
    if (hit) res = v;
    live = live && k_l != -1 && !hit;
    slot = (slot + 1u) & mask;
  }
  if (lane == 0) out[e] = res;
}

bool bad_args(int slot_bits, int max_probes, long long n) {
  return n <= 0 || slot_bits < 7 || slot_bits > 31 || max_probes < 1;
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

// K3: probe n pairs on `stream`, three bulk row copies per round.  Every
// plane must be 16-byte aligned (cp.async.bulk's rule); the wrapper checks.
int tt_probe_rows_async(const int* kl, const int* kr, const int* vv, int slot_bits,
                        int max_probes, const int* left, const int* right, int* out,
                        long long n, void* stream) {
  if (bad_args(slot_bits, max_probes, n)) return (int)cudaErrorInvalidValue;
  probe_rows_async_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      kl, kr, vv, slot_bits, max_probes, left, right, out, n);
  return (int)cudaGetLastError();
}

// K4: probe n pairs on `stream` with [window, window + window_bytes) marked
// persisting in L2 for this launch.  The hit ratio is the share of the
// window that the current set-aside (cudaLimitPersistingL2CacheSize) holds;
// with no set-aside the window is a no-op and the rows come from L2 as usual.
int tt_probe_rows_resident(const int* kl, const int* kr, const int* vv, int slot_bits,
                           int max_probes, const int* left, const int* right, int* out,
                           long long n, const void* window, size_t window_bytes,
                           void* stream) {
  if (bad_args(slot_bits, max_probes, n)) return (int)cudaErrorInvalidValue;
  int dev = 0, max_window = 0;
  size_t set_aside = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize, dev);
  if (err == cudaSuccess) err = cudaDeviceGetLimit(&set_aside, cudaLimitPersistingL2CacheSize);
  if (err != cudaSuccess) return (int)err;
  if (window_bytes > (size_t)max_window) window_bytes = (size_t)max_window;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeAccessPolicyWindow;
  attr[0].val.accessPolicyWindow.base_ptr = const_cast<void*>(window);
  attr[0].val.accessPolicyWindow.num_bytes = window_bytes;
  attr[0].val.accessPolicyWindow.hitRatio =
      window_bytes == 0 ? 0.0f
                        : (set_aside >= window_bytes ? 1.0f
                                                     : (float)set_aside / (float)window_bytes);
  attr[0].val.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
  attr[0].val.accessPolicyWindow.missProp = cudaAccessPropertyNormal;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_for(n));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, probe_rows_resident_kernel, kl, kr, vv, slot_bits,
                           max_probes, left, right, out, n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The device's limits for K4: the largest L2 set-aside for persisting
// accesses, the largest access-policy window, and the set-aside now
// reserved, in bytes.
int tt_l2_persist_attrs(int* max_persisting_bytes, int* max_window_bytes,
                        size_t* set_aside_bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_persisting_bytes, cudaDevAttrMaxPersistingL2CacheSize, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_window_bytes, cudaDevAttrMaxAccessPolicyWindowSize, dev);
  if (err == cudaSuccess) err = cudaDeviceGetLimit(set_aside_bytes, cudaLimitPersistingL2CacheSize);
  return (int)err;
}

// Reserve min(bytes, the device's maximum) of L2 for persisting accesses.
// The limit is device-wide: it holds for every later kernel until it is
// set again.
int tt_l2_persist_set(size_t bytes) {
  int max_persisting = 0, max_window = 0;
  size_t set_aside = 0;
  int rc = tt_l2_persist_attrs(&max_persisting, &max_window, &set_aside);
  if (rc != 0) return rc;
  if (bytes > (size_t)max_persisting) bytes = (size_t)max_persisting;
  return (int)cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, bytes);
}

// Demote every persisting line in L2 to normal.
int tt_l2_persist_reset(void) { return (int)cudaCtxResetPersistingL2Cache(); }

}  // extern "C"
