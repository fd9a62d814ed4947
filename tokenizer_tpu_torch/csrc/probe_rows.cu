// Pair-table probe through [n_rows, 128] planes, two ways, for Hopper (sm_90a).
// Plain C interface for ctypes.
//
// Replaces, on the card, two Pallas probe experiments of the JAX package:
//   K3 tokenizer_tpu/ops/exp_pallas_dma.py  probe_pallas_dma  -> _dma_kernel   (row DMA)
//   K4 tokenizer_tpu/ops/exp_pallas_dma.py  probe_pallas_vmem -> _vmem_kernel  (resident rows)
// Both compute PairTable.lookup: slot s of the table lives at plane[s >> 7][s & 127]
// of the three planes key_left, key_right, values (table_planes_2d); a probe
// hashes (left, right) to its home slot and walks max_probes slots, comparing
// the full key, stopping at an empty slot (key_left == -1).
//
// What bounds them: the tables (6.3, 12.6 and 25.2 MB) fit in the H100's
// 50 MB L2, and a pair needs 1.17-1.18 rounds on average, so the bytes a
// lookup must move are a few per pair and the time is set by how many L2
// round trips a pair waits for.  The Pallas kernels, and this file's first
// version, moved a whole 512-byte row of each plane per round (the smallest
// unit a TPU DMA or pl.ds slice moves) and waited for each round before the
// next: a chain of max_probes dependent row reads.  Nothing on Hopper needs
// that.  Slot home + p is known before any load, so the whole chain,
// home .. home + max_probes - 1, is one span of at most 16 slots (two, when
// it wraps past the last slot), and both kernels fetch it in one round trip.
//
// The window of a pass (pass_window, the same arithmetic as
// ops/probe_cuda.py probe_windows): a pass covers kPassRounds = 16 rounds
// (PairTable.build keeps max_probes <= 16 below 2^26 slots, so one pass
// serves every table the port builds); its slots are rounded out to 16
// bytes, start down to a multiple of 4 slots, end up, giving at most
// kWindow = 20 slots (80 bytes) of each plane; a chain that wraps takes its
// tail from slot 0 as a second span.  A longer max_probes takes further
// passes for the pairs whose chain has not ended, never a wrong id.
//
// K3 tt_probe_rows_async, the counterpart of make_async_copy + DMA semaphore:
// each lane of a warp owns one pair and issues its three (six, on a wrap)
// window copies itself as bulk asynchronous copies (cp.async.bulk, the
// Tensor Memory Accelerator's 1-D form) from global into its slot of the
// warp's shared-memory stage, completing on the stage's mbarrier.  The
// barrier counts 32 arrivals, each lane arriving with its own byte count,
// so 32 pairs share one barrier and one wait per pass.  The lane then walks
// its window in round order: the first empty slot ends the chain with a
// miss, the first slot holding the key gives the id.  A persistent grid
// walks the pairs 32 at a time through a ring of two stages per warp, so
// the next group's copies are in flight while the current group resolves.
// Measured with tools/rows_ab.py on one H100 80GB HBM3 (700 W limit), its
// time at 131,072 pairs follows the count of bulk copies (three a pair),
// not their bytes: a variant copying only key_left's window took 9.8 us
// against 14.4 us, while more warps in flight or no ring changed nothing.
//
// K4 tt_probe_rows_resident: the level of an H100 that can hold a 6-25 MB
// table next to the SMs is L2, not shared memory (227 KB a block), so the
// launch carries an access-policy window that marks the three planes
// persisting (cudaLaunchKernelEx + cudaLaunchAttributeAccessPolicyWindow;
// the stream's own attributes are left alone).  The window holds only within
// the set-aside that tt_l2_persist_set reserves.  Measured on one H100 80GB
// HBM3 (700 W limit) with 256 MB of other traffic between calls, the
// set-aside kept the table for the first version of this kernel: gpt2's
// [16, 128] tile took 5.0 us of device time with it and 6.5 us without.
// A half-warp serves one pair, one lane per round: each lane loads slot
// home + p of the three planes, all rounds' loads issued before the first
// compare and coalesced within the window, and __ballot_sync finds the
// first round that is empty or a hit; that lane's answer is shuffled to the
// others.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRank = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kPassRounds = 16;      // probe rounds one pass covers
constexpr int kWindow = 20;          // slots of a plane one pass copies for a pair
constexpr int kStages = 2;           // K3's ring, per warp
constexpr int kAsyncWarps = 2;       // K3 warps per block (30 KB of stages)
constexpr int kAsyncThreads = 32 * kAsyncWarps;
constexpr int kResidentThreads = 256;  // K4: 16 pairs per block, a half-warp each

__device__ __forceinline__ uint32_t home_slot(int left, int right, int slot_bits) {
  uint32_t h = ((uint32_t)left * 0x85EBCA6Bu) ^ ((uint32_t)right * 0xC2B2AE35u);
  h ^= h >> 16;
  return (h * 0x9E3779B9u) >> (32 - slot_bits);
}

__host__ __device__ constexpr int passes_for(int max_probes) {
  return max_probes / kPassRounds + (max_probes % kPassRounds != 0);
}

// Pass k of a chain from `home`: its rounds, and the slots that cover them,
// [start, start + len1) and, on a wrap, [0, len2); round k * 16 + i sits at
// index off + i of the two spans laid end to end.  Starts and lengths are
// multiples of 4 slots (16 bytes, cp.async.bulk's unit).
struct Window {
  uint32_t start, len1, len2, off;
  int rounds;
};

__device__ __forceinline__ Window pass_window(uint32_t home, int k, int max_probes,
                                              int slot_bits) {
  const uint32_t n = 1u << slot_bits;
  Window w;
  w.rounds = min(kPassRounds, max_probes - k * kPassRounds);
  const uint32_t s0 = (home + (uint32_t)k * kPassRounds) & (n - 1u);
  w.start = s0 & ~3u;
  w.off = s0 - w.start;
  const uint32_t end = s0 + (uint32_t)w.rounds;  // one past the last slot, unwrapped
  if (end <= n) {
    w.len1 = ((end + 3u) & ~3u) - w.start;
    w.len2 = 0;
  } else {
    w.len1 = n - w.start;
    w.len2 = (end - n + 3u) & ~3u;
  }
  return w;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
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

// One pair as a lane holds it; `live` until its chain has ended.
struct Pair {
  long long e;
  int l, r;
  uint32_t home;
  bool live;
};

__device__ __forceinline__ Pair load_pair(const int* __restrict__ left,
                                          const int* __restrict__ right, long long e,
                                          long long n, int slot_bits) {
  Pair p;
  p.e = e;
  p.l = e < n ? left[e] : -1;
  p.r = e < n ? right[e] : -1;
  p.live = p.l >= 0 && p.r >= 0;
  p.home = p.live ? home_slot(p.l, p.r, slot_bits) : 0u;
  return p;
}

// A warp's stage: per plane and lane, that lane's window.  80-byte rows keep
// every copy's destination 16-byte aligned.
struct alignas(128) Stage {
  int w[3][32][kWindow];
};

// The lane's part of pass k: arrive on the stage's barrier with the bytes of
// its window and, if its pair is live, copy the window of each plane.
__device__ __forceinline__ Window issue_pass(const Pair& p, int k, int max_probes,
                                             int slot_bits, const int* const planes[3],
                                             Stage& st, int lane, uint64_t* bar) {
  const Window w = pass_window(p.home, k, max_probes, slot_bits);
  if (!p.live) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
    return w;
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(3u * 4u * (w.len1 + w.len2)) : "memory");
  for (int q = 0; q < 3; ++q) {
    int* dst = st.w[q][lane];
    bulk_copy(dst, planes[q] + w.start, 4u * w.len1, bar);
    if (w.len2) bulk_copy(dst + w.len1, planes[q], 4u * w.len2, bar);
  }
  return w;
}

// Walk the pass's rounds in the lane's window, in order: the first empty
// slot ends the chain with a miss, the first slot holding the key with its id.
__device__ __forceinline__ void resolve(Pair& p, const Window& w, const Stage& st, int lane,
                                        int& res) {
  if (!p.live) return;
  for (int i = 0; i < w.rounds; ++i) {
    const int t = (int)w.off + i;
    const int k_l = st.w[0][lane][t];
    if (k_l == -1) {
      p.live = false;
      return;
    }
    if (k_l == p.l && st.w[1][lane][t] == p.r) {
      res = st.w[2][lane][t];
      p.live = false;
      return;
    }
  }
}

__global__ void __launch_bounds__(kAsyncThreads)
    probe_rows_async_kernel(const int* __restrict__ kl, const int* __restrict__ kr,
                            const int* __restrict__ vv, int slot_bits, int max_probes,
                            const int* __restrict__ left, const int* __restrict__ right,
                            int* __restrict__ out, long long n) {
  __shared__ Stage stages[kAsyncWarps][kStages];
  __shared__ alignas(8) uint64_t bars[kAsyncWarps][kStages];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long groups = (n + 31) >> 5;  // 32 pairs, one per lane
  const long long stride = (long long)gridDim.x * kAsyncWarps;
  long long g = (long long)blockIdx.x * kAsyncWarps + warp;
  if (g >= groups) return;  // whole warps leave; no block-wide barrier follows
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;" ::"r"(smem_addr(&bars[warp][s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  const int* const planes[3] = {kl, kr, vv};
  const int passes = passes_for(max_probes);
  Stage* ring = stages[warp];
  uint32_t parity = 0;  // bit s: the parity of stage s's next phase

  Pair cur = load_pair(left, right, g * 32 + lane, n, slot_bits);
  Window wc = issue_pass(cur, 0, max_probes, slot_bits, planes, ring[0], lane, &bars[warp][0]);
  for (int s = 0;; s ^= 1) {
    const long long gn = g + stride;
    Pair nxt;
    Window wn;
    if (gn < groups) {  // the next group's copies fly while this one resolves
      nxt = load_pair(left, right, gn * 32 + lane, n, slot_bits);
      wn = issue_pass(nxt, 0, max_probes, slot_bits, planes, ring[s ^ 1], lane,
                      &bars[warp][s ^ 1]);
    }
    wait_phase(&bars[warp][s], (parity >> s) & 1u);
    parity ^= 1u << s;
    int res = kMaxRank;
    resolve(cur, wc, ring[s], lane, res);
    for (int k = 1; k < passes && __any_sync(kFull, cur.live); ++k) {
      __syncwarp();  // every lane has read the stage before it is refilled
      wc = issue_pass(cur, k, max_probes, slot_bits, planes, ring[s], lane, &bars[warp][s]);
      wait_phase(&bars[warp][s], (parity >> s) & 1u);
      parity ^= 1u << s;
      resolve(cur, wc, ring[s], lane, res);
    }
    if (cur.e < n) out[cur.e] = res;
    if (gn >= groups) return;
    __syncwarp();  // stage s is refilled at the top of the next iteration
    g = gn;
    cur = nxt;
    wc = wn;
  }
}

__global__ void __launch_bounds__(kResidentThreads)
    probe_rows_resident_kernel(const int* __restrict__ kl, const int* __restrict__ kr,
                               const int* __restrict__ vv, int slot_bits, int max_probes,
                               const int* __restrict__ left, const int* __restrict__ right,
                               int* __restrict__ out, long long n) {
  const int lane = threadIdx.x & 31;
  const int round = lane & 15;        // this lane's round within a pass
  const int base = lane & 16;         // first lane of the pair's half-warp
  const long long e = ((long long)blockIdx.x * kResidentThreads + threadIdx.x) >> 4;
  if (((long long)blockIdx.x * kResidentThreads + (threadIdx.x & ~31)) >> 4 >= n)
    return;  // whole warps leave: both of their pairs lie past the end
  const int l = e < n ? left[e] : -1;
  const int r = e < n ? right[e] : -1;
  bool live = l >= 0 && r >= 0;
  const uint32_t home = live ? home_slot(l, r, slot_bits) : 0u;
  const uint32_t mask = (1u << slot_bits) - 1u;
  int res = kMaxRank;
  for (int p0 = 0; p0 < max_probes && __any_sync(kFull, live); p0 += kPassRounds) {
    const int p = p0 + round;
    bool stop = false;
    int ans = kMaxRank;
    if (live && p < max_probes) {
      const uint32_t slot = (home + (uint32_t)p) & mask;
      const int k_l = __ldg(kl + slot), k_r = __ldg(kr + slot), v = __ldg(vv + slot);
      const bool hit = k_l == l && k_r == r;
      stop = hit || k_l == -1;
      ans = hit ? v : kMaxRank;
    }
    const unsigned stops = (__ballot_sync(kFull, stop) >> base) & 0xFFFFu;
    const int first = stops ? __ffs(stops) - 1 : 0;
    const int got = __shfl_sync(kFull, ans, base + first);
    if (live && stops) {
      res = got;
      live = false;
    }
  }
  if (e < n && round == 0) out[e] = res;
}

bool bad_args(int slot_bits, int max_probes, long long n) {
  return n <= 0 || slot_bits < 7 || slot_bits > 31 || max_probes < 1;
}

}  // namespace

extern "C" {

// K3: probe n pairs on `stream`, each pair's windows copied in one round
// trip per pass.  Every plane must be 16-byte aligned (cp.async.bulk's
// rule); the wrapper checks.  The grid is persistent: as many blocks as
// fit on the card at once, or fewer when there are fewer pairs.
int tt_probe_rows_async(const int* kl, const int* kr, const int* vv, int slot_bits,
                        int max_probes, const int* left, const int* right, int* out,
                        long long n, void* stream) {
  if (bad_args(slot_bits, max_probes, n)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_rows_async_kernel,
                                                        kAsyncThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long groups = (n + 31) / 32;
  long long blocks = (groups + kAsyncWarps - 1) / kAsyncWarps;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  probe_rows_async_kernel<<<(unsigned int)blocks, kAsyncThreads, 0, (cudaStream_t)stream>>>(
      kl, kr, vv, slot_bits, max_probes, left, right, out, n);
  return (int)cudaGetLastError();
}

// K4: probe n pairs on `stream` with [window, window + window_bytes) marked
// persisting in L2 for this launch.  The hit ratio is the share of the
// window that the current set-aside (cudaLimitPersistingL2CacheSize) holds;
// with no set-aside the window is a no-op and the slots come from L2 as usual.
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
  cfg.gridDim = dim3((unsigned int)((n * 16 + kResidentThreads - 1) / kResidentThreads));
  cfg.blockDim = dim3(kResidentThreads);
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
