// Packed tiktoken merge for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces, on the card, the JAX package's merge kernels and their probes:
//   tokenizer_tpu/ops/merge_jax.py     merge_packed_jax, lookup_pairs (XLA)
//   tokenizer_tpu/ops/merge_pallas.py  merge_packed_pallas -> _merge_block_kernel, _lookup (Pallas)
// Semantics are exactly merge_packed_jax's: per column, merge the FIRST
// minimum-rank adjacent pair (the merged id is that rank), re-probe only the
// two pairs that touch the merged token, until no pair merges.  Unlike the
// Pallas kernel there is no 128-slot table cap: the probe gathers straight
// from global memory.
//
// Layout: ids/out_ids are [L, B] int32, row-major, so row r of column c lives
// at r * B + c.  Preconditions (the packer, ops/packing.py, guarantees them):
// 0 <= lengths[c] <= L and ids[r, c] == -1 for r >= lengths[c].  Rows at or
// beyond a column's length are copied, never shifted, so the full tile equals
// merge_packed_jax's only under the -1 padding.  Lengths outside [0, L] are
// clamped so that no access leaves the tile.
//
// Two kernels compute this:
//
// merge_packed_kernel (tt_merge_packed, the main path): one warp per column,
// kWarpCols adjacent columns per block.
// - What bounds it: memory.  The work is the tile (ids and lengths in, ids
//   and counts out) and the table slots that its probes need, each read
//   once: a probe per initial pair and two per merge, into the 6-25 MB
//   table, which should stay resident in the 50 MB L2.  Integer work has
//   no published peak.
// - What the design does about it.  The block copies its [L, kWarpCols]
//   slab into shared memory once, with plain coalesced loads (each row of
//   kWarpCols int32 is one 32-byte sector), and writes it back the same way;
//   between the two, a column lives in shared memory as id[L], rank[L]
//   (int32) and links nxt[L], prv[L] (int16), 12 bytes a row.  A merge never
//   shifts: the right token becomes a tombstone and the left one is relinked
//   past it, so live positions keep their order and the first minimum by
//   position is the first minimum of the sequence (argmin's tie-break).  Each
//   lane scans every 32nd rank; two warp reductions (__reduce_min_sync on the
//   rank, then on the position among the lanes that hold it) give every
//   lane the same (best, j), so the loop is warp-uniform.  The first probes
//   are spread over the lanes; the two re-probes of a merge run on lanes 0
//   and 1 in the same instructions.  A ballot prefix count compacts the live
//   ids at the end.  B = 8192 gives 8,192 warps in 1,024 blocks, which fills
//   the 132 SMs; the probe chains of many warps overlap.
// - Measured on an H100 (PERF.md, tools/merge_kernel_scaling.py): a tile
//   takes a few percent of its byte bound.  Its time follows the longest column's
//   chain of merges, about 1 us a step (argmin, relink, a probe of up to
//   three dependent L2 loads), and moves by at most 7% from L=64 up when
//   the table starts out of L2, so latency, not bytes or the table's
//   residency, holds it.
// - L is at most kMaxL (shared memory: 12 B x kWarpCols x 2,052 = 197 KB of
//   the 227 KB a block may hold, above 48 KB only after
//   cudaFuncSetAttribute).
//
// merge_packed_v1_kernel (tt_merge_packed_v1): the port's first kernel, kept
// so that the two can be timed within one process; nothing on the main path
// launches it.  One thread per column and 128 columns per block, an O(L)
// argmin, id shift and rank shift per merge through an [L, B] global scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRank = 0x7FFFFFFF;
constexpr int kV1Threads = 128;
constexpr int kLookupThreads = 256;
constexpr int kWarpCols = 8;  // columns (one warp each) per block
constexpr int kWarpThreads = 32 * kWarpCols;
constexpr int kMaxL = 2048;
constexpr short kDead = -2;  // prv[] of a merged-away position
constexpr unsigned kFull = 0xFFFFFFFFu;

// Column stride in shared memory: L rounded up to 32, plus 4, so that the
// kWarpCols columns of one slab row fall in distinct banks.
__host__ __device__ constexpr int col_stride(int L) { return (L + 31) / 32 * 32 + 4; }

constexpr size_t smem_bytes(int L) { return (size_t)12 * kWarpCols * col_stride(L); }

// (left, right) -> merged id, kMaxRank on a miss or a negative id.  The
// uint32 Murmur mix and Fibonacci shift of ops/pair_table.py hash_pair_u32,
// then up to max_probes linear probes comparing the full key and stopping
// at an empty slot (key_left == -1).
__device__ __forceinline__ int probe(const int* __restrict__ kl,
                                     const int* __restrict__ kr,
                                     const int* __restrict__ vv, int slot_bits,
                                     int max_probes, int left, int right) {
  if (left < 0 || right < 0) return kMaxRank;
  uint32_t h = ((uint32_t)left * 0x85EBCA6Bu) ^ ((uint32_t)right * 0xC2B2AE35u);
  h ^= h >> 16;
  uint32_t slot = (h * 0x9E3779B9u) >> (32 - slot_bits);
  const uint32_t mask = (1u << slot_bits) - 1u;
  for (int p = 0; p < max_probes; ++p) {
    const int k = __ldg(kl + slot);
    if (k == left && __ldg(kr + slot) == right) return __ldg(vv + slot);
    if (k == -1) return kMaxRank;
    slot = (slot + 1u) & mask;
  }
  return kMaxRank;
}

__global__ void __launch_bounds__(kWarpThreads)
    merge_packed_kernel(const int* __restrict__ kl, const int* __restrict__ kr,
                        const int* __restrict__ vv, int slot_bits, int max_probes,
                        const int* __restrict__ ids, const int* __restrict__ lengths,
                        int* __restrict__ out_ids, int* __restrict__ out_n, int L, int B) {
  extern __shared__ int smem[];
  __shared__ int s_n[kWarpCols];   // clamped length of each column
  __shared__ int s_nf[kWarpCols];  // its length after the merges
  const int S = col_stride(L);
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kWarpCols;
  const size_t stride = (size_t)B;
  int* ids_s = smem;                     // [kWarpCols][S] token ids
  int* rank_s = smem + kWarpCols * S;    // [kWarpCols][S] rank of (p, nxt[p])
  short* nxt_s = reinterpret_cast<short*>(smem + 2 * kWarpCols * S);
  short* prv_s = nxt_s + kWarpCols * S;

  // The block's [L, kWarpCols] slab, one 32-byte sector per row.
  for (int e = threadIdx.x; e < L * kWarpCols; e += kWarpThreads) {
    const int r = e / kWarpCols, cw = e % kWarpCols;
    ids_s[cw * S + r] = ids[r * stride + c0 + cw];
  }

  int* id = ids_s + w * S;
  int* rank = rank_s + w * S;
  short* nxt = nxt_s + w * S;
  short* prv = prv_s + w * S;
  int n = lengths[c0 + w];
  n = n < 0 ? 0 : (n > L ? L : n);
  __syncthreads();

  // Links, and the first n - 1 probes spread over the lanes.
  for (int r = lane; r < n; r += 32) {
    nxt[r] = (short)(r + 1);
    prv[r] = (short)(r - 1);
    rank[r] = r + 1 < n ? probe(kl, kr, vv, slot_bits, max_probes, id[r], id[r + 1]) : kMaxRank;
  }
  __syncwarp();

  while (true) {
    // First minimum: each lane's own over every 32nd position (strict <,
    // positions ascending), then the least position among the lanes that
    // hold the warp's minimum.  Tombstones and the last live token hold
    // kMaxRank.
    unsigned best = kMaxRank, pos = kFull;
    for (int r = lane; r < n; r += 32) {
      const unsigned v = (unsigned)rank[r];
      if (v < best) {
        best = v;
        pos = r;
      }
    }
    const unsigned wbest = __reduce_min_sync(kFull, best);
    if (wbest == (unsigned)kMaxRank) break;
    const int i = (int)__reduce_min_sync(kFull, best == wbest ? pos : kFull);
    const int k = nxt[i];  // merged into i
    const int m = nxt[k];  // i's new right neighbour (n if none)
    const int p = prv[i];  // i's left neighbour (-1 if none)
    __syncwarp();          // every lane has read the links
    if (lane == 0) {
      id[i] = (int)wbest;
      rank[k] = kMaxRank;
      prv[k] = kDead;
      nxt[i] = (short)m;
      if (m < n) prv[m] = (short)i;
    }
    if (lane < 2) {  // lane 0 re-probes (p, i), lane 1 (i, m), together
      const int left = lane == 0 ? (p >= 0 ? id[p] : -1) : (int)wbest;
      const int right = lane == 0 ? (int)wbest : (m < n ? id[m] : -1);
      const int dst = lane == 0 ? p : i;
      const int v = probe(kl, kr, vv, slot_bits, max_probes, left, right);
      if (dst >= 0) rank[dst] = v;
    }
    __syncwarp();
  }

  // Compact the live ids, in order, into rank[0, count).
  int count = 0;
  for (int base = 0; base < n; base += 32) {
    const int r = base + lane;
    const bool live = r < n && prv[r] != kDead;
    const unsigned bal = __ballot_sync(kFull, live);
    if (live) rank[count + __popc(bal & ((1u << lane) - 1u))] = id[r];
    count += __popc(bal);
  }
  if (lane == 0) {
    s_n[w] = n;
    s_nf[w] = count;
    out_n[c0 + w] = count;
  }
  __syncthreads();

  // Rows 0..count-1 the merged ids, then -1 up to the clamped length, then
  // the rows beyond it as they came in.
  for (int e = threadIdx.x; e < L * kWarpCols; e += kWarpThreads) {
    const int r = e / kWarpCols, cw = e % kWarpCols;
    out_ids[r * stride + c0 + cw] =
        r < s_nf[cw] ? rank_s[cw * S + r] : (r < s_n[cw] ? -1 : ids_s[cw * S + r]);
  }
}

__global__ void __launch_bounds__(kV1Threads)
    merge_packed_v1_kernel(const int* __restrict__ kl, const int* __restrict__ kr,
                           const int* __restrict__ vv, int slot_bits, int max_probes,
                           const int* __restrict__ ids, const int* __restrict__ lengths,
                           int* __restrict__ out_ids, int* __restrict__ out_n,
                           int* __restrict__ rank, int L, int B) {
  const int col = blockIdx.x * kV1Threads + threadIdx.x;
  if (col >= B) return;
  const size_t stride = (size_t)B;
  const int* src = ids + col;
  int* seg = out_ids + col;  // seg[r * stride]: id of segment r
  int* rk = rank + col;      // rk[r * stride]: rank of pair (r, r + 1), r < n - 1

  int n = lengths[col];
  n = n < 0 ? 0 : (n > L ? L : n);
  for (int r = 0; r < L; ++r) seg[r * stride] = src[r * stride];
  for (int r = 0; r + 1 < n; ++r)
    rk[r * stride] = probe(kl, kr, vv, slot_bits, max_probes, seg[r * stride],
                           seg[(r + 1) * stride]);

  while (true) {
    int best = kMaxRank;
    int j = -1;
    for (int r = 0; r + 1 < n; ++r) {
      const int v = rk[r * stride];
      if (v < best) {  // strict: the first minimum wins ties
        best = v;
        j = r;
      }
    }
    if (j < 0) break;
    // Segments j and j + 1 become one token whose id is the pair's rank.
    seg[j * stride] = best;
    for (int r = j + 1; r + 1 < n; ++r) seg[r * stride] = seg[(r + 1) * stride];
    seg[(n - 1) * stride] = -1;
    --n;
    // Pairs beyond j move up one row; the two pairs touching j re-probe.
    for (int r = j + 1; r + 1 < n; ++r) rk[r * stride] = rk[(r + 1) * stride];
    if (j > 0)
      rk[(j - 1) * stride] = probe(kl, kr, vv, slot_bits, max_probes,
                                   seg[(j - 1) * stride], best);
    if (j + 1 < n)
      rk[j * stride] = probe(kl, kr, vv, slot_bits, max_probes, best,
                             seg[(j + 1) * stride]);
  }
  out_n[col] = n;
}

__global__ void __launch_bounds__(kLookupThreads)
    lookup_pairs_kernel(const int* __restrict__ kl, const int* __restrict__ kr,
                        const int* __restrict__ vv, int slot_bits, int max_probes,
                        const int* __restrict__ left, const int* __restrict__ right,
                        int* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * kLookupThreads + threadIdx.x;
  if (i < n) out[i] = probe(kl, kr, vv, slot_bits, max_probes, left[i], right[i]);
}

}  // namespace

extern "C" {

// Launch the merge of one [L, B] tile on `stream` (the warp-per-column
// kernel); 1 <= L <= kMaxL (2048) and B a positive multiple of 8.
// Returns cudaGetLastError() after the launch (0 on success).
int tt_merge_packed(const int* kl, const int* kr, const int* vv, int slot_bits,
                    int max_probes, const int* ids, const int* lengths, int* out_ids,
                    int* out_n, int L, int B, void* stream) {
  if (L <= 0 || L > kMaxL || B <= 0 || B % kWarpCols != 0 || slot_bits < 1 ||
      slot_bits > 31)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(L);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        merge_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  merge_packed_kernel<<<B / kWarpCols, kWarpThreads, smem, (cudaStream_t)stream>>>(
      kl, kr, vv, slot_bits, max_probes, ids, lengths, out_ids, out_n, L, B);
  return (int)cudaGetLastError();
}

// Launch the port's first merge kernel (one thread per column) on one tile;
// B must be a positive multiple of 128.  rank_scratch is [L, B] int32 that
// the caller allocates.  Returns cudaGetLastError() after the launch.
int tt_merge_packed_v1(const int* kl, const int* kr, const int* vv, int slot_bits,
                       int max_probes, const int* ids, const int* lengths, int* out_ids,
                       int* out_n, int* rank_scratch, int L, int B, void* stream) {
  if (L <= 0 || B <= 0 || B % kV1Threads != 0 || slot_bits < 1 || slot_bits > 31)
    return (int)cudaErrorInvalidValue;
  merge_packed_v1_kernel<<<B / kV1Threads, kV1Threads, 0, (cudaStream_t)stream>>>(
      kl, kr, vv, slot_bits, max_probes, ids, lengths, out_ids, out_n, rank_scratch, L, B);
  return (int)cudaGetLastError();
}

// Probe n pairs on `stream` (the merge kernels' probe, exposed for checks).
int tt_lookup_pairs(const int* kl, const int* kr, const int* vv, int slot_bits,
                    int max_probes, const int* left, const int* right, int* out,
                    long long n, void* stream) {
  if (n <= 0 || slot_bits < 1 || slot_bits > 31) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((n + kLookupThreads - 1) / kLookupThreads);
  lookup_pairs_kernel<<<blocks, kLookupThreads, 0, (cudaStream_t)stream>>>(
      kl, kr, vv, slot_bits, max_probes, left, right, out, n);
  return (int)cudaGetLastError();
}

const char* tt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
