// Packed tiktoken merge for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces, on the card, the JAX package's merge kernels and their probes:
//   tokenizer_tpu/ops/merge_jax.py     merge_packed_jax, lookup_pairs (XLA)
//   tokenizer_tpu/ops/merge_pallas.py  merge_packed_pallas -> _merge_block_kernel, _lookup (Pallas)
// Semantics are exactly merge_packed_jax's: per column, merge the FIRST
// minimum-rank adjacent pair (the merged id is that rank), shift the tail
// up, re-probe only pairs (j-1, j) and (j, j+1), until no pair merges.
// Unlike the Pallas kernel there is no 128-slot table cap: the probe
// gathers straight from global memory.
//
// Layout: ids/out_ids/rank are [L, B] int32, row-major, so row r of column c
// lives at r * B + c.  One thread owns one column and a warp's 32 columns
// are adjacent, so every row access of a warp is one coalesced transaction.
// Each thread loops until ITS column converges (the Pallas kernel's
// per-block convergence taken down to one column).
//
// Preconditions (the packer, tokenizer_tpu/ops/packing.py, guarantees them):
// 0 <= lengths[c] <= L and ids[r, c] == -1 for r >= lengths[c].  Rows at or
// beyond a column's length are copied, never shifted, so the full tile
// equals merge_packed_jax's only under the -1 padding.  Lengths outside
// [0, L] are clamped so that no access leaves the tile.
//
// What bounds it on an H100: each probe is a chain of dependent 4-byte
// gathers into a 6-25 MB pair table (gpt2 to o200k scale) that should stay
// resident in the 50 MB L2, and each merge costs an O(L) argmin scan plus
// an O(L) shift of ids and ranks through global memory.  Later work: a warp
// per column for L >= 128 with the column in shared memory and a shuffle
// argmin over (rank, index), and an L2 persisting window over the table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRank = 0x7FFFFFFF;
constexpr int kMergeThreads = 128;
constexpr int kLookupThreads = 256;

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

__global__ void __launch_bounds__(kMergeThreads)
    merge_packed_kernel(const int* __restrict__ kl, const int* __restrict__ kr,
                        const int* __restrict__ vv, int slot_bits, int max_probes,
                        const int* __restrict__ ids, const int* __restrict__ lengths,
                        int* __restrict__ out_ids, int* __restrict__ out_n,
                        int* __restrict__ rank, int L, int B) {
  const int col = blockIdx.x * kMergeThreads + threadIdx.x;
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

// Launch the merge of one [L, B] tile on `stream`; B must be a positive
// multiple of 128.  rank_scratch is [L, B] int32 that the caller allocates.
// Returns cudaGetLastError() after the launch (0 on success).
int tt_merge_packed(const int* kl, const int* kr, const int* vv, int slot_bits,
                    int max_probes, const int* ids, const int* lengths, int* out_ids,
                    int* out_n, int* rank_scratch, int L, int B, void* stream) {
  if (L <= 0 || B <= 0 || B % kMergeThreads != 0 || slot_bits < 1 || slot_bits > 31)
    return (int)cudaErrorInvalidValue;
  merge_packed_kernel<<<B / kMergeThreads, kMergeThreads, 0, (cudaStream_t)stream>>>(
      kl, kr, vv, slot_bits, max_probes, ids, lengths, out_ids, out_n, rank_scratch, L, B);
  return (int)cudaGetLastError();
}

// Probe n pairs on `stream` (the merge kernel's probe, exposed for checks).
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
