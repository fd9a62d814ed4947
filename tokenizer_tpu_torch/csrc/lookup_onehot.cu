// Pair-table probe by one-hot int8 matrix product on Hopper's tensor cores (sm_90a).
// Plain C interface for ctypes.
//
// Replaces, on the card, the JAX package's third Pallas probe experiment:
//   K5 tokenizer_tpu/ops/exp_pallas_bigtable.py  lookup_onehot_pallas -> _onehot_lookup_kernel
// It computes PairTable.lookup for an [S, 128] tile of pairs.  The table is
// stored as four int8 byte planes of [n_rows, 384] (bigtable_device_table:
// key_left, key_right, values of slots 128 r .. 128 r + 127 in row r, byte k
// of each int32 entry in plane k).  For probe round p, pair i's slot is
// (home_i + p) mod n_slots, its row (slot >> 7) and its lane (slot & 127).
// The row is fetched as one_hot(row) [pairs, n_rows] @ plane k [n_rows, 384],
// accumulated exactly in int32 (one nonzero term per output), masked to a
// byte, and the bytes of lanes lane, 128 + lane and 256 + lane are put back
// together as the int32 key_left, key_right and value of the slot.
//
// The whole product is computed: every k-block of every plane, though all
// but one k-block of each one-hot row is zero.  Skipping them would turn the
// kernel back into a gather and drop the formulation the experiment records.
//
// What bounds it: arithmetic.  A [16, 128] tile of gpt2 (4,096 rows, 9
// rounds) is 2,048 x 9 x 4,096 x 1,536 = 116 G int8 multiply-adds, cl100k_synth
// (8,192 rows, 12 rounds) 309 G, to use 12 bytes a probe.  The design keeps
// the tensor cores fed and spends nothing else:
//  * mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on int8 tensor cores;
//  * the one-hot A fragments are built in registers from each pair's row
//    index and never stored;
//  * B is the byte plane transposed to [4, 384, n_rows] (the wrapper makes
//    it from the JAX layout), so each output column's K run is contiguous,
//    as the .col operand wants; tiles of 64 columns x 128 bytes of K are
//    staged into shared memory by cp.async, double-buffered, rows padded to
//    144 bytes so a warp's fragment loads hit 32 different banks;
//  * the probe rounds are independent products (the slot sequence is known
//    from the home slot), so one block takes one (128-pair row s of the
//    tile, round p, byte plane k) and the grid is S x max_probes x 4 blocks.
//    Each block writes, for each pair, the byte it selected for each of the
//    three arrays into a [3, max_probes, S * 128] int32 scratch viewed as
//    bytes, so byte k lands at bits 8k..8k+7 and no atomics are needed;
//  * a second kernel walks each pair's rounds in order, as the Pallas
//    kernel's loop does, and resolves hit, empty slot and miss.
// Measured on one H100 80GB HBM3 (700 W limit): 0.65 ms (gpt2) and 1.44 ms
// (cl100k_synth) of device time per [16, 128] tile, 178 and 214 T
// multiply-adds/s, about a fifth of the card's dense int8 peak.  wgmma with
// TMA-fed shared memory would be the next step for speed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRank = 0x7FFFFFFF;
constexpr int kLanes = 128;          // slots per row, and pairs per block
constexpr int kCols = 3 * kLanes;    // 384 columns per byte plane
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;           // output columns per pass
constexpr int kChunks = kCols / kChunk;
constexpr int kTileK = 128;          // bytes of K per staged tile
constexpr int kPitch = kTileK + 16;  // padded smem row, in bytes
constexpr int kResolveThreads = 256;

__device__ __forceinline__ uint32_t home_slot(int left, int right, int slot_bits) {
  uint32_t h = ((uint32_t)left * 0x85EBCA6Bu) ^ ((uint32_t)right * 0xC2B2AE35u);
  h ^= h >> 16;
  return (h * 0x9E3779B9u) >> (32 - slot_bits);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 4 one-hot bytes of k = base .. base + 3 for a row whose index is
// `target`: byte (target - base) is 1 when it falls among them.
__device__ __forceinline__ uint32_t onehot4(int target, int base) {
  const unsigned d = (unsigned)(target - base);
  return d < 4u ? 1u << (8u * d) : 0u;
}

// grid (S, max_probes, 4); block: 128 pairs x one round x one byte plane.
__global__ void __launch_bounds__(kThreads)
    onehot_rows_kernel(const int8_t* __restrict__ tab_t,  // [4, 384, n_rows]
                       int n_rows, int slot_bits, const int* __restrict__ left,
                       const int* __restrict__ right, uint8_t* __restrict__ sel,
                       int n_pairs, int rounds) {
  __shared__ alignas(16) int8_t tile[2][kChunk][kPitch];
  __shared__ int row_of[kLanes];
  __shared__ int lane_of[kLanes];

  const int s = blockIdx.x, p = blockIdx.y, plane = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // mma fragment coordinates

  {  // this block's 128 pairs at round p
    const int i = s * kLanes + tid;
    const int l = left[i], r = right[i];
    const bool valid = l >= 0 && r >= 0;
    const uint32_t slot =
        (home_slot(valid ? l : 0, valid ? r : 0, slot_bits) + (uint32_t)p) &
        ((1u << slot_bits) - 1u);
    row_of[tid] = (int)(slot >> 7);
    lane_of[tid] = (int)(slot & (kLanes - 1));
  }
  __syncthreads();

  // Warp w owns pairs 32w .. 32w + 31: two m16 tiles, rows g and g + 8 of each.
  int target[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) target[mt][h] = row_of[warp * 32 + mt * 16 + h * 8 + g];

  const int8_t* plane_t = tab_t + (size_t)plane * kCols * n_rows;
  const int k_tiles = (n_rows + kTileK - 1) / kTileK;
  const int n_tiles = kChunks * k_tiles;

  auto load = [&](int t, int buf) {
    const int chunk = t / k_tiles, k0 = (t % k_tiles) * kTileK;
    const int kw = min(kTileK, n_rows - k0);  // a multiple of 32
    const int segs = kw / 16;
    const int8_t* src = plane_t + (size_t)(chunk * kChunk) * n_rows + k0;
    for (int idx = tid; idx < kChunk * segs; idx += kThreads) {
      const int n = idx / segs, j = idx % segs;
      cp_async16(&tile[buf][n][j * 16], src + (size_t)n * n_rows + j * 16);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  int acc[2][8][4];  // all indices compile-time after unrolling: registers
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  load(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load(t + 1, (t + 1) & 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();

    const int buf = t & 1;
    const int k0 = (t % k_tiles) * kTileK;
    const int kw = min(kTileK, n_rows - k0);
    for (int kk = 0; kk < kw; kk += 32) {
      const int kb = k0 + kk + q * 4;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt][0] = onehot4(target[mt][0], kb);
        a[mt][1] = onehot4(target[mt][1], kb);
        a[mt][2] = onehot4(target[mt][0], kb + 16);
        a[mt][3] = onehot4(target[mt][1], kb + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int8_t* col = &tile[buf][nt * 8 + g][kk + q * 4];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(col);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(col + 16);
        mma_s8(acc[0][nt], a[0], b0, b1);
        mma_s8(acc[1][nt], a[1], b0, b1);
      }
    }

    if (t % k_tiles == k_tiles - 1) {  // chunk done: keep each pair's lane
      const int chunk = t / k_tiles;
      const int array = chunk / 2;               // 0 key_left, 1 key_right, 2 values
      const int lane0 = (chunk % 2) * kChunk;    // first lane of the chunk
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = warp * 32 + mt * 16 + g + (i >> 1) * 8;
            if (lane_of[m] == lane0 + nt * 8 + q * 2 + (i & 1)) {
              const size_t word = ((size_t)array * rounds + p) * n_pairs + s * kLanes + m;
              sel[word * 4 + plane] = (uint8_t)(acc[mt][nt][i] & 0xFF);
            }
            acc[mt][nt][i] = 0;
          }
    }
    __syncthreads();  // the next load reuses this buffer
  }
}

// One thread per pair: walk the rounds in order over the reassembled words.
__global__ void __launch_bounds__(kResolveThreads)
    onehot_resolve_kernel(const int* __restrict__ words,  // [3, rounds, n_pairs]
                          const int* __restrict__ left, const int* __restrict__ right,
                          int* __restrict__ out, int n_pairs, int rounds) {
  const int i = blockIdx.x * kResolveThreads + threadIdx.x;
  if (i >= n_pairs) return;
  const int l = left[i], r = right[i];
  bool live = l >= 0 && r >= 0;
  int res = kMaxRank;
  for (int p = 0; p < rounds; ++p) {
    const int k_l = words[(size_t)p * n_pairs + i];
    const int k_r = words[((size_t)rounds + p) * n_pairs + i];
    const bool hit = live && k_l == l && k_r == r;
    if (hit) res = words[((size_t)2 * rounds + p) * n_pairs + i];
    live = live && k_l != -1 && !hit;
  }
  out[i] = res;
}

}  // namespace

extern "C" {

// Probe an [S, 128] tile of pairs on `stream`.  tab_t is the byte planes
// transposed to [4, 384, n_rows] int8, 16-byte aligned; n_rows * 128 must
// be 2^slot_bits and n_rows a multiple of 32.  scratch is
// [3, max_probes, S * 128] int32 that the caller allocates.
int tt_lookup_onehot(const int8_t* tab_t, int n_rows, int slot_bits, int max_probes,
                     const int* left, const int* right, int* out, int* scratch, int S,
                     void* stream) {
  if (S <= 0 || max_probes < 1 || n_rows <= 0 || n_rows % 32 != 0 || slot_bits < 12 ||
      slot_bits > 31 || ((long long)n_rows << 7) != (1LL << slot_bits))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_pairs = S * kLanes;
  onehot_rows_kernel<<<dim3(S, max_probes, 4), kThreads, 0, st>>>(
      tab_t, n_rows, slot_bits, left, right, reinterpret_cast<uint8_t*>(scratch), n_pairs,
      max_probes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  onehot_resolve_kernel<<<(n_pairs + kResolveThreads - 1) / kResolveThreads, kResolveThreads,
                          0, st>>>(scratch, left, right, out, n_pairs, max_probes);
  return (int)cudaGetLastError();
}

}  // extern "C"
