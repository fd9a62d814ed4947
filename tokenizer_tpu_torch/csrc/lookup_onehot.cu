// Pair-table probe by one-hot int8 matrix product on Hopper's tensor cores (sm_90a).
// Plain C interface for ctypes.
//
// Replaces, on the card, the JAX package's third Pallas probe experiment:
//   K5 tokenizer_tpu/ops/exp_pallas_bigtable.py  lookup_onehot_pallas -> _onehot_lookup_kernel
// It computes PairTable.lookup for an [S, 128] tile of pairs.  The table is
// four int8 byte planes (bigtable_device_table: key_left, key_right, values
// of slots 128 r .. 128 r + 127 in row r, byte k of each int32 entry in plane
// k).  For probe round p, pair i's slot is (home_i + p) mod n_slots, its row
// (slot >> 7) and its lane (slot & 127).  The row is fetched by a one-hot
// product, accumulated exactly in int32 (one nonzero term per output),
// masked to a byte, and a resolve pass puts the bytes of the three arrays
// back together and walks each pair's rounds in order.
//
// The whole product is computed: every k-block of every plane, though all
// but one k-block of each one-hot row is zero.  Skipping them would turn the
// kernel back into a gather and drop the formulation the experiment records.
//
// One GEMM over every round.  Round p's slot is home + p, known up front, so
// the rounds are independent and the call is one product C[M, N] = A[M, K] B[K, N]:
//   M = S * 128 * max_probes pair-round rows, row m = p * S * 128 + i;
//   K = n_rows; A row m is one_hot(row of pair i at round p), never stored;
//   N = 4 * 384: B is the planes K-major, [4 * 384, n_rows] int8
//       (exp_probe_torch.bigtable_kmajor, made once, outside the call).
//
// What bounds it: operations.  2 M K N int8 operations: a [16, 128] tile is
// 232 T for gpt2 (M 18,432, K 4,096), 618 T for cl100k_synth (24,576 x
// 8,192) and 1,237 T for o200k_synth (24,576 x 16,384), 117.2 / 312.5 /
// 625.0 us at the H100's dense int8 peak of 1,979 TOP/s.  Bytes come second:
// every M-tile reads all of B, so what L2 must hand to shared memory is
// ceil(M / 256) times the table (453 MB, 1.21 GB, 2.42 GB).  The design:
//  * wgmma.mma_async m64n128k32 .s32.s8.s8, A from registers: each consumer
//    thread builds its 4-byte one-hot fragments from its rows' target index
//    (one compare per register), so A costs no memory traffic at all;
//  * B through TMA: a tensor map over the K-major planes, boxes of 128 rows
//    of N x 128 bytes of K with the 128-byte swizzle that the wgmma
//    descriptor reads, in a ring of kStages stages, each with a full and an
//    empty mbarrier; one producer thread keeps the loads in flight;
//  * tiles of 256 M-rows x 128 N-columns: two consumer warpgroups of 128
//    rows each (two m64 products per k-step) share every B stage, so L2 hands
//    over ceil(M / 256) x the table, half of what 128-row tiles would need.
//    An N-tile is one array of one byte plane, so each row's epilogue keeps
//    exactly one column, its lane;
//  * a persistent grid, one CTA per SM, walks the tiles N-tile by N-tile
//    (tile t is M-tile t % m_tiles of N-tile t / m_tiles): the CTAs in flight
//    share one or two N-tiles, so the 0.5-2 MB of B they stream stays in L2
//    and device memory gives up the table about once per call;
//  * the epilogue selects each row's lane from the accumulators, masks it to
//    a byte and writes it to byte `plane` of the [3, max_probes, S * 128]
//    int32 scratch: each byte has exactly one writer, so no atomics;
//  * a second kernel walks each pair's rounds in order, as the Pallas
//    kernel's loop does, and resolves hit, empty slot and miss.
// Measured times, against the mma.sync kernel this one replaced and against
// torch._int_mm on the same product: PERF.md section 6.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRank = 0x7FFFFFFF;
constexpr int kLanes = 128;            // slots per row
constexpr int kCols = 3 * kLanes;      // 384 columns per byte plane
constexpr int kN = 4 * kCols;          // 1,536 columns of B
constexpr int kTileM = 256;            // pair-round rows per tile
constexpr int kTileN = 128;            // one array of one byte plane
constexpr int kTileK = 128;            // bytes of K per stage: one swizzle row
constexpr int kNTiles = kN / kTileN;   // 12
constexpr int kStages = 5;
constexpr int kStageBytes = kTileN * kTileK;  // 16 KB
constexpr int kConsumerWarps = 8;      // two warpgroups
constexpr int kThreads = 3 * 128;      // two consumer warpgroups, one producer
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;
constexpr int kResolveThreads = 256;

__device__ __forceinline__ uint32_t home_slot(int left, int right, int slot_bits) {
  uint32_t h = ((uint32_t)left * 0x85EBCA6Bu) ^ ((uint32_t)right * 0xC2B2AE35u);
  h ^= h >> 16;
  return (h * 0x9E3779B9u) >> (32 - slot_bits);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Wait for the barrier's phase of this parity to complete.  A load or a
// release that never comes traps (an error the launch's caller sees)
// instead of hanging the card.
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

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// One TMA copy of the [kTileN, kTileK] box at (k0, n0) of B into `dst`,
// completing on `bar`, which was told to expect kStageBytes.
__device__ __forceinline__ void load_b(void* dst, const CUtensorMap* map, int k0, int n0,
                                       uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(kStageBytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(n0),
        "r"(smem_addr(bar))
      : "memory");
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: start
// address, stride of 1,024 bytes between groups of 8 rows, layout 1 (B128).
// The leading offset is unused for this layout.
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64] += A (4 registers of this thread's m64 x k32 fragment) x B (desc).
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the wgmma that owns it: the register is an operand of this empty asm.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int j = 0; j < 64; ++j) asm volatile("" : "+r"(d[j])::"memory");
}

// The 4 one-hot bytes of k = base .. base + 3 for a row whose index is
// `target`: byte (target - base) is 1 when it falls among them.  A padded
// row has target -1 and gets none.
__device__ __forceinline__ uint32_t onehot4(int target, int base) {
  const unsigned d = (unsigned)(target - base);
  return d < 4u ? 1u << (8u * d) : 0u;
}

// Persistent: CTA b takes tiles b, b + gridDim.x, ... of m_tiles * kNTiles.
// Warpgroups 0 and 1 consume (rows 0-127 and 128-255 of the M-tile);
// thread 0 of warpgroup 2 produces.
__global__ void __launch_bounds__(kThreads, 1)
    onehot_gemm_kernel(const __grid_constant__ CUtensorMap tab_map, int k_tiles,
                       int slot_bits, const int* __restrict__ left,
                       const int* __restrict__ right, uint8_t* __restrict__ sel,
                       int n_pairs, int rounds, int m_rows, int m_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&full[s])));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   ::"r"(smem_addr(&empty[s])), "r"(kConsumerWarps));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int n_tiles = m_tiles * kNTiles;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 2 * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int n0 = (tile / m_tiles) * kTileN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % kStages;
          wait_phase(&empty[s], ((it / kStages) & 1) ^ 1);
          load_b(stages + s * kStageBytes, &tab_map, kt * kTileK, n0, &full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;  // fragment coordinates
    const uint32_t mask = (1u << slot_bits) - 1u;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m_tile = tile % m_tiles, n_tile = tile / m_tiles;
      // This thread's four rows: m-block mb (64 rows), half h (row g or g + 8).
      int target[2][2], lane_of[2][2], round_of[2][2], pair_of[2][2];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m_tile * kTileM + wg * 128 + mb * 64 + warp * 16 + h * 8 + g;
          target[mb][h] = -1;  // a padded row: all-zero A, never written
          lane_of[mb][h] = -1;
          round_of[mb][h] = pair_of[mb][h] = 0;
          if (m < m_rows) {
            const int p = m / n_pairs, i = m - p * n_pairs;
            const int l = left[i], r = right[i];
            const bool valid = l >= 0 && r >= 0;
            const uint32_t slot =
                (home_slot(valid ? l : 0, valid ? r : 0, slot_bits) + (uint32_t)p) & mask;
            target[mb][h] = (int)(slot >> 7);
            lane_of[mb][h] = (int)(slot & (kLanes - 1));
            round_of[mb][h] = p;
            pair_of[mb][h] = i;
          }
        }

      int acc[2][64];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[mb][j] = 0;

      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % kStages;
        uint32_t a[2][4][4];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int kb = kt * kTileK + kk * 32 + q * 4;
            a[mb][kk][0] = onehot4(target[mb][0], kb);
            a[mb][kk][1] = onehot4(target[mb][1], kb);
            a[mb][kk][2] = onehot4(target[mb][0], kb + 16);
            a[mb][kk][3] = onehot4(target[mb][1], kb + 16);
          }
        wait_phase(&full[s], (it / kStages) & 1);
        __syncwarp();  // wgmma is .aligned: the warp issues it together
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        const uint32_t base = smem_addr(stages + s * kStageBytes);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t desc = b_desc(base + kk * 32);
          wgmma_s8(acc[0], a[0][kk], desc);
          wgmma_s8(acc[1], a[1][kk], desc);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        if (lane == 0) arrive(&empty[s]);  // this warp is done with the stage
      }

      // Accumulator j of an m64n128 fragment is row g + 8 ((j >> 1) & 1),
      // column 8 (j >> 2) + 2 q + (j & 1).  Keep each row's lane.
      const int plane = n_tile / 3, array = n_tile % 3;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int want = lane_of[mb][h];
          if (want < 0 || ((want & 7) >> 1) != q) continue;
          int v = 0;
#pragma unroll
          for (int j = 0; j < 64; ++j)
            if (((j >> 1) & 1) == h && 8 * (j >> 2) + 2 * q + (j & 1) == want) v = acc[mb][j];
          const size_t word = ((size_t)array * rounds + round_of[mb][h]) * n_pairs + pair_of[mb][h];
          sel[word * 4 + plane] = (uint8_t)(v & 0xFF);
        }
    }
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point
// query, so the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

extern "C" {

// Probe an [S, 128] tile of pairs on `stream`.  tab_k is the byte planes
// K-major, [4 * 384, n_rows] int8 (the same bytes as [4, 384, n_rows]),
// 16-byte aligned; n_rows * 128 must be 2^slot_bits and n_rows a multiple of
// 128.  m_tiles is ceil(S * 128 * max_probes / 256) and grid the number of
// persistent CTAs (probe_cuda.onehot_tiling computes both).  scratch is
// [3, max_probes, S * 128] int32 that the caller allocates.
int tt_lookup_onehot(const int8_t* tab_k, int n_rows, int slot_bits, int max_probes,
                     const int* left, const int* right, int* out, int* scratch, int S,
                     int m_tiles, int grid, void* stream) {
  if (S <= 0 || max_probes < 1 || n_rows <= 0 || n_rows % kTileK != 0 || slot_bits < 14 ||
      slot_bits > 31 || ((long long)n_rows << 7) != (1LL << slot_bits) || grid <= 0 ||
      ((uintptr_t)tab_k & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long m_rows = (long long)S * kLanes * max_probes;
  if (m_rows > 0x7FFFFFFF || m_tiles != (int)((m_rows + kTileM - 1) / kTileM) ||
      (long long)m_tiles * kNTiles > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)n_rows, (cuuint64_t)kN};
  const cuuint64_t strides[1] = {(cuuint64_t)n_rows};
  const cuuint32_t box[2] = {kTileK, kTileN};
  const cuuint32_t steps[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(tab_k), dims, strides,
             box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  // The attribute belongs to the current device: set it on every call.
  cudaError_t err = cudaFuncSetAttribute(onehot_gemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_pairs = S * kLanes;
  onehot_gemm_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      map, n_rows / kTileK, slot_bits, left, right, reinterpret_cast<uint8_t*>(scratch),
      n_pairs, max_probes, (int)m_rows, m_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  onehot_resolve_kernel<<<(n_pairs + kResolveThreads - 1) / kResolveThreads, kResolveThreads,
                          0, st>>>(scratch, left, right, out, n_pairs, max_probes);
  return (int)cudaGetLastError();
}

}  // extern "C"
