// tile_spmm: dense-tile frontier expansion over bit-packed 128x128 tiles.
//
// Replaces the Pallas TPU kernel tpu_bfs/ops/tile_spmm.py:tile_spmm
// (body _tile_spmm_kernel, pallas_call at tile_spmm.py:184).
//
// What it computes: for row tile j, output row r (of 128) is ORed with the
// OR, over the dense tiles b in [row_start[j], row_start[j+1]) and the
// columns c with A_b[r, c] = 1, of frontier row col_tile[b] * 128 + c
// (w words). The kernel reads A as row masks: word q of masks[b, r] holds
// columns 32q .. 32q+31 of row r (ops/tile_spmm.py:row_masks builds them
// once from the JAX layout). The output accumulates: the caller passes
// either zeros or a table to OR into (the hybrid engine's residual hits).
// Row tiles without dense tiles are not touched.
//
// What bounds it on an H100: device-memory bytes. Each dense tile needs
// its 2 KB of masks and a 128-row frontier slab of w words (128 KB at
// w = 256); a touched row tile is read and written once. The TPU kernel
// unpacks both operands to int8 and multiplies on the MXU: as an int8
// wgmma that is 2 * 128 * 128 * 32w operations a tile, about 13 ms a
// flagship level at the card's int8 peak, no better than streaming. A
// dense tile holds only about 2 % of its bits, so this kernel walks the
// set bits instead: one OR of a lane's words per edge, some 45x fewer
// operations.
//
// What the design does about it:
// - one block per (segment, chunk of kC = 128 words). A segment is at most
//   kSeg consecutive dense tiles of one row tile: hub row tiles hold
//   thousands of tiles and spread over many blocks, which merge with
//   atomicOr (OR is order-free, so the result is deterministic); a row tile
//   of one segment does a plain read-OR-write. The grid runs chunk-major:
//   all segments of chunk 0, then chunk 1;
// - a ring of kStages = 3 shared-memory stages, each one tile's masks and
//   its [128, kC] slab, filled with 16-byte cp.async. Every thread's copies
//   arrive on the stage's "full" mbarrier (cp.async.mbarrier.arrive), and
//   every thread arrives on its "empty" mbarrier once it has walked the
//   stage, so tiles b+1 and b+2 land while tile b is walked and a warp may
//   run a tile ahead of the others without a block barrier;
// - each of kWarps = 16 warps owns 8 output rows with their accumulators
//   in registers. It reads a row's four mask words with one broadcast
//   shared load and walks their set bits with __ffs (uniform over the
//   warp, so no divergence); a lane owns 4 words of the chunk, so one edge
//   is one 16-byte shared load and 4 ORs;
// - (kC, kStages, kWarps) = (128, 3, 16) with chunk-major order is the
//   fastest of the shapes measured on the flagship: 4.7 ms a launch against
//   the 4.3 ms its streamed bytes take at full rate; 64-word chunks, two
//   stages, 8 warps or chunk-minor order were 1 % to 60 % slower;
// - a width that is not a multiple of 4 words, or an unaligned operand,
//   takes the same kernel with 4-byte copies and scalar stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kMaskWords = kTile * 4;  // [128 rows][4 words] per tile
constexpr int kSeg = 32;               // dense tiles per segment at most
constexpr int kC = 128;                // frontier words per block
constexpr int kStages = 3;             // ring stages
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kTile / kWarps;  // output rows per warp
constexpr int kWpl = kC / 32;          // chunk words per lane: one uint4
constexpr int kStageWords = kMaskWords + kTile * kC;
constexpr int kRingBytes = kStages * kStageWords * 4;  // dynamic shared memory
static_assert(kWpl == 4 && kTile % kWarps == 0, "bad tile_spmm shape");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive on `bar` once every cp.async this thread issued so far has landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.b32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// acc |= the 4 words at p, one 16-byte shared load.
__device__ __forceinline__ void or_words(uint32_t (&acc)[kWpl], const uint32_t* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  acc[0] |= v.x; acc[1] |= v.y; acc[2] |= v.z; acc[3] |= v.w;
}

// VEC: w % 4 == 0 and fw, out 16-byte aligned (16-byte copies, vector
// stores); otherwise 4-byte copies and scalar stores.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
tile_spmm_kernel(const int32_t* __restrict__ row_start,
                 const int32_t* __restrict__ seg_end,
                 const int32_t* __restrict__ col_tile,
                 const uint32_t* __restrict__ masks,
                 const uint32_t* __restrict__ fw,
                 uint32_t* __restrict__ out, int num_row_tiles, int w) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];

  // Block -> (segment, chunk), chunk slowest: one pass over all tiles per
  // chunk. Segment -> (row tile j, its s-th run of kSeg tiles): seg_end is
  // the inclusive prefix sum of ceil(tiles_j / kSeg) over row tiles (0 for
  // a row tile without tiles).
  const int nseg = gridDim.x / ((w + kC - 1) / kC);
  const int seg = blockIdx.x % nseg;
  const int chunk = blockIdx.x / nseg;
  if (seg >= seg_end[num_row_tiles - 1]) return;  // uniform: grid is a bound
  int lo = 0, hi = num_row_tiles - 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (seg_end[mid] > seg) hi = mid; else lo = mid + 1;
  }
  const int j = lo;
  const int s = seg - (j ? seg_end[j - 1] : 0);
  const int b0 = row_start[j] + s * kSeg;
  const int n = min(kSeg, row_start[j + 1] - b0);
  const bool split = row_start[j + 1] - row_start[j] > kSeg;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col0 = chunk * kC;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], kThreads);
      mbar_init(&empty[st], kThreads);
    }
  }
  __syncthreads();

  // Start tile i's copies into stage i % kStages; every thread arrives on
  // the stage's full barrier when its own copies have landed.
  auto fill = [&](int i) {
    const int st = i % kStages;
    uint32_t* dst = smem + st * kStageWords;
    const int b = b0 + i;
    const uint32_t* msrc = masks + (size_t)b * kMaskWords;
    for (int g = tid; g < kMaskWords / 4; g += kThreads) cp_async16(dst + 4 * g, msrc + 4 * g);
    const uint32_t* slab = fw + (size_t)col_tile[b] * kTile * w;
    dst += kMaskWords;
    if constexpr (VEC) {
      constexpr int kGran = kC / 4;  // 16-byte granules per slab row
#pragma unroll 4
      for (int e = tid; e < kTile * kGran; e += kThreads) {
        const int c = e / kGran;
        const int word = col0 + 4 * (e - c * kGran);
        if (word < w) cp_async16(dst + c * kC + (word - col0), slab + (size_t)c * w + word);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < kTile * kC; e += kThreads) {
        const int c = e / kC;
        const int word = col0 + (e - c * kC);
        if (word < w) cp_async4(dst + c * kC + (word - col0), slab + (size_t)c * w + word);
      }
    }
    mbar_arrive_cp_async(&full[st]);
  };

  uint32_t acc[kRows][kWpl];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
    for (int t = 0; t < kWpl; ++t) acc[rr][t] = 0u;
  }

  for (int i = 0; i < min(kStages - 1, n); ++i) fill(i);
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    const uint32_t* stage = smem + st * kStageWords;
    const uint4* mrow = reinterpret_cast<const uint4*>(stage);
    const uint32_t* slab = stage + kMaskWords + lane * kWpl;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const uint4 mk = mrow[warp * kRows + rr];
      const uint32_t mw[4] = {mk.x, mk.y, mk.z, mk.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t m = mw[q];
        const uint32_t* sq = slab + q * 32 * kC;
        while (m) {
          const int c = __ffs(m) - 1;
          m &= m - 1;
          or_words(acc[rr], sq + c * kC);
        }
      }
    }
    mbar_arrive(&empty[st]);
    // Refill the stage tile i-1 used, once every thread has walked it.
    const int nx = i + kStages - 1;
    if (nx < n) {
      if (nx >= kStages) mbar_wait(&empty[nx % kStages], (nx / kStages - 1) & 1);
      fill(nx);
    }
  }

  const size_t row0 = (size_t)j * kTile;
  const int word0 = col0 + lane * kWpl;
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    uint32_t* dst = out + (row0 + warp * kRows + rr) * (size_t)w + word0;
    if constexpr (VEC) {
      // w % 4 == 0, so a lane's 4 words are all live or all dead.
      if (word0 >= w) continue;
      if (!split) {
        const uint4 v = *reinterpret_cast<const uint4*>(dst);
        *reinterpret_cast<uint4*>(dst) = make_uint4(v.x | acc[rr][0], v.y | acc[rr][1],
                                                    v.z | acc[rr][2], v.w | acc[rr][3]);
        continue;
      }
    }
#pragma unroll
    for (int t = 0; t < kWpl; ++t) {
      if (word0 + t >= w) break;
      if (!split) {
        dst[t] |= acc[rr][t];
      } else if (acc[rr][t]) {
        atomicOr(dst + t, acc[rr][t]);
      }
    }
  }
}

template <bool VEC>
int launch(const void* row_start, const void* seg_end, const void* col_tile,
           const void* masks, const void* fw, void* out, int num_row_tiles,
           int num_segments_bound, int w, cudaStream_t stream) {
  auto kernel = tile_spmm_kernel<VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)num_segments_bound * ((w + kC - 1) / kC);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, kRingBytes, stream>>>(
      (const int32_t*)row_start, (const int32_t*)seg_end, (const int32_t*)col_tile,
      (const uint32_t*)masks, (const uint32_t*)fw, (uint32_t*)out, num_row_tiles, w);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 = launched). The caller
// passes `seg_end` (see the kernel), `num_segments_bound` >= its last
// entry, `masks` [NT, 128, 4] (16-byte aligned) and `out` [num_row_tiles *
// 128, w], which the kernel ORs into. `vec` picks 16-byte copies (w % 4 ==
// 0, fw and out 16-byte aligned) or 4-byte ones.
extern "C" int tpubfs_tile_spmm(const void* row_start, const void* seg_end,
                                const void* col_tile, const void* masks,
                                const void* fw, void* out, int num_row_tiles,
                                int num_segments_bound, int w, int vec, void* stream) {
  if (num_row_tiles == 0 || num_segments_bound == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch<true>(row_start, seg_end, col_tile, masks, fw, out, num_row_tiles,
                            num_segments_bound, w, s)
             : launch<false>(row_start, seg_end, col_tile, masks, fw, out, num_row_tiles,
                             num_segments_bound, w, s);
}
