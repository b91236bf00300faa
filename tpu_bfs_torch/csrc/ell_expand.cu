// ell_expand: gated gather-combine over one padded bucketed-ELL table.
//
// Replaces the Pallas TPU kernel tpu_bfs/ops/ell_expand.py:ell_expand
// (body _ell_expand_kernel, pallas_call at ell_expand.py:225).
//
// What it computes: for each 128-row output tile j with need_blk[j] != 0,
// output row r is combine_kk fw[gt[kk, r]] (+ wt[kk, r] for minplus); a
// gated-out tile writes the op identity. Words are 32-bit; the tensors
// arrive as int32 and are read as uint32 here.
//
// What bounds it on an H100: device-memory bytes. Every computed tile
// reads its [k, 128] index slab and k * 128 frontier rows of w words
// (random rows, each a contiguous w-word run) and writes 128 rows of w
// words once; there is one combine per word read, far below the card's
// operation rate (tpu_bfs/ops/ell_expand.py:ell_expand_hbm_bytes counts
// the same bytes).
//
// What the design does about it:
// - one block per (128-row tile, 32-word chunk of the row): the 32 lanes
//   of a warp read 32 neighbouring words of one gathered row, so every
//   gather is a coalesced 128-byte transaction;
// - each of the 8 warps owns 16 output rows and keeps their accumulators
//   in registers for all k slots, so each output word is stored once
//   (the Pallas kernel's VMEM-resident accumulator);
// - the index (and weight) slab is staged through shared memory 32 slots
//   at a time, so any k fits a fixed 16 KB (32 KB for minplus) and every
//   warp reads its row ids as shared-memory broadcasts;
// - the 16 gathers of one slot are independent loads, unrolled, so a warp
//   keeps 16 row reads in flight to hide the gather latency.
// Block order is free: unlike the TPU grid nothing carries between tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;         // output rows per tile (== the gate tile)
constexpr int kWarps = 8;          // warps per block
constexpr int kRowsPerWarp = kTile / kWarps;
constexpr int kChunkWords = 32;    // words per block: one per lane
constexpr int kSlotChunk = 32;     // index-slab slots staged per pass

enum Op { kOr = 0, kMin = 1, kMinPlus = 2 };

template <int OP>
__device__ __forceinline__ uint32_t identity() {
  if (OP == kOr) return 0u;
  if (OP == kMin) return 0xFFFFFFFFu;
  return 1u << 29;  // MINPLUS_IDENT, the SSSP "unreached" value
}

template <int OP>
__device__ __forceinline__ uint32_t combine(uint32_t acc, uint32_t v, int32_t wt) {
  if (OP == kOr) return acc | v;
  if (OP == kMin) return v < acc ? v : acc;  // unsigned compare
  // minplus over int32: dist + weight, wrapping like the int32 reference.
  int32_t cand = (int32_t)(v + (uint32_t)wt);
  int32_t a = (int32_t)acc;
  return (uint32_t)(cand < a ? cand : a);
}

template <int OP>
__global__ void __launch_bounds__(kWarps * 32)
ell_expand_kernel(const int32_t* __restrict__ need_blk,
                  const int32_t* __restrict__ gt,
                  const uint32_t* __restrict__ fw,
                  const int32_t* __restrict__ wt,
                  uint32_t* __restrict__ out,
                  int k, int ncols, int w) {
  __shared__ int32_t s_idx[kSlotChunk][kTile];
  __shared__ int32_t s_wt[OP == kMinPlus ? kSlotChunk : 1][kTile];

  const int j = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int word = blockIdx.y * kChunkWords + lane;
  const bool live = word < w;
  const size_t row0 = (size_t)j * kTile;
  const uint32_t ident = identity<OP>();

  if (need_blk[j] == 0) {  // uniform over the block: no barrier is skipped
    if (live) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        out[(row0 + warp + i * kWarps) * (size_t)w + word] = ident;
      }
    }
    return;
  }

  uint32_t acc[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) acc[i] = ident;

  const int tid = warp * 32 + lane;
  for (int k0 = 0; k0 < k; k0 += kSlotChunk) {
    const int kc = min(kSlotChunk, k - k0);
    __syncthreads();  // the previous pass is done reading the slab
    for (int e = tid; e < kc * kTile; e += kWarps * 32) {
      const int kk = e / kTile;
      const int r = e - kk * kTile;
      const size_t src = (size_t)(k0 + kk) * ncols + row0 + r;
      s_idx[kk][r] = gt[src];
      if (OP == kMinPlus) s_wt[kk][r] = wt[src];
    }
    __syncthreads();
    if (live) {
      for (int kk = 0; kk < kc; ++kk) {
        uint32_t v[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          v[i] = __ldg(&fw[(size_t)s_idx[kk][warp + i * kWarps] * w + word]);
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int32_t wv = OP == kMinPlus ? s_wt[kk][warp + i * kWarps] : 0;
          acc[i] = combine<OP>(acc[i], v[i], wv);
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      out[(row0 + warp + i * kWarps) * (size_t)w + word] = acc[i];
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). The caller
// allocates `out` [ncols, w]; `wt` is read only for op 2 (minplus).
extern "C" int tpubfs_ell_expand(const void* need_blk, const void* gt,
                                 const void* fw, const void* wt, void* out,
                                 int k, int ncols, int w, int op,
                                 void* stream) {
  const int nb = ncols / kTile;
  if (nb == 0) return (int)cudaGetLastError();
  dim3 grid(nb, (w + kChunkWords - 1) / kChunkWords);
  dim3 block(32, kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* n = (const int32_t*)need_blk;
  const int32_t* g = (const int32_t*)gt;
  const uint32_t* f = (const uint32_t*)fw;
  const int32_t* t = (const int32_t*)wt;
  uint32_t* o = (uint32_t*)out;
  switch (op) {
    case kOr:
      ell_expand_kernel<kOr><<<grid, block, 0, s>>>(n, g, f, t, o, k, ncols, w);
      break;
    case kMin:
      ell_expand_kernel<kMin><<<grid, block, 0, s>>>(n, g, f, t, o, k, ncols, w);
      break;
    case kMinPlus:
      ell_expand_kernel<kMinPlus><<<grid, block, 0, s>>>(n, g, f, t, o, k, ncols, w);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
