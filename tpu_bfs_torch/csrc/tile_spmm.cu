// tile_spmm: dense-tile frontier expansion over bit-packed 128x128 tiles.
//
// Replaces the Pallas TPU kernel tpu_bfs/ops/tile_spmm.py:tile_spmm
// (body _tile_spmm_kernel, pallas_call at tile_spmm.py:184).
//
// What it computes: for row tile j, output row r (of 128) is the OR, over
// the dense tiles b in [row_start[j], row_start[j+1]) and the columns c
// with A_b[r, c] = 1, of frontier row col_tile[b] * 128 + c (w words).
// A_b[r, c] is bit r / 4 of a_tiles[b, r % 4, c] (the JAX layout, kept at
// the public function). Empty row tiles write zeros.
//
// What bounds it on an H100: device-memory bytes. Each dense tile reads its
// 2 KB bit tile and a 128-row frontier slab of w words; each row tile
// writes 128 rows once. The TPU kernel unpacks both operands to int8 and
// runs a 128x128x(32w) matrix product per tile on the MXU; walked bit by
// bit that is 128 * 128 * w word operations per tile (4.2 M at w = 256,
// some 4e11 a level at the flagship's ~98k tiles) - far too slow. A dense
// tile holds only >= tile_thr (64) of its 16,384 entries, so this kernel
// walks the set bits of A instead: one OR of w words per edge.
//
// What the design does about it:
// - one block per (segment, 32-word chunk): a segment is at most kSeg (32)
//   consecutive dense tiles of one row tile. On a power-law graph the hub
//   row tiles hold thousands of dense tiles (up to ~vt at RMAT scale 21),
//   and one block per row tile walked them serially: measured 48 ms per
//   launch on the flagship against a 4 ms streamed-bytes model. A row
//   tile of more than kSeg tiles spreads over several blocks, which merge
//   with atomicOr into the zeroed output (OR is order-free, so the result
//   stays deterministic); a row tile of one segment stores plainly;
// - 8 warps of a block own 16 output rows each, accumulators in registers;
// - per dense tile, the block stages the 2 KB A tile and the [128, 32]
//   frontier slab chunk in shared memory with coalesced 128-byte loads;
// - a warp turns row r's 128 column bits into four 32-bit masks with
//   __ballot_sync (lane c tests bit r / 4 of A word [r % 4, c]) and walks
//   their set bits with __ffs; the mask is warp-uniform, so there is no
//   divergence, and each set bit costs one conflict-free shared read.
// Tensor-core forms (mma.sync int8, or b1 AND+POPC) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kAW = kTile / 32;    // u32 words per packed A row group
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kTile / kWarps;
constexpr int kChunkWords = 32;
constexpr int kSeg = 32;  // dense tiles per block at most

__global__ void __launch_bounds__(kWarps * 32)
tile_spmm_kernel(const int32_t* __restrict__ row_start,
                 const int32_t* __restrict__ seg_end,
                 const int32_t* __restrict__ col_tile,
                 const uint32_t* __restrict__ a_tiles,
                 const uint32_t* __restrict__ fw,
                 uint32_t* __restrict__ out, int num_row_tiles, int w) {
  __shared__ uint32_t s_a[kAW][kTile];
  __shared__ uint32_t s_f[kTile][kChunkWords];

  // Segment -> (row tile j, its s-th run of kSeg tiles); seg_end is the
  // inclusive prefix sum of max(1, ceil(tiles_j / kSeg)) over row tiles.
  const int seg = blockIdx.x;
  if (seg >= seg_end[num_row_tiles - 1]) return;  // uniform: grid is a bound
  int lo = 0, hi = num_row_tiles - 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (seg_end[mid] > seg) hi = mid; else lo = mid + 1;
  }
  const int j = lo;
  const int s = seg - (j ? seg_end[j - 1] : 0);
  const int b0 = row_start[j] + s * kSeg;
  const int b1 = min(b0 + kSeg, row_start[j + 1]);
  const bool split = row_start[j + 1] - row_start[j] > kSeg;

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int word = blockIdx.y * kChunkWords + lane;
  const bool live = word < w;

  uint32_t acc[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) acc[i] = 0u;

  for (int b = b0; b < b1; ++b) {
    __syncthreads();  // the previous tile is done with the staged slabs
    const uint32_t* a = a_tiles + (size_t)b * (kAW * kTile);
    for (int e = tid; e < kAW * kTile; e += kWarps * 32) {
      s_a[e / kTile][e % kTile] = a[e];
    }
    const size_t base = (size_t)col_tile[b] * kTile;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int c = warp + i * kWarps;
      s_f[c][lane] = live ? fw[(base + c) * (size_t)w + word] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps;
      const int aw = r % kAW;
      const int bit = r / kAW;
      uint32_t h = acc[i];
#pragma unroll
      for (int q = 0; q < kTile / 32; ++q) {
        uint32_t m = __ballot_sync(0xFFFFFFFFu, (s_a[aw][q * 32 + lane] >> bit) & 1u);
        while (m) {
          const int c = __ffs(m) - 1;
          m &= m - 1;
          h |= s_f[q * 32 + c][lane];
        }
      }
      acc[i] = h;
    }
  }
  if (live) {
    const size_t row0 = (size_t)j * kTile;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      uint32_t* dst = &out[(row0 + warp + i * kWarps) * (size_t)w + word];
      if (!split) {
        *dst = acc[i];
      } else if (acc[i]) {
        atomicOr(dst, acc[i]);
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched). The caller
// passes `seg_end` (see the kernel) and `num_segments_bound` >= its last
// entry, and allocates `out` [num_row_tiles * 128, w] zeroed: split row
// tiles merge into it with atomicOr.
extern "C" int tpubfs_tile_spmm(const void* row_start, const void* seg_end,
                                const void* col_tile, const void* a_tiles,
                                const void* fw, void* out, int num_row_tiles,
                                int num_segments_bound, int w, void* stream) {
  if (num_row_tiles == 0) return (int)cudaGetLastError();
  dim3 grid(num_segments_bound, (w + kChunkWords - 1) / kChunkWords);
  dim3 block(32, kWarps);
  tile_spmm_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)row_start, (const int32_t*)seg_end,
      (const int32_t*)col_tile, (const uint32_t*)a_tiles, (const uint32_t*)fw,
      (uint32_t*)out, num_row_tiles, w);
  return (int)cudaGetLastError();
}
