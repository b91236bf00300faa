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
// What bounds it on an H100: memory bytes. Every computed tile reads its
// [k, 128] index slab and k * 128 frontier rows of w words (random rows,
// each a contiguous w-word run) and writes 128 rows of w words once;
// there is one combine per word read, far below the card's operation
// rate (tpu_bfs/ops/ell_expand.py:ell_expand_hbm_bytes counts the same
// bytes). Hub rows repeat across the table, so most gathers can be L2
// hits, and the L2's capacity and rate, not device memory, set the pace:
// the flagship gathers about 41 GB a level from a 1.27 GB table.
//
// What the design does about it:
// - one block per (128-row tile, 32-word strip of the row's words), the
//   strip the slow grid axis: all tiles gather one strip of their rows
//   before the next strip starts. Of the strips measured on the flagship,
//   32 words was the fastest at 5.5 ms a level; 128 words took 7.4 ms and
//   whole 256-word rows 8.5 ms, and 16- and 8-word strips lost again
//   (8.3 and 16.1 ms) to sector-sized gathers and a re-staged index slab
//   per strip;
// - 16-byte loads: in a 32-word strip 8 lanes gather one row's 128 bytes,
//   so one warp instruction moves pieces of 4 rows;
// - the [kc, 128] index slab (and weight slab for minplus) is staged in
//   shared memory once per (tile, strip), kKc slots a pass;
// - each warp owns 16 output rows, gathers U slots of all of them at once
//   (16 row pieces of 128 bytes per slot in flight per warp in the 32-word
//   strip), and keeps its accumulators in registers, so each output word
//   is stored once (the Pallas kernel's VMEM-resident accumulator). A
//   table with more than kKc slots takes several passes, the later ones
//   folding into the stored rows;
// - a width that is not a multiple of 4 words, or an unaligned fw or out,
//   takes the same kernel with 4-byte loads.
// Block order is free: unlike the TPU grid nothing carries between tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;  // output rows per tile (== the gate tile)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kTile / kWarps;

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

// A lane's words of one row: NV vectors of VW words. LPR lanes share a row
// (32 / LPR rows a warp instruction); lane l works on row sub-index
// l / LPR and words col0 + v * LPR * VW + (l % LPR) * VW + t.
template <int VW, int NV>
struct Words {
  uint32_t x[NV][VW];
};

template <int VW, int LPR>
__device__ __forceinline__ int word_of(int col0, int li, int v) {
  return col0 + v * LPR * VW + li * VW;
}

// NC: through the read-only path (fw, which no block writes); otherwise a
// plain load (out, which this kernel wrote).
template <bool NC, int VW, int LPR, int NV>
__device__ __forceinline__ void load_row(Words<VW, NV>& r, const uint32_t* __restrict__ row,
                                         int col0, int li, int w, uint32_t fill) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int word = word_of<VW, LPR>(col0, li, v);
    if constexpr (VW == 4) {
      // w % 4 == 0: a lane's 4 words are all live or all dead.
      uint4 q = make_uint4(fill, fill, fill, fill);
      if (word < w) {
        const uint4* p = reinterpret_cast<const uint4*>(row + word);
        q = NC ? __ldg(p) : *p;
      }
      r.x[v][0] = q.x; r.x[v][1] = q.y; r.x[v][2] = q.z; r.x[v][3] = q.w;
    } else {
      r.x[v][0] = word < w ? (NC ? __ldg(row + word) : row[word]) : fill;
    }
  }
}

template <int VW, int LPR, int NV>
__device__ __forceinline__ void store_row(const Words<VW, NV>& r, uint32_t* row, int col0,
                                          int li, int w) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int word = word_of<VW, LPR>(col0, li, v);
    if (word >= w) continue;
    if constexpr (VW == 4) {
      *reinterpret_cast<uint4*>(row + word) =
          make_uint4(r.x[v][0], r.x[v][1], r.x[v][2], r.x[v][3]);
    } else {
      row[word] = r.x[v][0];
    }
  }
}

// One block per (128-row tile, strip of LPR * VW * NV words); a warp
// gathers U slots of G row slots (G * 32 / LPR rows) together.
template <int OP, int VW, int LPR, int NV, int G, int U>
__global__ void __launch_bounds__(kThreads, 2)
ell_expand_kernel(const int32_t* __restrict__ need_blk,
                  const int32_t* __restrict__ gt,
                  const uint32_t* __restrict__ fw,
                  const int32_t* __restrict__ wt,
                  uint32_t* __restrict__ out,
                  int k, int ncols, int w) {
  constexpr int kKc = OP == kMinPlus ? 32 : 64;  // slots a pass: 32 KB of shared memory
  constexpr int kRpi = 32 / LPR;                 // rows a warp instruction
  constexpr int kGroups = kRowsPerWarp / (G * kRpi);
  static_assert(kGroups * G * kRpi == kRowsPerWarp, "bad ell_expand shape");
  __shared__ int32_t s_idx[kKc][kTile];
  __shared__ int32_t s_wt[OP == kMinPlus ? kKc : 1][kTile];

  const int j = blockIdx.x;
  const int col0 = blockIdx.y * (LPR * VW * NV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int li = lane % LPR;
  const size_t row0 = (size_t)j * kTile;
  const int rbase = (tid >> 5) * kRowsPerWarp + lane / LPR;  // + m * kRpi
  const uint32_t ident = identity<OP>();

  if (need_blk[j] == 0) {  // uniform over the block: no barrier is skipped
    Words<VW, NV> id;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int t = 0; t < VW; ++t) id.x[v][t] = ident;
    }
    for (int m = 0; m < kRowsPerWarp / kRpi; ++m) {
      store_row<VW, LPR>(id, out + (row0 + rbase + m * kRpi) * (size_t)w, col0, li, w);
    }
    return;
  }

  for (int k0 = 0; k0 < k; k0 += kKc) {
    const int kc = min(kKc, k - k0);
    if (k0) __syncthreads();  // the previous pass is done reading the slab
    for (int e = tid; e < kc * kTile; e += kThreads) {
      const int kk = e / kTile;
      const int r = e - kk * kTile;
      const size_t src = (size_t)(k0 + kk) * ncols + row0 + r;
      s_idx[kk][r] = gt[src];
      if constexpr (OP == kMinPlus) s_wt[kk][r] = wt[src];
    }
    __syncthreads();
    for (int g = 0; g < kGroups; ++g) {
      const int rg = rbase + g * G * kRpi;  // row slot i is rg + i * kRpi
      Words<VW, NV> acc[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (k0 == 0) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
#pragma unroll
            for (int t = 0; t < VW; ++t) acc[i].x[v][t] = ident;
          }
        } else {  // this lane's own store of the previous pass
          load_row<false, VW, LPR>(acc[i], out + (row0 + rg + i * kRpi) * (size_t)w, col0, li,
                                   w, ident);
        }
      }
      for (int kk = 0; kk < kc; kk += U) {
        Words<VW, NV> got[U][G];
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int i = 0; i < G; ++i) {
            if (kk + u < kc) {
              const int idx = s_idx[kk + u][rg + i * kRpi];
              load_row<true, VW, LPR>(got[u][i], fw + (size_t)idx * w, col0, li, w, ident);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (kk + u >= kc) break;
#pragma unroll
          for (int i = 0; i < G; ++i) {
            const int32_t wv = OP == kMinPlus ? s_wt[kk + u][rg + i * kRpi] : 0;
#pragma unroll
            for (int v = 0; v < NV; ++v) {
#pragma unroll
              for (int t = 0; t < VW; ++t) {
                acc[i].x[v][t] = combine<OP>(acc[i].x[v][t], got[u][i].x[v][t], wv);
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        store_row<VW, LPR>(acc[i], out + (row0 + rg + i * kRpi) * (size_t)w, col0, li, w);
      }
    }
  }
}

template <int OP, int VW, int LPR, int NV, int G, int U>
int launch(const void* need_blk, const void* gt, const void* fw, const void* wt, void* out,
           int k, int ncols, int w, cudaStream_t stream) {
  constexpr int strip = LPR * VW * NV;
  dim3 grid(ncols / kTile, (w + strip - 1) / strip);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  ell_expand_kernel<OP, VW, LPR, NV, G, U><<<grid, kThreads, 0, stream>>>(
      (const int32_t*)need_blk, (const int32_t*)gt, (const uint32_t*)fw, (const int32_t*)wt,
      (uint32_t*)out, k, ncols, w);
  return (int)cudaGetLastError();
}

// vec: 16-byte loads over 32-word strips, 8 lanes a row (4 rows a warp
// instruction); otherwise 4-byte loads, 64 words a block.
template <int OP>
int launch_op(const void* need_blk, const void* gt, const void* fw, const void* wt, void* out,
              int k, int ncols, int w, int vec, cudaStream_t s) {
  if (!vec) return launch<OP, 1, 32, 2, 4, 2>(need_blk, gt, fw, wt, out, k, ncols, w, s);
  return launch<OP, 4, 8, 1, 4, 4>(need_blk, gt, fw, wt, out, k, ncols, w, s);
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 = launched). The caller
// allocates `out` [ncols, w]; `wt` is read only for op 2 (minplus). `vec`
// asks for 16-byte loads and stores (w % 4 == 0 and fw, out 16-byte
// aligned).
extern "C" int tpubfs_ell_expand(const void* need_blk, const void* gt,
                                 const void* fw, const void* wt, void* out,
                                 int k, int ncols, int w, int op, int vec, void* stream) {
  if (ncols / kTile == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kOr:
      return launch_op<kOr>(need_blk, gt, fw, wt, out, k, ncols, w, vec, s);
    case kMin:
      return launch_op<kMin>(need_blk, gt, fw, wt, out, k, ncols, w, vec, s);
    case kMinPlus:
      return launch_op<kMinPlus>(need_blk, gt, fw, wt, out, k, ncols, w, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
