// Symmetric block-banded matvec over float slab storage, streamed flavor
// (Hopper).
//
// Replaces sgvamp_tpu/ops/band_kernel.py::_sym_slab_kernel_streamed
// (launcher _sym_slab_matvec_streamed), with spill=False and, through the
// second entry point, with spill=True.
//
// What it computes, per cohort k and right-hand side s, from slab storage
// upper (K, nb, (hb+1) B, B) with T_i[d B + q, p] = U[i,d][p, q]:
//   y_i[p] = sum_w T_i[w, p] * x[i B + w]             (row part: one product of
//                                                      the (hb+1) B window)
//          + sum_{d>=1} sum_p' T_{i-d}[d B + p, p'] * x_{i-d}[p']   (mirror part)
// x arrives in the block dtype, products and sums are float32 (float64 for
// float64 blocks), y is written in that type.
//
// Design: the read-once streamed scheme of sym_band_float.cu on slab
// storage, cut into its tiles of the band. A CTA takes the tile of run c (G
// consecutive block rows r0 = c G .. r0 + G - 1, one warp a block row) and
// range j (diagonals d0 = j D .. d0 + D - 1, at most hb); the wrapper picks
// (G, D) (ops/band_kernel.py::_slab_tiles). The warp of block row i walks
// the sub-blocks d0 .. d1 of its slab T_i once, sub-block d in phase d, and
// takes both products from the same registers. Slab storage swaps which
// product reduces (sym_band_tile.cuh): the row part is a column sum of T_i -
// a lane owns output columns p and keeps their sums in registers over the
// tile's sub-blocks, with x_{i+d} one value a slab row from the tile's x
// window in shared memory (block rows r0 + d0 .. r0 + G - 1 + d1) - and the
// mirror part a row sum, one shuffle reduction an output q, with x_i at the
// lane's columns in registers. A mirror sum that lands in the run (block
// row t = i + d < r0 + G) is added into the run's mirror sums in shared
// memory, one writer a row a phase, a barrier between the phases that write
// there; one that lands in a later run, or past the end of a shard in the
// spill form, is stored to the scratch of partial sums
// (sym_band_tile.cuh::Partials): which sums leave a CTA depends on its run
// alone, whatever the range.
//  * One range (J = 1; the spill form always): the CTA writes y of its run,
//    and the second launch, fold_partials, adds the partial sums into y in a
//    fixed order of d or writes them to carry. This pass runs the kernel's
//    instance without tiles (TILED false): the kernel before tiles, every
//    diagonal from 0, x_i from the window, whose code it keeps.
//  * J > 1 ranges: no tile holds a whole row sum, so the CTA stores its
//    run's row sums and in-run mirror sums to rows j nb + t of the second
//    part of the scratch (sym_band_tile.cuh::Scratch), and fold_tiles,
//    launched as the kernel's programmatic dependent, writes y_t from every
//    tile part and partial slot of block row t in one fixed order.
// No atomics and no CTA waits on another of its grid: the same bits on every
// run. Shared memory: the x window and the run's mirror sums, S B (2 G + D -
// 1) accumulator words (S B (2 G + hb) with one range); the wrapper cuts D
// until they fit.
//
// Spill form (one shard of a sharded operator; `carry` is not null). upper
// holds the shard's nb slabs, x its nb x blocks followed by the next shard's
// first hb (the halo). The row part of the last hb block rows multiplies
// the halo where the whole operator ends: inside a shard the sub-blocks d
// of T_i with i + d >= nb are ordinary data, so the window is not cut at
// the local end, and their mirror terms are the carry, which the caller adds
// into the head of the next shard's y. Mirror terms from the previous shard
// are not in y: they arrive as its carry. It takes runs of G <= 16 block
// rows and every diagonal (ops/band_kernel.py::_slab_runs).
//
// Bound. 4 S operations an element against 2 to 8 bytes: bytes from HBM. A
// pass reads every stored slab once, plus the partial sums written and read
// again (at most 2 S B hb accumulator words a block row, and with several
// ranges one row of S B words a tile). What stands in the way on this card,
// as for sym_band_float.cu: a warp streams its sub-blocks at a few GB/s, so
// the card needs on the order of a thousand warps with similar shares; a
// dense panel's whole triangle (nb = 64, hb = 64) in runs of 8 gave 16 CTAs,
// and the warp of block row 0 streamed all 65 of its sub-blocks.

#include "sym_band_tile.cuh"

namespace {

using namespace sgv;

// W: the most warps (block rows) a CTA of this instance has; runs of up to 8
// rows leave a thread 255 registers, runs of 16 (the spill form with
// rows_per_step=16) 128. TILED: the band is cut into J > 1 ranges (tl).
// Without it the CTA takes run blockIdx.x over every diagonal and writes y:
// the kernel before tiles, whose code a band that is not cut keeps.
template <typename T, int B, int S, int W, bool TILED>
__global__ void __launch_bounds__(32 * W)
sym_slab_streamed_kernel(const T* __restrict__ upper, const T* __restrict__ x,
                         typename AccOf<T>::type* __restrict__ y,
                         typename AccOf<T>::type* __restrict__ part, int nb, int hb, int G,
                         bool spill, const __grid_constant__ Tiles tl) {
  using A = typename AccOf<T>::type;
  using L = Tile<T, B>;
  constexpr int AHEAD = kStreamAhead<T, B>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the tile: range j (the last whose first tile is at most blockIdx.x),
  // run c of it, and its x window: block rows r0 + d0 .. r0 + d0 + xrows - 1
  const int j = TILED ? tile_range(tl) : 0;
  const int d0 = TILED ? j * tl.D : 0;
  const int d1 = !TILED ? hb : d0 + tl.D - 1 < hb ? d0 + tl.D - 1 : hb;
  const int xrows = TILED ? G + tl.D - 1 : G + hb;
  A* xs = reinterpret_cast<A*>(smem_raw);   // S x xrows x B: the x window
  const int xstride = xrows * B;
  const int gstride = G * B;
  A* ym = xs + S * xstride;                  // S x G x B: mirror sums from the run
  const int r0 = TILED ? (blockIdx.x - tl.start[j]) * G : blockIdx.x * G;
  const int k = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nx = spill ? nb + hb : nb;       // x block rows: with the halo in the spill form
  const size_t slab = static_cast<size_t>(hb + 1) * B * B;
  const T* uk = upper + static_cast<size_t>(k) * nb * slab;
  const T* xk = x + static_cast<size_t>(k) * S * nx * B;
  const Partials pp(nb, hb, G, spill);
  // between right-hand sides: Partials' slots, and with J > 1 the tiles' rows
  const size_t pstride = TILED ? Scratch(nb, hb, G, spill, tl.J).rows * B
                               : static_cast<size_t>(pp.F) * hb * B;
  A* pk = part + static_cast<size_t>(k) * S * pstride;

  load_x_rows<T, B, S>(xk, nx, r0 + d0, xrows, xs);
  for (int e = threadIdx.x; e < S * gstride; e += blockDim.x) ym[e] = A(0);
  __syncthreads();

  const int i = r0 + warp;
  A xc[S][L::CV];     // x_i at this lane's columns p: the mirror part's operand
  A cacc[S][L::CV];   // y_i at this lane's columns p: the row part's sums
  if constexpr (TILED) {
    // the window starts at r0 + d0: x_i from device memory
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int c = 0; c < L::CV; ++c) xc[s][c] = A(0);
    if (i < nb)
      load_cols_global<T, B, S>(xk + static_cast<size_t>(i) * B, static_cast<size_t>(nx) * B,
                                lane, xc);
  } else {
    load_cols<T, B, S>(xs + warp * B, xstride, lane, xc);
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int c = 0; c < L::CV; ++c) cacc[s][c] = A(0);
  for (int d = d0; d <= d1; ++d) {
    const int t = i + d;   // the sub-block's mirror term lands in block row t
    if (i < nb && t < nx) {
      const T* g = uk + static_cast<size_t>(i) * slab + static_cast<size_t>(d) * B * B;
      const A* xw = xs + (warp + d - d0) * B;   // the window's x for slab rows d B .. (d+1) B - 1
      if (d == 0)
        walk_block<T, B, S, false, true, false, AHEAD>(g, lane, xc, xw, xstride, nullptr, 0,
                                                       cacc);
      else if (t < r0 + G && t < nb)
        walk_block<T, B, S, true, true, false, AHEAD>(g, lane, xc, xw, xstride,
                                                      ym + (t - r0) * B, gstride, cacc);
      else
        walk_block<T, B, S, true, true, true, AHEAD>(
            g, lane, xc, xw, xstride, pk + (static_cast<size_t>(pp.row(t)) * hb + d - 1) * B,
            pstride, cacc);
    }
    // phase d's adds into ym are done before phase d + 1's begin
    if (d >= 1 && d + 1 < G) __syncthreads();
  }
  __syncthreads();

  // the row part + the mirror sums from the run: y_i with one range, else
  // the tile's row of the scratch
  if (i >= nb) return;
  combine_cols<T, B, S>(cacc);
  A* yw = ym + warp * B;
  add_cols<T, B, S>(yw, gstride, lane, cacc);
  __syncwarp();
  const size_t M = static_cast<size_t>(nb) * B;
  A* yk = TILED ? pk + (static_cast<size_t>(pp.F) * hb + static_cast<size_t>(j) * nb + i) * B
                : y + static_cast<size_t>(k) * S * M + static_cast<size_t>(i) * B;
  const size_t ostride = TILED ? pstride : M;
#pragma unroll
  for (int s = 0; s < S; ++s)
    for (int col = lane; col < B; col += 32) yk[s * ostride + col] = yw[s * gstride + col];
}

template <typename T, int B, int S>
struct Launch {
  static int run(const Args& a) {
    using A = typename AccOf<T>::type;
    // the x window of G + D - 1 block rows and the run's mirror sums
    const size_t smem = static_cast<size_t>(S) * B * (2 * a.G + a.D - 1) * sizeof(A);
    if (a.G <= 8)
      return launch_tiles<A, B, S>(sym_slab_streamed_kernel<T, B, S, 8, false>,
                                   sym_slab_streamed_kernel<T, B, S, 8, true>, a, a.D, smem,
                                   static_cast<const T*>(a.upper), static_cast<const T*>(a.x));
    // runs of more than 8 block rows take every diagonal in one range
    if (a.D != a.hb + 1) return -1;
    return launch_tiles<A, B, S>(sym_slab_streamed_kernel<T, B, S, kMaxRowsPerCta, false>,
                                 sym_slab_streamed_kernel<T, B, S, kMaxRowsPerCta, false>, a,
                                 a.D, smem, static_cast<const T*>(a.upper),
                                 static_cast<const T*>(a.x));
  }
};

}  // namespace

// upper (K, nb, (hb+1)*B, B) and x (K, S, nb*B) in the type named by dtype
// (0 bfloat16 as raw 16-bit words, 1 float32, 2 float64), y (K, S, nb*B) in
// float32 (float64 for dtype 2), partials the scratch (K, S, rows, B) in y's
// type (sym_band_tile.cuh::Scratch: Partials' F hb slots for runs of G,
// then J nb rows with J = ceil((hb + 1) / D) > 1 ranges; nothing for
// hb = 0); all contiguous on the device, upper on a 16-byte boundary. Tiles
// of G block rows (1..8; 9..16 with D = hb + 1; any nb) and D diagonals
// (1 <= D <= hb + 1, at most kMaxRanges ranges). Launches the kernel and its
// fold on `stream`; returns 0 or the first launch's error
// (cudaGetLastError() after each), 716 (cudaErrorMisalignedAddress) with
// nothing launched for an unaligned upper, -1 for a dtype, block size, S, G
// or D the kernel is not built for, -2 when the x window and the mirror
// sums, S B (2 G + D - 1) accumulator words, need more shared memory than a
// CTA can have.
extern "C" int sgv_sym_slab_streamed_matvec(const void* upper, const void* x, void* y,
                                            void* partials, int K, int nb, int hb, int B, int S,
                                            int G, int D, int dtype, void* stream) {
  const sgv::Args a{upper, x, y, K, nb, hb, G, static_cast<cudaStream_t>(stream), nullptr,
                    partials, D};
  return sgv::dispatch<Launch>(a, B, S, dtype);
}

// The spill form: upper of one shard's nb slabs, x (K, S, (nb+hb)*B) with
// the halo, y (K, S, nb*B) and carry (K, S, hb*B) in y's type, the scratch
// with the carry's hb rows; runs of G block rows (1..16), every diagonal in
// one range. With hb = 0 nothing is written to carry (the caller's is one
// block of zeros). Returns as above.
extern "C" int sgv_sym_slab_streamed_spill(const void* upper, const void* x, void* y,
                                           void* carry, void* partials, int K, int nb, int hb,
                                           int B, int S, int G, int dtype, void* stream) {
  if (carry == nullptr) return -1;
  const sgv::Args a{upper, x, y, K, nb, hb, G, static_cast<cudaStream_t>(stream), carry,
                    partials, hb + 1};
  return sgv::dispatch<Launch>(a, B, S, dtype);
}
