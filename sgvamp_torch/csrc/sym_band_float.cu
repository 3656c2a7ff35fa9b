// Symmetric block-banded matvec over float upper-triangle blocks, streamed
// flavor, diag layout (Hopper).
//
// Replaces sgvamp_tpu/ops/band_kernel.py::_sym_band_kernel_streamed, the
// unquantized flavor (blocks in bfloat16, float32 or float64, no scales),
// with spill=False and, through the second entry point, with spill=True.
//
// What it computes, per cohort k and right-hand side s:
//   y_i = sum_{d=0..hb, i+d<nb} U[i,d]     @ x_{i+d}     (row part)
//       + sum_{d=1..hb, i-d>=0} U[i-d,d]^T @ x_{i-d}     (mirror part)
// with U[i,d] the (B, B) block R[block i, block i+d]. x arrives in the
// block dtype (bf16 blocks see a bf16 x, f32 blocks an f32 x), products and
// sums are taken in f32 (f64 for f64 blocks) and y is written in that
// type. A float32 block times a float32 x is a true float32 product here;
// the TPU's matrix unit truncates f32 operands to bf16 at its default
// precision.
//
// Bound. 2*S flops per element read (S <= 4), against 2 to 8 bytes per
// element: bytes from HBM. A pass reads the stored blocks once, plus the
// partial sums written and read again: at most 2 S B hb accumulator words a
// block row (those of the first min(hb, G) rows of a run), and with tiles
// of several diagonal ranges one row of S B words a tile. What stands in
// the way on this card: a warp streams its blocks at a few GB/s while
// latency bounds it, so the card needs on the order of a thousand warps,
// each with a similar share, to reach its rate. A band of few block rows
// and many diagonals (a dense panel's whole triangle, nb = 64 and hb = 64)
// must not be cut by block rows alone, where the warp of block row 0 would
// stream all 65 of its blocks (2 MiB in bf16 at B = 128) while the card
// idles.
//
// Design: every stored block is read ONCE a pass, and the band is cut into
// tiles (sym_band_tile.cuh's Tiles, shared with sym_band_int8.cu). A CTA
// takes the tile of run c (G consecutive block rows, one warp a block row)
// and range j (diagonals d0 = j D .. d0 + D - 1, at most hb); the wrapper
// picks (G, D) (ops/band_kernel.py::_float_tiles: every diagonal in one
// range where the runs put enough warps on the card, else the fewest ranges
// that do). The warp of block row i walks its blocks d = d0..d1 in phases,
// one block a phase (sym_band_tile.cuh's walker: 16-byte loads, x_{i+d} at
// the lane's columns in registers). From the same registers it takes both
// products of block (i, d): the row term into the tile's row sums (shared
// memory, one writer a row) and the mirror term of block row t = i + d.
// Where t lies in the run the mirror sum is added into the tile's mirror
// sums in shared memory: in phase d warp w writes row w + d, one writer a
// row a phase, and a barrier separates the phases that write there
// (d < G). Where t lies in a later run, or past the end of a shard in the
// spill form, the sum goes to a scratch of partial sums in device memory,
// one slot a (t, d) (sym_band_tile.cuh::Partials): which sums leave a CTA
// depends on its run only, whatever the range.
//  * One range (J = 1; the spill form always): the CTA writes y of its run
//    once, and a second launch on the same stream, fold_partials, adds the
//    partial sums into y in a fixed order of d, and in the spill form
//    writes the sums that land in block rows nb .. nb + hb - 1 (the next
//    shard's head) to carry. That pass runs the kernel's instance without
//    tiles (TILED false): no search, every diagonal from 0.
//  * J > 1 ranges: no tile holds a whole row sum, so the CTA stores its
//    run's row + mirror sums to rows j nb + t of a second part of the
//    scratch (sym_band_tile.cuh::Scratch), and fold_tiles, launched as the
//    kernel's programmatic dependent, writes y_t from every tile part and
//    partial slot of block row t in one fixed order.
// No atomics, no CTA waits on another of its grid: the same bits on every
// run. Shared memory: x of the run (the mirror products' operand, one value
// a block row), its row sums and its mirror sums, 3 G S B accumulator
// words, whatever D is; x_{i+d} comes from device memory (L2), so any hb
// fits.
//
// Spill form (one shard of a sharded operator; `carry` is not null): x
// carries the next shard's first hb blocks after the shard's own nb (the
// halo), the row part of the last hb block rows multiplies them (blocks
// with i+d >= nb are ordinary data inside a shard), and their mirror terms
// are the carry.

#include "sym_band_tile.cuh"

namespace {

using namespace sgv;

// the most block rows a run may have: the wrapper's DIAG_RUN_ROWS
// (ops/band_kernel.py); 256 threads leave a thread up to 255 registers
constexpr int kMaxRunRows = 8;

// TILED: the band is cut into J > 1 ranges (tl). Without it the CTA takes
// run blockIdx.x over every diagonal and writes y: the kernel before tiles,
// whose code a band that is not cut keeps.
template <typename T, int B, int S, bool TILED>
__global__ void __launch_bounds__(32 * kMaxRunRows)
sym_band_float_kernel(const T* __restrict__ upper, const T* __restrict__ x,
                      typename AccOf<T>::type* __restrict__ y,
                      typename AccOf<T>::type* __restrict__ part, int nb, int hb, int G,
                      bool spill, const __grid_constant__ Tiles tl) {
  using A = typename AccOf<T>::type;
  using L = Tile<T, B>;
  constexpr int AHEAD = kStreamAhead<T, B>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int gstride = G * B;                   // between right-hand sides
  A* xs = reinterpret_cast<A*>(smem_raw);      // S x G x B: x of the run
  A* yr = xs + S * gstride;                    // S x G x B: row sums
  A* ym = yr + S * gstride;                    // S x G x B: mirror sums from the run
  // the tile: range j (the last whose first tile is at most blockIdx.x),
  // run c of it
  const int j = TILED ? tile_range(tl) : 0;
  const int r0 = TILED ? (blockIdx.x - tl.start[j]) * G : blockIdx.x * G;
  const int d0 = TILED ? j * tl.D : 0;
  const int d1 = !TILED ? hb : d0 + tl.D - 1 < hb ? d0 + tl.D - 1 : hb;
  const int k = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nx = spill ? nb + hb : nb;         // x block rows: with the halo in the spill form
  const size_t Mx = static_cast<size_t>(nx) * B;
  const T* uk = upper + static_cast<size_t>(k) * nb * (hb + 1) * B * B;
  const T* xk = x + static_cast<size_t>(k) * S * Mx;
  const Scratch scr(nb, hb, G, spill, TILED ? tl.J : 1);
  const Partials& pp = scr.pp;
  const size_t pstride = scr.rows * B;         // between right-hand sides
  A* pk = part + static_cast<size_t>(k) * S * pstride;

  load_x_rows<T, B, S>(xk, nx, r0, G, xs);
  for (int e = threadIdx.x; e < 2 * S * gstride; e += blockDim.x) yr[e] = A(0);
  __syncthreads();

  const int i = r0 + warp;
  for (int d = d0; d <= d1; ++d) {
    const int t = i + d;   // the block's mirror term lands in block row t
    if (i < nb && t < nx) {
      const T* g = uk + (static_cast<size_t>(i) * (hb + 1) + d) * B * B;
      A xc[S][L::CV];
      A cacc[S][L::CV];
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int c = 0; c < L::CV; ++c) cacc[s][c] = A(0);
      load_cols_global<T, B, S>(xk + static_cast<size_t>(t) * B, Mx, lane, xc);
      if (d == 0) {
        walk_block<T, B, S, true, false, false, AHEAD>(g, lane, xc, nullptr, 0, yr + warp * B,
                                                       gstride, cacc);
      } else {
        walk_block<T, B, S, true, true, false, AHEAD>(g, lane, xc, xs + warp * B, gstride,
                                                      yr + warp * B, gstride, cacc);
        combine_cols<T, B, S>(cacc);
        if (t < r0 + G && t < nb)
          add_cols<T, B, S>(ym + (t - r0) * B, gstride, lane, cacc);
        else
          store_cols<T, B, S>(pk + (static_cast<size_t>(pp.row(t)) * hb + d - 1) * B, pstride,
                              lane, cacc);
      }
    }
    // phase d's adds into ym are done before phase d + 1's begin
    if (d >= 1 && d + 1 < G) __syncthreads();
  }
  __syncthreads();

  // the run's row sums + the mirror sums from inside the run: y with one
  // range, else the tile's rows of the scratch
  const size_t M = static_cast<size_t>(nb) * B;
  A* out = !TILED ? y + static_cast<size_t>(k) * S * M + static_cast<size_t>(r0) * B
                  : pk + (static_cast<size_t>(pp.F) * hb + static_cast<size_t>(j) * nb + r0) * B;
  const size_t ostride = !TILED ? M : pstride;
  for (int e = threadIdx.x; e < S * gstride; e += blockDim.x) {
    const int s = e / gstride;
    const int w = e - s * gstride;   // (block row of the run) * B + column
    if (r0 + w / B >= nb) continue;
    out[s * ostride + w] = yr[e] + ym[e];
  }
}

template <typename T, int B, int S>
struct Launch {
  static int run(const Args& a) {
    using A = typename AccOf<T>::type;
    if (a.G > kMaxRunRows) return -1;
    return launch_tiles<A, B, S>(sym_band_float_kernel<T, B, S, false>,
                                 sym_band_float_kernel<T, B, S, true>, a, a.D,
                                 3 * static_cast<size_t>(S) * B * a.G * sizeof(A),
                                 static_cast<const T*>(a.upper), static_cast<const T*>(a.x));
  }
};

}  // namespace

// upper (K, nb, hb+1, B, B) and x (K, S, nb*B) in the type named by dtype
// (0 bfloat16 as raw 16-bit words, 1 float32, 2 float64), y (K, S, nb*B) in
// float32 (float64 for dtype 2), partials the scratch (K, S, rows, B) in y's
// type (sym_band_tile.cuh::Scratch: Partials' F hb slots for runs of G,
// then J nb rows with J = ceil((hb + 1) / D) > 1 ranges; nothing for
// hb = 0); all contiguous on the device, upper on a 16-byte boundary. Tiles
// of G block rows (1..8; any nb) and D diagonals (1 <= D <= hb + 1, at most
// kMaxRanges ranges). Launches the kernel and its fold on `stream`; returns
// 0 or the first launch's error (cudaGetLastError() after each), 716
// (cudaErrorMisalignedAddress) with nothing launched for an unaligned upper,
// -1 for a dtype, block size, S, G or D the kernel is not built for.
extern "C" int sgv_sym_band_float_matvec(const void* upper, const void* x, void* y,
                                         void* partials, int K, int nb, int hb, int B, int S,
                                         int G, int D, int dtype, void* stream) {
  const sgv::Args a{upper, x, y, K, nb, hb, G, static_cast<cudaStream_t>(stream), nullptr,
                    partials, D};
  return sgv::dispatch<Launch>(a, B, S, dtype);
}

// The spill form: upper of one shard's nb block rows, x (K, S, (nb+hb)*B)
// with the halo, y (K, S, nb*B) and carry (K, S, hb*B) in y's type, the
// scratch with the carry's hb rows; one range, D = hb + 1. With hb = 0
// nothing is written to carry (the caller's is one block of zeros). Returns
// as above.
extern "C" int sgv_sym_band_float_spill(const void* upper, const void* x, void* y, void* carry,
                                        void* partials, int K, int nb, int hb, int B, int S,
                                        int G, int D, int dtype, void* stream) {
  if (carry == nullptr) return -1;
  const sgv::Args a{upper, x, y, K, nb, hb, G, static_cast<cudaStream_t>(stream), carry,
                    partials, D};
  return sgv::dispatch<Launch>(a, B, S, dtype);
}
