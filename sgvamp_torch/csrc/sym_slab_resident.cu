// Symmetric block-banded matvec over float slab storage, resident flavor
// (Hopper).
//
// Replaces sgvamp_tpu/ops/band_kernel.py::_sym_slab_kernel (launcher
// _sym_slab_matvec).
//
// What it computes, per cohort k and right-hand side s, from slab storage
// upper (K, nb, (hb+1) B, B) with T_i[d B + q, p] = U[i,d][p, q] (the stacked
// transposes of block row i's upper blocks):
//   y_i[p]     += sum_w T_i[w, p] * x[i B + w],  w over the (hb+1) B window
//                 (row part: ONE product of the contiguous x window with T_i)
//   y_{i+d}[q] += sum_p T_i[d B + q, p] * x_i[p],  d >= 1   (mirror part:
//                 both operands contracted over their last axis)
// and every slab is read ONCE. x arrives in the block dtype, products and
// sums are float32 (float64 for float64 blocks), y is written in that type.
// The TPU kernel pads x by hb B zeros so that the window never leaves the
// array; here the window lives in shared memory, which is filled with zeros
// past the matrix end, and no x is read past the array.
//
// Design. The run scheme of sym_band_resident.cu: a CTA owns G consecutive
// block rows, keeps their x (and hb rows on either side) and their y in
// shared memory, one warp a block row, mirror terms into one slot a
// diagonal, a barrier, y written once, no atomics; the hb (hb + 1) / 2
// sub-blocks of the previous run whose mirror terms land in this run are read
// again by this CTA. Slab storage swaps which product reduces: the row part
// is a COLUMN sum of T_i (a lane owns output columns p, keeps their sums in
// registers over the whole window and needs one x value a slab row, with no
// shuffle), the mirror part a ROW sum (x_i at the lane's columns sits in
// registers for the whole slab, one shuffle reduction a slab row) - the
// reverse of the diag layout.
//
// Bound. As sym_band_resident.cu: bytes from HBM, 1 + hb / (2 G) of the
// stored slabs a pass; shared memory caps G.

#include "sym_band_tile.cuh"

namespace {

using namespace sgv;

template <typename T, int B, int S>
__global__ void __launch_bounds__(32 * kMaxRowsPerCta)
sym_slab_resident_kernel(const T* __restrict__ upper, const T* __restrict__ x,
                         typename AccOf<T>::type* __restrict__ y, int nb, int hb, int G) {
  using A = typename AccOf<T>::type;
  using L = Tile<T, B>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RunShared<A> sh(smem_raw, hb, G, B, S);
  const int r0 = blockIdx.x * G;
  const int k = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t M = static_cast<size_t>(nb) * B;
  const size_t slab = static_cast<size_t>(hb + 1) * B * B;
  const T* uk = upper + static_cast<size_t>(k) * nb * slab;

  run_begin<T, B, S>(x + static_cast<size_t>(k) * S * M, nb, hb, G, r0, sh);

  A xc[S][L::CV];     // x_i at this lane's columns p: the mirror part's operand
  A cacc[S][L::CV];   // y_i at this lane's columns p: the row part's sums

  // this warp's block row of the run
  const int i = r0 + warp;
  if (i < nb) {
    load_cols<T, B, S>(sh.xs + (warp + hb) * B, sh.xstride, lane, xc);
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int j = 0; j < L::CV; ++j) cacc[s][j] = A(0);
    const T* ti = uk + static_cast<size_t>(i) * slab;
    for (int d = 0; d <= hb && i + d < nb; ++d) {
      const T* g = ti + static_cast<size_t>(d) * B * B;   // slab rows d B .. (d+1) B - 1
      const A* xw = sh.xs + (warp + d + hb) * B;           // the window's x for those rows
      if (d > 0 && warp + d < G)
        walk_block<T, B, S, true, true>(g, lane, xc, xw, sh.xstride,
                                        sh.ym + (d - 1) * S * sh.ystride + (warp + d) * B,
                                        sh.ystride, cacc);
      else   // d = 0 has no mirror term; past the run the next CTA takes it
        walk_block<T, B, S, false, true>(g, lane, xc, xw, sh.xstride, nullptr, 0, cacc);
    }
    combine_cols<T, B, S>(cacc);
    add_cols<T, B, S>(sh.yr + warp * B, sh.ystride, lane, cacc);
  }
  // the sub-blocks of the previous run whose mirror terms land in this one,
  // dealt out to the warps from the last (they had the fewest mirror terms)
  int e = 0;
  for (int a = 1; a <= hb && r0 - a >= 0; ++a)
    for (int d = a; d <= hb; ++d) {
      const int target = d - a;   // block row of this run
      if (target >= G || r0 + target >= nb) continue;
      if (G - 1 - (e % G) == warp) {
        load_cols<T, B, S>(sh.xs + (hb - a) * B, sh.xstride, lane, xc);
        walk_block<T, B, S, true, false>(
            uk + static_cast<size_t>(r0 - a) * slab + static_cast<size_t>(d) * B * B, lane, xc,
            nullptr, 0, sh.ym + (d - 1) * S * sh.ystride + target * B, sh.ystride, cacc);
      }
      ++e;
    }

  run_end<T, B, S>(y + static_cast<size_t>(k) * S * M, nb, hb, r0, sh);
}

template <typename T, int B, int S>
struct Launch {
  static int run(const Args& a) {
    using A = typename AccOf<T>::type;
    return launch_rows<T, A>(sym_slab_resident_kernel<T, B, S>, a,
                             run_shared_bytes<A>(a.hb, a.G, B, S));
  }
};

}  // namespace

// upper (K, nb, (hb+1)*B, B) and x (K, S, nb*B) in the type named by dtype
// (0 bfloat16 as raw 16-bit words, 1 float32, 2 float64), y (K, S, nb*B) in
// float32 (float64 for dtype 2); all contiguous on the device. G block rows
// a CTA (1..16; any nb). Launches on `stream`; returns cudaGetLastError()
// after the launch, -1 for a dtype, block size, S or G the kernel is not
// built for, -2 when G rows need more shared memory than a CTA can have.
extern "C" int sgv_sym_slab_resident_matvec(const void* upper, const void* x, void* y, int K,
                                            int nb, int hb, int B, int S, int G, int dtype,
                                            void* stream) {
  const sgv::Args a{upper, x, y, K, nb, hb, G, static_cast<cudaStream_t>(stream)};
  return sgv::dispatch<Launch>(a, B, S, dtype);
}
