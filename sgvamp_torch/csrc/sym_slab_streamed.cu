// Symmetric block-banded matvec over float slab storage, streamed flavor
// (Hopper).
//
// Replaces sgvamp_tpu/ops/band_kernel.py::_sym_slab_kernel_streamed
// (launcher _sym_slab_matvec_streamed), spill=False.
//
// What it computes, per cohort k and right-hand side s, from slab storage
// upper (K, nb, (hb+1) B, B) with T_i[d B + q, p] = U[i,d][p, q]:
//   y_i[p] = sum_w T_i[w, p] * x[i B + w]             (row part: one product of
//                                                      the (hb+1) B window)
//          + sum_{d>=1} sum_p' T_{i-d}[d B + p, p'] * x_{i-d}[p']   (mirror part)
// x arrives in the block dtype, products and sums are float32 (float64 for
// float64 blocks), y is written in that type.
//
// Design. The TPU kernel walks chunks of block rows in order and carries the
// mirror terms that cross a chunk in on-chip memory; CTAs run in no order, so
// this is a GATHER, as the diag-layout streamed kernels are: each output
// block row is computed whole by one warp, which reads its own slab T_i (the
// row part) and the sub-blocks d of the hb slabs before it (the mirror
// part), and writes y_i once. Nothing is exchanged, nothing is kept between
// block rows, and no shape is too large for it; the price is that every
// off-diagonal sub-block is read twice a pass, (2 hb + 1) / (hb + 1) of the
// stored bytes unless the second read hits a cache (the two readers are
// warps of one CTA or of neighbouring CTAs). A CTA is G warps on G
// consecutive block rows, which share the x of rows r0 - hb .. r0 + G + hb - 1
// in shared memory.
// Slab storage swaps which product reduces (sym_band_tile.cuh): the row part
// is a column sum of T_i - a lane owns output columns p and walks the window
// with its sums in registers and no shuffle - and the mirror part a row sum,
// one shuffle reduction an output q, with x_{i-d} at the lane's columns in
// registers.
//
// Bound. 4 S operations an element against 2 to 8 bytes: bytes from HBM.

#include "sym_band_tile.cuh"

namespace {

using namespace sgv;

template <typename T, int B, int S>
__global__ void __launch_bounds__(32 * kMaxRowsPerCta)
sym_slab_streamed_kernel(const T* __restrict__ upper, const T* __restrict__ x,
                         typename AccOf<T>::type* __restrict__ y, int nb, int hb, int G) {
  using A = typename AccOf<T>::type;
  using L = Tile<T, B>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* xs = reinterpret_cast<A*>(smem_raw);   // S x (G + 2 hb) x B
  const int xstride = (G + 2 * hb) * B;
  A* ys = xs + S * xstride;                  // G x S x B: each warp's mirror sums
  const int r0 = blockIdx.x * G;
  const int k = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t M = static_cast<size_t>(nb) * B;
  const size_t slab = static_cast<size_t>(hb + 1) * B * B;
  const T* uk = upper + static_cast<size_t>(k) * nb * slab;

  load_x_rows<T, B, S>(x + static_cast<size_t>(k) * S * M, nb, r0 - hb, G + 2 * hb, xs);
  for (int e = threadIdx.x; e < G * S * B; e += blockDim.x) ys[e] = A(0);
  __syncthreads();

  const int i = r0 + warp;
  if (i >= nb) return;
  A* yw = ys + warp * S * B;
  A xc[S][L::CV];
  A cacc[S][L::CV];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < L::CV; ++j) {
      xc[s][j] = A(0);
      cacc[s][j] = A(0);
    }
  // row part: the window product, column sums of T_i
  for (int d = 0; d <= hb && i + d < nb; ++d)
    walk_block<T, B, S, false, true>(uk + static_cast<size_t>(i) * slab
                                         + static_cast<size_t>(d) * B * B,
                                     lane, xc, xs + (warp + d + hb) * B, xstride, nullptr, 0,
                                     cacc);
  // mirror part: row sums of sub-block d of T_{i-d}
  for (int d = 1; d <= hb && i - d >= 0; ++d) {
    load_cols<T, B, S>(xs + (warp - d + hb) * B, xstride, lane, xc);
    walk_block<T, B, S, true, false>(uk + static_cast<size_t>(i - d) * slab
                                         + static_cast<size_t>(d) * B * B,
                                     lane, xc, nullptr, 0, yw, B, cacc);
  }
  combine_cols<T, B, S>(cacc);
  __syncwarp();
  add_cols<T, B, S>(yw, B, lane, cacc);
  __syncwarp();
  A* yk = y + static_cast<size_t>(k) * S * M + static_cast<size_t>(i) * B;
#pragma unroll
  for (int s = 0; s < S; ++s)
    for (int col = lane; col < B; col += 32) yk[s * M + col] = yw[s * B + col];
}

template <typename T, int B, int S>
struct Launch {
  static int run(const Args& a) {
    using A = typename AccOf<T>::type;
    const size_t smem = static_cast<size_t>(S) * B * (2 * a.G + 2 * a.hb) * sizeof(A);
    return launch_rows<T, A>(sym_slab_streamed_kernel<T, B, S>, a, smem);
  }
};

}  // namespace

// upper (K, nb, (hb+1)*B, B) and x (K, S, nb*B) in the type named by dtype
// (0 bfloat16 as raw 16-bit words, 1 float32, 2 float64), y (K, S, nb*B) in
// float32 (float64 for dtype 2); all contiguous on the device. G block rows
// (warps) a CTA, 1..16; any nb. Launches on `stream`; returns
// cudaGetLastError() after the launch, -1 for a dtype, block size, S or G
// the kernel is not built for, -2 when the x window needs more shared memory
// than a CTA can have.
extern "C" int sgv_sym_slab_streamed_matvec(const void* upper, const void* x, void* y, int K,
                                            int nb, int hb, int B, int S, int G, int dtype,
                                            void* stream) {
  const sgv::Args a{upper, x, y, K, nb, hb, G, static_cast<cudaStream_t>(stream)};
  return sgv::dispatch<Launch>(a, B, S, dtype);
}
