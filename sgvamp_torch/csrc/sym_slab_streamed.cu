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
// Spill form (one shard of a sharded operator; `carry` is not null). upper
// holds the shard's nb slabs, x its nb x blocks followed by the next shard's
// first hb (the halo). The row part of the last hb block rows multiplies
// the halo where the whole operator ends: inside a shard the sub-blocks d
// of T_i with i + d >= nb are ordinary data, so the window is not cut at
// the local end. And hb more warps a cohort, for the output block rows
// nb .. nb + hb - 1 that belong to the next shard, take only the mirror
// terms of this shard's slabs that land there (d > i - nb) and write them to
// carry; the caller adds carry into the head of the next shard's y. Mirror
// terms from the previous shard are not in y: they arrive as its carry.
//
// Bound. 4 S operations an element against 2 to 8 bytes: bytes from HBM.

#include "sym_band_tile.cuh"

namespace {

using namespace sgv;

template <typename T, int B, int S>
__global__ void __launch_bounds__(32 * kMaxRowsPerCta)
sym_slab_streamed_kernel(const T* __restrict__ upper, const T* __restrict__ x,
                         typename AccOf<T>::type* __restrict__ y,
                         typename AccOf<T>::type* __restrict__ carry, int nb, int hb, int G) {
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
  const int nx = carry ? nb + hb : nb;  // x block rows, and output block rows with the carry's
  const size_t M = static_cast<size_t>(nb) * B;
  const size_t slab = static_cast<size_t>(hb + 1) * B * B;
  const T* uk = upper + static_cast<size_t>(k) * nb * slab;

  load_x_rows<T, B, S>(x + static_cast<size_t>(k) * S * nx * B, nx, r0 - hb, G + 2 * hb, xs);
  for (int e = threadIdx.x; e < G * S * B; e += blockDim.x) ys[e] = A(0);
  __syncthreads();

  const int i = r0 + warp;
  if (i >= nx) return;
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
  for (int d = 0; i < nb && d <= hb && i + d < nx; ++d)
    walk_block<T, B, S, false, true>(uk + static_cast<size_t>(i) * slab
                                         + static_cast<size_t>(d) * B * B,
                                     lane, xc, xs + (warp + d + hb) * B, xstride, nullptr, 0,
                                     cacc);
  // mirror part: row sums of sub-block d of T_{i-d}
  for (int d = 1; d <= hb && i - d >= 0; ++d) {
    if (i - d >= nb) continue;  // a carry row: only this shard's slabs land in it
    load_cols<T, B, S>(xs + (warp - d + hb) * B, xstride, lane, xc);
    walk_block<T, B, S, true, false>(uk + static_cast<size_t>(i - d) * slab
                                         + static_cast<size_t>(d) * B * B,
                                     lane, xc, nullptr, 0, yw, B, cacc);
  }
  combine_cols<T, B, S>(cacc);
  __syncwarp();
  add_cols<T, B, S>(yw, B, lane, cacc);
  __syncwarp();
  // block rows past nb are the carry (K, S, hb * B)
  const size_t Mo = i < nb ? M : static_cast<size_t>(hb) * B;
  A* ok = (i < nb ? y + static_cast<size_t>(i) * B : carry + static_cast<size_t>(i - nb) * B)
          + static_cast<size_t>(k) * S * Mo;
#pragma unroll
  for (int s = 0; s < S; ++s)
    for (int col = lane; col < B; col += 32) ok[s * Mo + col] = yw[s * B + col];
}

template <typename T, int B, int S>
struct Launch {
  static int run(const Args& a) {
    using A = typename AccOf<T>::type;
    const size_t smem = static_cast<size_t>(S) * B * (2 * a.G + 2 * a.hb) * sizeof(A);
    auto kernel = sym_slab_streamed_kernel<T, B, S>;
    if (const int err = reserve_shared(kernel, smem)) return err;
    const int rows = a.carry ? a.nb + a.hb : a.nb;   // output block rows, one warp each
    kernel<<<dim3((rows + a.G - 1) / a.G, a.K), 32 * a.G, smem, a.stream>>>(
        static_cast<const T*>(a.upper), static_cast<const T*>(a.x), static_cast<A*>(a.y),
        static_cast<A*>(a.carry), a.nb, a.hb, a.G);
    return static_cast<int>(cudaGetLastError());
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

// The spill form: upper of one shard's nb slabs, x (K, S, (nb+hb)*B) with
// the halo, y (K, S, nb*B) and carry (K, S, hb*B) in y's type. With hb = 0
// nothing is written to carry (the caller's is one block of zeros). Returns
// as above.
extern "C" int sgv_sym_slab_streamed_spill(const void* upper, const void* x, void* y,
                                           void* carry, int K, int nb, int hb, int B, int S,
                                           int G, int dtype, void* stream) {
  if (carry == nullptr) return -1;
  const sgv::Args a{upper, x, y, K, nb, hb, G, static_cast<cudaStream_t>(stream), carry};
  return sgv::dispatch<Launch>(a, B, S, dtype);
}
