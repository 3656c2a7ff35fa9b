// Symmetric block-banded matvec over float upper-triangle blocks, resident
// flavor, diag layout (Hopper).
//
// Replaces sgvamp_tpu/ops/band_kernel.py::_sym_band_kernel (launcher
// _sym_band_matvec), with and without its `window` flag.
//
// What it computes, per cohort k and right-hand side s, from
// upper (K, nb, hb+1, B, B) with U[i,d] = R[block i, block i+d]:
//   every stored block is read ONCE and gives both its terms,
//     y_i     += U[i,d]   @ x_{i+d}    (row term)
//     y_{i+d} += U[i,d]^T @ x_i        (mirror term, d >= 1)
// x arrives in the block dtype, products and sums are float32 (float64 for
// float64 blocks), y is written in that type.
//
// Design. The TPU kernel keeps x and y whole in on-chip memory and walks the
// block rows one after another, which is what makes its adds into y free of
// races. No SM can hold x and y whole, and CTAs run in no order, so here the
// unit that stays on chip is a RUN: a CTA owns G consecutive block rows and
// keeps in shared memory the x of those rows and of the hb rows on either
// side, and the y of the run. One warp takes one block row: it reads the
// row's hb+1 blocks once, in 16-byte vectors, and from the same registers
// adds the row term into its own row of y (a shuffle reduction a block row)
// and collects the mirror term of its columns (sym_band_tile.cuh). Mirror
// terms go to a slot of their own per diagonal, so every word of shared
// memory has one writing warp; after a barrier the slots are summed in a
// fixed order and y is written once. No atomics: the same bits on every run.
// Mirror terms that cross into the NEXT run are not exchanged: the next CTA
// reads the hb (hb + 1) / 2 blocks of its neighbour's last hb rows again and
// takes only their mirror terms (one launch, nothing carried between CTAs).
// So a pass reads 1 + hb / (2 G) of the stored blocks, against
// (2 hb + 1) / (hb + 1) for the gather of sym_band_float.cu.
// The `window` flag of the TPU kernel (row part as one product over the
// (hb+1) B window of x) changes nothing here: a warp already walks the hb+1
// blocks of its row in one sweep with x in registers, so both values of the
// flag run this instruction stream.
//
// Bound. 4 S operations an element against 2 to 8 bytes: bytes from HBM. The
// shared memory a CTA needs, S B (G (hb + 2) + 2 hb) accumulator words, caps
// G; the wrapper picks it (SymBandedLD.resident_rows).

#include "sym_band_tile.cuh"

namespace {

using namespace sgv;

// The warp's share of block (i, d): ROW adds the row term into row i of the
// run, MIR the mirror term into slot d of row i + d.
template <typename T, int B, int S, bool ROW, bool MIR>
__device__ __forceinline__ void diag_block(const T* __restrict__ uk, int hb, int G, int r0,
                                           int i, int d, int lane,
                                           const RunShared<typename AccOf<T>::type>& sh) {
  using A = typename AccOf<T>::type;
  using L = Tile<T, B>;
  const T* g = uk + (static_cast<size_t>(i) * (hb + 1) + d) * B * B;
  A xc[S][L::CV];
  A cacc[S][L::CV];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < L::CV; ++j) {
      xc[s][j] = A(0);
      cacc[s][j] = A(0);
    }
  if constexpr (ROW) load_cols<T, B, S>(sh.xs + (i + d - r0 + hb) * B, sh.xstride, lane, xc);
  walk_block<T, B, S, ROW, MIR>(g, lane, xc, sh.xs + (i - r0 + hb) * B, sh.xstride,
                                sh.yr + (i - r0) * B, sh.ystride, cacc);
  if constexpr (MIR) {
    combine_cols<T, B, S>(cacc);
    add_cols<T, B, S>(sh.ym + (d - 1) * S * sh.ystride + (i + d - r0) * B, sh.ystride, lane,
                      cacc);
  }
}

template <typename T, int B, int S>
__global__ void __launch_bounds__(32 * kMaxRowsPerCta)
sym_band_resident_kernel(const T* __restrict__ upper, const T* __restrict__ x,
                         typename AccOf<T>::type* __restrict__ y, int nb, int hb, int G) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RunShared<A> sh(smem_raw, hb, G, B, S);
  const int r0 = blockIdx.x * G;
  const int k = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t M = static_cast<size_t>(nb) * B;
  const T* uk = upper + static_cast<size_t>(k) * nb * (hb + 1) * B * B;

  run_begin<T, B, S>(x + static_cast<size_t>(k) * S * M, nb, hb, G, r0, sh);

  // this warp's block row of the run
  const int i = r0 + warp;
  if (i < nb) {
    for (int d = 0; d <= hb && i + d < nb; ++d) {
      if (d > 0 && warp + d < G)
        diag_block<T, B, S, true, true>(uk, hb, G, r0, i, d, lane, sh);
      else   // d = 0 has no mirror term; past the run the next CTA takes it
        diag_block<T, B, S, true, false>(uk, hb, G, r0, i, d, lane, sh);
    }
  }
  // the blocks of the previous run whose mirror terms land in this one,
  // dealt out to the warps from the last (they had the fewest mirror terms)
  int e = 0;
  for (int a = 1; a <= hb && r0 - a >= 0; ++a)
    for (int d = a; d <= hb; ++d) {
      const int target = d - a;   // block row of this run
      if (target >= G || r0 + target >= nb) continue;
      if (G - 1 - (e % G) == warp)
        diag_block<T, B, S, false, true>(uk, hb, G, r0, r0 - a, d, lane, sh);
      ++e;
    }

  run_end<T, B, S>(y + static_cast<size_t>(k) * S * M, nb, hb, r0, sh);
}

template <typename T, int B, int S>
struct Launch {
  static int run(const Args& a) {
    using A = typename AccOf<T>::type;
    return launch_rows<T, A>(sym_band_resident_kernel<T, B, S>, a,
                             run_shared_bytes<A>(a.hb, a.G, B, S));
  }
};

}  // namespace

// upper (K, nb, hb+1, B, B) and x (K, S, nb*B) in the type named by dtype
// (0 bfloat16 as raw 16-bit words, 1 float32, 2 float64), y (K, S, nb*B) in
// float32 (float64 for dtype 2); all contiguous on the device. G block rows
// a CTA (1..16; any nb). Launches on `stream`; returns cudaGetLastError()
// after the launch, -1 for a dtype, block size, S or G the kernel is not
// built for, -2 when G rows need more shared memory than a CTA can have.
extern "C" int sgv_sym_band_resident_matvec(const void* upper, const void* x, void* y, int K,
                                            int nb, int hb, int B, int S, int G, int dtype,
                                            void* stream) {
  const sgv::Args a{upper, x, y, K, nb, hb, G, static_cast<cudaStream_t>(stream)};
  return sgv::dispatch<Launch>(a, B, S, dtype);
}
