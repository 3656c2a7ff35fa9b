// Shared pieces of the float-block kernels in which ONE WARP walks a (B, B)
// row-major block of the LD matrix once and takes both products of it:
// sym_slab_streamed.cu, sym_band_resident.cu, sym_slab_resident.cu.
//
// A warp reads the block in 16-byte vectors, 32 lanes on 512 consecutive
// bytes (8 bfloat16, 4 float32 or 2 float64 values a lane), a few loads
// ahead of the arithmetic. Depending on B and the type one such load covers
// R >= 1 whole block rows (LPR = 32 / R lanes a row) or 1 / C of a row, so a
// lane always owns the same C * V columns of every row it meets:
//   row sums     sum_q g[p, q] * xc[q]: the x values at the lane's columns
//                sit in registers (xc), the partial sums of the lanes that
//                share row p are added by shuffles, and the first of them
//                adds the sum into shared memory;
//   column sums  sum_p g[p, q] * xr[p]: one x value a row, read from shared
//                memory once a row (not once a multiply-add), the sums of the
//                lane's columns kept in registers (cacc) across rows and
//                blocks, and added over the R row positions at the end.
// Which of the two is the "row part" and which the "mirror part" of the
// symmetric matvec depends on the storage: in diag layout a block is
// U[i,d][p, q], in slab layout it is its transpose.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace sgv {

constexpr int kMaxSharedBytes = 232448;  // shared memory one CTA can use on an H100
constexpr int kMaxRowsPerCta = 16;       // one warp a block row, 512 threads at most

struct bf16_t { uint16_t bits; };

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float to_acc(bf16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v.bits) << 16);
}
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }

// the values of one 16-byte vector, in the accumulation type
__device__ __forceinline__ void unpack(const uint4& w, float (&o)[8], bf16_t) {
  o[0] = __uint_as_float(w.x << 16);
  o[1] = __uint_as_float(w.x & 0xffff0000u);
  o[2] = __uint_as_float(w.y << 16);
  o[3] = __uint_as_float(w.y & 0xffff0000u);
  o[4] = __uint_as_float(w.z << 16);
  o[5] = __uint_as_float(w.z & 0xffff0000u);
  o[6] = __uint_as_float(w.w << 16);
  o[7] = __uint_as_float(w.w & 0xffff0000u);
}
__device__ __forceinline__ void unpack(const uint4& w, float (&o)[4], float) {
  o[0] = __uint_as_float(w.x);
  o[1] = __uint_as_float(w.y);
  o[2] = __uint_as_float(w.z);
  o[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, double (&o)[2], double) {
  o[0] = __hiloint2double(static_cast<int>(w.y), static_cast<int>(w.x));
  o[1] = __hiloint2double(static_cast<int>(w.w), static_cast<int>(w.z));
}

// How a warp's 16-byte loads tile a (B, B) block of T.
template <typename T, int B>
struct Tile {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // values a lane loads at once
  static constexpr int TILE = 32 * V;                // values a warp loads at once
  static constexpr int R = TILE > B ? TILE / B : 1;  // block rows one warp load covers
  static constexpr int C = B > TILE ? B / TILE : 1;  // warp loads a block row takes
  static constexpr int LPR = 32 / R;                 // lanes that share a block row
  static constexpr int NRG = B / R;                  // row groups of a block
  static constexpr int U = C >= 4 ? 1 : (C == 2 ? 2 : 4);  // row groups loaded ahead
  static constexpr int CV = C * V;                   // columns a lane owns
};

// xc[s][..] = src[s * stride + the lane's columns]
template <typename T, int B, int S>
__device__ __forceinline__ void load_cols(const typename AccOf<T>::type* src, int stride,
                                          int lane,
                                          typename AccOf<T>::type (&xc)[S][Tile<T, B>::CV]) {
  using L = Tile<T, B>;
  const int col0 = (lane % L::LPR) * L::V;
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int c = 0; c < L::C; ++c)
#pragma unroll
      for (int v = 0; v < L::V; ++v)
        xc[s][c * L::V + v] = src[s * stride + c * L::TILE + col0 + v];
}

// Adds the column sums of the R row positions of a warp load; afterwards
// every lane holds the totals of its columns.
template <typename T, int B, int S>
__device__ __forceinline__ void combine_cols(typename AccOf<T>::type (&cacc)[S][Tile<T, B>::CV]) {
  using L = Tile<T, B>;
#pragma unroll
  for (int off = L::LPR; off < 32; off <<= 1)
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int j = 0; j < L::CV; ++j)
        cacc[s][j] += __shfl_xor_sync(0xffffffffu, cacc[s][j], off);
}

// dst[s * stride + the lane's columns] += cacc, by the lanes of row position 0
// (call combine_cols first).
template <typename T, int B, int S>
__device__ __forceinline__ void add_cols(typename AccOf<T>::type* dst, int stride, int lane,
                                         const typename AccOf<T>::type (&cacc)[S][Tile<T, B>::CV]) {
  using L = Tile<T, B>;
  if (lane >= L::LPR) return;
  const int col0 = lane * L::V;
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int c = 0; c < L::C; ++c)
#pragma unroll
      for (int v = 0; v < L::V; ++v)
        dst[s * stride + c * L::TILE + col0 + v] += cacc[s][c * L::V + v];
}

// One warp walks the (B, B) row-major block g once.
//   ROWS: rout[s * rstride + p] += sum_q g[p, q] * xc[s][q]   (rout in shared
//         memory; a row is always added by the same lane of the same warp)
//   COLS: cacc[s][q] += sum_p g[p, q] * xr[s * xstride + p]   (xr in shared
//         memory; cacc is per row position until combine_cols)
template <typename T, int B, int S, bool ROWS, bool COLS>
__device__ __forceinline__ void walk_block(
    const T* __restrict__ g, int lane,
    const typename AccOf<T>::type (&xc)[S][Tile<T, B>::CV],
    const typename AccOf<T>::type* xr, int xstride,
    typename AccOf<T>::type* rout, int rstride,
    typename AccOf<T>::type (&cacc)[S][Tile<T, B>::CV]) {
  using A = typename AccOf<T>::type;
  using L = Tile<T, B>;
  const int sub = lane / L::LPR;               // row position inside a warp load
  const int col0 = (lane % L::LPR) * L::V;     // first column of the lane
  const T* base = g + static_cast<size_t>(sub) * B + col0;

  for (int rg0 = 0; rg0 < L::NRG; rg0 += L::U) {
    uint4 raw[L::U][L::C];
#pragma unroll
    for (int u = 0; u < L::U; ++u)
#pragma unroll
      for (int c = 0; c < L::C; ++c)
        raw[u][c] = *reinterpret_cast<const uint4*>(
            base + static_cast<size_t>(rg0 + u) * L::R * B + c * L::TILE);
#pragma unroll
    for (int u = 0; u < L::U; ++u) {
      const int p = (rg0 + u) * L::R + sub;
      A xrow[S];
      A part[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        part[s] = A(0);
        xrow[s] = A(0);
        if constexpr (COLS) xrow[s] = xr[s * xstride + p];
      }
#pragma unroll
      for (int c = 0; c < L::C; ++c) {
        A uv[L::V];
        unpack(raw[u][c], uv, T{});
#pragma unroll
        for (int v = 0; v < L::V; ++v)
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if constexpr (ROWS) part[s] = fma_acc(uv[v], xc[s][c * L::V + v], part[s]);
            if constexpr (COLS)
              cacc[s][c * L::V + v] = fma_acc(uv[v], xrow[s], cacc[s][c * L::V + v]);
          }
      }
      if constexpr (ROWS) {
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int off = L::LPR / 2; off > 0; off >>= 1)
            part[s] += __shfl_xor_sync(0xffffffffu, part[s], off);
        if (lane % L::LPR == 0) {
#pragma unroll
          for (int s = 0; s < S; ++s) rout[s * rstride + p] += part[s];
        }
      }
    }
  }
}

// Fills xs, S x (rows * B) in the accumulation type, with block rows
// first .. first + rows - 1 of x (K, S, nb * B), zeros outside the matrix.
template <typename T, int B, int S>
__device__ __forceinline__ void load_x_rows(const T* __restrict__ xk, int nb, int first, int rows,
                                            typename AccOf<T>::type* xs) {
  using A = typename AccOf<T>::type;
  const long long M = static_cast<long long>(nb) * B;
  const int stride = rows * B;
  for (int e = threadIdx.x; e < S * stride; e += blockDim.x) {
    const int s = e / stride;
    const long long m = static_cast<long long>(first) * B + (e - s * stride);
    xs[e] = (m >= 0 && m < M) ? to_acc(xk[s * M + m]) : A(0);
  }
}

// Shared memory of a CTA that owns a run of G block rows r0 .. r0 + G - 1
// (the resident kernels): x of block rows r0 - hb .. r0 + G + hb - 1, the
// run's row-part sums yr, and the mirror-part sums ym that land in the run,
// one slot per diagonal d = 1..hb so that every slot has one writer. Strides
// between right-hand sides: xstride for xs, ystride for yr and ym.
template <typename A>
struct RunShared {
  A* xs;        // S x (G + 2 hb) x B
  A* yr;        // S x G x B
  A* ym;        // hb x S x G x B
  int xstride;  // (G + 2 hb) * B
  int ystride;  // G * B

  __device__ RunShared(unsigned char* raw, int hb, int G, int B, int S)
      : xs(reinterpret_cast<A*>(raw)), xstride((G + 2 * hb) * B), ystride(G * B) {
    yr = xs + S * xstride;
    ym = yr + S * ystride;
  }
};

template <typename A>
size_t run_shared_bytes(int hb, int G, int B, int S) {
  return static_cast<size_t>(S) * B * (G + 2 * hb + (hb + 1) * G) * sizeof(A);
}

// Loads the run's x and zeroes its sums; ends with a CTA barrier.
template <typename T, int B, int S>
__device__ __forceinline__ void run_begin(const T* __restrict__ xk, int nb, int hb, int G, int r0,
                                          const RunShared<typename AccOf<T>::type>& sh) {
  using A = typename AccOf<T>::type;
  load_x_rows<T, B, S>(xk, nb, r0 - hb, G + 2 * hb, sh.xs);
  for (int e = threadIdx.x; e < (hb + 1) * S * sh.ystride; e += blockDim.x) sh.yr[e] = A(0);
  __syncthreads();
}

// After a CTA barrier, y of the run = row-part sums + the mirror-part sums
// of d = 1..hb in that order: the same bits on every run.
template <typename T, int B, int S>
__device__ __forceinline__ void run_end(typename AccOf<T>::type* __restrict__ yk, int nb, int hb,
                                        int r0, const RunShared<typename AccOf<T>::type>& sh) {
  using A = typename AccOf<T>::type;
  const size_t M = static_cast<size_t>(nb) * B;
  __syncthreads();
  for (int e = threadIdx.x; e < S * sh.ystride; e += blockDim.x) {
    const int s = e / sh.ystride;
    const int w = e - s * sh.ystride;   // (block row of the run) * B + column
    if (r0 + w / B >= nb) continue;
    A v = sh.yr[e];
    for (int d = 1; d <= hb; ++d) v += sh.ym[(d - 1) * S * sh.ystride + e];
    yk[s * M + static_cast<size_t>(r0) * B + w] = v;
  }
}

// The arguments every launcher takes, and the switch from run-time
// (dtype, B, S) to a template instance Launch<T, B, S>::run(args).
struct Args {
  const void* upper;
  const void* x;
  void* y;
  int K, nb, hb, G;
  cudaStream_t stream;
};

template <template <typename, int, int> class Launch, typename T, int B>
int dispatch_s(const Args& a, int S) {
  switch (S) {
    case 1: return Launch<T, B, 1>::run(a);
    case 2: return Launch<T, B, 2>::run(a);
    case 3: return Launch<T, B, 3>::run(a);
    case 4: return Launch<T, B, 4>::run(a);
    default: return -1;
  }
}

template <template <typename, int, int> class Launch, typename T>
int dispatch_b(const Args& a, int B, int S) {
  switch (B) {
    case 64: return dispatch_s<Launch, T, 64>(a, S);
    case 128: return dispatch_s<Launch, T, 128>(a, S);
    case 256: return dispatch_s<Launch, T, 256>(a, S);
    default: return -1;
  }
}

// dtype: 0 bfloat16 as raw 16-bit words, 1 float32, 2 float64. Returns the
// launch's cudaGetLastError(), -1 for a dtype, block size, S or G no
// instance exists for, -2 when the CTA would need more shared memory than
// the card has.
template <template <typename, int, int> class Launch>
int dispatch(const Args& a, int B, int S, int dtype) {
  if (a.G < 1 || a.G > kMaxRowsPerCta) return -1;
  switch (dtype) {
    case 0: return dispatch_b<Launch, bf16_t>(a, B, S);
    case 1: return dispatch_b<Launch, float>(a, B, S);
    case 2: return dispatch_b<Launch, double>(a, B, S);
    default: return -1;
  }
}

// Launches `kernel` with G warps a CTA over (ceil(nb / G), K) CTAs and
// `smem` bytes of dynamic shared memory.
template <typename T, typename A, typename Kernel>
int launch_rows(Kernel kernel, const Args& a, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSharedBytes)) return -2;
  if (smem > 48 * 1024) {  // above the default limit it must be asked for
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3((a.nb + a.G - 1) / a.G, a.K), 32 * a.G, smem, a.stream>>>(
      static_cast<const T*>(a.upper), static_cast<const T*>(a.x), static_cast<A*>(a.y),
      a.nb, a.hb, a.G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgv
