// Shared pieces of the kernels in which ONE WARP walks a (B, B) row-major
// block of the LD matrix once (or its share of the block's rows) and takes
// both products of it: over float blocks sym_band_float.cu,
// sym_slab_streamed.cu, sym_band_resident.cu, sym_slab_resident.cu; over
// int8 blocks with one scale a block, sym_band_int8.cu.
//
// A warp reads the block in 16-byte vectors, 32 lanes on 512 consecutive
// bytes (16 int8, 8 bfloat16, 4 float32 or 2 float64 values a lane), a few
// loads ahead of the arithmetic. int8 values are decoded without I2F (the
// 2^23 trick of int8_at) and multiply an x that arrives in bfloat16.
// Depending on B and the type one such load covers R >= 1 whole block rows
// (LPR = 32 / R lanes a row) or 1 / C of a row, so a lane always owns the
// same C * V columns of every row it meets:
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
//
// The streamed kernels (sym_band_float.cu, sym_slab_streamed.cu,
// sym_band_int8.cu) also share the second launch of their pass: mirror sums
// that land outside the CTA's run of block rows are written to a scratch of
// partial sums (`Partials`), and fold_partials adds them into y (or writes
// them to the spill form's carry) in a fixed order of d. The three share
// their matvec form's tiles of the band too (`Tiles`, `Scratch`, fold_tiles,
// launch_tiles).
//
// The int8 kernel's matvec form has a second instance (LANES true) that
// works on the caller's lanes: x f32 in (S, K, M), rounded to bfloat16 as
// it is loaded (f32_bf16), y f32 in (S, K, M), and optionally A's shift
// y = gamw y + gam2 x applied where each row's sum becomes final (Lanes,
// shifted): in the kernel, fold_partials or fold_tiles, whichever writes
// the row last. The instances with LANES false are the parent's.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace sgv {

constexpr int kMaxSharedBytes = 232448;  // shared memory one CTA can use on an H100
constexpr int kMaxRowsPerCta = 16;       // one warp a block row, 512 threads at most

struct bf16_t { uint16_t bits; };

template <typename T> struct AccOf { using type = float; };   // int8_t too
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float to_acc(bf16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v.bits) << 16);
}
__device__ __forceinline__ float to_acc(float v) { return v; }
// an f32 x that the int8 kernel takes as bfloat16: rounded to nearest even
// as it is loaded, as torch's .to(torch.bfloat16) rounds it on the card
struct f32_bf16 { float v; };
__device__ __forceinline__ float to_acc(f32_bf16 v) {
  return __bfloat162float(__float2bfloat16_rn(v.v));
}
// two of them at once (one conversion of a pair, the same rounding)
__device__ __forceinline__ void to_acc2(float a, float b, float& ra, float& rb) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  ra = __low2float(h);
  rb = __high2float(h);
}
__device__ __forceinline__ double to_acc(double v) { return v; }

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }

// A byte b (b ^ 0x80 in `biased`, picked by byte_perm selector `sel`: 0x7440
// for byte 0 .. 0x7443 for byte 3) as the signed value it stores, without
// I2F: the byte under 0x4B000000 is the float 2^23 + (b + 128), and one FADD
// takes 2^23 + 128 away. Exact for -128..127.
__device__ __forceinline__ float int8_at(uint32_t biased, uint32_t sel) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, sel)) - 8388736.0f;
}

// 16 bytes from device to shared memory without registers (cp.async: both
// addresses on a 16-byte boundary), and its groups
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the values of one 16-byte vector, in the accumulation type
__device__ __forceinline__ void unpack(const uint4& w, float (&o)[16], int8_t) {
  const uint32_t words[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                             w.w ^ 0x80808080u};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    o[4 * e + 0] = int8_at(words[e], 0x7440);
    o[4 * e + 1] = int8_at(words[e], 0x7441);
    o[4 * e + 2] = int8_at(words[e], 0x7442);
    o[4 * e + 3] = int8_at(words[e], 0x7443);
  }
}
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

// xc[s][..] = src[s * stride + the lane's columns], read from device memory
// in x's type X: the block type, or bfloat16 for int8 blocks (the streamed
// diag kernels' x_{i+d}), or f32 rounded to it (f32_bf16: 16 bytes a load,
// src and stride on 4 values).
template <typename T, int B, int S, typename X = T>
__device__ __forceinline__ void load_cols_global(const X* __restrict__ src, size_t stride,
                                                 int lane,
                                                 typename AccOf<T>::type (&xc)[S][Tile<T, B>::CV]) {
  using L = Tile<T, B>;
  const int col0 = (lane % L::LPR) * L::V;
  if constexpr (std::is_same_v<X, f32_bf16>) {
    static_assert(L::V % 4 == 0, "a lane's columns come in float4s");
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int c = 0; c < L::C; ++c)
#pragma unroll
        for (int v = 0; v < L::V; v += 4) {
          const float4 q = *reinterpret_cast<const float4*>(
              &src[s * stride + c * L::TILE + col0 + v].v);
          const int j = c * L::V + v;
          to_acc2(q.x, q.y, xc[s][j], xc[s][j + 1]);
          to_acc2(q.z, q.w, xc[s][j + 2], xc[s][j + 3]);
        }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int c = 0; c < L::C; ++c)
#pragma unroll
        for (int v = 0; v < L::V; ++v)
          xc[s][c * L::V + v] = to_acc(src[s * stride + c * L::TILE + col0 + v]);
  }
}

// dst[s * stride + the lane's columns] = cacc, by the lanes of row position 0
// (call combine_cols first); dst may hold nothing yet.
template <typename T, int B, int S>
__device__ __forceinline__ void store_cols(
    typename AccOf<T>::type* dst, size_t stride, int lane,
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
        dst[s * stride + c * L::TILE + col0 + v] = cacc[s][c * L::V + v];
}

// One warp walks the (B, B) row-major block g once.
//   ROWS: rout[s * rstride + p] += sum_q g[p, q] * xc[s][q]   (rout in shared
//         memory; a row is always added by the same lane of the same warp);
//         with STORE the sum is stored instead of added (rout may then be
//         device memory that holds nothing yet)
//   COLS: cacc[s][q] += sum_p g[p, q] * xr[s * xstride + p]   (xr in shared
//         memory; cacc is per row position until combine_cols)
// AHEAD row groups are loaded before their arithmetic (AHEAD divides NRG).
template <typename T, int B, int S, bool ROWS, bool COLS, bool STORE = false,
          int AHEAD = Tile<T, B>::U>
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

  static_assert(L::NRG % AHEAD == 0, "AHEAD must divide the row groups");
  for (int rg0 = 0; rg0 < L::NRG; rg0 += AHEAD) {
    uint4 raw[AHEAD][L::C];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u)
#pragma unroll
      for (int c = 0; c < L::C; ++c)
        raw[u][c] = *reinterpret_cast<const uint4*>(
            base + static_cast<size_t>(rg0 + u) * L::R * B + c * L::TILE);
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
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
          for (int s = 0; s < S; ++s) {
            if constexpr (STORE) rout[s * rstride + p] = part[s];
            else rout[s * rstride + p] += part[s];
          }
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

// Row groups the streamed kernels load ahead of their arithmetic: twice the
// walker's default, since a streamed CTA keeps no run's worth of blocks in
// flight otherwise (one warp a block row, and a shard of 1024 block rows is
// about 8 warps an SM).
template <typename T, int B>
constexpr int kStreamAhead = 2 * Tile<T, B>::U;

// The scratch of partial sums of a streamed pass, (K, S, F, hb, B) in the
// accumulation type. A CTA owns the run of G block rows c G .. c G + G - 1;
// the mirror sum of block (i, d) lands in block row t = i + d, and goes to
// the scratch when t lies in a later run (d > t mod G) or past the end of a
// shard (the spill form, t >= nb): to row f(t), slot d - 1, with
//   f(t) = (t / G) H + t mod G  for t < nb (only the first H = min(hb, G)
//                                block rows of a run receive such sums),
//   f(t) = C H + t - nb         for the carry's block rows nb .. nb + hb - 1,
// C = ceil(nb / G) runs. Every (t, d) slot has one writer, and the wrapper
// sizes the scratch by the same F (ops/band_kernel.py::_partials_shape).
struct Partials {
  int G, H, C, F, nb;
  __host__ __device__ Partials(int nb_, int hb, int G_, bool spill)
      : G(G_), H(hb < G_ ? hb : G_), C((nb_ + G_ - 1) / G_), nb(nb_) {
    F = C * H + (spill ? hb : 0);
  }
  __device__ int row(int t) const { return t >= nb ? C * H + t - nb : (t / G) * H + t % G; }
};

// Where a pass finds its lanes. Lanes<false>: x (K, S, Mx) and y (K, S, M),
// the parent's layout, nothing more. Lanes<true> (the int8 matvec form
// over the caller's lanes): x and y f32 (S, K, M), lane s K + k of cohort
// k; with gamw and gam2 (S K values, or null) the pass stores gamw y +
// gam2 x, x unrounded.
template <bool LANES> struct Lanes {};
template <> struct Lanes<true> {
  const float* x;
  const float* gamw;
  const float* gam2;
};

// gamw y + gam2 x as torch computes gamw[:, None] * y + gam2[:, None] * x:
// two products and their sum, each rounded to nearest (no FMA)
__device__ __forceinline__ float shifted(const Lanes<true>& io, int lane, float y, float x) {
  return __fadd_rn(__fmul_rn(io.gamw[lane], y), __fmul_rn(io.gam2[lane], x));
}

// The second launch of a streamed pass: CTA (f, k) takes scratch row f of
// cohort k. A row of a run, t = c G + o: y_t += the partials of d = o + 1 ..
// min(hb, t) in that order. A carry row nb + j: carry_j = the partials of
// d = j + 1 .. hb in that order. LANES (float, the matvec form): y in the
// caller's lanes, and the shift after the adds.
template <typename A, bool LANES = false>
__global__ void __launch_bounds__(128)
fold_partials_kernel(const A* __restrict__ part, A* __restrict__ y, A* __restrict__ carry,
                     int nb, int hb, int G, int B, int S, const Lanes<LANES> io) {
  const Partials pp(nb, hb, G, carry != nullptr);
  const int f = blockIdx.x;
  const int k = blockIdx.y;
  int t, dlo;
  A* out;
  size_t ostride;
  if (f < pp.C * pp.H) {
    t = (f / pp.H) * G + f % pp.H;
    if (t >= nb) return;
    dlo = f % pp.H + 1;
    if constexpr (LANES) {
      ostride = static_cast<size_t>(gridDim.y) * nb * B;
      out = y + (static_cast<size_t>(k) * nb + t) * B;
    } else {
      ostride = static_cast<size_t>(nb) * B;
      out = y + static_cast<size_t>(k) * S * ostride + static_cast<size_t>(t) * B;
    }
  } else {
    const int j = f - pp.C * pp.H;
    t = nb + j;
    dlo = j + 1;
    ostride = static_cast<size_t>(hb) * B;
    out = carry + static_cast<size_t>(k) * S * ostride + static_cast<size_t>(j) * B;
  }
  const bool add = t < nb;
  const int dhi = hb < t ? hb : t;
  for (int e = threadIdx.x; e < S * B; e += blockDim.x) {
    const int s = e / B;
    const int c = e - s * B;
    const A* src = part + ((static_cast<size_t>(k) * S + s) * pp.F + f) * hb * B + c;
    A v = add ? out[s * ostride + c] : A(0);
    for (int d = dlo; d <= dhi; ++d) v += src[static_cast<size_t>(d - 1) * B];
    if constexpr (LANES) {
      if (io.gamw) v = shifted(io, s * gridDim.y + k, v, io.x[(out - y) + s * ostride + c]);
    }
    out[s * ostride + c] = v;
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
  void* carry = nullptr;     // the spill form's second output (the streamed kernels)
  void* partials = nullptr;  // the streamed kernels' scratch (Partials)
  int D = 0;                 // diagonals a tile (the streamed kernels' launch_tiles)
  Lanes<true> lanes{};       // the int8 matvec form over the caller's lanes
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

// Asks for `smem` bytes of dynamic shared memory for `kernel`: 0, -2 when a
// CTA cannot have that much, or the CUDA error.
template <typename Kernel>
int reserve_shared(Kernel kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSharedBytes)) return -2;
  if (smem > 48 * 1024) {  // above the default limit it must be asked for
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The second launch of a streamed pass, after the kernel's on the same
// stream: fold_partials over the scratch of runs of a.G block rows. 0 or the
// first error (the kernel's launch included); nothing to do when hb = 0 (no
// mirror terms; the spill form's carry is then the caller's zeros).
template <typename A, bool LANES = false>
int launch_fold(const Args& a, int B, int S) {
  if (const int err = static_cast<int>(cudaGetLastError())) return err;
  if (a.hb == 0) return 0;
  const Partials pp(a.nb, a.hb, a.G, a.carry != nullptr);
  Lanes<LANES> io{};
  if constexpr (LANES) io = a.lanes;
  fold_partials_kernel<A, LANES><<<dim3(pp.F, a.K), 128, 0, a.stream>>>(
      static_cast<const A*>(a.partials), static_cast<A*>(a.y), static_cast<A*>(a.carry), a.nb,
      a.hb, a.G, B, S, io);
  return static_cast<int>(cudaGetLastError());
}

// The streamed kernels' launches: `kernel` over (ceil(nb / G), K) CTAs of G
// warps with `smem` bytes of dynamic shared memory, then fold_partials on the
// same stream. 0 or the first error; cudaErrorMisalignedAddress (716) with
// nothing launched when upper does not start on a 16-byte boundary (the
// walker reads it 16 bytes at a time).
template <typename T, typename A, typename Kernel>
int launch_streamed(Kernel kernel, const Args& a, int B, int S, size_t smem) {
  if (reinterpret_cast<uintptr_t>(a.upper) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (const int err = reserve_shared(kernel, smem)) return err;
  const bool spill = a.carry != nullptr;
  kernel<<<dim3((a.nb + a.G - 1) / a.G, a.K), 32 * a.G, smem, a.stream>>>(
      static_cast<const T*>(a.upper), static_cast<const T*>(a.x), static_cast<A*>(a.y),
      static_cast<A*>(a.partials), a.nb, a.hb, a.G, spill);
  return launch_fold<A>(a, B, S);
}

// ---------------------------------------------------------------------------
// Tiles of the band: the matvec form of the streamed kernels
// (sym_band_int8.cu, sym_band_float.cu, sym_slab_streamed.cu). A CTA takes
// the tile of run c (G consecutive block rows r0 = c G .. r0 + G - 1, one
// warp a block row) and diagonal range j (diagonals d0 = j D .. d0 + D - 1,
// at most hb): the band's J = ceil((hb + 1) / D) ranges. The grid holds only
// the tiles that hold data (Tiles, in the kernel's parameters), and a CTA
// finds its (j, c) by a binary search of it (tile_range). Which mirror sums leave a CTA depends on
// its run only, so they take Partials' slots whatever D is. With J > 1 no
// tile holds a whole row sum: each stores its run's row sums and in-run
// mirror sums to a second part of the scratch (Scratch), and fold_tiles
// writes y. With J = 1 the kernel writes y itself and fold_partials adds
// the partial slots, as without tiles.
// ---------------------------------------------------------------------------

// the most diagonal ranges a pass may cut the band into: the wrappers'
// MAX_RANGES (ops/band_kernel.py)
constexpr int kMaxRanges = 128;

// The tiles of a pass, in the kernel's parameters: D diagonals a range, J
// ranges, and start[j] the first tile of range j (start[J] = all of them).
// Range j holds the runs c whose first block row has data at diagonal j D:
// c G + j D <= nx - 1, the x block rows less one (nb, or nb + hb with the
// spill form's halo), and c G < nb.
struct Tiles {
  int D, J;
  int start[kMaxRanges + 1];
};

inline Tiles tiles_of(int nb, int nx, int hb, int G, int D) {
  Tiles tl{};
  tl.D = D;
  tl.J = (hb + D) / D;
  const int runs = (nb + G - 1) / G;
  for (int j = 0; j < tl.J && j < kMaxRanges; ++j) {
    const int last = nx - 1 - j * D;   // the highest first row a run may have
    const int n = last < 0 ? 0 : last / G + 1;
    tl.start[j + 1] = tl.start[j] + (n < runs ? n : runs);
  }
  return tl;
}

// The scratch of a pass (K, S, rows, B) in the accumulation type: Partials'
// F hb slots of mirror sums, then with J > 1 the tiles' J nb rows of row
// sums (range j's part of block row t in row F hb + j nb + t).
struct Scratch {
  Partials pp;
  size_t rows;   // of B values, a cohort and lane
  __host__ __device__ Scratch(int nb, int hb, int G, bool spill, int J)
      : pp(nb, hb, G, spill),
        rows(static_cast<size_t>(pp.F) * hb + (J > 1 ? static_cast<size_t>(J) * nb : 0)) {}
};

// The range j of this CTA's tile: the last whose first tile is at most
// blockIdx.x. First lets the grid's programmatic dependent, fold_tiles,
// launch: it may take the SMs that this grid's CTAs leave, and waits for all
// of them to finish before it reads the scratch.
__device__ __forceinline__ int tile_range(const Tiles& tl) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  int j = 0;
  for (int hi = tl.J - 1; j < hi;) {
    const int mid = (j + hi + 1) / 2;
    if (tl.start[mid] <= static_cast<int>(blockIdx.x)) j = mid;
    else hi = mid - 1;
  }
  return j;
}

// 16 bytes of the accumulation type: fold_tiles' unit of a source
template <typename A> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int N = 4;
  __device__ static float4 zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static void add(float4& a, const float4& b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int N = 2;
  __device__ static double2 zero() { return make_double2(0.0, 0.0); }
  __device__ static void add(double2& a, const double2& b) { a.x += b.x; a.y += b.y; }
};

// fold_tiles' shape: NV vectors of 16 bytes hold one source's S B values, a
// vector a thread, in P groups of threads (256 threads, or one group of NV
// where a source is larger: f64 at S B > 512)
template <typename A, int B, int S>
struct FoldShape {
  static constexpr int NV = S * B / Vec16<A>::N;
  static constexpr int THREADS = NV > 256 ? NV : 256;
  static constexpr int P = THREADS / NV;
};

// The second launch of a pass over J > 1 ranges (the matvec form): CTA
// (t, k) writes y_t of cohort k, the sum of the tile parts of t's run for
// ranges 0 .. J_t - 1 (J_t: the ranges whose tile of that run exists) and
// then of the partial slots d = t mod G + 1 .. min(hb, t) where t has
// them (t mod G < H), in that order. The n sources are dealt round robin to
// the P groups of threads, 16 bytes of the S B values a thread; each group
// adds its own in order, four loads at a time, and the groups' sums are
// added in order of the group: one fixed order, the same bits on every run.
// It is launched as the kernel's programmatic dependent (the launch
// attribute cudaLaunchAttributeProgrammaticStreamSerialization): its CTAs
// may start on the SMs the kernel's last CTAs leave, and wait
// (griddepcontrol.wait) until the kernel's grid has finished and its writes
// are visible. LANES (float): y in the caller's lanes, and the shift.
template <typename A, int B, int S, bool LANES = false>
__global__ void __launch_bounds__(FoldShape<A, B, S>::THREADS)
fold_tiles_kernel(const A* __restrict__ part, A* __restrict__ y, int nb, int hb, int G, int D,
                  int J, const Lanes<LANES> io) {
  using W = Vec16<A>;
  using V = typename W::type;
  constexpr int NV = FoldShape<A, B, S>::NV;
  constexpr int P = FoldShape<A, B, S>::P;
  constexpr int BV = B / W::N;           // vectors of one lane's block row
  __shared__ V sums[P][NV];
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the kernel's grid has finished
  const Scratch scr(nb, hb, G, false, J);
  const Partials& pp = scr.pp;
  const int t = blockIdx.x;
  const int k = blockIdx.y;
  const int r0 = t - t % G;
  const int nj = (nb - 1 - r0) / D + 1 < J ? (nb - 1 - r0) / D + 1 : J;
  const int o = t % G;
  const int np = o < pp.H ? (hb < t ? hb : t) - o : 0;   // slots d = o + 1 .. min(hb, t)
  const int n = nj + np;
  const int g = threadIdx.x / NV;
  const int v = threadIdx.x % NV;
  const int s = v / BV;
  const size_t pstride = scr.rows * B;
  const A* base = part + (static_cast<size_t>(k) * S + s) * pstride + (v % BV) * W::N;
  const A* tiles = base + (static_cast<size_t>(pp.F) * hb + t) * B;          // + j nb B
  const A* slots = base + (static_cast<size_t>(pp.row(t)) * hb + o) * B;     // + (q - nj) B
  auto src = [&](int q) {
    return *reinterpret_cast<const V*>(
        q < nj ? tiles + static_cast<size_t>(q) * nb * B : slots + static_cast<size_t>(q - nj) * B);
  };
  if (g < P) {
    V acc = W::zero();
    int q = g;
    for (; q + 3 * P < n; q += 4 * P) {
      const V a0 = src(q), a1 = src(q + P), a2 = src(q + 2 * P), a3 = src(q + 3 * P);
      W::add(acc, a0); W::add(acc, a1); W::add(acc, a2); W::add(acc, a3);
    }
    for (; q < n; q += P) W::add(acc, src(q));
    sums[g][v] = acc;
  }
  __syncthreads();
  if (g == 0) {
    V tot = sums[0][v];
    for (int h = 1; h < P; ++h) W::add(tot, sums[h][v]);
    if constexpr (LANES) {
      const int lane = s * gridDim.y + k;
      const size_t at = (static_cast<size_t>(lane) * nb + t) * B + (v % BV) * W::N;
      if (io.gamw) {
        const float4 xv = *reinterpret_cast<const float4*>(io.x + at);
        tot.x = shifted(io, lane, tot.x, xv.x);
        tot.y = shifted(io, lane, tot.y, xv.y);
        tot.z = shifted(io, lane, tot.z, xv.z);
        tot.w = shifted(io, lane, tot.w, xv.w);
      }
      *reinterpret_cast<V*>(y + at) = tot;
    } else {
      *reinterpret_cast<V*>(y + (static_cast<size_t>(k) * S + s) * nb * B +
                            static_cast<size_t>(t) * B + (v % BV) * W::N) = tot;
    }
  }
}

// A pass of a streamed kernel over tiles of a.G block rows and D
// diagonals: `untiled` where one range holds every diagonal (J = 1), else
// `tiled`, over the tiles that hold data x K CTAs of a.G warps with `smem`
// bytes of dynamic shared memory, launched by go(kernel, grid, spill, tiles)
// on a.stream; then the second launch on the same stream: fold_partials with
// one range, else fold_tiles as the kernel's programmatic dependent, both
// over the lanes that LANES says. The spill form takes one range. 0 or the
// first error (cudaGetLastError() after each launch); -1 for a D the pass
// cannot take; cudaErrorMisalignedAddress (716) with nothing launched when
// upper does not start on a 16-byte boundary (the walkers read 16 bytes).
template <typename A, int B, int S, bool LANES, typename Kernel, typename Go>
int launch_tiles_by(Kernel untiled, Kernel tiled, const Args& a, int D, size_t smem, Go go) {
  const bool spill = a.carry != nullptr;
  if (D < 1 || D > a.hb + 1 || (a.hb + D) / D > kMaxRanges || (spill && D != a.hb + 1))
    return -1;
  if (reinterpret_cast<uintptr_t>(a.upper) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Tiles tl = tiles_of(a.nb, spill ? a.nb + a.hb : a.nb, a.hb, a.G, D);
  Kernel kernel = tl.J > 1 ? tiled : untiled;
  if (const int err = reserve_shared(kernel, smem)) return err;
  go(kernel, dim3(tl.start[tl.J], a.K), spill, tl);
  if (tl.J == 1) return launch_fold<A, LANES>(a, B, S);
  if (const int err = static_cast<int>(cudaGetLastError())) return err;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(a.nb, a.K);
  cfg.blockDim = dim3(FoldShape<A, B, S>::THREADS);
  cfg.stream = a.stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  Lanes<LANES> io{};
  if constexpr (LANES) io = a.lanes;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, fold_tiles_kernel<A, B, S, LANES>,
                                             static_cast<const A*>(a.partials),
                                             static_cast<A*>(a.y), a.nb, a.hb, a.G, D, tl.J, io));
}

// launch_tiles_by for a kernel that takes its inputs `in...`, then y, the
// scratch, nb, hb, G, spill and the Tiles, over the parent's lanes.
template <typename A, int B, int S, typename Kernel, typename... In>
int launch_tiles(Kernel untiled, Kernel tiled, const Args& a, int D, size_t smem, In... in) {
  return launch_tiles_by<A, B, S, false>(
      untiled, tiled, a, D, smem, [&](Kernel kernel, dim3 grid, bool spill, const Tiles& tl) {
        kernel<<<grid, 32 * a.G, smem, a.stream>>>(in..., static_cast<A*>(a.y),
                                                   static_cast<A*>(a.partials), a.nb, a.hb,
                                                   a.G, spill, tl);
      });
}

// Launches `kernel` with G warps a CTA over (ceil(nb / G), K) CTAs and
// `smem` bytes of dynamic shared memory.
template <typename T, typename A, typename Kernel>
int launch_rows(Kernel kernel, const Args& a, size_t smem) {
  if (const int err = reserve_shared(kernel, smem)) return err;
  kernel<<<dim3((a.nb + a.G - 1) / a.G, a.K), 32 * a.G, smem, a.stream>>>(
      static_cast<const T*>(a.upper), static_cast<const T*>(a.x), static_cast<A*>(a.y),
      a.nb, a.hb, a.G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgv
