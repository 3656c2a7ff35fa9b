// Symmetric block-banded matvec over int8 upper-triangle blocks (Hopper).
//
// Replaces sgvamp_tpu/ops/band_kernel.py:179, _sym_band_kernel_streamed
// with quantized=True (int8 blocks, one f32 scale each), with spill=False
// and, through the second entry point, with spill=True.
//
// What it computes, per cohort k and right-hand side s:
//   y_i = sum_{d=0..hb, i+d<nb} sc[i,d]   * U[i,d]   @ x_{i+d}     (row part)
//       + sum_{d=1..hb, i-d>=0} sc[i-d,d] * U[i-d,d]^T @ x_{i-d}   (mirror part)
// with U[i,d] the (B, B) int8 block R[block i, block i+d] / sc[i,d], x in
// bf16 and y in f32. Each block's dot is taken in f32 and then multiplied
// by the block's f32 scale, as the TPU kernel does. A bf16 times an int8 is
// exact in f32, so only the order of the sums differs from the TPU.
//
// Bound. A pass must read every stored block that holds data once (1 byte
// an element) and takes 2 S multiply-adds an element (row and mirror
// product), far below the tensor cores' rate: bytes from HBM bound it on
// paper. What stands in the way on this card: (1) a gather (one CTA an
// output block row) reads every off-diagonal block twice; (2) once the
// blocks are read once, the instructions an element, the decode and the
// 2 S FMAs with the row sums' cross-lane adds, come close to the byte
// bound (an int8 -> f32 conversion, I2F, issues at a fraction of the FMA
// rate, so it is not used); (3) a warp streams its blocks at a few GB/s
// while latency bounds it, so the card needs on the order of a thousand
// warps, each with a similar share, to reach its rate: a band of few block
// rows and many diagonals (a dense panel's whole triangle, nb = 64 and
// hb = 64) must not be cut by block rows alone, where one warp of block
// row 0 would stream all 64 of its blocks while the card idles.
//
// Design: the read-once scheme of sym_band_float.cu over int8 blocks, cut
// into tiles of the band.
//  * Tiles. A CTA takes the tile of run c (G consecutive block rows r0 =
//    c G .. r0 + G - 1, one warp a block row) and diagonal range j
//    (diagonals d0 = j D .. d0 + D - 1, at most hb): the band's J =
//    ceil((hb + 1) / D) ranges. The wrapper picks (G, D)
//    (ops/band_kernel.py::_int8_tiles): the runs of _int8_runs with D =
//    hb + 1, one range, wherever that puts enough warps on the card (the
//    bench shape, a 1024-row shard), else the fewest ranges that do. The
//    grid holds only the tiles that hold data: a table in the kernel's
//    parameters (Tiles) gives the first tile of each range, ranges in
//    order and runs in order within each, and a CTA finds its (j, c) by a
//    binary search of it. The spill form always takes one range. A pass of
//    one range runs the kernel's instance without tiles (TILED false): no
//    search, every diagonal from 0, y written in place.
//  * One read. In phase d the warp of block row i walks block (i, d) once in
//    row groups (sym_band_tile.cuh's Tile: 16 int8 a lane, 4 block rows a
//    warp load at B = 128) and takes both products from the same
//    registers. The bytes come through a ring of kStages slots in shared
//    memory that each warp fills by cp.async, chunks ahead and across its
//    blocks and the phases' barriers.
//  * Decode without I2F: sgv::int8_at puts byte ^ 0x80 under 0x4B000000, the
//    f32 2^23 + (b + 128), and one FADD makes b.
//  * Row sums. A row's sum is spread over the LPR lanes that share it; one
//    transposed butterfly adds a chunk's row groups over those lanes (3
//    shuffles where a butterfly a row group takes 12, B = 128), then the
//    sum is multiplied by sc[i,d] (dot, then scale) and added into the
//    tile's row sums in shared memory, one writer a row.
//  * Column sums (the mirror term, into block row t = i + d): x_i one value
//    a row from a permuted copy of the run's x (4 rows a load), the sums of
//    the lane's 16 columns in registers, added over the lanes' row positions
//    by shuffles, multiplied by sc[i,d], then added into the tile's mirror
//    sums in shared memory where t lies in the tile's own run (d <= t mod G:
//    one writer a row a phase, a barrier between the phases that write
//    there) or stored to the scratch of partial sums
//    (sym_band_tile.cuh::Partials, slot (t, d)) where t lies in a later run
//    or past the end of a shard. Which mirror sums leave a CTA depends on
//    the run only, not on the range, so Partials and its fold are the float
//    kernels' as they are.
//  * Out of a tile: with one range (J = 1) the CTA writes y of its run, row
//    sums + mirror sums, once. With J > 1 no tile holds a whole row sum:
//    the CTA stores its run's row + mirror sums to row j nb + t of a second
//    part of the scratch (after the F hb partial slots of each cohort and
//    lane), every row t < nb of the run, zeros included. Tiles, their
//    search, the Scratch layout, fold_tiles and the launches are
//    sym_band_tile.cuh's, shared with sym_band_float.cu.
//  * The second launch adds what went through the scratch in a fixed
//    order: with J = 1 fold_partials (sym_band_tile.cuh) adds the partial
//    slots into y in order of d, or writes them to the spill form's carry;
//    with J > 1 fold_tiles writes y_t = the tile parts of ranges 0 ..
//    J_t - 1 (those whose tile of t's run exists) and then its partial
//    slots, in that order, dealt to groups of threads by a fixed rule and
//    the groups added in order. fold_tiles is launched as the kernel's
//    programmatic dependent, so that its launch and first CTAs overlap the
//    kernel's last ones (about 1.5 µs a pass at nb = 64, hb = 64). No
//    atomics (but the counting build's, below), no CTA waits on another
//    of its grid: the same bits on every run.
//  * The caller's lanes (sgv_sym_band_int8_lanes; the kernel's and the
//    folds' instances with LANES true, the others unchanged). CG holds its
//    2K lanes as f32 (S, K, M) and wants A p = gamw R p + gam2 p. The pass
//    reads those lanes where they lie (lane stride K M), rounds each x value
//    to bfloat16 as it loads it (__float2bfloat16_rn, what torch's
//    .to(torch.bfloat16) does on the card: the same products as over a cast
//    and transposed copy), writes y in the same layout, and, given gamw and
//    gam2, stores gamw y + gam2 x (x unrounded; __fmul_rn, __fadd_rn, so no
//    FMA contracts them: torch's bits) where a row's sum becomes final: in
//    the kernel for the rows of a run that no partial slot reaches, in
//    fold_partials for the first min(hb, G), in fold_tiles for every row
//    when J > 1. The run's x is kept unrounded in shared memory for that
//    (one more S G B floats).
//
// Spill form (one shard of a sharded operator; `carry` is not null): x
// carries the next shard's first hb blocks after the shard's own nb (the
// halo), the row part of the last hb block rows multiplies them (blocks
// with i+d >= nb are ordinary data inside a shard), and their mirror terms,
// which land in block rows nb .. nb+hb-1 of the next shard, are the carry;
// the caller adds it into the head of the next shard's y. Mirror terms from
// the previous shard are not in y: they arrive as its carry.
//
// Shared memory: the warps' rings (kStages x 2 KB a warp), x of the run,
// its row sums and its mirror sums (3 G S B floats): 72 KB at G = 8,
// B = 128, S = 2 (two CTAs an SM; registers bound it), whatever D is; over
// the caller's lanes 4 G S B floats, 80 KB.
//
// Built with -DSGV_COUNT_BLOCK_BYTES (ops/_build.py's library
// sym_band_int8_counted), each warp also adds the bytes of every chunk of
// blocks it copies to a counter on the device, which
// sgv_sym_band_int8_block_bytes reads: what a pass reads of the blocks,
// counted by the kernel itself. The default build has no counter.

#include <type_traits>

#include "sym_band_tile.cuh"

namespace {

using namespace sgv;

// the longest run, G block rows of one warp each: the wrapper's
// INT8_MAX_RUN_ROWS (ops/band_kernel.py). At S <= 2 two such CTAs share an
// SM (128 registers a thread), at S = 3, 4 one (255).
constexpr int kMaxRunRows = 8;
// A warp streams its blocks through a ring of kStages slots in shared
// memory, kChunk row groups (2 KB) a slot, by cp.async: kStages - 1 chunks
// in flight while it computes one, in no registers.
constexpr int kChunk = 4;
constexpr int kStages = 3;
#ifdef SGV_COUNT_BLOCK_BYTES
__device__ unsigned long long g_block_bytes;   // block bytes the warps copied
#endif

// The stream of one warp over n / NCH consecutive blocks of block row i,
// from block (i, d0): chunk c is row groups (c % NCH) CH .. + CH - 1 of
// block (i, d0 + c / NCH), in slot c % kStages. Every lane copies and reads
// its own 16 bytes of each row group, so a lane waits for its own copies
// only.
template <int B>
struct Stream {
  using L = Tile<int8_t, B>;
  static constexpr int NRG = L::NRG;                        // row groups of a block
  static constexpr int CH = kChunk < NRG ? kChunk : NRG;    // row groups a chunk
  static constexpr int NCH = NRG / CH;                      // chunks a block
  static constexpr int BYTES = kStages * CH * 32 * 16;      // the ring of a warp
  uint4* ring;          // the lane's vector in slot 0
  const int8_t* src;    // the lane's first byte of block (i, d0)
  int n;                // chunks of the warp's blocks

  // copies chunk c (if there is one) and commits a group
  __device__ __forceinline__ void fetch(int c) const {
    if (c < n) {
      const int8_t* g = src + static_cast<size_t>(c / NCH) * B * B +
                        static_cast<size_t>(c % NCH) * CH * L::R * B;
      uint4* dst = ring + (c % kStages) * CH * 32;
      unsigned copied = 0;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        cp_async16(dst + u * 32, g + static_cast<size_t>(u) * L::R * B);
        copied += 16;
      }
#ifdef SGV_COUNT_BLOCK_BYTES
      // c and n are the same in every lane: the whole warp is here
      copied = __reduce_add_sync(0xffffffffu, copied);
      if ((threadIdx.x & 31) == 0) atomicAdd(&g_block_bytes, copied);
#endif
    }
    cp_async_commit();
  }
  // starts chunk c + kStages - 1 and returns chunk c's slot once it has landed
  __device__ __forceinline__ const uint4* next(int c) const {
    fetch(c + kStages - 1);
    cp_async_wait<kStages - 1>();
    return ring + (c % kStages) * CH * 32;
  }
};

// Both products of block (i, d), the warp's n-th block, chunk by chunk
// (COLS: d >= 1). Column sums go into cacc as in sym_band_tile.cuh's walker, with
// x_i at the chunk's rows read 4 at a time from the run's x, which the
// kernel stores permuted (xp: row p = g R + r of a block at r NRG + g, so
// that a lane's rows in consecutive row groups are adjacent). The row sums
// of the chunk's CH row groups are added over the LPR lanes of a row by a
// transposed butterfly: at each of the first log2 CH levels a lane sends
// half of its sums and keeps the other half, CH - 1 shuffles in all where
// one butterfly a row group takes CH log2 LPR; then plain levels. Row group
// u's total ends in the lanes l = u LPR / CH .. (u + 1) LPR / CH - 1 of its
// row position, and the first of them adds it, times the scale, into rout.
template <int B, int S, bool COLS>
__device__ __forceinline__ void walk_stream(const Stream<B>& st, int n, int lane,
                                            const float (&xc)[S][Tile<int8_t, B>::CV],
                                            const float* xp, float* rout, int stride,
                                            float (&cacc)[S][Tile<int8_t, B>::CV], float sc) {
  using L = Tile<int8_t, B>;
  using St = Stream<B>;
  constexpr int CH = St::CH;
  constexpr int SPREAD = L::LPR / CH;   // lanes of a row that end with one row group's total
  static_assert(CH == 4 || CH == 2, "a chunk is 2 or 4 row groups");
  const int sub = lane / L::LPR;
  const int l = lane % L::LPR;
  for (int b = 0; b < St::NCH; ++b) {
    const uint4* slot = st.next(n * St::NCH + b);
    uint4 v[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) v[u] = slot[u * 32];
    float xrow[S][CH];
    if constexpr (COLS) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float* src = xp + s * stride + sub * L::NRG + b * CH;
        if constexpr (CH == 4) {
          const float4 q = *reinterpret_cast<const float4*>(src);
          xrow[s][0] = q.x; xrow[s][1] = q.y; xrow[s][2] = q.z; xrow[s][3] = q.w;
        } else {
          const float2 q = *reinterpret_cast<const float2*>(src);
          xrow[s][0] = q.x; xrow[s][1] = q.y;
        }
      }
    }
    float part[CH][S];
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      float uv[L::V];
      unpack(v[u], uv, int8_t{});
#pragma unroll
      for (int s = 0; s < S; ++s) part[u][s] = 0.0f;
#pragma unroll
      for (int e = 0; e < L::V; ++e)
#pragma unroll
        for (int s = 0; s < S; ++s) {
          part[u][s] = fmaf(uv[e], xc[s][e], part[u][s]);
          if constexpr (COLS) cacc[s][e] = fmaf(uv[e], xrow[s][u], cacc[s][e]);
        }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int n = CH, off = L::LPR / 2; n > 1; n >>= 1, off >>= 1) {
        const bool hi = l & off;
#pragma unroll
        for (int j = 0; j < n / 2; ++j) {
          const float send = hi ? part[j][s] : part[j + n / 2][s];
          const float keep = hi ? part[j + n / 2][s] : part[j][s];
          part[j][s] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
#pragma unroll
      for (int off = SPREAD / 2; off > 0; off >>= 1)
        part[0][s] += __shfl_xor_sync(0xffffffffu, part[0][s], off);
    }
    if (l % SPREAD == 0) {
      const int p = (b * CH + l / SPREAD) * L::R + sub;
#pragma unroll
      for (int s = 0; s < S; ++s) rout[s * stride + p] += part[0][s] * sc;
    }
  }
}

// x as a pass takes it: bf16 words in the parent's lanes, f32 rounded as it
// is loaded in the caller's
template <bool LANES>
using XOf = std::conditional_t<LANES, f32_bf16, bf16_t>;

// TILED: the band is cut into J > 1 ranges (tl). Without it the CTA takes
// run blockIdx.x over every diagonal and writes y: the kernel before tiles,
// whose code a band that is not cut keeps (on an H100 with a few warps an
// SM, the tile search's instructions slowed each warp by 7-8%). LANES: the
// caller's lanes (sym_band_tile.cuh::Lanes); the run's x is also kept
// unrounded (xu) for the shift of the rows the kernel writes last.
template <int B, int S, bool TILED, bool LANES = false>
__global__ void __launch_bounds__(32 * kMaxRunRows, S <= 2 ? 2 : 1)
sym_band_int8_kernel(const int8_t* __restrict__ upper, const float* __restrict__ scales,
                     const XOf<LANES>* __restrict__ x, float* __restrict__ y,
                     float* __restrict__ part, int nb, int hb, int G, bool spill,
                     const __grid_constant__ Tiles tl, const Lanes<LANES> io) {
  using L = Tile<int8_t, B>;
  using St = Stream<B>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gstride = G * B;                        // between right-hand sides
  float* xs = reinterpret_cast<float*>(smem_raw + static_cast<size_t>(G) * St::BYTES);
  float* yr = xs + S * gstride;                     // S x G x B: row sums (xs: x of the run)
  float* ym = yr + S * gstride;                     // S x G x B: mirror sums from the run
  float* xu = ym + S * gstride;                     // S x G x B with LANES: x unrounded

  // the tile: range j (the last whose first tile is at most blockIdx.x),
  // run c of it
  const int j = TILED ? tile_range(tl) : 0;
  const int r0 = TILED ? (blockIdx.x - tl.start[j]) * G : blockIdx.x * G;
  const int d0 = TILED ? j * tl.D : 0;
  const int d1 = !TILED ? hb : d0 + tl.D - 1 < hb ? d0 + tl.D - 1 : hb;
  const int k = blockIdx.y;
  const int nx = spill ? nb + hb : nb;              // x block rows: with the halo in the spill form
  const size_t Mx = static_cast<size_t>(nx) * B;
  const int8_t* uk = upper + static_cast<size_t>(k) * nb * (hb + 1) * B * B;
  const float* sk = scales + static_cast<size_t>(k) * nb * (hb + 1);
  // between x's lanes: Mx in the parent's, K Mx in the caller's
  const size_t xls = LANES ? static_cast<size_t>(gridDim.y) * Mx : Mx;
  const XOf<LANES>* xk = x + static_cast<size_t>(k) * (LANES ? 1 : S) * Mx;
  const Scratch scr(nb, hb, G, spill, TILED ? tl.J : 1);
  const Partials& pp = scr.pp;
  const size_t pstride = scr.rows * B;              // between right-hand sides
  float* pk = part + static_cast<size_t>(k) * S * pstride;

  // the warp's blocks: d = d0 .. min(d1, nx - 1 - i), none past the end
  const int i = r0 + warp;
  const int dend = d1 < nx - 1 - i ? d1 : nx - 1 - i;
  const St st{reinterpret_cast<uint4*>(smem_raw + static_cast<size_t>(warp) * St::BYTES) + lane,
              uk + (static_cast<size_t>(i) * (hb + 1) + d0) * B * B +
                  static_cast<size_t>(lane / L::LPR) * B + (lane % L::LPR) * L::V,
              i < nb && d0 <= dend ? (dend - d0 + 1) * St::NCH : 0};
  for (int c = 0; c < kStages - 1; ++c) st.fetch(c);

  // x of the run, permuted within each block row for walk_stream; zeros past x
  for (int e = threadIdx.x; e < S * gstride; e += blockDim.x) {
    const int s = e / gstride;
    const int w = e - s * gstride;   // (block row of the run) * B + row p of the block
    const int p = w % B;
    const size_t m = static_cast<size_t>(r0) * B + w;
    xs[s * gstride + (w - p) + (p % L::R) * L::NRG + p / L::R] =
        m < Mx ? to_acc(xk[s * xls + m]) : 0.0f;
    if constexpr (LANES && !TILED) xu[e] = m < Mx ? xk[s * xls + m].v : 0.0f;
  }
  for (int e = threadIdx.x; e < 2 * S * gstride; e += blockDim.x) yr[e] = 0.0f;
  __syncthreads();

  for (int d = d0; d <= d1; ++d) {
    const int t = i + d;   // the block's mirror term lands in block row t
    const bool live = i < nb && t < nx;
    const bool in_run = t < r0 + G && t < nb;
    if (live) {
      const float sc = sk[static_cast<size_t>(i) * (hb + 1) + d];
      float xc[S][L::CV];
      float cacc[S][L::CV];
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int c = 0; c < L::CV; ++c) cacc[s][c] = 0.0f;
      load_cols_global<int8_t, B, S, XOf<LANES>>(xk + static_cast<size_t>(t) * B, xls, lane,
                                                 xc);
      if (d == 0) {
        walk_stream<B, S, false>(st, 0, lane, xc, nullptr, yr + warp * B, gstride, cacc, sc);
      } else {
        walk_stream<B, S, true>(st, d - d0, lane, xc, xs + warp * B, yr + warp * B, gstride,
                                cacc, sc);
        combine_cols<int8_t, B, S>(cacc);
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int c = 0; c < L::CV; ++c) cacc[s][c] *= sc;
        if (in_run)
          add_cols<int8_t, B, S>(ym + (t - r0) * B, gstride, lane, cacc);
        else
          store_cols<int8_t, B, S>(pk + (static_cast<size_t>(pp.row(t)) * hb + d - 1) * B,
                                   pstride, lane, cacc);
      }
    }
    // phase d's adds into ym are done before phase d + 1's begin
    if (d >= 1 && d + 1 < G) __syncthreads();
  }
  __syncthreads();

  // the run's row sums + the mirror sums from inside the run: y with one
  // range, else the tile's rows of the scratch. With LANES and one range the
  // rows no partial slot reaches (block row w / B >= H of the run) are final
  // here and take the shift; fold_partials shifts the others.
  const size_t M = static_cast<size_t>(nb) * B;
  float* out = !TILED ? y + static_cast<size_t>(k) * (LANES ? 1 : S) * M +
                            static_cast<size_t>(r0) * B
                      : pk + (static_cast<size_t>(pp.F) * hb + static_cast<size_t>(j) * nb +
                              r0) * B;
  const size_t ostride = !TILED ? (LANES ? static_cast<size_t>(gridDim.y) * M : M) : pstride;
  for (int e = threadIdx.x; e < S * gstride; e += blockDim.x) {
    const int s = e / gstride;
    const int w = e - s * gstride;   // (block row of the run) * B + column
    if (r0 + w / B >= nb) continue;
    float v = yr[e] + ym[e];
    if constexpr (LANES && !TILED) {
      if (io.gamw && w / B >= pp.H) v = shifted(io, s * gridDim.y + k, v, xu[e]);
    }
    out[s * ostride + w] = v;
  }
}

template <int B, int S, bool LANES>
int launch(const Args& a, const float* scales) {
  if (a.G < 1 || a.G > kMaxRunRows) return -1;
  const size_t smem = static_cast<size_t>(a.G) * Stream<B>::BYTES +
                      static_cast<size_t>(LANES ? 4 : 3) * S * B * a.G * sizeof(float);
  Lanes<LANES> io{};
  if constexpr (LANES) io = a.lanes;
  using Kernel = decltype(&sym_band_int8_kernel<B, S, false, LANES>);
  return launch_tiles_by<float, B, S, LANES>(
      sym_band_int8_kernel<B, S, false, LANES>, sym_band_int8_kernel<B, S, true, LANES>, a, a.D,
      smem, [&](Kernel kernel, dim3 grid, bool spill, const Tiles& tl) {
        kernel<<<grid, 32 * a.G, smem, a.stream>>>(
            static_cast<const int8_t*>(a.upper), scales,
            static_cast<const XOf<LANES>*>(a.x), static_cast<float*>(a.y),
            static_cast<float*>(a.partials), a.nb, a.hb, a.G, spill, tl, io);
      });
}

template <int B, bool LANES>
int launch_s(const Args& a, const float* scales, int S) {
  switch (S) {
    case 1: return launch<B, 1, LANES>(a, scales);
    case 2: return launch<B, 2, LANES>(a, scales);
    case 3: return launch<B, 3, LANES>(a, scales);
    case 4: return launch<B, 4, LANES>(a, scales);
    default: return -1;
  }
}

template <bool LANES = false>
int matvec(const Args& a, const void* scales, int B, int S) {
  const auto* sc = static_cast<const float*>(scales);
  switch (B) {
    case 64: return launch_s<64, LANES>(a, sc, S);
    case 128: return launch_s<128, LANES>(a, sc, S);
    case 256: return launch_s<256, LANES>(a, sc, S);
    default: return -1;
  }
}

}  // namespace

// upper (K, nb, hb+1, B, B) int8, scales (K, nb, hb+1) f32, x (K, S, nb*B)
// bf16 as raw 16-bit words, y (K, S, nb*B) f32, partials the scratch
// (K, S, rows, B) f32 (Scratch: Partials' F hb slots for runs of G, then J
// nb rows with J = ceil((hb + 1) / D) > 1 ranges; nothing for hb = 0); all
// contiguous on the device, upper on a 16-byte boundary. Tiles of G block
// rows (1 <= G <= 8; any nb) and D diagonals (1 <= D <= hb + 1, at most
// kMaxRanges ranges). Launches the kernel and its fold on `stream`;
// returns 0 or the first launch's error (cudaGetLastError() after each),
// 716 (cudaErrorMisalignedAddress) with nothing launched for an unaligned
// upper, -1 for a block size, S, G or D the kernel is not built for.
extern "C" int sgv_sym_band_int8_matvec(const void* upper, const void* scales,
                                        const void* x, void* y, void* partials, int K,
                                        int nb, int hb, int B, int S, int G, int D,
                                        void* stream) {
  const sgv::Args a{upper, x, y, K, nb, hb, G, static_cast<cudaStream_t>(stream), nullptr,
                    partials, D};
  return matvec(a, scales, B, S);
}

// The spill form: upper and scales of one shard's nb block rows, x
// (K, S, (nb+hb)*B) with the halo, y (K, S, nb*B) and carry (K, S, hb*B)
// f32, the scratch with the carry's hb rows; one range, D = hb + 1. With
// hb = 0 nothing is written to carry (the caller's is one block of zeros).
// Returns as above.
extern "C" int sgv_sym_band_int8_spill(const void* upper, const void* scales,
                                       const void* x, void* y, void* carry, void* partials,
                                       int K, int nb, int hb, int B, int S, int G, int D,
                                       void* stream) {
  if (carry == nullptr) return -1;
  const sgv::Args a{upper, x, y, K, nb, hb, G, static_cast<cudaStream_t>(stream), carry,
                    partials, D};
  return matvec(a, scales, B, S);
}

// The matvec form over the caller's lanes: x (S, K, nb*B) f32, rounded to
// bfloat16 (to nearest even) as the kernel loads it, y (S, K, nb*B) f32,
// lane s K + k of cohort k; gamw and gam2 null, or S K f32 each, and then y
// = gamw y + gam2 x with x unrounded, each product and the sum rounded as
// torch's gamw[:, None] * y + gam2[:, None] * x. x 16-byte aligned; the
// rest as sgv_sym_band_int8_matvec. Returns as above.
extern "C" int sgv_sym_band_int8_lanes(const void* upper, const void* scales, const void* x,
                                       void* y, void* partials, const void* gamw,
                                       const void* gam2, int K, int nb, int hb, int B, int S,
                                       int G, int D, void* stream) {
  if ((gamw == nullptr) != (gam2 == nullptr) || (reinterpret_cast<uintptr_t>(x) & 15))
    return -1;
  sgv::Args a{upper, x, y, K, nb, hb, G, static_cast<cudaStream_t>(stream), nullptr, partials, D};
  a.lanes = {static_cast<const float*>(x), static_cast<const float*>(gamw),
             static_cast<const float*>(gam2)};
  return matvec<true>(a, scales, B, S);
}

#ifdef SGV_COUNT_BLOCK_BYTES
// The block bytes the kernel's warps have copied since the count was last
// reset, into *out, after the device has finished its work; then resets
// the count to 0 if `reset` is not 0. Returns 0 or the first CUDA error.
extern "C" int sgv_sym_band_int8_block_bytes(unsigned long long* out, int reset) {
  if (const cudaError_t err = cudaDeviceSynchronize()) return static_cast<int>(err);
  if (const cudaError_t err = cudaMemcpyFromSymbol(out, g_block_bytes, sizeof(*out)))
    return static_cast<int>(err);
  const unsigned long long zero = 0;
  if (reset) return static_cast<int>(cudaMemcpyToSymbol(g_block_bytes, &zero, sizeof(zero)));
  return 0;
}
#endif
