// The gather kernel shared by the int4 and the hybrid int8/int4 storage of
// the symmetric block-banded LD operator (sym_band_int4.cu,
// sym_band_hybrid.cu). The two differ only in which slot holds a diagonal
// and in how the d=0 block decodes.
//
// Storage. A slot is a (B, B/2) array of bytes.
//   int4 slot:  byte [p, j] holds Q[p, j] in its low nibble and
//               Q[p, j + B/2] in its high nibble, both sign-extended.
//   int8 half:  byte [p, j] is Q[p, j + h*B/2] for half h (hybrid d=0 only:
//               slot 0 is h=0, slot 1 is h=1).
//   int4:   nslot = hb+1, diagonal d in slot d.
//   hybrid: nslot = hb+2, d=0 in slots 0 and 1 as int8 halves, d>=1 in
//           slot d+1 as int4.
// scales (K, nb, nslot, B) f32 are per block ROW p (the hybrid's d=0 block
// takes slot 0's). The d=0 block is stored with its unit diagonal stripped.
//
// What it computes, per cohort k and right-hand side s, x in bf16, y f32:
//   row part (d = 0..hb, block U = slot of (i, d), xv = x_{i+d}):
//     y_i[p] += sc[p] * sum_q Q[p, q] xv[q]      (+ xv[p] when d = 0)
//   mirror part (d = 1..hb, block of (i-d, d), xv = x_{i-d}):
//     y_i[q] += sum_p Q[p, q] * bf16(xv[p] * sc[p])
// The mirror's per-row scale sits on the contraction axis; the TPU kernel
// folds it into x and rounds that product to bf16 (round to nearest even),
// and so does this one. Every product of a bf16 and a small integer is
// exact in f32, so only the order of the sums differs from the TPU.
//
// Design: the gather on the tensor cores.
//  * One CTA of four warps per (output block row i, cohort k) reads every
//    slot that lands in y_i, sums in registers and writes y_i once; no
//    atomics, the same bits on every run.
//  * Staging: each slot, with its x block and its row scales, is copied to
//    shared memory (slot rows padded to B/2+16 bytes) by cp.async, 16
//    bytes a thread (so upper, scales and x must start on a 16-byte
//    boundary), double-buffered: the next slot of the CTA's list is
//    in flight while the current one is computed. The mirror's
//    bf16(x * sc) is formed where its B fragment is read.
//  * Both products run as mma.sync m16n8k16 (bf16 in, f32 accumulate) with
//    the block on the 16x16 A side and the S <= 4 lanes of x on the n = 8
//    side, zero beyond S: x.U^T (row part) and x'.U (mirror part), as the
//    TPU kernel's two half-width matmuls.
//  * Decode without I2F. int4: a 32-bit word of bytes gives eight values:
//    each nibble XOR 8, OR-ed under the bf16 pattern of 128.0 (0x4300, by
//    one byte_perm a pair) is 128 + (n ^ 8), and one bf16x2 FMA subtracts
//    136: exact for -8..7. The low nibbles feed the k-tile at byte column
//    j, the high ones the k-tile at j + B/2, so one load feeds both. int8
//    (hybrid d=0): byte ^ 0x80 under 0x4B000000 is the f32 2^23 + (b+128),
//    one FADD makes b, one cvt packs two to bf16x2: the 2^23 trick, chosen
//    over the split into two nibble products because it keeps one product
//    a k-tile and needs no second copy of x scaled by 16.
//  * The contraction order inside a k-tile is free, as long as A and B
//    agree. Row part (A = U: m = p, k = q): lane (g, t) reads one word of
//    row g and one of row g+8 at byte columns 4t..4t+3 of a 16-byte k
//    chunk, so k = 2t, 2t+1, 2t+8, 2t+9 are those four columns, and its B
//    fragment is x[g][4t..4t+3], one 8-byte load. Mirror part (A = U^T:
//    m = q, k = p): a register must hold two rows of one column, so lane
//    (g, t) reads the words of rows 2t, 2t+1, 2t+8, 2t+9 at byte columns
//    4g..4g+3 of a 32-byte column chunk and byte_perm interleaves each row
//    pair ([r0.b0, r1.b0, r0.b1, r1.b1]) before the same decode: four
//    16-column tiles (low and high nibbles of columns 4g, 4g+1 and of 4g+2,
//    4g+3) per 16 rows. With the padded row both orientations read shared
//    memory free of bank conflicts.
//  * Warp split. Row part: warp w owns m-tiles w*B/64 .. (w+1)*B/64 - 1 of
//    16 rows, all columns. Mirror part: warp w owns column chunk w % (B/64)
//    and a quarter, half or all of the rows (B = 64, 128, 256), a partial
//    sum. The per-row scale multiplies each slot's row-part fragment before
//    it joins the row accumulator. At the end the warps' sums meet in
//    shared memory and are added in a fixed order, with x_i for the
//    stripped unit diagonal.
//
// Spill form (one shard of a sharded operator; `carry` is not null), as in
// csrc/sym_band_int8.cu: x carries the next shard's first hb blocks after
// the shard's own nb, the row part of the last hb block rows multiplies
// them (slots with i+d >= nb are ordinary data inside a shard), and hb
// more CTAs a cohort sum the mirror terms that land in the next shard's
// block rows nb .. nb+hb-1, bf16(x * scale) rounding included, and write
// them to carry.
//
// Bound. About 8*S operations per int4 byte (4*S per int8 byte of the
// hybrid's d=0 halves), far below the tensor cores' rate: bytes from HBM
// bound it, the f32 scales (one per 64 to 128 bytes of a row) included. The
// gather reads every off-diagonal slot twice, up to (2hb+1)/(hb+1) of
// bytes_per_pass() unless the second read hits L2.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sym_band_tile.cuh"   // the int8 decode and cp.async

namespace sgv_packed {

using sgv::cp_async16;
using sgv::cp_async_commit;
using sgv::cp_async_wait;
using sgv::int8_at;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *static_cast<const uint32_t*>(p);
}

// (bf16 pair of 128 + u) - 136 for the two biased nibbles u: exact
__device__ __forceinline__ uint32_t minus136(uint32_t v) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(r) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// A word of four int4-pair bytes b0..b3 as four bf16x2 registers (first
// value in the low half): r[0] = (lo b0, lo b1), r[1] = (lo b2, lo b3),
// r[2] = (hi b0, hi b1), r[3] = (hi b2, hi b3).
__device__ __forceinline__ void decode4(uint32_t w, uint32_t r[4]) {
  const uint32_t lo = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  r[0] = minus136(__byte_perm(lo, 0x43434343u, 0x4140));
  r[1] = minus136(__byte_perm(lo, 0x43434343u, 0x4342));
  r[2] = minus136(__byte_perm(hi, 0x43434343u, 0x4140));
  r[3] = minus136(__byte_perm(hi, 0x43434343u, 0x4342));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float first, float second) {
  uint32_t r;  // cvt puts its first source in the upper half
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(second), "f"(first));
  return r;
}

// A word of four int8 bytes as r[0] = (b0, b1), r[1] = (b2, b3) in bf16x2.
__device__ __forceinline__ void decode8(uint32_t w, uint32_t r[2]) {
  const uint32_t u = w ^ 0x80808080u;
  r[0] = pack_bf16x2(int8_at(u, 0x7440), int8_at(u, 0x7441));
  r[1] = pack_bf16x2(int8_at(u, 0x7442), int8_at(u, 0x7443));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Shared memory of one CTA, bytes: NBUF stages of [slot | x block as bf16,
// S rows of B + 8 | the slot's B row scales]; the warps' sums reuse it at
// the end.
template <int B, int S>
struct Smem {
  static constexpr int NBUF = 2;           // slots in flight: double buffering
  static constexpr int ROW = B / 2 + 16;   // padded slot row, bytes
  static constexpr int XS = B + 8;         // padded x row, bf16 values
  static constexpr int WPC = 256 / B;      // warps that share a mirror column chunk
  static constexpr int XS_OFF = B * ROW;
  static constexpr int SC_OFF = XS_OFF + (S * XS * 2 + 15) / 16 * 16;
  static constexpr int STAGE = SC_OFF + B * 4;
  static constexpr int RED = (1 + WPC) * S * B * 4;
  static constexpr int BYTES = NBUF * STAGE > RED ? NBUF * STAGE : RED;
};

template <int B, int S, bool HYBRID>
__global__ void __launch_bounds__(THREADS)
sym_band_packed_kernel(const int8_t* __restrict__ upper,
                       const float* __restrict__ scales,
                       const uint16_t* __restrict__ x,
                       float* __restrict__ y, float* __restrict__ carry, int nb, int hb) {
  using L = Smem<B, S>;
  constexpr int BH = B / 2;        // bytes in a slot row
  constexpr int ROW = L::ROW;
  constexpr int XS = L::XS;
  constexpr int NBUF = L::NBUF;
  constexpr int VEC = BH / 16;     // 16-byte vectors per slot row
  constexpr int RT = B / 64;       // row part: m-tiles of a warp
  constexpr int KC = BH / 16;      // row part: 16-byte k chunks of a row
  constexpr int CC = B / 64;       // mirror part: 32-byte column chunks
  constexpr int WPC = L::WPC;
  constexpr int KT = B / 16 / WPC; // mirror part: k-tiles of 16 rows a warp
  constexpr int NE = (S * B + THREADS - 1) / THREADS;  // outputs a thread writes
  extern __shared__ __align__(16) unsigned char smem[];

  const int i = blockIdx.x;
  const int k = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nslot = hb + (HYBRID ? 2 : 1);
  const int nx = carry ? nb + hb : nb;  // x block rows: with the halo in the spill form
  const size_t M = static_cast<size_t>(nb) * B;
  const size_t Mx = static_cast<size_t>(nx) * B;
  const int8_t* uk = upper + static_cast<size_t>(k) * nb * nslot * B * BH;
  const float* sk = scales + static_cast<size_t>(k) * nb * nslot * B;
  const uint16_t* xk = x + static_cast<size_t>(k) * S * Mx;

  // x_i for the stripped unit diagonal, read now and added at the end
  float xdiag[NE];
#pragma unroll
  for (int n = 0; n < NE; ++n) {
    const int e = n * THREADS + tid;
    xdiag[n] = i < nb && e < S * B
                   ? bf16_to_f32(xk[(e / B) * Mx + static_cast<size_t>(i) * B + e % B])
                   : 0.0f;
  }

  // The slots that land in y_i, in order: item = 2*step + sub. Step
  // 0..hb is the row part of diagonal d = step, step hb+d the mirror part
  // of d; sub 1 is the hybrid d=0 block's second int8 half. The tests are
  // the same for every thread; src >= nb only for the carry's block rows.
  auto valid_from = [&](int step) {
    for (; step < 2 * hb + 1; ++step) {
      const bool mirror = step > hb;
      const int d = mirror ? step - hb : step;
      const int src = mirror ? i - d : i;     // block row that stores the block
      const int xb = mirror ? i - d : i + d;  // x block it multiplies
      if (src >= 0 && src < nb && xb < nx) return 2 * step;
    }
    return -1;
  };
  auto next_item = [&](int item) {
    if (HYBRID && item == 0) return 1;
    return valid_from((item >> 1) + 1);
  };

  // cp.async of one item's slot, x block and row scales into stage `buf`
  auto stage = [&](int item, int buf) {
    const int step = item >> 1, sub = item & 1;
    const bool mirror = step > hb;
    const int d = mirror ? step - hb : step;
    const int src = mirror ? i - d : i;
    const int xb = mirror ? i - d : i + d;
    const size_t slot0 = static_cast<size_t>(src) * nslot + (HYBRID ? (d == 0 ? 0 : d + 1) : d);
    unsigned char* st = smem + buf * L::STAGE;
    const int8_t* gslot = uk + (slot0 + sub) * B * BH;
#pragma unroll
    for (int n = 0; n < B * VEC / THREADS; ++n) {
      const int v = n * THREADS + tid;
      cp_async16(st + (v / VEC) * ROW + (v % VEC) * 16, gslot + v * 16);
    }
    uint16_t* xs = reinterpret_cast<uint16_t*>(st + L::XS_OFF);
    float* scs = reinterpret_cast<float*>(st + L::SC_OFF);
    const uint16_t* gx = xk + static_cast<size_t>(xb) * B;
    const float* gs = sk + slot0 * B;  // the hybrid's halves share slot 0's scales
    for (int v = tid; v < S * B / 8; v += THREADS)
      cp_async16(xs + (v / (B / 8)) * XS + (v % (B / 8)) * 8, gx + (v / (B / 8)) * Mx + (v % (B / 8)) * 8);
    for (int v = tid; v < B / 4; v += THREADS) cp_async16(scs + 4 * v, gs + 4 * v);
  };

  float racc[RT][4];    // row part: m-tile r of the warp, (row, lane) as mma's C
  float part[RT][4];    // row part of the current diagonal, before its scale
  float macc[4][4];     // mirror part: the four column tiles of the warp's chunk
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) racc[r][e] = part[r][e] = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) macc[c][e] = 0.0f;

  int cur = valid_from(0);
  int ahead = cur;       // the next item to stage
#pragma unroll
  for (int b = 0; b < NBUF - 1; ++b) {
    if (ahead >= 0) {
      stage(ahead, b);
      ahead = next_item(ahead);
    }
    cp_async_commit();
  }
  for (int buf = 0; cur >= 0; cur = next_item(cur), buf = (buf + 1) % NBUF) {
    if (ahead >= 0) {
      stage(ahead, (buf + NBUF - 1) % NBUF);  // its readers passed the last barrier
      ahead = next_item(ahead);
    }
    cp_async_commit();
    cp_async_wait<NBUF - 1>();  // the current item's copies have landed
    __syncthreads();

    const unsigned char* blk = smem + buf * L::STAGE;
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(blk + L::XS_OFF);
    const float* scs = reinterpret_cast<const float*>(blk + L::SC_OFF);
    const int step = cur >> 1, sub = cur & 1;
    const bool mirror = step > hb;
    const bool halves8 = HYBRID && step == 0;  // two int8 halves instead of nibbles

    // B fragment of the row part: x[g][col .. col+3] as k = 2t, 2t+1 and
    // 2t+8, 2t+9
    auto xfrag_row = [&](int col, uint32_t& b0, uint32_t& b1) {
      b0 = b1 = 0u;
      if (g < S) {
        const uint2 v = *reinterpret_cast<const uint2*>(xs + g * XS + col);
        b0 = v.x;
        b1 = v.y;
      }
    };

    if (!mirror && !halves8) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const int j = kc * 16 + 4 * t;
        uint32_t bl0, bl1, bh0, bh1;
        xfrag_row(j, bl0, bl1);        // low nibbles: columns j..j+3
        xfrag_row(BH + j, bh0, bh1);   // high nibbles: columns BH+j..
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int p = (warp * RT + r) * 16 + g;
          uint32_t u0[4], u1[4];
          decode4(lds32(blk + p * ROW + j), u0);
          decode4(lds32(blk + (p + 8) * ROW + j), u1);
          mma16816(part[r], u0[0], u1[0], u0[1], u1[1], bl0, bl1);
          mma16816(part[r], u0[2], u1[2], u0[3], u1[3], bh0, bh1);
        }
      }
    } else if (!mirror) {
      // int8 half `sub`: byte column j is column sub*BH + j
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const int j = kc * 16 + 4 * t;
        uint32_t b0, b1;
        xfrag_row(sub * BH + j, b0, b1);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int p = (warp * RT + r) * 16 + g;
          uint32_t v0[2], v1[2];
          decode8(lds32(blk + p * ROW + j), v0);
          decode8(lds32(blk + (p + 8) * ROW + j), v1);
          mma16816(part[r], v0[0], v1[0], v0[1], v1[1], b0, b1);
        }
      }
    } else {
      // lane (g, t) reads byte columns cb..cb+3 of rows p, p+1, p+8, p+9
      // of each k-tile; its B fragment is bf16(x[g][p] * sc[p]) at those rows
      const int cb = (warp % CC) * 32 + 4 * g;
#pragma unroll 4
      for (int kt = 0; kt < KT; ++kt) {
        const int p = ((warp / CC) * KT + kt) * 16 + 2 * t;
        uint32_t b0 = 0u, b1 = 0u;
        if (g < S) {
          const uint32_t x01 = lds32(xs + g * XS + p), x89 = lds32(xs + g * XS + p + 8);
          const float2 s01 = *reinterpret_cast<const float2*>(scs + p);
          const float2 s89 = *reinterpret_cast<const float2*>(scs + p + 8);
          b0 = pack_bf16x2(bf16_to_f32(x01 & 0xFFFFu) * s01.x, bf16_to_f32(x01 >> 16) * s01.y);
          b1 = pack_bf16x2(bf16_to_f32(x89 & 0xFFFFu) * s89.x, bf16_to_f32(x89 >> 16) * s89.y);
        }
        const uint32_t w0 = lds32(blk + p * ROW + cb);
        const uint32_t w1 = lds32(blk + (p + 1) * ROW + cb);
        const uint32_t w2 = lds32(blk + (p + 8) * ROW + cb);
        const uint32_t w3 = lds32(blk + (p + 9) * ROW + cb);
        uint32_t a01[4], a23[4], c01[4], c23[4];
        decode4(__byte_perm(w0, w1, 0x5140), a01);  // columns cb, cb+1
        decode4(__byte_perm(w2, w3, 0x5140), a23);
        decode4(__byte_perm(w0, w1, 0x7362), c01);  // columns cb+2, cb+3
        decode4(__byte_perm(w2, w3, 0x7362), c23);
        mma16816(macc[0], a01[0], a01[1], a23[0], a23[1], b0, b1);
        mma16816(macc[1], c01[0], c01[1], c23[0], c23[1], b0, b1);
        mma16816(macc[2], a01[2], a01[3], a23[2], a23[3], b0, b1);
        mma16816(macc[3], c01[2], c01[3], c23[2], c23[3], b0, b1);
      }
    }

    if (!mirror && !(halves8 && sub == 0)) {  // the diagonal's last item: scale it in
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int p = (warp * RT + r) * 16 + g;
        const float s0 = scs[p], s8 = scs[p + 8];
        racc[r][0] += s0 * part[r][0];
        racc[r][1] += s0 * part[r][1];
        racc[r][2] += s8 * part[r][2];
        racc[r][3] += s8 * part[r][3];
#pragma unroll
        for (int e = 0; e < 4; ++e) part[r][e] = 0.0f;
      }
    }
    __syncthreads();  // the stage is free for the copy issued next round
  }
  cp_async_wait<0>();

  // the warps' sums meet in shared memory: rows [S][B], then the mirror
  // partials [WPC][S][B]; each element written by one lane
  float* rows = reinterpret_cast<float*>(smem);
  float* mirs = rows + S * B;
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int s = 2 * t + e;
    if (s < S) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int p = (warp * RT + r) * 16 + g;
        rows[s * B + p] = racc[r][e];
        rows[s * B + p + 8] = racc[r][2 + e];
      }
      float* m = mirs + ((warp / CC) * S + s) * B + (warp % CC) * 32 + 4 * g;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int q = (c >= 2 ? BH : 0) + 2 * (c & 1);
        m[q] = macc[c][e];
        m[q + 1] = macc[c][2 + e];
      }
    }
  }
  __syncthreads();

  // block rows past nb are the carry (K, S, hb * B)
  const size_t Mo = i < nb ? M : static_cast<size_t>(hb) * B;
  float* ok = (i < nb ? y + static_cast<size_t>(i) * B : carry + static_cast<size_t>(i - nb) * B)
              + static_cast<size_t>(k) * S * Mo;
#pragma unroll
  for (int n = 0; n < NE; ++n) {
    const int e = n * THREADS + tid;
    if (e < S * B) {
      float v = rows[e];
#pragma unroll
      for (int w = 0; w < WPC; ++w) v += mirs[w * S * B + e];
      ok[(e / B) * Mo + e % B] = v + xdiag[n];
    }
  }
}

template <int B, int S, bool HYBRID>
int launch(const int8_t* upper, const float* scales, const uint16_t* x,
           float* y, float* carry, int K, int nb, int hb, cudaStream_t stream) {
  constexpr int bytes = Smem<B, S>::BYTES;
  auto* kernel = sym_band_packed_kernel<B, S, HYBRID>;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the slots, x and the scales are copied 16 bytes at a time
  const uintptr_t bits = reinterpret_cast<uintptr_t>(upper) | reinterpret_cast<uintptr_t>(scales) |
                         reinterpret_cast<uintptr_t>(x);
  if (bits & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  kernel<<<dim3(carry ? nb + hb : nb, K), THREADS, bytes, stream>>>(
      upper, scales, x, y, carry, nb, hb);
  return static_cast<int>(cudaGetLastError());
}

template <int B, bool HYBRID>
int launch_s(const int8_t* upper, const float* scales, const uint16_t* x,
             float* y, float* carry, int K, int nb, int hb, int S, cudaStream_t stream) {
  switch (S) {
    case 1: return launch<B, 1, HYBRID>(upper, scales, x, y, carry, K, nb, hb, stream);
    case 2: return launch<B, 2, HYBRID>(upper, scales, x, y, carry, K, nb, hb, stream);
    case 3: return launch<B, 3, HYBRID>(upper, scales, x, y, carry, K, nb, hb, stream);
    case 4: return launch<B, 4, HYBRID>(upper, scales, x, y, carry, K, nb, hb, stream);
    default: return -1;
  }
}

// cudaGetLastError() after the launch, cudaErrorMisalignedAddress (716)
// with nothing launched if upper, scales or x does not start on a 16-byte
// boundary, or -1 for a block size or S the kernel is not built for. carry: null for the whole operator, else the
// spill form's (K, S, hb*B) f32 output (with hb = 0 nothing is written to
// it), and x is then (K, S, (nb+hb)*B).
template <bool HYBRID>
int matvec(const void* upper, const void* scales, const void* x, void* y, void* carry,
           int K, int nb, int hb, int B, int S, void* stream) {
  const auto* u = static_cast<const int8_t*>(upper);
  const auto* sc = static_cast<const float*>(scales);
  const auto* xv = static_cast<const uint16_t*>(x);
  auto* yv = static_cast<float*>(y);
  auto* cv = static_cast<float*>(carry);
  auto st = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 64: return launch_s<64, HYBRID>(u, sc, xv, yv, cv, K, nb, hb, S, st);
    case 128: return launch_s<128, HYBRID>(u, sc, xv, yv, cv, K, nb, hb, S, st);
    case 256: return launch_s<256, HYBRID>(u, sc, xv, yv, cv, K, nb, hb, S, st);
    default: return -1;
  }
}

}  // namespace sgv_packed
