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
// scales (K, nb, nslot, B) f32 are per block ROW p. The d=0 block is stored
// with its unit diagonal stripped.
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
// Design. The gather of sym_band_int8.cu: one CTA of B threads per (output
// block row i, cohort k) reads every slot that lands in y_i, sums in
// registers and writes y_i once; no atomics, the same bits on every run.
// Each slot (B*B/2 bytes, at most 32 KB) is staged through shared memory
// with coalesced 16-byte loads into rows padded to B/2+16 bytes, so that
// the row orientation (thread = row p, 16-byte reads along the row) is free
// of bank conflicts. In the mirror orientation thread q < B/2 decodes the
// low nibble of byte column q and thread q >= B/2 the high nibble of byte
// column q - B/2.
//
// Bound. About 8*S flops per int4 byte (4*S per int8 byte of the hybrid's
// d=0 halves): bytes from HBM bound it, the f32 scales (one per 64 to 128
// bytes of a row) included. The gather reads every off-diagonal slot
// twice, up to (2hb+1)/(hb+1) of bytes_per_pass() unless the second read
// hits L2.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sgv_packed {

__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// f rounded to bf16 (nearest even) and back
__device__ __forceinline__ float round_bf16(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

__device__ __forceinline__ float nib_lo(int8_t b) {
  return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(b) << 4) >> 4);
}
__device__ __forceinline__ float nib_hi(int8_t b) {
  return static_cast<float>(b >> 4);  // arithmetic shift keeps the sign
}

template <int B, int S, bool HYBRID>
__global__ void __launch_bounds__(B)
sym_band_packed_kernel(const int8_t* __restrict__ upper,
                       const float* __restrict__ scales,
                       const uint16_t* __restrict__ x,
                       float* __restrict__ y, int nb, int hb) {
  constexpr int BH = B / 2;       // bytes in a slot row
  constexpr int ROW = BH + 16;    // padded shared-memory row, bytes
  constexpr int VEC = BH / 16;    // 16-byte vectors per slot row
  __shared__ __align__(16) int8_t blk[B * ROW];
  __shared__ float xs[S * B];

  const int i = blockIdx.x;
  const int k = blockIdx.y;
  const int t = threadIdx.x;
  const int nslot = hb + (HYBRID ? 2 : 1);
  const size_t M = static_cast<size_t>(nb) * B;
  const int8_t* uk = upper + static_cast<size_t>(k) * nb * nslot * B * BH;
  const float* sk = scales + static_cast<size_t>(k) * nb * nslot * B;
  const uint16_t* xk = x + static_cast<size_t>(k) * S * M;

  float acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = 0.0f;

  for (int step = 0; step < 2 * hb + 1; ++step) {
    const bool mirror = step > hb;
    const int d = mirror ? step - hb : step;
    const int src = mirror ? i - d : i;     // block row that stores the block
    const int xb = mirror ? i - d : i + d;  // x block it multiplies
    if (xb < 0 || xb >= nb) continue;       // the same for every thread
    const int slot = HYBRID ? (d == 0 ? 0 : d + 1) : d;
    const bool halves8 = HYBRID && d == 0;  // two int8 halves instead of nibbles
    const size_t slot0 = static_cast<size_t>(src) * nslot + slot;
    const float sc = sk[slot0 * B + t];     // scale of block row t

    float part[S];
#pragma unroll
    for (int s = 0; s < S; ++s) part[s] = 0.0f;

    for (int sub = 0; sub < (halves8 ? 2 : 1); ++sub) {
      const int4* g = reinterpret_cast<const int4*>(uk + (slot0 + sub) * B * BH);
      __syncthreads();  // the previous slot's readers are done
#pragma unroll
      for (int n = 0; n < VEC; ++n) {
        const int v = n * B + t;
        *reinterpret_cast<int4*>(blk + (v / VEC) * ROW + (v % VEC) * 16) = g[v];
      }
      if (sub == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float xv = bf16_to_f32(xk[s * M + static_cast<size_t>(xb) * B + t]);
          xs[s * B + t] = mirror ? round_bf16(xv * sc) : xv;
        }
      }
      __syncthreads();

      if (!mirror) {
        // thread t is output row p
        const int8_t* rowp = blk + t * ROW;
#pragma unroll 2
        for (int c = 0; c < VEC; ++c) {
          const int4 w = *reinterpret_cast<const int4*>(rowp + c * 16);
          const uint32_t words[4] = {static_cast<uint32_t>(w.x), static_cast<uint32_t>(w.y),
                                     static_cast<uint32_t>(w.z), static_cast<uint32_t>(w.w)};
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int8_t b = static_cast<int8_t>(words[e / 4] >> (8 * (e % 4)));
            const int j = c * 16 + e;
            if (halves8) {
              const float u = static_cast<float>(b);
#pragma unroll
              for (int s = 0; s < S; ++s)
                part[s] = fmaf(u, xs[s * B + sub * BH + j], part[s]);
            } else {
              const float lo = nib_lo(b), hi = nib_hi(b);
#pragma unroll
              for (int s = 0; s < S; ++s) {
                part[s] = fmaf(lo, xs[s * B + j], part[s]);
                part[s] = fmaf(hi, xs[s * B + BH + j], part[s]);
              }
            }
          }
        }
      } else {
        // thread t is output column q; xs holds bf16(x[p] * sc[p])
        const int jq = t < BH ? t : t - BH;
        const bool high = t >= BH;
#pragma unroll 8
        for (int p = 0; p < B; ++p) {
          const int8_t b = blk[p * ROW + jq];
          const float u = high ? nib_hi(b) : nib_lo(b);
#pragma unroll
          for (int s = 0; s < S; ++s) part[s] = fmaf(u, xs[s * B + p], part[s]);
        }
      }
    }

    if (mirror) {
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s] += part[s];
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        acc[s] += sc * part[s];
        if (d == 0) acc[s] += xs[s * B + t];  // the stripped unit diagonal
      }
    }
  }

  float* yk = y + static_cast<size_t>(k) * S * M + static_cast<size_t>(i) * B + t;
#pragma unroll
  for (int s = 0; s < S; ++s) yk[s * M] = acc[s];
}

template <int B, int S, bool HYBRID>
int launch(const int8_t* upper, const float* scales, const uint16_t* x,
           float* y, int K, int nb, int hb, cudaStream_t stream) {
  sym_band_packed_kernel<B, S, HYBRID><<<dim3(nb, K), B, 0, stream>>>(
      upper, scales, x, y, nb, hb);
  return static_cast<int>(cudaGetLastError());
}

template <int B, bool HYBRID>
int launch_s(const int8_t* upper, const float* scales, const uint16_t* x,
             float* y, int K, int nb, int hb, int S, cudaStream_t stream) {
  switch (S) {
    case 1: return launch<B, 1, HYBRID>(upper, scales, x, y, K, nb, hb, stream);
    case 2: return launch<B, 2, HYBRID>(upper, scales, x, y, K, nb, hb, stream);
    case 3: return launch<B, 3, HYBRID>(upper, scales, x, y, K, nb, hb, stream);
    case 4: return launch<B, 4, HYBRID>(upper, scales, x, y, K, nb, hb, stream);
    default: return -1;
  }
}

// cudaGetLastError() after the launch, or -1 for a block size or S the
// kernel is not built for.
template <bool HYBRID>
int matvec(const void* upper, const void* scales, const void* x, void* y,
           int K, int nb, int hb, int B, int S, void* stream) {
  const auto* u = static_cast<const int8_t*>(upper);
  const auto* sc = static_cast<const float*>(scales);
  const auto* xv = static_cast<const uint16_t*>(x);
  auto* yv = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 64: return launch_s<64, HYBRID>(u, sc, xv, yv, K, nb, hb, S, st);
    case 128: return launch_s<128, HYBRID>(u, sc, xv, yv, K, nb, hb, S, st);
    case 256: return launch_s<256, HYBRID>(u, sc, xv, yv, K, nb, hb, S, st);
    default: return -1;
  }
}

}  // namespace sgv_packed
