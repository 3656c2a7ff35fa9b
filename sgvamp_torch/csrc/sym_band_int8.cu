// Symmetric block-banded matvec over int8 upper-triangle blocks (Hopper).
//
// Replaces sgvamp_tpu/ops/band_kernel.py::_sym_band_kernel_streamed, the
// quantized flavor (quantized=True), with spill=False and, through the
// second entry point, with spill=True.
//
// What it computes, per cohort k and right-hand side s:
//   y_i = sum_{d=0..hb, i+d<nb} sc[i,d]   * U[i,d]   @ x_{i+d}     (row part)
//       + sum_{d=1..hb, i-d>=0} sc[i-d,d] * U[i-d,d]^T @ x_{i-d}   (mirror part)
// with U[i,d] the (B, B) int8 block R[block i, block i+d] / sc[i,d], x in
// bf16 and y in f32. Each block's dot is taken in f32 and then multiplied
// by the block's f32 scale, as the TPU kernel does. A bf16 times an int8 is
// exact in f32, so only the order of the sums differs from the TPU.
//
// Design. The TPU kernel walks chunks of block rows in grid order and
// carries the mirror terms that cross a chunk in VMEM; that is race-free
// only because TPU grid steps run one after another. Here CTAs run
// concurrently in no order, so the kernel GATHERS instead: one CTA per
// (output block row i, cohort k) reads every block that lands in y_i (row
// blocks U[i,0..hb], mirror blocks U[i-d,d] for d=1..hb), accumulates in
// registers and writes y_i once. No atomics, no second pass, and the
// result is the same bits on every run.
//
// Spill form (one shard of a sharded operator; `carry` is not null). upper
// holds the shard's nb block rows, x its nb x blocks followed by the next
// shard's first hb (the halo). Two things change. The row part of the last
// hb block rows multiplies the halo where the whole operator ends: inside a
// shard the blocks U[i,d] with i+d >= nb are ordinary data, so nothing past
// the local end may be skipped. And hb more CTAs a cohort, for the output
// block rows nb .. nb+hb-1 that belong to the next shard, sum the mirror
// terms of this shard's blocks that land there (d > i-nb) and write them to
// carry; the caller adds carry into the head of the next shard's y. Mirror
// terms from the previous shard are not in y: they arrive as its carry. The
// gather needs nothing else: no CTA waits for another in either form.
//
// Bound. About 4*S flops per int8 byte: far below where tensor cores
// matter, so bytes from HBM bound it. The gather reads every off-diagonal
// block twice, once as a row block (CTA i) and once as a mirror block
// (CTA i+d), which is up to (2hb+1)/(hb+1) of bytes_per_pass() from HBM.
// CTAs are launched in block-row order (blockIdx.x = i), so CTA i+d runs
// in the same wave as CTA i and its second read of U[i,d] can hit L2;
// timing on an H100 says about a third of them do (PERF.md). A read-once
// scheme is later work.
//
// Each block is staged through shared memory with 16-byte loads, coalesced
// across the CTA, into rows padded to B+16 bytes so that the row
// orientation (thread = output row p, 16-byte reads along q) is free of
// bank conflicts; the mirror orientation (thread = output column q) reads
// consecutive bytes of one row per step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

template <int B, int S>
__global__ void __launch_bounds__(B)
sym_band_int8_kernel(const int8_t* __restrict__ upper,
                     const float* __restrict__ scales,
                     const uint16_t* __restrict__ x,
                     float* __restrict__ y, float* __restrict__ carry, int nb, int hb) {
  constexpr int ROW = B + 16;    // padded shared-memory row, bytes
  constexpr int VEC = B / 16;    // 16-byte vectors per block row
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* blk = reinterpret_cast<int8_t*>(smem);          // B * ROW bytes
  float* xs = reinterpret_cast<float*>(smem + B * ROW);   // S * B floats

  const int i = blockIdx.x;
  const int k = blockIdx.y;
  const int t = threadIdx.x;
  const int nslot = hb + 1;
  const int nx = carry ? nb + hb : nb;  // x block rows: with the halo in the spill form
  const size_t M = static_cast<size_t>(nb) * B;
  const size_t Mx = static_cast<size_t>(nx) * B;
  const int8_t* uk = upper + static_cast<size_t>(k) * nb * nslot * B * B;
  const float* sk = scales + static_cast<size_t>(k) * nb * nslot;
  const uint16_t* xk = x + static_cast<size_t>(k) * S * Mx;

  float acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = 0.0f;

  for (int step = 0; step < 2 * hb + 1; ++step) {
    const bool mirror = step > hb;
    const int d = mirror ? step - hb : step;
    const int src = mirror ? i - d : i;     // block row that stores the block
    const int xb = mirror ? i - d : i + d;  // x block it multiplies
    // the same for every thread; src >= nb only for the carry's block rows
    if (src < 0 || src >= nb || xb >= nx) continue;
    const int4* g = reinterpret_cast<const int4*>(
        uk + (static_cast<size_t>(src) * nslot + d) * B * B);

    __syncthreads();  // the previous block's readers are done
#pragma unroll
    for (int n = 0; n < VEC; ++n) {
      const int v = n * B + t;
      *reinterpret_cast<int4*>(blk + (v / VEC) * ROW + (v % VEC) * 16) = g[v];
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
      xs[s * B + t] = bf16_to_f32(xk[s * Mx + static_cast<size_t>(xb) * B + t]);
    __syncthreads();

    float part[S];
#pragma unroll
    for (int s = 0; s < S; ++s) part[s] = 0.0f;
    if (!mirror) {
      // thread t is output row p: sum_q U[p, q] x[q]
      const int8_t* rowp = blk + t * ROW;
#pragma unroll 2
      for (int c = 0; c < VEC; ++c) {
        const int4 w = *reinterpret_cast<const int4*>(rowp + c * 16);
        const uint32_t words[4] = {static_cast<uint32_t>(w.x), static_cast<uint32_t>(w.y),
                                   static_cast<uint32_t>(w.z), static_cast<uint32_t>(w.w)};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float u = static_cast<float>(
              static_cast<int8_t>(words[e / 4] >> (8 * (e % 4))));
#pragma unroll
          for (int s = 0; s < S; ++s)
            part[s] = fmaf(u, xs[s * B + c * 16 + e], part[s]);
        }
      }
    } else {
      // thread t is output column q: sum_p U[p, q] x[p]
#pragma unroll 8
      for (int p = 0; p < B; ++p) {
        const float u = static_cast<float>(blk[p * ROW + t]);
#pragma unroll
        for (int s = 0; s < S; ++s) part[s] = fmaf(u, xs[s * B + p], part[s]);
      }
    }
    const float sc = sk[static_cast<size_t>(src) * nslot + d];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] += sc * part[s];
  }

  // block rows past nb are the carry (K, S, hb * B)
  const size_t Mo = i < nb ? M : static_cast<size_t>(hb) * B;
  float* ok = (i < nb ? y + static_cast<size_t>(i) * B : carry + static_cast<size_t>(i - nb) * B)
              + static_cast<size_t>(k) * S * Mo + t;
#pragma unroll
  for (int s = 0; s < S; ++s) ok[s * Mo] = acc[s];
}

template <int B, int S>
int launch(const int8_t* upper, const float* scales, const uint16_t* x,
           float* y, float* carry, int K, int nb, int hb, cudaStream_t stream) {
  const int smem = B * (B + 16) + S * B * static_cast<int>(sizeof(float));
  auto kernel = sym_band_int8_kernel<B, S>;
  if (smem > 48 * 1024) {  // above the default limit (B=256) it must be asked for
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(carry ? nb + hb : nb, K), B, smem, stream>>>(upper, scales, x, y, carry, nb,
                                                             hb);
  return static_cast<int>(cudaGetLastError());
}

template <int B>
int launch_b(const int8_t* upper, const float* scales, const uint16_t* x,
             float* y, float* carry, int K, int nb, int hb, int S, cudaStream_t stream) {
  switch (S) {
    case 1: return launch<B, 1>(upper, scales, x, y, carry, K, nb, hb, stream);
    case 2: return launch<B, 2>(upper, scales, x, y, carry, K, nb, hb, stream);
    case 3: return launch<B, 3>(upper, scales, x, y, carry, K, nb, hb, stream);
    case 4: return launch<B, 4>(upper, scales, x, y, carry, K, nb, hb, stream);
    default: return -1;
  }
}

int matvec(const void* upper, const void* scales, const void* x, void* y, void* carry,
           int K, int nb, int hb, int B, int S, void* stream) {
  const auto* u = static_cast<const int8_t*>(upper);
  const auto* sc = static_cast<const float*>(scales);
  const auto* xv = static_cast<const uint16_t*>(x);
  auto* yv = static_cast<float*>(y);
  auto* cv = static_cast<float*>(carry);
  auto st = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 64: return launch_b<64>(u, sc, xv, yv, cv, K, nb, hb, S, st);
    case 128: return launch_b<128>(u, sc, xv, yv, cv, K, nb, hb, S, st);
    case 256: return launch_b<256>(u, sc, xv, yv, cv, K, nb, hb, S, st);
    default: return -1;
  }
}

}  // namespace

// upper (K, nb, hb+1, B, B) int8, scales (K, nb, hb+1) f32, x (K, S, nb*B)
// bf16 as raw 16-bit words, y (K, S, nb*B) f32; all contiguous on the
// device. Launches on `stream` and returns cudaGetLastError() after the
// launch, or -1 for a block size or S the kernel is not built for.
extern "C" int sgv_sym_band_int8_matvec(const void* upper, const void* scales,
                                        const void* x, void* y, int K, int nb,
                                        int hb, int B, int S, void* stream) {
  return matvec(upper, scales, x, y, nullptr, K, nb, hb, B, S, stream);
}

// The spill form: upper and scales of one shard's nb block rows, x
// (K, S, (nb+hb)*B) with the halo, y (K, S, nb*B) and carry (K, S, hb*B) f32.
// With hb = 0 nothing is written to carry (the caller's is one block of
// zeros). Returns as above.
extern "C" int sgv_sym_band_int8_spill(const void* upper, const void* scales,
                                       const void* x, void* y, void* carry, int K,
                                       int nb, int hb, int B, int S, void* stream) {
  if (carry == nullptr) return -1;
  return matvec(upper, scales, x, y, carry, K, nb, hb, B, S, stream);
}
