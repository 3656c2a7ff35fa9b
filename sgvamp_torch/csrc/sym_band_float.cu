// Symmetric block-banded matvec over float upper-triangle blocks (Hopper).
//
// Replaces sgvamp_tpu/ops/band_kernel.py::_sym_band_kernel_streamed, the
// unquantized flavor (blocks in bfloat16, float32 or float64, no scales,
// spill=False).
//
// What it computes, per cohort k and right-hand side s:
//   y_i = sum_{d=0..hb, i+d<nb} U[i,d]     @ x_{i+d}     (row part)
//       + sum_{d=1..hb, i-d>=0} U[i-d,d]^T @ x_{i-d}     (mirror part)
// with U[i,d] the (B, B) block R[block i, block i+d]. x arrives in the
// block dtype (bf16 blocks see a bf16 x, f32 blocks an f32 x), products and
// sums are taken in f32 (f64 for f64 blocks) and y is written in that
// type. A float32 block times a float32 x is a true float32 product here;
// the TPU's matrix unit truncates f32 operands to bf16 at its default
// precision.
//
// Design. The same gather as csrc/sym_band_int8.cu: one CTA per (output
// block row i, cohort k) reads every block that lands in y_i, and writes
// y_i once; no atomics, and the same bits on every run. A float block is
// up to 512 KB (f64, B=256), more than a CTA's shared memory, so blocks
// are NOT staged: both orientations read global memory directly, each in
// the order that coalesces.
//   row part:    one warp per block row p, lanes along q (consecutive
//                addresses), a shuffle reduction, and the owning warp adds
//                the sum into a shared y row;
//   mirror part: thread t is output column q and walks p; for each p the
//                CTA reads one contiguous block row.
// Only x (S*B values) lives in shared memory.
//
// Bound. 2*S flops per element read (S <= 4), against 2 to 8 bytes per
// element: bytes from HBM bound it. The gather reads every off-diagonal
// block twice (as a row block in CTA i, as a mirror block in CTA i+d),
// up to (2hb+1)/(hb+1) of bytes_per_pass() from HBM unless the second
// read hits L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

template <typename T, int B, int S>
__global__ void __launch_bounds__(B)
sym_band_float_kernel(const T* __restrict__ upper, const T* __restrict__ x,
                      typename AccOf<T>::type* __restrict__ y, int nb, int hb) {
  using A = typename AccOf<T>::type;
  constexpr int NW = B / 32;     // warps in the CTA
  __shared__ A xs[S * B];        // the x block of this step
  __shared__ A ys[S * B];        // row-part sums; row p is owned by warp p % NW

  const int i = blockIdx.x;
  const int k = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nslot = hb + 1;
  const size_t M = static_cast<size_t>(nb) * B;
  const T* uk = upper + static_cast<size_t>(k) * nb * nslot * B * B;
  const T* xk = x + static_cast<size_t>(k) * S * M;

  A acc[S];                      // mirror-part sums of output column t
#pragma unroll
  for (int s = 0; s < S; ++s) {
    acc[s] = A(0);
    ys[s * B + t] = A(0);
  }

  for (int step = 0; step < 2 * hb + 1; ++step) {
    const bool mirror = step > hb;
    const int d = mirror ? step - hb : step;
    const int src = mirror ? i - d : i;     // block row that stores the block
    const int xb = mirror ? i - d : i + d;  // x block it multiplies
    if (xb < 0 || xb >= nb) continue;       // the same for every thread
    const T* g = uk + (static_cast<size_t>(src) * nslot + d) * B * B;

    __syncthreads();  // the previous step's readers of xs are done
#pragma unroll
    for (int s = 0; s < S; ++s)
      xs[s * B + t] = to_acc(xk[s * M + static_cast<size_t>(xb) * B + t]);
    __syncthreads();

    if (!mirror) {
      // warp w takes rows p = w, w + NW, ...: sum_q U[p, q] x[q]
      for (int p = warp; p < B; p += NW) {
        const T* row = g + static_cast<size_t>(p) * B;
        A part[S];
#pragma unroll
        for (int s = 0; s < S; ++s) part[s] = A(0);
#pragma unroll
        for (int q = lane; q < B; q += 32) {
          const A u = to_acc(row[q]);
#pragma unroll
          for (int s = 0; s < S; ++s) part[s] = fma_acc(u, xs[s * B + q], part[s]);
        }
#pragma unroll
        for (int s = 0; s < S; ++s) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part[s] += __shfl_down_sync(0xffffffffu, part[s], off);
        }
        if (lane == 0) {
#pragma unroll
          for (int s = 0; s < S; ++s) ys[s * B + p] += part[s];
        }
      }
    } else {
      // thread t is output column q: sum_p U[p, q] x[p]
#pragma unroll 8
      for (int p = 0; p < B; ++p) {
        const A u = to_acc(g[static_cast<size_t>(p) * B + t]);
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s] = fma_acc(u, xs[s * B + p], acc[s]);
      }
    }
  }

  __syncthreads();  // every warp's row sums are in ys
  A* yk = y + static_cast<size_t>(k) * S * M + static_cast<size_t>(i) * B + t;
#pragma unroll
  for (int s = 0; s < S; ++s) yk[s * M] = ys[s * B + t] + acc[s];
}

template <typename T, int B, int S>
int launch(const void* upper, const void* x, void* y, int K, int nb, int hb,
           cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  sym_band_float_kernel<T, B, S><<<dim3(nb, K), B, 0, stream>>>(
      static_cast<const T*>(upper), static_cast<const T*>(x),
      static_cast<A*>(y), nb, hb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int B>
int launch_s(const void* upper, const void* x, void* y, int K, int nb, int hb,
             int S, cudaStream_t stream) {
  switch (S) {
    case 1: return launch<T, B, 1>(upper, x, y, K, nb, hb, stream);
    case 2: return launch<T, B, 2>(upper, x, y, K, nb, hb, stream);
    case 3: return launch<T, B, 3>(upper, x, y, K, nb, hb, stream);
    case 4: return launch<T, B, 4>(upper, x, y, K, nb, hb, stream);
    default: return -1;
  }
}

template <typename T>
int launch_b(const void* upper, const void* x, void* y, int K, int nb, int hb,
             int B, int S, cudaStream_t stream) {
  switch (B) {
    case 64: return launch_s<T, 64>(upper, x, y, K, nb, hb, S, stream);
    case 128: return launch_s<T, 128>(upper, x, y, K, nb, hb, S, stream);
    case 256: return launch_s<T, 256>(upper, x, y, K, nb, hb, S, stream);
    default: return -1;
  }
}

}  // namespace

// upper (K, nb, hb+1, B, B) and x (K, S, nb*B) in the type named by dtype
// (0 bfloat16 as raw 16-bit words, 1 float32, 2 float64), y (K, S, nb*B) in
// float32 (float64 for dtype 2); all contiguous on the device. Launches on
// `stream` and returns cudaGetLastError() after the launch, or -1 for a
// dtype, block size or S the kernel is not built for.
extern "C" int sgv_sym_band_float_matvec(const void* upper, const void* x,
                                         void* y, int K, int nb, int hb, int B,
                                         int S, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_b<bf16_t>(upper, x, y, K, nb, hb, B, S, st);
    case 1: return launch_b<float>(upper, x, y, K, nb, hb, B, S, st);
    case 2: return launch_b<double>(upper, x, y, K, nb, hb, B, S, st);
    default: return -1;
  }
}
