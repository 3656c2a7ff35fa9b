// Symmetric block-banded matvec over int4 upper-triangle blocks (Hopper).
//
// Replaces sgvamp_tpu/ops/band_kernel.py::_sym_band_kernel_streamed, the
// packed4=True flavor (spill=False): two 4-bit values a byte as contiguous
// column halves, one f32 scale per block row, the unit diagonal of the d=0
// block stripped and x added back. The kernel, what it computes, its
// design and what bounds it (bytes from HBM, about 8*S flops a byte; the
// gather re-reads off-diagonal blocks, up to (2hb+1)/(hb+1) of
// bytes_per_pass()) are in sym_band_packed.cuh.

#include "sym_band_packed.cuh"

// upper (K, nb, hb+1, B, B/2) int8, scales (K, nb, hb+1, B) f32, x
// (K, S, nb*B) bf16 as raw 16-bit words, y (K, S, nb*B) f32; all contiguous
// on the device. Launches on `stream`; returns cudaGetLastError() after the
// launch, or -1 for a block size or S the kernel is not built for.
extern "C" int sgv_sym_band_int4_matvec(const void* upper, const void* scales,
                                        const void* x, void* y, int K, int nb,
                                        int hb, int B, int S, void* stream) {
  return sgv_packed::matvec<false>(upper, scales, x, y, K, nb, hb, B, S, stream);
}
