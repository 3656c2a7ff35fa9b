// Symmetric block-banded matvec over hybrid int8/int4 upper-triangle blocks
// (Hopper).
//
// Replaces sgvamp_tpu/ops/band_kernel.py::_sym_band_kernel_streamed, the
// hybrid=True flavor (spill=False): the d=0 block as two int8 column halves
// in slots 0 and 1 (no mirror, x added back for the stripped unit
// diagonal), diagonal d >= 1 as int4 in slot d+1, one f32 scale per block
// row. The kernel, what it computes, its design and what bounds it (bytes
// from HBM: about 4*S flops a byte on the int8 halves, 8*S on the int4
// slots; the gather re-reads off-diagonal slots, up to (2hb+1)/(hb+1) of
// bytes_per_pass()) are in sym_band_packed.cuh.

#include "sym_band_packed.cuh"

// upper (K, nb, hb+2, B, B/2) int8, scales (K, nb, hb+2, B) f32, x
// (K, S, nb*B) bf16 as raw 16-bit words, y (K, S, nb*B) f32; all contiguous
// on the device. Launches on `stream`; returns cudaGetLastError() after the
// launch, or -1 for a block size or S the kernel is not built for.
extern "C" int sgv_sym_band_hybrid_matvec(const void* upper, const void* scales,
                                          const void* x, void* y, int K, int nb,
                                          int hb, int B, int S, void* stream) {
  return sgv_packed::matvec<true>(upper, scales, x, y, K, nb, hb, B, S, stream);
}
