// Symmetric block-banded matvec over hybrid int8/int4 upper-triangle blocks
// (Hopper).
//
// Replaces sgvamp_tpu/ops/band_kernel.py::_sym_band_kernel_streamed, the
// hybrid=True flavor (spill=False, and spill=True through the
// second entry point): the d=0 block as two int8 column halves
// in slots 0 and 1 (no mirror, x added back for the stripped unit
// diagonal), diagonal d >= 1 as int4 in slot d+1, one f32 scale per block
// row. The kernel, what it computes and its design (the gather; both
// products of every slot as mma.sync on the tensor cores, int8 and int4
// decoded to bf16 without I2F) are in sym_band_packed.cuh. Bound: bytes
// from HBM (about 4*S operations a byte on the int8 halves, 8*S on the
// int4 slots); the gather re-reads off-diagonal slots, up to
// (2hb+1)/(hb+1) of bytes_per_pass().

#include "sym_band_packed.cuh"

// upper (K, nb, hb+2, B, B/2) int8, scales (K, nb, hb+2, B) f32, x
// (K, S, nb*B) bf16 as raw 16-bit words, y (K, S, nb*B) f32; all contiguous
// on the device. Launches on `stream`; returns cudaGetLastError() after the
// launch, or -1 for a block size or S the kernel is not built for.
extern "C" int sgv_sym_band_hybrid_matvec(const void* upper, const void* scales,
                                          const void* x, void* y, int K, int nb,
                                          int hb, int B, int S, void* stream) {
  return sgv_packed::matvec<true>(upper, scales, x, y, nullptr, K, nb, hb, B, S, stream);
}

// The spill form: upper and scales of one shard's nb block rows, x
// (K, S, (nb+hb)*B) with the halo, y (K, S, nb*B) and carry (K, S, hb*B) f32
// (sym_band_packed.cuh). Returns as above.
extern "C" int sgv_sym_band_hybrid_spill(const void* upper, const void* scales,
                                           const void* x, void* y, void* carry, int K,
                                           int nb, int hb, int B, int S, void* stream) {
  if (carry == nullptr) return -1;
  return sgv_packed::matvec<true>(upper, scales, x, y, carry, K, nb, hb, B, S, stream);
}
