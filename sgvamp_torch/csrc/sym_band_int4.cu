// Symmetric block-banded matvec over int4 upper-triangle blocks (Hopper).
//
// Replaces sgvamp_tpu/ops/band_kernel.py::_sym_band_kernel_streamed, the
// packed4=True flavor (spill=False, and spill=True through the
// second entry point): two 4-bit values a byte as contiguous
// column halves, one f32 scale per block row, the unit diagonal of the d=0
// block stripped and x added back. The kernel, what it computes and its
// design (the gather; both products of every slot as mma.sync on the
// tensor cores, the nibbles decoded to bf16 without I2F) are in
// sym_band_packed.cuh. Bound: bytes from HBM (about 8*S operations a
// byte); the gather re-reads off-diagonal blocks, up to (2hb+1)/(hb+1) of
// bytes_per_pass().

#include "sym_band_packed.cuh"

// upper (K, nb, hb+1, B, B/2) int8, scales (K, nb, hb+1, B) f32, x
// (K, S, nb*B) bf16 as raw 16-bit words, y (K, S, nb*B) f32; all contiguous
// on the device. Launches on `stream`; returns cudaGetLastError() after the
// launch, or -1 for a block size or S the kernel is not built for.
extern "C" int sgv_sym_band_int4_matvec(const void* upper, const void* scales,
                                        const void* x, void* y, int K, int nb,
                                        int hb, int B, int S, void* stream) {
  return sgv_packed::matvec<false>(upper, scales, x, y, nullptr, K, nb, hb, B, S, stream);
}

// The spill form: upper and scales of one shard's nb block rows, x
// (K, S, (nb+hb)*B) with the halo, y (K, S, nb*B) and carry (K, S, hb*B) f32
// (sym_band_packed.cuh). Returns as above.
extern "C" int sgv_sym_band_int4_spill(const void* upper, const void* scales,
                                         const void* x, void* y, void* carry, int K,
                                         int nb, int hb, int B, int S, void* stream) {
  if (carry == nullptr) return -1;
  return sgv_packed::matvec<false>(upper, scales, x, y, carry, K, nb, hb, B, S, stream);
}
