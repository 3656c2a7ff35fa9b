// PLINK .ld parser, band assembler and block packers for sgvamp_torch
// (host code, single-threaded; the port's own copy of the JAX package's
// native/ldparse.cpp, kept bit for bit in what it computes).
//
// A .ld table is streamed once: each line's SNP names are resolved against
// the harmonized variant index with one hash map, and the (a, b, r)
// triplets are kept in three arrays. The CSR -> band pass and the int8 and
// hybrid packers each walk their input once, in row order; their output is
// bit-identical to the numpy versions in data/loaders.py and
// ops/band_kernel.py (pack_int8, pack_hybrid).
//
// C ABI (ctypes-friendly):
//   ldparse_parse(path, variants_blob, n_variants) -> handle (NULL on OOM)
//   ldparse_error(handle)  -> error string or NULL
//   ldparse_count(handle)  -> number of parsed (a, b, r) triplets
//   ldparse_copy(handle, a, b, v) -> copy out triplets (caller allocates)
//   ldparse_free(handle)
//   ldparse_max_bandwidth(n, a, b) -> max |a-b|
//   ldparse_to_band(n, a, b, v, M, bw, band) -> dropped-entry count;
//       band is float32 (M, 2*bw+1), diagonal preset to 1 by this call.
//       A pair given twice is last-write-wins (triplets_to_csr sums it).
//   ldparse_csr_to_band_{i32,i64}_{f32,f64}, ldparse_csr_max_bw_{i32,i64}
//   ldparse_band_pack_i8, ldparse_band_pack_hybrid

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Result {
  std::vector<int64_t> a, b;
  std::vector<double> v;
  std::string err;
};

// Split a line into whitespace-separated tokens (in place, no copies).
inline int tokenize(char* line, char** toks, int max_toks) {
  int n = 0;
  char* p = line;
  while (*p && n < max_toks) {
    while (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n') ++p;
    if (!*p) break;
    toks[n++] = p;
    while (*p && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n') ++p;
    if (*p) *p++ = '\0';
  }
  return n;
}

template <typename T>
int64_t to_band_impl(int64_t n, const int64_t* a, const int64_t* b,
                     const double* v, int64_t M, int64_t bw, T* band) {
  const int64_t nd = 2 * bw + 1;
  // unit diagonal (the CSR assembly adds ones(M) as well)
  for (int64_t i = 0; i < M; ++i) band[i * nd + bw] = T(1);
  int64_t dropped = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r0 = a[i], c0 = b[i];
    int64_t d = c0 - r0;
    if (d > bw || d < -bw) {
      ++dropped;
      continue;
    }
    T val = static_cast<T>(v[i]);
    band[r0 * nd + (bw + d)] = val;       // R[r0, c0]
    band[c0 * nd + (bw - d)] = val;       // symmetric mirror
  }
  return dropped;
}

}  // namespace

extern "C" {

void* ldparse_parse(const char* path, const char* variants_blob,
                    int64_t n_variants) {
  auto* res = new (std::nothrow) Result();
  if (!res) return nullptr;

  // Build the variant -> reference-index map over the '\n'-separated blob.
  std::unordered_map<std::string_view, int64_t> index;
  index.reserve(static_cast<size_t>(n_variants) * 2);
  {
    const char* p = variants_blob;
    for (int64_t i = 0; i < n_variants; ++i) {
      const char* q = strchr(p, '\n');
      size_t len = q ? static_cast<size_t>(q - p) : strlen(p);
      index.emplace(std::string_view(p, len), i);
      if (!q) break;
      p = q + 1;
    }
  }

  FILE* f = fopen(path, "rb");
  if (!f) {
    res->err = std::string("cannot open ") + path;
    return res;
  }

  char buf[1 << 16];
  char* toks[64];
  int col_a = -1, col_b = -1, col_r = -1;

  // Header: locate SNP_A, SNP_B, R columns.
  if (fgets(buf, sizeof(buf), f)) {
    int n = tokenize(buf, toks, 64);
    for (int i = 0; i < n; ++i) {
      if (!strcmp(toks[i], "SNP_A")) col_a = i;
      else if (!strcmp(toks[i], "SNP_B")) col_b = i;
      else if (!strcmp(toks[i], "R")) col_r = i;
    }
  }
  if (col_a < 0 || col_b < 0 || col_r < 0) {
    res->err = "missing SNP_A/SNP_B/R columns in .ld header";
    fclose(f);
    return res;
  }
  int need = (col_a > col_b ? col_a : col_b) > col_r
                 ? (col_a > col_b ? col_a : col_b)
                 : col_r;

  int64_t lineno = 1;
  while (fgets(buf, sizeof(buf), f)) {
    ++lineno;
    int n = tokenize(buf, toks, 64);
    if (n == 0) continue;  // blank line
    if (n <= need) {
      res->err = "short line " + std::to_string(lineno);
      break;
    }
    auto ia = index.find(std::string_view(toks[col_a]));
    auto ib = index.find(std::string_view(toks[col_b]));
    if (ia == index.end() || ib == index.end()) {
      res->err = "unknown SNP on line " + std::to_string(lineno);
      break;
    }
    res->a.push_back(ia->second);
    res->b.push_back(ib->second);
    res->v.push_back(strtod(toks[col_r], nullptr));
  }
  fclose(f);
  return res;
}

const char* ldparse_error(void* h) {
  auto* res = static_cast<Result*>(h);
  return res->err.empty() ? nullptr : res->err.c_str();
}

int64_t ldparse_count(void* h) {
  return static_cast<int64_t>(static_cast<Result*>(h)->a.size());
}

void ldparse_copy(void* h, int64_t* a, int64_t* b, double* v) {
  auto* res = static_cast<Result*>(h);
  size_t n = res->a.size();
  memcpy(a, res->a.data(), n * sizeof(int64_t));
  memcpy(b, res->b.data(), n * sizeof(int64_t));
  memcpy(v, res->v.data(), n * sizeof(double));
}

void ldparse_free(void* h) { delete static_cast<Result*>(h); }

int64_t ldparse_max_bandwidth(int64_t n, const int64_t* a, const int64_t* b) {
  int64_t bw = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t d = a[i] > b[i] ? a[i] - b[i] : b[i] - a[i];
    if (d > bw) bw = d;
  }
  return bw;
}

int64_t ldparse_to_band(int64_t n, const int64_t* a, const int64_t* b,
                        const double* v, int64_t M, int64_t bw, float* band) {
  return to_band_impl(n, a, b, v, M, bw, band);
}

int64_t ldparse_to_band_f64(int64_t n, const int64_t* a, const int64_t* b,
                            const double* v, int64_t M, int64_t bw,
                            double* band) {
  return to_band_impl(n, a, b, v, M, bw, band);
}

}  // extern "C"

// -- direct CSR -> symmetric band (data/loaders.csr_to_band's native path) -
//
// One row-ordered pass over indptr/indices writes the band rows in order,
// where the numpy path expands the rows and scatters every entry. The
// diagonal comes from the matrix itself (the numpy path's contract).
// Returns the dropped-entry count (|col - row| > bw).

namespace {

template <typename I, typename V>
int64_t csr_to_band_impl(int64_t M, const I* indptr, const I* indices,
                         const V* data, int64_t bw, float* band) {
  const int64_t W = 2 * bw + 1;
  int64_t dropped = 0;
  for (int64_t i = 0; i < M; ++i) {
    float* row = band + i * W;
    const int64_t k1 = static_cast<int64_t>(indptr[i + 1]);
    for (int64_t k = static_cast<int64_t>(indptr[i]); k < k1; ++k) {
      const int64_t d = static_cast<int64_t>(indices[k]) - i;
      if (d < -bw || d > bw) {
        ++dropped;
        continue;
      }
      row[bw + d] = static_cast<float>(data[k]);
    }
  }
  return dropped;
}

template <typename I>
int64_t csr_max_bw_impl(int64_t M, const I* indptr, const I* indices) {
  int64_t bw = 0;
  for (int64_t i = 0; i < M; ++i) {
    const int64_t k1 = static_cast<int64_t>(indptr[i + 1]);
    for (int64_t k = static_cast<int64_t>(indptr[i]); k < k1; ++k) {
      const int64_t d = static_cast<int64_t>(indices[k]) - i;
      const int64_t ad = d < 0 ? -d : d;
      if (ad > bw) bw = ad;
    }
  }
  return bw;
}

}  // namespace

extern "C" {

int64_t ldparse_csr_to_band_i32_f32(int64_t M, const int32_t* indptr,
                                    const int32_t* indices, const float* data,
                                    int64_t bw, float* band) {
  return csr_to_band_impl(M, indptr, indices, data, bw, band);
}

int64_t ldparse_csr_to_band_i32_f64(int64_t M, const int32_t* indptr,
                                    const int32_t* indices, const double* data,
                                    int64_t bw, float* band) {
  return csr_to_band_impl(M, indptr, indices, data, bw, band);
}

int64_t ldparse_csr_to_band_i64_f32(int64_t M, const int64_t* indptr,
                                    const int64_t* indices, const float* data,
                                    int64_t bw, float* band) {
  return csr_to_band_impl(M, indptr, indices, data, bw, band);
}

int64_t ldparse_csr_to_band_i64_f64(int64_t M, const int64_t* indptr,
                                    const int64_t* indices, const double* data,
                                    int64_t bw, float* band) {
  return csr_to_band_impl(M, indptr, indices, data, bw, band);
}

int64_t ldparse_csr_max_bw_i32(int64_t M, const int32_t* indptr,
                               const int32_t* indices) {
  return csr_max_bw_impl(M, indptr, indices);
}

int64_t ldparse_csr_max_bw_i64(int64_t M, const int64_t* indptr,
                               const int64_t* indices) {
  return csr_max_bw_impl(M, indptr, indices);
}

// -- band -> upper-triangle int8 blocks (SymBandedLD.from_band's native path)
//
// One pass builds the (nb, hb+1, B, B) upper blocks from float32 band
// storage and quantizes them symmetrically per block (q = rint(v/scale),
// scale = max|v|/127), bit-identical to ops/band_kernel.pack_int8: the
// float32 divide and round-half-even match np.rint elementwise, and
// abs-max is order-independent. Rows past M_orig are the pad rows (unit
// diagonal); columns past the band are zero; blocks whose column index
// runs past the matrix (d >= 1, i >= nb - d) stay exactly zero with
// scale 0 - the invariants pack_blocks enforces. It reads the band once
// and writes int8 and scales, where the numpy version makes float32
// temporaries of the whole block array.

void ldparse_band_pack_i8(const float* band, int64_t M_orig, int64_t nd,
                          int64_t B, int64_t nb, int64_t hb, int8_t* upper,
                          float* scales) {
  const int64_t bw = (nd - 1) / 2;
  std::vector<float> blk(static_cast<size_t>(B) * B);
  for (int64_t i = 0; i < nb; ++i) {
    for (int64_t d = 0; d <= hb; ++d) {
      int8_t* out = upper + ((i * (hb + 1) + d) * B * B);
      float* sc_out = scales + (i * (hb + 1) + d);
      if (d >= 1 && i >= nb - d) {  // past-matrix block: exact zeros
        memset(out, 0, static_cast<size_t>(B) * B);
        *sc_out = 0.0f;
        continue;
      }
      float amax = 0.0f;
      for (int64_t p = 0; p < B; ++p) {
        const int64_t row = i * B + p;
        float* dst = blk.data() + p * B;
        if (row >= M_orig) {  // pad row: unit diagonal only
          memset(dst, 0, static_cast<size_t>(B) * sizeof(float));
          if (d == 0) {
            dst[p] = 1.0f;
            if (1.0f > amax) amax = 1.0f;
          }
          continue;
        }
        const float* brow = band + row * nd;
        const int64_t base = bw + d * B - p;  // col offset for q = 0
        const int64_t q0 = base < 0 ? -base : 0;
        const int64_t q1 = base + B > nd ? nd - base : B;
        for (int64_t q = 0; q < q0; ++q) dst[q] = 0.0f;
        for (int64_t q = q0; q < q1; ++q) {
          const float v = brow[base + q];
          dst[q] = v;
          const float a = v < 0 ? -v : v;
          if (a > amax) amax = a;
        }
        for (int64_t q = q1 < 0 ? 0 : q1; q < B; ++q) dst[q] = 0.0f;
      }
      const float sc = amax / 127.0f;
      *sc_out = sc;
      if (sc == 0.0f) {
        memset(out, 0, static_cast<size_t>(B) * B);
        continue;
      }
      for (int64_t k = 0; k < B * B; ++k) {
        float q = nearbyintf(blk[k] / sc);
        if (q > 127.0f) q = 127.0f;
        if (q < -127.0f) q = -127.0f;
        out[k] = static_cast<int8_t>(q);
      }
    }
  }
}

// -- band -> hybrid int8/int4 blocks (SymBandedLD.from_band dtype="hybrid")
//
// Same one-pass structure as ldparse_band_pack_i8, but producing the
// hybrid layout: upper is (nb, hb+2, B, B/2) int8 where slots 0,1 hold
// the d=0 block's PER-ROW int8 column halves (unit diagonal stripped
// first, scale = rowmax/127) and slot d+1 holds far diagonal d >= 1
// packed int4 (per-row scale = rowmax/7, low nibble = column j, high
// nibble = column j + B/2). scales is (nb, hb+2, B) float32 with slots
// 0 and 1 sharing the d=0 row scales. Bit-identical to the numpy path
// (rint = round-half-even, per-row abs-max, identical pad/edge
// invariants); the tests assert exact equality of the packed bytes
// and scales.

void ldparse_band_pack_hybrid(const float* band, int64_t M_orig, int64_t nd,
                              int64_t B, int64_t nb, int64_t hb,
                              int8_t* upper, float* scales) {
  const int64_t bw = (nd - 1) / 2;
  const int64_t Bh = B / 2;
  const int64_t nslot = hb + 2;
  std::vector<float> blk(static_cast<size_t>(B) * B);
  std::vector<float> rowmax(static_cast<size_t>(B));
  for (int64_t i = 0; i < nb; ++i) {
    for (int64_t d = 0; d <= hb; ++d) {
      const bool past = (d >= 1 && i >= nb - d);
      for (int64_t p = 0; p < B; ++p) {
        float* dst = blk.data() + p * B;
        float amax = 0.0f;
        const int64_t row = i * B + p;
        if (past || row >= M_orig) {
          // past-matrix block or pad row: zeros; a pad row's unit
          // diagonal in the d=0 block is stripped before quantization,
          // so it contributes nothing here either
          memset(dst, 0, static_cast<size_t>(B) * sizeof(float));
          rowmax[p] = 0.0f;
          continue;
        }
        const float* brow = band + row * nd;
        const int64_t base = bw + d * B - p;  // col offset for q = 0
        const int64_t q0 = base < 0 ? -base : 0;
        const int64_t q1 = base + B > nd ? nd - base : B;
        for (int64_t q = 0; q < q0; ++q) dst[q] = 0.0f;
        for (int64_t q = q0; q < q1; ++q) dst[q] = brow[base + q];
        for (int64_t q = q1 < 0 ? 0 : q1; q < B; ++q) dst[q] = 0.0f;
        if (d == 0) dst[p] -= 1.0f;  // strip the unit diagonal
        for (int64_t q = 0; q < B; ++q) {
          const float a = dst[q] < 0 ? -dst[q] : dst[q];
          if (a > amax) amax = a;
        }
        rowmax[p] = amax;
      }
      if (d == 0) {
        // slots 0,1: int8 column halves, per-row scale = rowmax/127
        int8_t* out0 = upper + ((i * nslot + 0) * B * Bh);
        int8_t* out1 = upper + ((i * nslot + 1) * B * Bh);
        float* sc0 = scales + ((i * nslot + 0) * B);
        float* sc1 = scales + ((i * nslot + 1) * B);
        for (int64_t p = 0; p < B; ++p) {
          const float sc = rowmax[p] / 127.0f;
          sc0[p] = sc;
          sc1[p] = sc;
          const float* src = blk.data() + p * B;
          for (int64_t q = 0; q < Bh; ++q) {
            float v = sc == 0.0f ? 0.0f : nearbyintf(src[q] / sc);
            if (v > 127.0f) v = 127.0f;
            if (v < -127.0f) v = -127.0f;
            out0[p * Bh + q] = static_cast<int8_t>(v);
            float w = sc == 0.0f ? 0.0f : nearbyintf(src[Bh + q] / sc);
            if (w > 127.0f) w = 127.0f;
            if (w < -127.0f) w = -127.0f;
            out1[p * Bh + q] = static_cast<int8_t>(w);
          }
        }
      } else {
        // slot d+1: packed int4, per-row scale = rowmax/7
        int8_t* out = upper + ((i * nslot + d + 1) * B * Bh);
        float* sc_out = scales + ((i * nslot + d + 1) * B);
        for (int64_t p = 0; p < B; ++p) {
          const float sc = rowmax[p] / 7.0f;
          sc_out[p] = sc;
          const float* src = blk.data() + p * B;
          for (int64_t q = 0; q < Bh; ++q) {
            float lo = sc == 0.0f ? 0.0f : nearbyintf(src[q] / sc);
            if (lo > 7.0f) lo = 7.0f;
            if (lo < -7.0f) lo = -7.0f;
            float hi = sc == 0.0f ? 0.0f : nearbyintf(src[Bh + q] / sc);
            if (hi > 7.0f) hi = 7.0f;
            if (hi < -7.0f) hi = -7.0f;
            const uint8_t lo4 =
                static_cast<uint8_t>(static_cast<int8_t>(lo)) & 0xF;
            const uint8_t hi4 =
                static_cast<uint8_t>(static_cast<int8_t>(hi)) & 0xF;
            out[p * Bh + q] =
                static_cast<int8_t>(lo4 | static_cast<uint8_t>(hi4 << 4));
          }
        }
      }
    }
  }
}

}  // extern "C"
