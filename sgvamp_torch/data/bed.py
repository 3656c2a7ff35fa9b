"""Minimal PLINK1 .bed reader/writer (SNP-major, 2-bit genotypes), numpy only.

A copy of sgvamp_tpu/data/bed.py: the real-genotype phenotype simulator
(data/simulate.py::simulate_from_bed) reads its genotypes through it when
the optional bed_reader package is not installed (identical values by
construction). The same arrays write the same three files in both
packages, and the errors carry the same messages.

Format (https://www.cog-genomics.org/plink/1.9/formats#bed):
  3 magic bytes 0x6c 0x1b 0x01 (SNP-major), then for each of the M
  variants ceil(N/4) bytes; sample i of a byte-block of 4 occupies bits
  [2*(i%4), 2*(i%4)+1] with codes
    00 = homozygous A1,  01 = missing,  10 = heterozygous,  11 = hom A2.

Values follow bed_reader's default orientation: the COUNT OF A1 ALLELES
(00 -> 2.0, 10 -> 1.0, 11 -> 0.0, 01 -> NaN). N and M come from the
companion .fam/.bim files, exactly as bed_reader derives them.
"""

from __future__ import annotations

import os

import numpy as np

MAGIC = b"\x6c\x1b\x01"

# 2-bit code -> A1 allele count (index by code)
_CODE_TO_COUNT = np.asarray([2.0, np.nan, 1.0, 0.0])
_COUNT_TO_CODE = {2.0: 0, 1.0: 2, 0.0: 3}


def _companion_counts(bed_path: str) -> tuple[int, int]:
    base = bed_path[:-4] if bed_path.endswith(".bed") else bed_path
    try:
        with open(base + ".fam") as f:
            N = sum(1 for line in f if line.strip())
        with open(base + ".bim") as f:
            M = sum(1 for line in f if line.strip())
    except FileNotFoundError as e:
        raise FileNotFoundError(
            f"{bed_path}: companion .fam/.bim files are required to size "
            f"the genotype matrix (PLINK triples travel together)") from e
    return N, M


def read_bed(bed_path: str) -> np.ndarray:
    """Read a PLINK1 triple into an (N, M) float64 array of A1 counts.

    Missing genotypes (code 01) come back as NaN, matching bed_reader.
    """
    if not bed_path.endswith(".bed"):
        bed_path = bed_path + ".bed"
    N, M = _companion_counts(bed_path)
    raw = np.fromfile(bed_path, dtype=np.uint8)
    if raw[:3].tobytes() != MAGIC:
        raise ValueError(
            f"{bed_path}: bad magic {raw[:3].tobytes()!r} (expect PLINK1 "
            f"SNP-major {MAGIC!r})")
    bpv = (N + 3) // 4  # bytes per variant
    body = raw[3:]
    if body.size != M * bpv:
        raise ValueError(
            f"{bed_path}: {body.size} genotype bytes, expected {M}x{bpv} "
            f"for N={N}, M={M}")
    body = body.reshape(M, bpv)
    # unpack 2-bit codes: sample i of each 4-block sits at bits 2*(i%4)
    codes = np.stack([(body >> shift) & 0b11 for shift in (0, 2, 4, 6)],
                     axis=2).reshape(M, bpv * 4)[:, :N]
    return _CODE_TO_COUNT[codes].T.copy()  # (N, M)


def write_bed(bed_path: str, genotypes: np.ndarray) -> None:
    """Write an (N, M) array of A1 counts {0, 1, 2, NaN} as a PLINK1
    triple (.bed + minimal valid .fam/.bim companions)."""
    if not bed_path.endswith(".bed"):
        bed_path = bed_path + ".bed"
    G = np.asarray(genotypes, np.float64)
    N, M = G.shape
    codes = np.full((M, N), 1, np.uint8)  # missing
    for val, code in _COUNT_TO_CODE.items():
        codes[G.T == val] = code
    bpv = (N + 3) // 4
    padded = np.zeros((M, bpv * 4), np.uint8)
    padded[:, :N] = codes
    packed = (padded[:, 0::4]
              | (padded[:, 1::4] << 2)
              | (padded[:, 2::4] << 4)
              | (padded[:, 3::4] << 6)).astype(np.uint8)
    with open(bed_path, "wb") as f:
        f.write(MAGIC)
        f.write(packed.tobytes())
    base = bed_path[:-4]
    with open(base + ".fam", "w") as f:
        for i in range(N):
            f.write(f"fam{i} ind{i} 0 0 0 -9\n")
    with open(base + ".bim", "w") as f:
        for j in range(M):
            f.write(f"1\tsnp{j}\t0\t{j + 1}\tA\tC\n")


def _exists(bed_path: str) -> bool:
    p = bed_path if bed_path.endswith(".bed") else bed_path + ".bed"
    return os.path.exists(p)
