"""Dense LD operator (PyTorch port of sgvamp_tpu/core/operators.py::DenseLD).

Every operator has the batched matvec contract x (S*K, M) -> (S*K, M):
row s*K + k is multiplied by cohort k's matrix, so one pass over the
matrix serves S right-hand sides. The (1-s) R + s I regularization is
folded into the matvec. The banded operator that the main path runs is
ops/band_kernel.py::SymBandedLD.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor


def _regularize(y: Tensor, x: Tensor, s: float) -> Tensor:
    # Rused @ x = (1-s) * (R @ x) + s * x
    if s == 0.0:
        return y
    return (1.0 - s) * y + s * x


@dataclasses.dataclass(frozen=True)
class DenseLD:
    """Dense stacked LD operator: mats (K, M, M), one matrix per cohort."""

    mats: Tensor
    s: float = 0.0

    @property
    def K(self) -> int:
        return self.mats.shape[0]

    @property
    def M(self) -> int:
        return self.mats.shape[-1]

    def bytes_per_pass(self) -> int:
        """Bytes of LD data read by one matvec (roofline accounting)."""
        return self.mats.numel() * self.mats.element_size()

    def matvec(self, x: Tensor) -> Tensor:
        S = x.shape[0] // self.K
        xs = x.reshape(S, self.K, self.M).to(self.mats.dtype)
        y = torch.einsum("kij,skj->ski", self.mats, xs)
        return _regularize(y.reshape(x.shape).to(x.dtype), x, self.s)

    def diag_blocks(self, block_size: int = 0) -> Tensor:
        """(K, nb, B, B) f32 regularized diagonal blocks of Rused (for the
        block-Jacobi preconditioner, core/precond.py). Default block: the
        largest divisor of M at most 256."""
        B = block_size or max(b for b in range(1, min(256, self.M) + 1)
                              if self.M % b == 0)
        if self.M % B:
            raise ValueError(f"M={self.M} not a multiple of block {B}")
        nb = self.M // B
        Dv = self.mats.reshape(self.K, nb, B, nb, B)
        D = torch.diagonal(Dv, dim1=1, dim2=3).movedim(-1, 1).float()
        if self.s != 0.0:
            eye = torch.eye(B, dtype=D.dtype, device=D.device)
            D = (1.0 - self.s) * D + self.s * eye
        return D
