"""Mesh construction and operator placement for a sharded run inside one
process (PyTorch port of sgvamp_tpu/parallel/sharding.py).

The mesh has the JAX package's two named axes:

  * "cohort" - the K cohorts are divided over it;
  * "shard"  - the marker axis M: the LD operator is cut by block rows, so
    that no device holds a whole cohort's LD matrix.

JAX places arrays on a Mesh and XLA inserts the collectives. PyTorch has no
such thing inside one process, so this module is explicit: a Mesh is a
(n_cohort, n_shard) grid of torch.devices, one process drives every cell of
it, and a device may stand in more than one cell (one card, or the CPU, can
run every shard in turn: the sharded code path with nothing left out).

What the mesh divides is the OPERATOR: shard_inputs cuts its blocks into one
contiguous piece per cell, on that cell's device. The (K, M) vectors, the
prior and the preconditioner's factors stay whole on the mesh's first
device, so every reduction of the VAMP step runs there unchanged; a sharded
matvec sends each cell the slice of x it needs and gathers y.

A mesh made by parallel/multihost.py::make_multihost_mesh spans several
processes: its cohort axis runs across them, each process drives the cells
of its own rows (Mesh.local), and VampEngine exchanges what the step needs
across processes once a step (core/vamp.py).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

import numpy as np
import torch
from torch import Tensor

from sgvamp_torch import default_device
from sgvamp_torch.core.operators import (BandedLD, BlockSparseLD, DenseLD, LDOperator,
                                         _regularize, _regularize_diag, default_diag_block)
from sgvamp_torch.ops.band_kernel import SymBandedLD

COHORT_AXIS = "cohort"
SHARD_AXIS = "shard"

logger = logging.getLogger("sgvamp")


class Mesh:
    """A (n_cohort, n_shard) grid of torch.devices with the axis names
    (COHORT_AXIS, SHARD_AXIS). devices: the grid as a numpy object array;
    shape: {axis name: size}, as a JAX mesh has it.

    processes: None when one process drives every cell; else the size of
    the torch.distributed group whose processes divide the cohort axis,
    rank-major: process p drives rows p*R .. (p+1)*R - 1, R = n_cohort /
    processes (each process names the devices of its rows as it sees
    them), and `rank` is this process's."""

    axis_names = (COHORT_AXIS, SHARD_AXIS)

    def __init__(self, devices, processes: Optional[int] = None, rank: int = 0) -> None:
        grid = np.empty(np.shape(devices), dtype=object)
        if grid.ndim != 2:
            raise ValueError(f"a mesh is a 2-D grid of devices, got shape {grid.shape}")
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(devices[idx[0]][idx[1]])
        if processes is not None and grid.shape[0] % processes:
            raise ValueError(f"a cohort axis of {grid.shape[0]} rows does not divide over "
                             f"{processes} processes")
        self.devices = grid
        self.processes = processes
        self.rank = rank

    def row_process(self, row: int) -> int:
        """The process that drives the cells of cohort row `row`."""
        if self.processes is None:
            return 0
        return row // (self.devices.shape[0] // self.processes)

    def local(self) -> "Mesh":
        """The rows this process drives, as a mesh of one process."""
        if self.processes is None:
            return self
        rows = [r for r in range(self.devices.shape[0]) if self.row_process(r) == self.rank]
        return Mesh(self.devices[rows].tolist())

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """The device that holds what the mesh does not divide."""
        return self.devices[0, 0]


def make_mesh(n_cohort: int = 1, n_shard: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a (cohort, shard) mesh. devices None: the visible CUDA cards.
    n_shard None: the devices divided by the cohort axis. Where the mesh
    has more cells than there are devices, they are taken round-robin: a
    device then runs its cells one after another."""
    if devices is None:
        default_device()   # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_shard is None:
        if len(devices) % n_cohort:
            raise ValueError(
                f"{len(devices)} devices not divisible by cohort axis {n_cohort}"
            )
        n_shard = len(devices) // n_cohort
    n = n_cohort * n_shard
    cells = [devices[i % len(devices)] for i in range(n)]
    distinct = len(set(cells))
    if distinct < n:
        what = "card" if cells[0].type == "cuda" else "CPU device"
        logger.info(f"{n} mesh cells on {distinct} {what}{'s' if distinct > 1 else ''}: "
                    f"the cells of one device run one after another")
    return Mesh([cells[c * n_shard:(c + 1) * n_shard] for c in range(n_cohort)])


def _cut(t: Tensor, c: int, j: int, n_c: int, n: int, device, axis: int = 1) -> Tensor:
    """Cell (c, j)'s contiguous piece of t on `device`: cohorts (axis 0)
    divided n_c ways, `axis` divided n ways. A piece that is contiguous as
    it lies in t on the same device is a view of it, not a copy."""
    K_l = t.shape[0] // n_c
    piece = t[c * K_l:(c + 1) * K_l]
    if n > 1:
        w = t.shape[axis] // n
        piece = piece.narrow(axis, j * w, w)
    return piece.to(device).contiguous()


@dataclasses.dataclass(frozen=True)
class MeshLD(LDOperator):
    """An LD operator cut over a mesh, for every case but a SymBandedLD's
    shard axis (which SymBandedLD._matvec_sharded runs itself).

    cells[c][j] is the piece of mesh cell (c, j) on that cell's device:
      kind "cohort" (n_shard == 1, any operator): the operator of the
        cell's cohorts, whole along M, with its own s; the cell runs its
        ordinary matvec (a SymBandedLD its non-spill kernel);
      kind "dense": DenseLD rows, mats (K_l, M/n, M) - every cell gets the
        whole x;
      kind "banded": a BandedLD over the cell's block rows - every cell
        gets its x blocks and hb blocks of halo on both sides;
      kind "blocksparse": a BlockSparseLD over a contiguous range of the
        slots (the slot list padded to a multiple of n_shard with all-zero
        blocks at rows = cols = 0, as the JAX package pads it), its own
        rows and cols with it; every cell gets its cohorts' whole x and
        returns a partial y over all block rows, and the partial y's are
        added on the mesh's first device in cell order.
    For "dense", "banded" and "blocksparse" the pieces carry s = 0 and the s
    term is added once, to the gathered y. Same matvec contract as the other
    operators.
    """

    cells: tuple
    mesh: Mesh
    kind: str
    K: int
    M: int
    s: float = 0.0

    def bytes_per_pass(self) -> int:
        return sum(cell.bytes_per_pass() for row in self.cells for cell in row)

    def matvec(self, x: Tensor) -> Tensor:
        n_c, n = self.mesh.devices.shape
        K, M = self.K, self.M
        S = x.shape[0] // K
        K_l = K // n_c
        xs = x.reshape(S, K, M)
        rows = []
        for c in range(n_c):
            xc = xs[:, c * K_l:(c + 1) * K_l]
            if self.kind == "cohort":
                cell = self.cells[c][0]
                dev = self.mesh.devices[c, 0]
                y = cell.matvec(xc.reshape(S * K_l, M).to(dev)).reshape(S, K_l, M)
                rows.append(y.to(x.device))
                continue
            if self.kind == "blocksparse":
                nb, B = self.cells[c][0].nb, self.cells[c][0].B
                y = None
                for j in range(n):
                    cell, dev = self.cells[c][j], self.mesh.devices[c, j]
                    part = cell.apply(xc.reshape(S, K_l, nb, B).to(dev)).to(x.device)
                    y = part if y is None else y + part
                rows.append(y.reshape(S, K_l, M))
                continue
            if self.kind == "banded":
                nb_l, hb, B = (getattr(self.cells[c][0], f) for f in ("nb", "hb", "B"))
                # zeros past the matrix's two ends, as BandedLD.matvec pads
                edge = xc.new_zeros(S, K_l, hb, B)
                xpad = torch.cat([edge, xc.reshape(S, K_l, n * nb_l, B), edge], dim=2)
            parts = []
            for j in range(n):
                cell, dev = self.cells[c][j], self.mesh.devices[c, j]
                if self.kind == "dense":
                    y = torch.einsum("kij,skj->ski", cell.mats, xc.to(dev, cell.mats.dtype))
                else:   # the cell's x blocks and hb blocks of halo on both sides
                    x_ext = xpad[:, :, j * nb_l:(j + 1) * nb_l + 2 * hb]
                    y = cell.apply_padded(x_ext.to(dev)).reshape(S, K_l, nb_l * B)
                parts.append(y.to(x.device))
            rows.append(torch.cat(parts, dim=2))
        y = torch.cat(rows, dim=1).reshape(x.shape).to(x.dtype)
        return y if self.kind == "cohort" else _regularize(y, x, self.s)

    def diag_blocks(self) -> Tensor:
        """(K, nb, B, B) f32 regularized diagonal blocks of Rused, from the
        pieces, on the mesh's first device."""
        dev = self.mesh.first
        n = self.mesh.devices.shape[1]
        rows = []
        for cells in self.cells:
            if self.kind == "cohort":
                rows.append(cells[0].diag_blocks().to(dev))
                continue
            if self.kind == "blocksparse":
                # the first nb slots with rows == cols over the whole slot
                # list, as BlockSparseLD.diag_blocks takes them (the
                # padding's rows = cols = 0 slots come last)
                w = cells[0].nnzb
                diag = torch.cat([(cell.rows == cell.cols).cpu() for cell in cells])
                slots = torch.nonzero(diag).flatten()[:cells[0].nb]
                parts = [cell.blocks.index_select(
                    1, (slots[(slots >= j * w) & (slots < (j + 1) * w)] - j * w).to(
                        cell.blocks.device)).to(dev) for j, cell in enumerate(cells)]
                rows.append(_regularize_diag(torch.cat(parts, dim=1).float(), self.s))
                continue
            if self.kind == "dense":
                B = default_diag_block(self.M)   # as for the whole matrix
                M_l = self.M // n
                if M_l % B:
                    raise ValueError(f"diagonal blocks of {B} markers straddle the "
                                     f"{n}-way marker-shard axis (shard width {M_l})")
                parts = [DenseLD(mats=cell.mats[:, :, j * M_l:(j + 1) * M_l],
                                 s=self.s).diag_blocks(B) for j, cell in enumerate(cells)]
            else:
                parts = [dataclasses.replace(cell, s=self.s).diag_blocks() for cell in cells]
            rows.append(torch.cat([p.to(dev) for p in parts], dim=1))
        return torch.cat(rows, dim=0)


def cohort_slice(op, lo: int, hi: int):
    """The operator of cohorts lo .. hi-1 alone (views of its blocks)."""
    if isinstance(op, SymBandedLD):
        if op.mesh is not None:
            raise ValueError("cut the cohorts before the mesh cuts the operator")
        return dataclasses.replace(op, upper=op.upper[lo:hi],
                                   scales=None if op.scales is None else op.scales[lo:hi])
    if isinstance(op, (BandedLD, BlockSparseLD)):
        return dataclasses.replace(op, blocks=op.blocks[lo:hi])
    if isinstance(op, DenseLD):
        return dataclasses.replace(op, mats=op.mats[lo:hi])
    raise ValueError(f"no cohort slice for operator {type(op).__name__}")


def _shard_operator(op, mesh: Mesh):
    """The operator cut over the mesh: a SymBandedLD with the mesh pinned
    (n_shard > 1), else a MeshLD."""
    n_c, n = mesh.devices.shape
    if op.K % n_c:
        raise ValueError(f"{op.K} cohorts not divisible by the {n_c}-way cohort axis")
    grid = [[(c, j, mesh.devices[c, j]) for j in range(n)] for c in range(n_c)]

    if isinstance(op, SymBandedLD):
        if n > 1:
            if op.nb % n:
                raise ValueError(
                    f"sym operator: {op.nb} block rows not divisible by "
                    f"the {n}-way marker-shard axis")
            if op.nb // n < op.hb:
                raise ValueError(
                    f"sym operator: shard width {op.nb // n} block "
                    f"rows is narrower than the block half-bandwidth "
                    f"{op.hb} - halo/spill exchange only reaches one "
                    f"neighbor; use fewer shards, a wider block size, or the "
                    f"banded operator")

        def piece(c, j, dev):
            return dataclasses.replace(
                op, upper=_cut(op.upper, c, j, n_c, n, dev),
                scales=None if op.scales is None else _cut(op.scales, c, j, n_c, n, dev))

        pieces = tuple(tuple(piece(*cell) for cell in row) for row in grid)
        if n == 1:
            return MeshLD(cells=pieces, mesh=mesh, kind="cohort", K=op.K, M=op.M)
        # the whole operator's shape and dtype, without storage
        return dataclasses.replace(
            op, upper=op.upper.to("meta"),
            scales=None if op.scales is None else op.scales.to("meta"),
            mesh=mesh, shards=pieces)

    if isinstance(op, BandedLD):
        if op.nb % n:
            raise ValueError(f"banded operator: {op.nb} block rows not divisible by "
                             f"the {n}-way marker-shard axis")
        if n > 1 and op.nb // n < op.hb:
            raise ValueError(f"banded operator: shard width {op.nb // n} block rows is "
                             f"narrower than the block half-bandwidth {op.hb}")
        cells = tuple(tuple(dataclasses.replace(
            op, blocks=_cut(op.blocks, c, j, n_c, n, dev), s=op.s if n == 1 else 0.0)
            for c, j, dev in row) for row in grid)
    elif isinstance(op, BlockSparseLD):
        pad = (-op.nnzb) % n
        if pad:
            # all-zero blocks that add zeros into block row 0
            op = dataclasses.replace(
                op, blocks=torch.cat([op.blocks, op.blocks.new_zeros(
                    (op.K, pad, op.B, op.B))], dim=1),
                rows=torch.cat([op.rows, op.rows.new_zeros(pad)]),
                cols=torch.cat([op.cols, op.cols.new_zeros(pad)]))
        w = op.nnzb // n
        cells = tuple(tuple(dataclasses.replace(
            op, blocks=_cut(op.blocks, c, j, n_c, n, dev),
            rows=op.rows[j * w:(j + 1) * w].to(dev), cols=op.cols[j * w:(j + 1) * w].to(dev),
            s=op.s if n == 1 else 0.0)
            for c, j, dev in row) for row in grid)
    elif isinstance(op, DenseLD):
        if op.M % n:
            raise ValueError(f"dense operator: {op.M} markers not divisible by "
                             f"the {n}-way marker-shard axis")
        cells = tuple(tuple(dataclasses.replace(
            op, mats=_cut(op.mats, c, j, n_c, n, dev), s=op.s if n == 1 else 0.0)
            for c, j, dev in row) for row in grid)
    else:
        raise ValueError(f"no sharding for operator {type(op).__name__}")
    kind = ("cohort" if n == 1 else "banded" if isinstance(op, BandedLD)
            else "blocksparse" if isinstance(op, BlockSparseLD) else "dense")
    return MeshLD(cells=cells, mesh=mesh, kind=kind, K=op.K, M=op.M, s=op.s)


def _to_device(obj, device):
    """Every tensor of a (nested) dataclass moved to `device`."""
    if isinstance(obj, Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_device(getattr(obj, f.name), device) for f in dataclasses.fields(obj)})
    return obj


def shard_inputs(inputs, mesh: Mesh):
    """Place VampInputs on the mesh (see sgvamp_torch.core.vamp.VampInputs):
    the operator cut into one piece per cell (a SymBandedLD under a shard
    axis gets the mesh pinned, so that its matvec runs the spill kernels),
    everything else whole on the mesh's first device."""
    op = _shard_operator(inputs.op, mesh)
    rest = _to_device(dataclasses.replace(inputs, op=None), mesh.first)
    return dataclasses.replace(rest, op=op)


def shard_state(state, mesh: Mesh):
    """Place a VampState on the mesh: whole, on the mesh's first device
    (the mesh divides the operator, not the vectors)."""
    return _to_device(state, mesh.first)
