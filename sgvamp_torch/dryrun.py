"""One VAMP step over a mesh of n cells for every LD operator, held against
the unsharded step (PyTorch port of __graft_entry__.py::dryrun_multichip).

    python -m sgvamp_torch.dryrun 8                   # on the visible cards
    python -m sgvamp_torch.dryrun 8 --platform cpu    # on the CPU

The mesh is built through parallel/multihost.py::make_multihost_mesh (with
one process, the local grid), its cells taken round-robin over the visible
cards, or all the CPU with --platform cpu: where there are fewer devices
than cells, a device runs its cells one after another, so one card (or the
CPU) runs the sharded matvecs - the sym operators' CUDA spill kernels on a
card - their padding and the order of their partial sums as a mesh of
n_devices cards would.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

OPERATORS = ("banded", "sym", "sym_int8", "sym_int4", "sym_hybrid", "blocksparse")


def make_problem(M: int, K: int, bandwidth: int, block_size: int, operator: str,
                 device=None):
    """(inputs, cfg, prior) of a small float32 banded panel under
    `operator`, on `device` (None: the default CUDA device), as the JAX
    package's dry run makes it."""
    import scipy.sparse

    from sgvamp_torch import resolve_device
    from sgvamp_torch.config import VampConfig
    from sgvamp_torch.core.operators import BandedLD, BlockSparseLD
    from sgvamp_torch.core.prior import PriorState
    from sgvamp_torch.core.vamp import VampInputs
    from sgvamp_torch.data.simulate import simulate_ld_band
    from sgvamp_torch.ops.band_kernel import SymBandedLD

    rng = np.random.default_rng(0)
    device, dt = resolve_device(device), torch.float32
    N, lam, h2 = 50000, 0.05, 0.7
    band, r, _ = simulate_ld_band(N, M, bandwidth, h2=h2, lam=lam, rng=rng, dtype=np.float32)
    if operator.startswith("sym"):
        quant = {"sym": None, "sym_int8": "int8", "sym_int4": "int4", "sym_hybrid": "hybrid"}
        op = SymBandedLD.from_band(band, block_size=block_size, K=K, dtype=quant[operator],
                                   device=device)
    elif operator == "blocksparse":
        dense = BandedLD.from_band(band, block_size=block_size, device="cpu").to_dense()[0]
        R = scipy.sparse.csr_matrix(dense.numpy())
        op = BlockSparseLD.from_csr([R] * K, block_size=block_size, device=device)
    else:
        op = BandedLD.from_band(band, block_size=block_size, K=K, device=device)
    Mp = op.M
    mask = np.zeros(Mp, np.float32)
    mask[:M] = 1.0
    rp = np.zeros((K, Mp), np.float32)
    rp[:, :M] = r
    cm = max(int(M * lam), 1)
    cfg = VampConfig(prior_update="em", dtype="float32", cg_maxit=10, em_prior_maxit=3, rho=0.5,
                     lmmse_damp=True)
    prior = PriorState.create(lam, [1.0], [h2 / cm * float(K * N)], device=device)
    inputs = VampInputs(
        op=op,
        r=torch.as_tensor(rp, dtype=dt, device=device),
        a=torch.full((K,), 1.0 / K, dtype=dt, device=device),
        N=torch.full((K,), float(N), dtype=dt, device=device),
        mask=torch.as_tensor(mask, dtype=dt, device=device),
    )
    return inputs, cfg, prior


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> None:
    """Two VAMP steps over a (cohort, shard) mesh of n_devices cells for
    each of the six operators, against the same steps unsharded (the same
    seed, so the same probes): a wrong cut or a wrong sum of the partial
    results shows as a mismatch. Raises AssertionError on one.

    devices: the devices the cells are taken from, round-robin (None: the
    visible cards; ["cpu"] for the CPU). The problem lies on the first."""
    from sgvamp_torch import default_device
    from sgvamp_torch.core.vamp import VampEngine, vamp_step
    from sgvamp_torch.parallel.multihost import make_multihost_mesh

    if devices is None:
        default_device()   # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    cells = [torch.device(devices[i % len(devices)]) for i in range(n_devices)]
    n_cohort = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_shard = n_devices // n_cohort
    mesh = make_multihost_mesh(n_cohort, devices=cells)
    assert mesh.shape == {"cohort": n_cohort, "shard": n_shard}, mesh.shape
    block_size = 128
    M = block_size * n_shard * 2
    for operator in OPERATORS:
        inputs, cfg, prior = make_problem(M, n_cohort, 64, block_size, operator,
                                          device=cells[0])
        results = []
        for m in (mesh, None):
            engine = VampEngine(inputs, cfg, prior, gamw=5.0, gam1=1e-6, mesh=m)
            if operator.startswith("sym") and n_shard > 1 and m is not None:
                assert engine.inputs.op.mesh is not None, (
                    "shard_inputs must pin the mesh on SymBandedLD")
            state = engine.init_state(0)
            for _ in range(2):
                state, _ = vamp_step(state, engine.inputs, cfg, None)
            assert state.it == 2
            results.append(state)
        sharded, unsharded = results
        # gam1 = gam2 (1 - alpha2) / alpha2 scales alpha2's rounding by about
        # 1 / alpha2, so it has the looser bound, as in the JAX package
        loose = 10.0 if operator in ("sym_int8", "sym_int4", "sym_hybrid") else 1.0
        for name, tol in (("xhat1", 1e-4 * loose), ("alpha2", 1e-4 * loose),
                          ("gamw", 1e-4 * loose), ("gam1", 1e-2 * loose)):
            a = getattr(sharded, name).double().cpu()
            b = getattr(unsharded, name).double().cpu()
            scale = float(torch.linalg.norm(b)) + 1e-30
            err = float(torch.linalg.norm(a - b)) / scale
            assert torch.isfinite(a).all() and err <= tol, (
                f"[{operator}] sharded/unsharded mismatch on {name}: {err:.3e} relative")
        print(f"dryrun_multichip: operator={operator} mesh={mesh.shape} "
              f"device={cells[0].type} parity ok", flush=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_devices", type=int, nargs="?", default=8)
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the visible cards, the default) or cpu")
    a = p.parse_args()
    dryrun_multichip(a.n_devices, devices=["cpu"] if a.platform == "cpu" else None)
