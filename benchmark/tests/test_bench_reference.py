"""The plain reference against dense float64 computations at a small M, and
its int8 blocks against the port's packer."""

import numpy as np
import pytest
import torch

from benchmark import panel
from benchmark.reference import int8_band
from benchmark.reference import vamp as ref


def dense(band):
    M, nd = band.shape
    bw = (nd - 1) // 2
    R = np.zeros((M, M))
    for d in range(-bw, bw + 1):
        i = np.arange(max(0, -d), min(M, M - d))
        R[i, i + d] = band[i, bw + d]
    return R


def dequantized_dense(q, scale):
    nb, nd1, B, _ = q.shape
    R = np.zeros((nb * B, nb * B))
    blocks = q.double().numpy() * scale.double().numpy()[..., None, None]
    for i in range(nb):
        for d in range(nd1):
            if i + d < nb:
                U = blocks[i, d]
                R[i * B:(i + 1) * B, (i + d) * B:(i + d + 1) * B] = U
                if d:
                    R[(i + d) * B:(i + d + 1) * B, i * B:(i + 1) * B] = U.T
    return R


@pytest.fixture(scope="module")
def small():
    return panel.make_panel(1024, 256, 300000, 0.7, 0.01, 2, 0.6, 0.85, 11, "cpu")


def test_int8_blocks_equal_the_ports_packer(small):
    from sgvamp_torch.ops.band_kernel import pack_int8

    q, scale = int8_band.int8_blocks(small.band, 128)
    q_port, s_port = pack_int8(small.band.numpy(), 128)
    assert np.array_equal(q.numpy(), q_port) and np.array_equal(scale.numpy(), s_port)


def test_int8_band_is_the_panel_within_its_rounding(small):
    q, scale = int8_band.int8_blocks(small.band, 128)
    Rq = dequantized_dense(q, scale)
    R = dense(small.band.double().numpy())
    step = np.repeat(np.repeat(scale.double().numpy().max(axis=1), 128), 1)
    assert np.abs(Rq - R).max() <= 0.5 * step.max() * (1 + 1e-6)
    assert np.array_equal(Rq, Rq.T)


def test_matvec_against_dense_float64(small):
    op = int8_band.Int8Band(small.band, 128, torch.float64)
    q, scale = int8_band.int8_blocks(small.band, 128)
    Rq = dequantized_dense(q, scale)
    x = torch.randn(4, 1024, dtype=torch.float64)
    lanes = x.to(torch.bfloat16).double().numpy()
    y = op.matvec(x).numpy()
    assert np.abs(y - lanes @ Rq.T).max() <= 1e-12 * np.abs(y).max()


def test_forced_cg_solves_the_dense_system(small):
    q, scale = int8_band.int8_blocks(small.band, 128)
    Rq = dequantized_dense(q, scale)
    g = torch.tensor([[3.0], [0.5]], dtype=torch.float64)
    b = torch.randn(2, 1024, dtype=torch.float64)
    A = [g[k, 0].item() * Rq + 1.0 * np.eye(1024) for k in range(2)]
    settings = ref.Settings(rho=0.5, em_maxit=5, em_tol=1e-6, cg_maxit=60, cg_force=True,
                            cg_rtol=1e-5)
    # the dense float64 product, without the operator's bfloat16 lanes
    dense_op = torch.from_numpy(Rq)
    x = ref._cg(lambda v: g * (v @ dense_op.T) + v, b, torch.zeros_like(b), settings)
    for k in range(2):
        want = np.linalg.solve(A[k], b[k].numpy())
        assert np.abs(x[k].numpy() - want).max() <= 1e-9 * np.abs(want).max()


def test_fit_in_float64_and_float32_agree_to_the_lane_rounding(small):
    op64 = int8_band.Int8Band(small.band, 128, torch.float64)
    op32 = int8_band.Int8Band(small.band, 128, torch.float32)
    u = panel.probes(1, 4, 2, 1024, 11, "cpu")[0]
    settings = ref.Settings(rho=0.5, em_maxit=5, em_tol=1e-6, cg_maxit=40, cg_force=True,
                            cg_rtol=1e-5)
    args = (small.r, torch.full((2,), 0.5), torch.full((2,), 3e5), 0.01,
            torch.tensor([1.0]), torch.tensor([0.7 / 10 * 3e5]), 5.0, 1e-6, u, settings)
    x64 = ref.fit(op64, *args, torch.float64)
    x32 = ref.fit(op32, *args, torch.float32).double()
    assert torch.isfinite(x64).all()
    assert float(torch.linalg.norm(x32 - x64) / torch.linalg.norm(x64)) < 1e-2
