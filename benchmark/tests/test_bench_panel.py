"""The panel made from the seed."""

import numpy as np
import pytest
import torch

from benchmark import panel


def dense(band):
    M, nd = band.shape
    bw = (nd - 1) // 2
    R = np.zeros((M, M))
    for d in range(-bw, bw + 1):
        i = np.arange(max(0, -d), min(M, M - d))
        R[i, i + d] = band[i, bw + d]
    return R


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 17, 12345678901])
def test_band_is_symmetric_unit_diagonal_positive_definite(seed):
    p = panel.make_panel(1024, 256, 300000, 0.7, 0.01, 2, 0.6, 0.85, seed, "cpu")
    R = dense(p.band.double().numpy())
    assert np.array_equal(R, R.T)
    assert np.allclose(np.diag(R), 1.0, atol=1e-6)
    assert np.linalg.eigvalsh(R)[0] > 0.1
    assert p.r.shape == (2, 1024) and p.r.dtype == torch.float32
    assert int((p.x0 != 0).sum()) == 10


def test_the_seed_decides_the_panel():
    a = panel.make_panel(512, 64, 1000, 0.5, 0.05, 1, 0.6, 0.85, 7, "cpu")
    b = panel.make_panel(512, 64, 1000, 0.5, 0.05, 1, 0.6, 0.85, 7, "cpu")
    c = panel.make_panel(512, 64, 1000, 0.5, 0.05, 1, 0.6, 0.85, 8, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.band, c.band)


def test_traits_follow_the_panel():
    # r = R x0 + eps with Var(eps) = (1 - h2) R: the signal's share of r
    p = panel.make_panel(4096, 128, 300000, 0.7, 0.01, 1, 0.6, 0.85, 3, "cpu")
    R = dense(p.band.double().numpy())
    signal = R @ p.x0.numpy()
    noise = p.r[0].double().numpy() - signal
    assert abs(np.var(noise) / (1 - 0.7) - 1) < 0.1


def test_probes_are_rademacher():
    u = panel.probes(3, 4, 2, 256, 5, "cpu")
    assert u.shape == (3, 4, 2, 256) and u.dtype == torch.int8
    assert set(u.unique().tolist()) == {-1, 1}
