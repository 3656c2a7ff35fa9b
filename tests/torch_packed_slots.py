"""int4 and hybrid slots for the tests of the packed band kernels, and the
per-element yardstick they are held to (numpy only: no jax, no CUDA)."""

import numpy as np


def packed_slots(B: int, hb: int, nb: int, K: int, hybrid: bool, seed: int) -> tuple:
    """int4 or hybrid (upper, scales) as numpy arrays in which every column
    of every slot, the first and the last of a row included, runs through
    all 256 byte values down its nb*B >= 256 rows: both nibbles take -8..7
    and the hybrid's int8 halves -128..127 in every position. Scales are
    log-uniform on 1e-4..1e2."""
    nslot = hb + (2 if hybrid else 1)
    n, sl, p, j = np.ix_(np.arange(nb), np.arange(nslot), np.arange(B), np.arange(B // 2))
    vals = (n * B + p + 97 * sl + 29 * j) % 256
    upper = np.broadcast_to(vals.astype(np.uint8).view(np.int8), (K, nb, nslot, B, B // 2))
    rng = np.random.default_rng(seed)
    scales = (10.0 ** rng.uniform(-4, 2, size=(K, nb, nslot, B))).astype(np.float32)
    return upper.copy(), scales


def term_magnitudes(upper, scales, x, hybrid: bool, spill: bool) -> tuple:
    """For each output element of the packed kernel (or its plain version),
    the sum of the absolute values of the terms added into it: (y,) or, in
    the spill form, (y_l, carry), shaped as the kernel's outputs. The hard
    slots' scales span six decades, so an error in a row of small scales
    is measured against that row's own terms, not against max|y|."""
    upper, scales = np.asarray(upper), np.asarray(scales, np.float64)
    x = np.asarray(x, np.float64)
    K, nb, nslot, B, _ = upper.shape
    S = x.shape[1]
    hb = nslot - (2 if hybrid else 1)
    nx = nb + hb if spill else nb
    u = upper.astype(np.int32)
    lo, hi = ((u & 0xF) ^ 8) - 8, u >> 4

    def block(d):        # |Q| of diagonal d, (K, nb, B, B), and its row scales
        if hybrid and d == 0:
            q = np.concatenate([u[:, :, 0], u[:, :, 1]], axis=-1)
        else:
            s = d + 1 if hybrid else d
            q = np.concatenate([lo[:, :, s], hi[:, :, s]], axis=-1)
        return np.abs(q).astype(np.float64), scales[:, :, d + 1 if hybrid and d else d]

    ax = np.abs(x[..., :nx * B]).reshape(K, S, nx, B)
    out = np.zeros((K, S, nb + hb, B))
    out[:, :, :nb] += ax[:, :, :nb]               # the stripped unit diagonal
    for d in range(hb + 1):
        q, sc = block(d)
        for i in range(nb):
            if i + d < nx:                        # row part: U_(i,d) x_(i+d)
                out[:, :, i] += sc[:, None, i] * np.einsum("kpq,ksq->ksp", q[:, i],
                                                           ax[:, :, i + d])
            if d and (spill or i + d < nb):       # mirror part, into y_(i+d)
                out[:, :, i + d] += np.einsum("kpq,ksp->ksq", q[:, i],
                                              ax[:, :, i] * sc[:, None, i])
    y = out[:, :, :nb].reshape(K, S, nb * B)
    if not spill:
        return (y,)
    # with hb = 0 the wrappers return B zeros a lane as the carry
    carry = out[:, :, nb:].reshape(K, S, hb * B) if hb else np.zeros((K, S, B))
    return y, carry


def worst_termwise_error(got, want, mags) -> float:
    """max over the outputs of |got - want| / (sum of |terms|), element by
    element; an element with no terms must match exactly."""
    worst = 0.0
    for g, w, m in zip(got, want, mags):
        diff = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
        assert diff.shape == m.shape and not diff[m == 0].any()
        worst = max(worst, float((diff[m > 0] / m[m > 0]).max(initial=0.0)))
    return worst
