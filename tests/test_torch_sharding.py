"""The port's sharded run (sgvamp_torch.parallel.sharding, the spill forms
of the streamed kernels, SymBandedLD._matvec_sharded, VampEngine(mesh=) and
the command line's --mesh-* flags) against the JAX package, on the CPU.

Both packages get the same numpy inputs. On the JAX side the Pallas kernels
run in interpret mode and the mesh is made of the virtual CPU devices of
conftest.py; on the port's side the wrappers take their plain versions (the
tensors lie on the CPU) and every cell of the mesh is the CPU, so the cells
run one after another. Tolerances:
  * a spill kernel's plain version against the Pallas kernel: float64
    1e-10; the other storages a scaled 1e-5 (exact products summed in f32 in
    another order);
  * the sharded operator against the unsharded one: 1e-6, as the JAX
    package's own tests;
  * float64 trajectories: rtol 1e-9 on xhat1 against the port's unsharded
    run (the head rows of a shard sum in another order), 1e-8 against the
    JAX engine under the same mesh (other reduction orders everywhere);
  * int4 trajectories: relative L2 2e-3, the JAX package's own bound.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sgvamp_torch import interop
from sgvamp_torch.cli import main as tcli
from sgvamp_torch.cli import simulate as tsim
from sgvamp_torch.config import VampConfig as TConfig
from sgvamp_torch.core import vamp as tvamp
from sgvamp_torch.core.operators import BandedLD as TBanded
from sgvamp_torch.core.operators import DenseLD as TDense
from sgvamp_torch.core.prior import PriorState as TPrior
from sgvamp_torch.ops import band_kernel as tbk
from sgvamp_torch.ops.band_kernel import SymBandedLD as TSym
from sgvamp_torch.parallel import sharding as tsh
from sgvamp_tpu.config import VampConfig as JConfig
from sgvamp_tpu.core import vamp as jvamp
from sgvamp_tpu.core.operators import BandedLD as JBanded
from sgvamp_tpu.core.operators import DenseLD as JDense
from sgvamp_tpu.core.prior import PriorState as JPrior
from sgvamp_tpu.data.simulate import simulate_ld_band
from sgvamp_tpu.ops.band_kernel import SymBandedLD as JSym
from sgvamp_tpu.ops.band_kernel import (_sym_band_matvec_streamed,
                                        _sym_slab_matvec_streamed)
from sgvamp_tpu.parallel import sharding as jsh

SCALED_TOL = 1e-5

# storage -> (from_band dtype, layout)
STORAGES = {"int8": ("int8", "diag"), "float32": ("float32", "diag"),
            "float64": ("float64", "diag"), "int4": ("int4", "diag"),
            "hybrid": ("hybrid", "diag"), "slab": ("float64", "slab"),
            "slab32": ("float32", "slab")}


def _band(M, bw, seed, n=10000):
    if bw == 0:
        return np.random.default_rng(seed).normal(size=(M, 1))
    return simulate_ld_band(n, M, bandwidth=bw, rng=np.random.default_rng(seed),
                            dtype=np.float64)[0]


def _port_op(jop, **kw):
    """The port's operator over the JAX operator's blocks, on the CPU."""
    up = np.asarray(jop.upper.astype(jnp.float32) if jop.upper.dtype == jnp.bfloat16
                    else jop.upper)
    return interop.operator_from_numpy(
        up, None if jop.scales is None else np.asarray(jop.scales), s=jop.s,
        packed=jop.packed, hybrid=jop.hybrid, layout=jop.layout, device="cpu", **kw)


def _x_types(jop):
    """(jax dtype, torch dtype) of the x the kernels take."""
    if str(jop.upper.dtype) == "int8":
        return jnp.bfloat16, torch.bfloat16
    return jop.upper.dtype, {"float32": torch.float32,
                             "float64": torch.float64}[str(jop.upper.dtype)]


def _spill_pair(jop, top, sh, n, G, x):
    """Shard sh of n through both packages' spill kernels: the JAX Pallas
    kernel in interpret mode and the port's wrapper on CPU tensors, on one
    halo-extended x padded to a whole chunk as the JAX package wants it.
    Returns ((y_l, carry) of JAX, (y_l, carry) of the port), as float64."""
    nb_l, hb, B = jop.nb // n, jop.hb, jop.B
    hbB = max(hb, 1) * B
    K, S, M = x.shape
    x_l = x[:, :, sh * nb_l * B:(sh + 1) * nb_l * B]
    halo = (x[:, :, (sh + 1) * nb_l * B:(sh + 1) * nb_l * B + hbB] if sh < n - 1
            else np.zeros((K, S, hbB), x.dtype))   # the wraparound leg: zeros
    x_ext = np.concatenate([x_l, halo, np.zeros((K, S, G * B - hbB), x.dtype)], axis=2)
    jdt, tdt = _x_types(jop)
    rows = slice(sh * nb_l, (sh + 1) * nb_l)
    if jop.layout == "slab":
        jy, jc = _sym_slab_matvec_streamed(jop.upper[:, rows], jnp.asarray(x_ext).astype(jdt),
                                           nb_l, interpret=True, rows_per_step=G, spill=True)
    else:
        jy, jc = _sym_band_matvec_streamed(
            jop.upper[:, rows], jnp.asarray(x_ext).astype(jdt), nb_l, interpret=True,
            rows_per_step=G, spill=True,
            scales=None if jop.scales is None else jop.scales[:, rows],
            packed4=jop.packed, hybrid=jop.hybrid)
    piece = dataclasses.replace(
        top, upper=top.upper[:, rows].contiguous(),
        scales=None if top.scales is None else top.scales[:, rows].contiguous(),
        rows_per_step=G)
    kernel, plain, args, xdt = tbk.band_kernel_of(piece, S, spill=True)
    assert xdt == tdt and kernel.__name__.endswith("_spill")
    xt = torch.from_numpy(x_ext).to(tdt)
    before = kernel.launches
    ty, tc = kernel(*args, xt)
    assert kernel.launches == before          # a CPU tensor: the plain version, no launch
    py, pc = plain(*args, xt)
    assert torch.equal(ty, py) and torch.equal(tc, pc)
    # the exact form, without the JAX package's padding, gives the same bits
    ey, ec = kernel(*args, xt[:, :, :(nb_l + hb) * B].contiguous())
    assert torch.equal(ey, ty) and torch.equal(ec, tc)
    return ((np.asarray(jy, np.float64), np.asarray(jc, np.float64)),
            (ty.double().numpy(), tc.double().numpy()))


def _close(got, want, f64):
    assert got.shape == want.shape
    if f64:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    else:
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=SCALED_TOL)


# ---------------------------------------------------------------------------
# (a), (b) the spill kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("storage", sorted(STORAGES))
@pytest.mark.parametrize("bw", [200, 0])
def test_spill_plain_version_matches_pallas(storage, shard, bw):
    """One shard of two at M=1024, B=128, G=4 (bandwidth 200: hb=2) and the
    diagonal-only band (hb=0: a carry of one block of zeros)."""
    dtype, layout = STORAGES[storage]
    jop = JSym.from_band(_band(1024, bw, seed=7), block_size=128, K=2, dtype=dtype,
                         layout=layout)
    top = _port_op(jop)
    assert jop.hb == (2 if bw else 0)
    x = np.random.default_rng(8).normal(size=(2, 2, 1024)).astype(
        np.float64 if dtype == "float64" else np.float32)
    (jy, jc), (ty, tc) = _spill_pair(jop, top, shard, 2, 4, x)
    assert tc.shape == (2, 2, max(jop.hb, 1) * 128)
    _close(ty, jy, dtype == "float64")
    if np.abs(jc).max() > 0:
        _close(tc, jc, dtype == "float64")
    else:
        assert np.all(tc == 0)
    if shard == 1 or bw == 0:
        # what leaves the global panel, and all of an hb=0 carry: exact zeros
        assert np.all(tc == 0) and np.all(jc == 0)
    else:
        assert np.abs(tc).max() > 0


@pytest.mark.parametrize("storage", sorted(STORAGES))
def test_two_shard_composition_matches_the_whole_operator(storage):
    """Two half-panels with halo-extended x, the first's carry added into
    the second's head: the whole panel's matvec (the JAX package's
    test_streamed_spill_two_shard_composition, through the port)."""
    dtype, layout = STORAGES[storage]
    jop = dataclasses.replace(
        JSym.from_band(_band(1024, 200, seed=7), block_size=128, dtype=dtype, layout=layout),
        mode="streamed")
    top = _port_op(jop, mode="streamed")
    x = np.random.default_rng(9).normal(size=(1, 2, 1024)).astype(
        np.float64 if dtype == "float64" else np.float32)
    ys, carries = [], []
    for sh in range(2):
        _, (ty, tc) = _spill_pair(jop, top, sh, 2, 4, x)
        ys.append(ty)
        carries.append(tc)
    ys[1][:, :, :carries[0].shape[2]] += carries[0]
    got = np.concatenate(ys, axis=2)[0]
    _, tdt = _x_types(jop)
    want_t = top.matvec(torch.from_numpy(x.reshape(2, 1024)).to(tdt).to(
        torch.float64 if dtype == "float64" else torch.float32)).double().numpy()
    want_j = np.asarray(jop.matvec(jnp.asarray(x.reshape(2, 1024))), np.float64)
    _close(got, want_t, dtype == "float64")
    _close(got, want_j, dtype == "float64")
    assert np.all(carries[1] == 0)


def test_spill_wrappers_reject_bad_input():
    top = TSym.from_band(_band(1024, 200, seed=7), block_size=128, dtype="int8", device="cpu")
    one = dataclasses.replace(top, upper=top.upper[:, :1].contiguous(),
                              scales=top.scales[:, :1].contiguous())
    x = torch.zeros((1, 2, 3 * 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at least hb=2"):   # a shard narrower than hb
        tbk.sym_band_matvec_int8_spill(one.upper, one.scales, x)
    with pytest.raises(ValueError, match="halo"):             # x without its halo
        tbk.sym_band_matvec_int8_spill(top.upper, top.scales, x)
    with pytest.raises(ValueError, match="bfloat16"):
        tbk.sym_band_matvec_int8_spill(top.upper, top.scales,
                                       torch.zeros((1, 2, 10 * 128)))
    f32 = TSym.from_band(_band(1024, 200, seed=7), block_size=128, dtype="float32",
                         layout="slab", device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tbk.sym_slab_matvec_streamed_spill(f32.upper, 3, torch.zeros((1, 2, 10 * 128)))


def test_band_kernel_of_routes_the_spill_forms():
    band = _band(1024, 200, seed=7)
    want = {"int8": "sym_band_matvec_int8_spill", "int4": "sym_band_matvec_int4_spill",
            "hybrid": "sym_band_matvec_hybrid_spill", "float32": "sym_band_matvec_spill",
            "slab": "sym_slab_matvec_streamed_spill"}
    for storage, name in want.items():
        dtype, layout = STORAGES[storage]
        op = TSym.from_band(band, block_size=128, dtype=dtype, layout=layout, device="cpu")
        for mode in ("auto", "streamed") + (() if op.upper.dtype == torch.int8
                                            else ("resident",)):
            # under a mesh the streamed spill kernel, whatever the mode says
            kernel, plain, _, _ = tbk.band_kernel_of(dataclasses.replace(op, mode=mode), 2,
                                                     spill=True)
            assert kernel.__name__ == name and plain.__name__ == name + "_ref"
            assert kernel in tbk.BAND_KERNELS and kernel.launches == 0


# ---------------------------------------------------------------------------
# (c), (e) make_mesh, shard_inputs and the sharded operator
# ---------------------------------------------------------------------------

def _inputs(top, K=None, dtype=torch.float32):
    K = K or top.K
    return tvamp.VampInputs(op=top, r=torch.zeros((K, top.M), dtype=dtype),
                            a=torch.full((K,), 1.0 / K, dtype=dtype),
                            N=torch.full((K,), 20000.0, dtype=dtype))


@pytest.mark.parametrize("storage", ["int8", "int4", "hybrid", "float32", "slab32"])
def test_sharded_operator_matches_jax_and_unsharded(storage):
    """(1, 4) mesh, M=512, B=64, bandwidth 100 (nb=8, hb=2): the JAX
    package's test_int8_sharded_matches_unsharded and its int4 and hybrid
    twins, through both packages."""
    dtype, layout = STORAGES[storage]
    band = _band(512, 100, seed=10, n=20000)
    jop = JSym.from_band(band, block_size=64, dtype=dtype, layout=layout, s=0.05)
    top = _port_op(jop)
    x = np.random.default_rng(11).normal(size=(2, jop.M)).astype(np.float32)
    jmesh = jsh.make_mesh(1, 4)
    jinputs = jvamp.VampInputs(op=jop, r=jnp.zeros((1, jop.M), jnp.float32),
                               a=jnp.asarray([1.0]), N=jnp.asarray([20000.0]))
    jsharded = jsh.shard_inputs(jinputs, jmesh)
    assert jsharded.op.mesh is jmesh
    want_j = np.asarray(jsharded.op.matvec(jnp.asarray(x)))
    mesh = interop.mesh_like(dict(jmesh.shape), device="cpu")
    sh = tsh.shard_inputs(_inputs(top), mesh)
    assert sh.op.mesh is mesh and sh.op.upper.device.type == "meta"
    assert len(sh.op.shards) == 1 and len(sh.op.shards[0]) == 4
    for piece in sh.op.shards[0]:
        assert piece.upper.is_contiguous() and piece.nb == 2 and piece.mesh is None
        assert piece.scales is None or piece.scales.shape[1] == 2
    got = sh.op.matvec(torch.from_numpy(x)).numpy()
    want_t = top.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want_t, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want_j, rtol=1e-6, atol=1e-6)
    assert sh.op.bytes_per_pass() == top.bytes_per_pass()
    assert torch.equal(sh.op.diag_blocks(), top.diag_blocks())
    assert torch.equal(sh.op.to_dense(), top.to_dense())


def test_sharded_operator_over_both_axes_and_cohort_axis_only():
    band = _band(512, 100, seed=12)
    for storage in ("float64", "hybrid"):
        top = TSym.from_band(band, block_size=64, K=2, dtype=storage, s=0.05, device="cpu")
        x = torch.from_numpy(np.random.default_rng(13).normal(size=(4, top.M)))
        x = x if storage == "float64" else x.float()
        want = top.matvec(x)
        for shape in ((2, 4), (1, 2), (2, 1), (1, 1)):
            mesh = interop.mesh_like(shape, device="cpu")
            sh = tsh.shard_inputs(_inputs(top, dtype=x.dtype), mesh)
            if shape[1] > 1:
                assert isinstance(sh.op, TSym) and sh.op.mesh is mesh
            else:   # the cohort axis alone: every cell its ordinary matvec
                assert isinstance(sh.op, tsh.MeshLD) and sh.op.kind == "cohort"
                assert all(c[0].mesh is None for c in sh.op.cells)
            got = sh.op.matvec(x)
            assert float((got - want).abs().max() / want.abs().max()) <= (
                1e-12 if storage == "float64" else 1e-6), (storage, shape)


def test_shared_device_mesh_gives_the_bits_of_the_hand_composition():
    """Four cells on one device ([cpu]*4): the operator's sharded matvec
    equals, bit for bit, the four spill wrappers composed by hand on copies
    of the pieces, and a second pass gives the same bits again."""
    band = _band(1024, 200, seed=14)
    top = TSym.from_band(band, block_size=64, dtype="float32", s=0.0, device="cpu")
    mesh = tsh.make_mesh(1, 4, devices=[torch.device("cpu")] * 4)
    sh = tsh.shard_inputs(_inputs(top), mesh)
    x = torch.from_numpy(np.random.default_rng(15).normal(size=(2, top.M)).astype(np.float32))
    got = sh.op.matvec(x)
    assert torch.equal(got, sh.op.matvec(x))
    nb_l, hbB = top.nb // 4, top.hb * top.B
    xs = torch.cat([x.reshape(2, 1, top.M).transpose(0, 1), torch.zeros(1, 2, hbB)], dim=2)
    ys, carry = [], None
    for j in range(4):
        x_ext = xs[:, :, j * nb_l * 64:(j + 1) * nb_l * 64 + hbB].contiguous()
        y_l, spilled = tbk.sym_band_matvec_spill(
            top.upper[:, j * nb_l:(j + 1) * nb_l].clone(), x_ext)
        if j:
            y_l[:, :, :hbB] += carry
        carry = spilled
        ys.append(y_l)
    assert torch.equal(got, torch.cat(ys, dim=2).transpose(0, 1).reshape(x.shape))
    assert float(carry.abs().max()) == 0.0


def test_shard_inputs_value_errors_have_the_jax_package_s_words():
    def jax_inputs(band):
        op = JSym.from_band(band, block_size=64)
        return jvamp.VampInputs(op=op, r=jnp.zeros((1, op.M)), a=jnp.asarray([1.0]),
                                N=jnp.asarray([1.0]))

    def port_inputs(band):
        return _inputs(TSym.from_band(band, block_size=64, device="cpu"), dtype=torch.float64)

    # nb=10 over 4 shards; then nb=8, hb=2 over 8 shards: one block row a shard
    for band, n, words in (
            (_band(640, 100, seed=16), 4,
             "10 block rows not divisible by the 4-way marker-shard axis"),
            (_band(512, 100, seed=16), 8,
             "shard width 1 block rows is narrower than the block half-bandwidth 2 - "
             "halo/spill exchange only reaches one neighbor")):
        with pytest.raises(ValueError, match=words):
            jsh.shard_inputs(jax_inputs(band), jsh.make_mesh(1, n))
        with pytest.raises(ValueError, match=words):
            tsh.shard_inputs(port_inputs(band), interop.mesh_like((1, n), device="cpu"))
    top = TSym.from_band(band, block_size=64, device="cpu")
    with pytest.raises(ValueError, match="cohorts not divisible"):
        tsh.shard_inputs(_inputs(top, dtype=torch.float64),
                         interop.mesh_like((2, 2), device="cpu"))
    with pytest.raises(ValueError, match="pinned together"):
        dataclasses.replace(top, mesh=interop.mesh_like((1, 2), device="cpu"))


def test_make_mesh_arithmetic_and_error():
    cpu = torch.device("cpu")
    mesh = tsh.make_mesh(2, devices=[cpu] * 8)
    jmesh = jsh.make_mesh(2)
    assert mesh.shape == dict(jmesh.shape) == {"cohort": 2, "shard": 4}
    assert mesh.axis_names == tuple(jmesh.axis_names) == (tsh.COHORT_AXIS, tsh.SHARD_AXIS)
    assert mesh.devices.shape == jmesh.devices.shape and mesh.first == cpu
    for mod, devices in ((tsh, [cpu] * 8), (jsh, None)):
        with pytest.raises(ValueError, match="8 devices not divisible by cohort axis 3"):
            mod.make_mesh(3, devices=devices)
    # more cells than devices: round-robin
    assert tsh.make_mesh(2, 3, devices=[cpu]).devices.shape == (2, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):   # the default is the cards
            tsh.make_mesh(1, 4)


def test_shard_state_puts_everything_on_the_first_device():
    top = TSym.from_band(_band(512, 100, seed=17), block_size=64, device="cpu")
    mesh = interop.mesh_like((1, 4), device="cpu")
    cfg = TConfig(dtype="float64")
    prior = TPrior.create(0.1, [1.0], [1.0], device="cpu")
    eng = tvamp.VampEngine(_inputs(top, dtype=torch.float64), cfg, prior, mesh=mesh)
    assert eng.inputs.op.mesh is mesh and eng.mesh is mesh
    state = eng.init_state(seed=1)
    placed = tsh.shard_state(state, mesh)
    assert placed.r1.device == mesh.first and placed.prior.lam.device == mesh.first
    assert placed.it == state.it and placed.gen is state.gen
    assert torch.equal(placed.r1, state.r1)


# ---------------------------------------------------------------------------
# (d) engine trajectories under a mesh
# ---------------------------------------------------------------------------

def _engines(jop, top, r, N, cfg, prior_args, mesh_shape, mask=None):
    """(JAX engine under the mesh, port engine under the mesh, port engine
    without one) over the same problem."""
    K = r.shape[0]
    fdt = np.float64 if cfg["dtype"] == "float64" else np.float32
    tdt = torch.float64 if cfg["dtype"] == "float64" else torch.float32
    a, Nk = np.full(K, 1.0 / K, fdt), np.full(K, float(N), fdt)
    jinputs = jvamp.VampInputs(op=jop, r=jnp.asarray(r, fdt), a=jnp.asarray(a),
                               N=jnp.asarray(Nk),
                               mask=None if mask is None else jnp.asarray(mask, fdt))
    jmesh = jsh.make_mesh(*mesh_shape)
    jeng = jvamp.VampEngine(jinputs, JConfig(**cfg), JPrior.create(*prior_args), mesh=jmesh)
    tinputs = interop.inputs_from_numpy(top, r, a, Nk, mask=mask, dtype=tdt, device="cpu")
    tprior = TPrior.create(*prior_args, device="cpu")
    mesh = interop.mesh_like(dict(jmesh.shape), device="cpu")
    teng = tvamp.VampEngine(tinputs, TConfig(**cfg), tprior, mesh=mesh)
    tref = tvamp.VampEngine(tinputs, TConfig(**cfg), tprior)
    return jeng, teng, tref


def _assert_f64_trajectories(jeng, teng, tref, u, iters, M_out=None):
    hj = jeng.run(iters, fixed_u=u, M_out=M_out)
    ht = teng.run(iters, fixed_u=u, M_out=M_out)
    hr = tref.run(iters, fixed_u=u, M_out=M_out)
    assert len(ht["xhat1"]) == iters
    for it in range(iters):
        top = np.abs(hr["xhat1"][it]).max()
        np.testing.assert_allclose(ht["xhat1"][it], hr["xhat1"][it], rtol=1e-9,
                                   atol=1e-9 * top)
        np.testing.assert_allclose(ht["xhat1"][it], hj["xhat1"][it], rtol=1e-8,
                                   atol=1e-8 * top)
        np.testing.assert_allclose(np.asarray(ht["params"][it]), np.asarray(hr["params"][it]),
                                   rtol=1e-9)
        np.testing.assert_allclose(np.asarray(ht["params"][it]), np.asarray(hj["params"][it]),
                                   rtol=1e-8)


F64_CFG = dict(prior_update="em", dtype="float64", cg_maxit=300, cg_rtol=1e-10)


@pytest.mark.parametrize("mesh_shape,layout", [
    ((1, 4), "diag"), ((1, 2), "diag"), ((1, 4), "slab"), ((1, 2), "slab")])
def test_sharded_sym_trajectory_matches(mesh_shape, layout):
    N, M, lam, h2 = 20000, 512, 0.1, 0.7
    band, r, _ = simulate_ld_band(N, M, bandwidth=100, rng=np.random.default_rng(9),
                                  dtype=np.float64, h2=h2, lam=lam)
    jop = JSym.from_band(band, block_size=64, layout=layout)   # nb=8, hb=2
    top = _port_op(jop)
    jeng, teng, tref = _engines(jop, top, r[None], N, F64_CFG,
                                (lam, [1.0], [h2 / int(M * lam) * N]), mesh_shape)
    assert teng.inputs.op.mesh is teng.mesh and tref.inputs.op.mesh is None
    u = np.random.default_rng(2).choice([-1.0, 1.0], size=(3, 1, M))
    _assert_f64_trajectories(jeng, teng, tref, u, 3)


def test_sharded_sym_multicohort_trajectory_matches():
    """K=2 cohorts on the cohort axis, block rows on the shard axis."""
    N, M, lam, h2 = 20000, 512, 0.1, 0.7
    rng = np.random.default_rng(10)
    bands, rs = zip(*[simulate_ld_band(N, M, bandwidth=48, rng=rng, dtype=np.float64,
                                       h2=h2, lam=lam)[:2] for _ in range(2)])
    jops = [JSym.from_band(b, block_size=64) for b in bands]
    jop = JSym(upper=jnp.concatenate([o.upper for o in jops], axis=0))
    top = _port_op(jop)
    jeng, teng, tref = _engines(jop, top, np.stack(rs), N, F64_CFG,
                                (lam, [1.0], [h2 / int(M * lam) * 2.0 * N]), (2, 4))
    u = np.random.default_rng(3).choice([-1.0, 1.0], size=(3, 2, M))
    _assert_f64_trajectories(jeng, teng, tref, u, 3)


def test_sharded_sym_with_mask_trajectory_matches():
    """A padded operator and its validity mask under a (1, 2) mesh: the
    padded block rows are cut like the others."""
    N, M, lam, h2 = 20000, 380, 0.1, 0.7   # pads to 384 = 6 blocks of 64
    band, r, _ = simulate_ld_band(N, M, bandwidth=40, rng=np.random.default_rng(4),
                                  dtype=np.float64, h2=h2, lam=lam)
    jop = JSym.from_band(band, block_size=64)
    top = _port_op(jop)
    Mp = jop.M
    mask = (np.arange(Mp) < M).astype(np.float64)
    rp = np.zeros((1, Mp))
    rp[0, :M] = r
    jeng, teng, tref = _engines(jop, top, rp, N, F64_CFG,
                                (lam, [1.0], [h2 / int(M * lam) * N]), (1, 2), mask=mask)
    u = np.random.default_rng(8).choice([-1.0, 1.0], size=(3, 1, Mp))
    _assert_f64_trajectories(jeng, teng, tref, u, 3, M_out=M)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 4)])
def test_sharded_sym_int4_trajectory_matches(mesh_shape):
    K = mesh_shape[0]
    N, M, lam, h2, iters = 20000, 1024, 0.05, 0.7, 3
    band, r, _ = simulate_ld_band(N, M, bandwidth=100, rng=np.random.default_rng(11),
                                  dtype=np.float64, h2=h2, lam=lam)
    jop = JSym.from_band(band, block_size=128, K=K, dtype="int4")
    top = _port_op(jop)
    assert top.packed
    rs = np.tile(r[None], (K, 1)) * (1.0 + 0.01 * np.arange(K)[:, None])
    cfg = dict(prior_update="em", dtype="float32", cg_maxit=100, cg_rtol=1e-5, rho=0.5,
               lmmse_damp=True)
    jeng, teng, tref = _engines(jop, top, rs, N, cfg,
                                (lam, [1.0], [h2 / int(M * lam) * float(K * N)]), mesh_shape)
    u = (np.random.default_rng(42).integers(0, 2, size=(iters, K, M)) * 2 - 1).astype(
        np.float64)
    hj = jeng.run(iters, fixed_u=u)
    ht = teng.run(iters, fixed_u=u)
    hr = tref.run(iters, fixed_u=u)
    for it in range(iters):
        for other in (hr, hj):
            b = np.asarray(other["xhat1"][it], np.float64)
            err = np.linalg.norm(ht["xhat1"][it] - b) / (np.linalg.norm(b) + 1e-30)
            assert err < 2e-3, f"int4 sharded parity failed at it={it}: {err:.3e}"
            np.testing.assert_allclose(np.asarray(ht["params"][it], np.float64),
                                       np.asarray(other["params"][it], np.float64), rtol=1e-2)


def _dense_problem(K, M=256, N=800):
    from sgvamp_tpu.data.simulate import simulate_multi

    ds = simulate_multi(N, M, K=K, h2=0.8, lam=0.1, rng=np.random.default_rng(0))
    return (np.stack([d.R for d in ds]), np.stack([d.r for d in ds]), N,
            (0.05, [1.0], [0.01 * float(K * N)]))


@pytest.mark.parametrize("mesh_shape", [(2, 4), (2, 1)])
def test_sharded_dense_trajectory_matches(mesh_shape):
    Rs, rs, N, prior_args = _dense_problem(2)
    jop = JDense(mats=jnp.asarray(Rs), s=0.05)
    top = TDense(mats=torch.from_numpy(Rs), s=0.05)
    jeng, teng, tref = _engines(jop, top, rs, N, dict(F64_CFG, cg_maxit=500), prior_args,
                                mesh_shape)
    assert isinstance(teng.inputs.op, tsh.MeshLD)
    assert teng.inputs.op.kind == ("dense" if mesh_shape[1] > 1 else "cohort")
    u = np.random.default_rng(5).choice([-1.0, 1.0], size=(3, 2, Rs.shape[1]))
    _assert_f64_trajectories(jeng, teng, tref, u, 3)


def test_sharded_banded_trajectory_matches():
    N, M, lam, h2 = 20000, 512, 0.1, 0.7
    band, r, _ = simulate_ld_band(N, M, bandwidth=48, rng=np.random.default_rng(1),
                                  dtype=np.float64, h2=h2, lam=lam)
    jop = JBanded.from_band(band, block_size=64)   # nb=8 over 4 shards
    top = interop.banded_from_numpy(np.asarray(jop.blocks), s=jop.s,
                                    accum_dtype=jop.accum_dtype, device="cpu")
    jeng, teng, tref = _engines(jop, top, r[None], N, F64_CFG,
                                (lam, [1.0], [h2 / int(M * lam) * N]), (1, 4))
    assert teng.inputs.op.kind == "banded"
    u = np.random.default_rng(2).choice([-1.0, 1.0], size=(3, 1, M))
    _assert_f64_trajectories(jeng, teng, tref, u, 3)


@pytest.mark.parametrize("kind", ["dense", "banded"])
def test_mesh_ld_matvec_and_diag_blocks_match_the_whole_operator(kind):
    band = _band(1024, 100, seed=18)
    whole = TBanded.from_band(band, block_size=64, K=2, s=0.05, device="cpu")
    if kind == "dense":
        whole = TDense(mats=whole.to_dense() - 0.05 * torch.eye(1024, dtype=torch.float64),
                       s=0.05)
    x = torch.from_numpy(np.random.default_rng(19).normal(size=(4, 1024)))
    want = whole.matvec(x)
    for shape in ((1, 4), (2, 2), (2, 1)):
        sh = tsh.shard_inputs(_inputs(whole, dtype=torch.float64),
                              interop.mesh_like(shape, device="cpu"))
        assert sh.op.kind == (kind if shape[1] > 1 else "cohort")
        got = sh.op.matvec(x)
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
        assert torch.equal(sh.op.diag_blocks(), whole.diag_blocks())
        assert sh.op.bytes_per_pass() == whole.bytes_per_pass()
    with pytest.raises(ValueError, match="not divisible"):
        tsh.shard_inputs(_inputs(whole, dtype=torch.float64),
                         interop.mesh_like((1, 3), device="cpu"))


def test_precond_from_the_cut_operator_equals_the_whole_one_s():
    """With cg_precond_eig the engine factors the operator before the mesh
    cuts it; without, each step takes diag_blocks() from the pieces: both
    must give the unsharded run's trajectory."""
    N, M, lam, h2 = 20000, 512, 0.1, 0.7
    band, r, _ = simulate_ld_band(N, M, bandwidth=100, rng=np.random.default_rng(9),
                                  dtype=np.float64, h2=h2, lam=lam)
    top = TSym.from_band(band, block_size=64, dtype="hybrid", device="cpu")
    u = np.random.default_rng(2).choice([-1.0, 1.0], size=(2, 1, M))
    for eig in (True, False):
        cfg = TConfig(prior_update="em", dtype="float32", cg_maxit=50, cg_rtol=1e-6,
                      cg_precond_block=32, cg_precond_eig=eig)
        inputs = interop.inputs_from_numpy(top, r[None], [1.0], [float(N)], device="cpu")
        prior = TPrior.create(lam, [1.0], [h2 / int(M * lam) * N], device="cpu")
        href = tvamp.VampEngine(inputs, cfg, prior).run(2, fixed_u=u)
        mesh = interop.mesh_like((1, 4), device="cpu")
        hsh = tvamp.VampEngine(inputs, cfg, prior, mesh=mesh).run(2, fixed_u=u)
        for it in range(2):
            b = href["xhat1"][it]
            assert np.linalg.norm(hsh["xhat1"][it] - b) / np.linalg.norm(b) < 1e-4
            np.testing.assert_array_equal(hsh["cg1_iters"][it], href["cg1_iters"][it])


# ---------------------------------------------------------------------------
# (f) the command line
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    d = tmp_path_factory.mktemp("panel")
    assert tsim.main(["gen-band", "--out", str(d / "p"), "--N", "20000", "--M", "1024",
                      "--h2", "0.7", "--lam", "0.02", "--bandwidth", "100", "--seed", "3",
                      "--uncompressed"]) == 0
    return d


def _cli(panel, out, name, *extra, K=1):
    argv = ["--ld-files", ",".join([str(panel / "p_R.npz")] * K),
            "--r-files", ",".join([str(panel / "p_r.npy")] * K),
            "--true-signal-file", str(panel / "p_bet.npy"), "--out-dir", str(out),
            "--out-name", name, "--N", "20000", "--M", "1024", "--K", str(K),
            "--iterations", "3", "--operator", "sym", "--block-size", "64",
            "--platform", "cpu", "--seed", "1", *extra]
    assert tcli.main(argv) == 0
    return {f[len(name):]: (out / f).read_bytes() for f in sorted(os.listdir(out))
            if f.startswith(name + "_")}


@pytest.mark.parametrize("extra,K", [
    (["--mesh-shard", "4"], 1),
    (["--mesh-shard", "4", "--cg-precond-block", "32"], 1),
    (["--mesh-cohort", "2", "--mesh-shard", "2"], 2),
    (["--mesh-cohort", "2"], 2),
])
def test_cli_mesh_run_writes_the_unsharded_run_s_files(panel, tmp_path, extra, K):
    """float64 on the CPU: the sharded run's files equal the unsharded
    run's to the byte (on this panel the head rows' other summation order
    does not change a bit)."""
    keep = extra[extra.index("--cg-precond-block"):] if "--cg-precond-block" in extra else []
    ref = _cli(panel, tmp_path, "ref", *keep, K=K)
    got = _cli(panel, tmp_path, "sh", *extra, K=K)
    assert sorted(got) == sorted(ref) and "_xhat_it_2.bin" in got
    for name in ref:
        assert got[name] == ref[name], name


@pytest.mark.parametrize("ld_dtype", ["int8", "hybrid"])
def test_cli_mesh_run_quantized(panel, tmp_path, ld_dtype):
    ref = _cli(panel, tmp_path, "ref", "--ld-dtype", ld_dtype, "--x64", "0")
    got = _cli(panel, tmp_path, "sh", "--ld-dtype", ld_dtype, "--x64", "0",
               "--mesh-shard", "4")
    assert sorted(got) == sorted(ref)
    a = np.frombuffer(got["_xhat_it_2.bin"], "<f8")
    b = np.frombuffer(ref["_xhat_it_2.bin"], "<f8")
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-4


@pytest.mark.parametrize("extra,named", [
    (["--coordinator-address", "localhost:1"], "--coordinator-address"),
    (["--num-processes", "2"], "--num-processes"),
    (["--process-id", "0"], "--process-id"),
])
def test_cli_multi_process_flags_still_exit_by_name(extra, named, monkeypatch):
    """Runs over several processes are ported; a set of their flags that
    defines no process group (an address without a size, a size or an id
    without an address) still exits, naming the flag."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--ld-files", "R.npz", "--r-files", "r.npy", "--N", "10", "--M", "10",
                   "--platform", "cpu", "--mesh-shard", "2", *extra])
    assert str(exc.value).startswith(named)
    assert "torch.distributed" in str(exc.value)
