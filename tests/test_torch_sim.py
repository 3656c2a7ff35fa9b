"""The port's genotype simulation (data/bed.py, data/simulate.py, the
simulation command line's gen-phen-mult and phen), its plotting commands
(cli/plots.py, cli/vis_ld.py) and --profile-dir (utils/profiling.py::
device_trace) against the JAX package's, on the CPU.

The .bed files and the simulators are numpy on both sides, so their outputs
must be equal to the byte (np.array_equal for arrays). The command lines'
inference draws its probes from different generators, so the two are
compared on the file set, the CSV headers and the best alignment (within
0.02), as in test_torch_cli.py; the .bed -> engine trajectory gets the same
injected probes on both sides and holds to 1e-8 in float64.
"""

import csv
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sgvamp_torch.cli import main as tcli
from sgvamp_torch.cli import plots as tplots
from sgvamp_torch.cli import simulate as tsim
from sgvamp_torch.cli import vis_ld as tvis
from sgvamp_torch.data import bed as tbed
from sgvamp_torch.data import simulate as tsimd
from sgvamp_torch.utils.profiling import device_trace
from sgvamp_tpu.cli import main as jcli
from sgvamp_tpu.cli import plots as jplots
from sgvamp_tpu.cli import simulate as jsim
from sgvamp_tpu.cli import vis_ld as jvis
from sgvamp_tpu.data import bed as jbed
from sgvamp_tpu.data import simulate as jsimd

MULT = ["--N", "1500", "--M", "200", "--K", "2", "--h2", "0.8", "--lam", "0.1", "--seed", "0"]


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f, delimiter="\t"))


def _files(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


def _genotypes(seed, N, M, missing=0.0):
    rng = np.random.default_rng(seed)
    G = rng.binomial(2, 0.4, size=(N, M)).astype(np.float64)
    if missing:
        G[rng.random(size=G.shape) < missing] = np.nan
    return G


# ---------------------------------------------------------------------------
# the PLINK .bed reader and writer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [40, 41, 42, 43])   # every N % 4
def test_bed_files_byte_equal_and_read_by_the_other_package(tmp_path, N):
    G = _genotypes(N, N, 17, missing=0.1)
    assert np.isnan(G).any()
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tbed.write_bed(str(tmp_path / "t" / "g.bed"), G)
    jbed.write_bed(str(tmp_path / "j" / "g"), G)     # extension-less path
    t, j = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert sorted(t) == ["g.bed", "g.bim", "g.fam"] and t == j
    assert t["g.bed"][:3] == tbed.MAGIC == jbed.MAGIC
    from_j = tbed.read_bed(str(tmp_path / "j" / "g.bed"))
    from_t = jbed.read_bed(str(tmp_path / "t" / "g"))
    np.testing.assert_array_equal(from_j, G)   # NaN where missing, on both sides
    np.testing.assert_array_equal(from_t, G)
    assert from_j.dtype == np.float64 and from_j.shape == (N, 17)
    assert tbed._companion_counts(str(tmp_path / "t" / "g.bed")) == (N, 17)
    assert tbed._exists(str(tmp_path / "j" / "g")) and not tbed._exists(str(tmp_path / "x"))


@pytest.mark.parametrize("case", ["no companions", "bad magic", "short body"])
def test_bed_errors_carry_the_jax_messages(tmp_path, case):
    p = str(tmp_path / "bad.bed")
    tbed.write_bed(p, np.full((5, 3), 2.0))
    if case == "no companions":
        os.remove(tmp_path / "bad.fam")
        err = FileNotFoundError
    elif case == "bad magic":
        with open(p, "r+b") as f:
            f.write(b"\x00\x00\x00")
        err = ValueError
    else:
        with open(p, "ab") as f:
            f.write(b"\x00")
        err = ValueError
    with pytest.raises(err) as t:
        tbed.read_bed(p)
    with pytest.raises(err) as j:
        jbed.read_bed(p)
    assert str(t.value) == str(j.value) and str(t.value).startswith(p)


# ---------------------------------------------------------------------------
# the simulators: the same arrays from the same seed
# ---------------------------------------------------------------------------

def _simulate(pkg, which, seed, bed_path):
    rng = np.random.default_rng(seed)
    if which == "multi":
        return [vars(d) for d in pkg.simulate_multi(300, 120, K=3, h2=0.7, lam=0.2, rng=rng)]
    if which == "from_bed":
        return [vars(pkg.simulate_from_bed(bed_path, 50, h2=0.8, lam=0.25, rng=rng))]
    Rs, rs, x0 = pkg.simulate_banded(1000, 150, 20, K=2, rng=rng)
    return [{"Rs": Rs, "rs": rs, "x0": x0}]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("which", ["multi", "from_bed", "banded"])
def test_simulators_give_the_jax_arrays(tmp_path, which, seed):
    bed_path = str(tmp_path / "g.bed")
    G = _genotypes(seed + 10, 203, 50)
    tbed.write_bed(bed_path, G)
    got, want = (_simulate(pkg, which, seed, bed_path) for pkg in (tsimd, jsimd))
    assert len(got) == len(want) == {"multi": 3}.get(which, 1)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            if w[key] is None:
                assert g[key] is None, key
            else:
                assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key
    if which == "multi":   # one beta shared by every cohort
        assert all(np.array_equal(d["beta"], got[0]["beta"]) for d in got)
    np.testing.assert_array_equal(tsimd._standardize_genotypes(G),
                                  jsimd._standardize_genotypes(G))


# ---------------------------------------------------------------------------
# the simulation command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cmd", ["gen-phen-mult", "phen"])
def test_simulate_files_byte_equal(tmp_path, cmd):
    if cmd == "phen":
        bed_path = str(tmp_path / "g.bed")
        tbed.write_bed(bed_path, _genotypes(3, 301, 60))
        args = ["phen", "--bed", bed_path, "--M", "60", "--lam", "0.2", "--seed", "4"]
        want = ["s_bet.npy", "s_phen.npy", "s_r.npy"]
    else:
        args = ["gen-phen-mult", "--N", "400", "--M", "90", "--K", "3", "--seed", "4"]
        want = sorted(["s_bet.npy"] + [f"s_{i}_{f}.npy" for i in range(3)
                                       for f in ("R", "phen", "r")])
    outs = {}
    for name, pkg in (("t", tsim), ("j", jsim)):
        (tmp_path / name).mkdir()
        assert pkg.main(args + ["--out", str(tmp_path / name / "s")]) == 0
        outs[name] = _files(tmp_path / name)
    assert sorted(outs["t"]) == want and outs["t"] == outs["j"]


def test_simulate_prints_the_jax_messages(tmp_path, capsys):
    bed_path = str(tmp_path / "g.bed")
    tbed.write_bed(bed_path, _genotypes(5, 64, 20))
    for args in (["gen-phen-mult", "--N", "64", "--M", "20", "--seed", "1"],
                 ["phen", "--bed", bed_path, "--M", "20", "--seed", "1"]):
        said = []
        for pkg in (tsim, jsim):
            assert pkg.main(args + ["--out", str(tmp_path / "o")]) == 0
            said.append(capsys.readouterr().out)
        assert said[0] == said[1] and said[0].startswith("wrote ")
    with pytest.raises(SystemExit):   # --bed is required by phen, --N is not
        tsim.main(["phen", "--out", "x", "--M", "10"])


@pytest.fixture(scope="module")
def mult(tmp_path_factory):
    """gen-phen-mult's files (K=2) and the port's dense command line over
    them (x64, 5 iterations)."""
    d = tmp_path_factory.mktemp("mult")
    assert tsim.main(["gen-phen-mult", "--out", str(d / "m"), *MULT]) == 0
    assert tcli.main(_mult_argv(d, d / "t_dense", "dense")) == 0
    return d


def _mult_argv(d, out, operator):
    op = ["--operator", operator] + (["--ld-dtype", "int8", "--x64", "0", "--block-size", "64"]
                                     if operator == "sym" else ["--x64", "1"])
    return ["--ld-files", f"{d / 'm_0_R.npy'},{d / 'm_1_R.npy'}",
            "--r-files", f"{d / 'm_0_r.npy'},{d / 'm_1_r.npy'}",
            "--true-signal-file", str(d / "m_bet.npy"), "--out-dir", str(out),
            "--out-name", "m", "--N", "1500", "--M", "200", "--K", "2", "--iterations", "5",
            "--prior-probs", "0.9,0.1", "--prior-vars", "0,0.04", "--platform", "cpu",
            "--compile-cache-dir", "", *op]


@pytest.mark.parametrize("operator", ["dense", "sym"])
def test_gen_phen_mult_feeds_both_command_lines(mult, tmp_path, operator):
    tdir = mult / "t_dense" if operator == "dense" else tmp_path / "t"
    if operator != "dense":
        assert tcli.main(_mult_argv(mult, tdir, operator)) == 0
    assert jcli.main(_mult_argv(mult, tmp_path / "j", operator)) == 0
    tn, jn = sorted(os.listdir(tdir)), sorted(os.listdir(tmp_path / "j"))
    assert tn == jn and "m_cohort_2.csv" in tn and "m_xhat_it_4.bin" in tn
    for name in ("m_cohort_1.csv", "m_cohort_2.csv", "m_metrics.csv"):
        tr, jr = _read_csv(tdir / name), _read_csv(tmp_path / "j" / name)
        assert tr[0] == jr[0] and len(tr) == len(jr) == 6
    best = [max(float(r[1]) for r in _read_csv(d / "m_metrics.csv")[1:])
            for d in (tdir, tmp_path / "j")]
    assert best[0] > 0.9 and abs(best[0] - best[1]) <= 0.02, best


# ---------------------------------------------------------------------------
# .bed -> simulate_from_bed -> the engine, against the JAX engine
# ---------------------------------------------------------------------------

def test_bed_feeds_the_engine_as_in_jax(tmp_path):
    """test_bed.py::test_simulate_from_bed_feeds_engine on both engines:
    the port's .bed and simulator, R from the same standardized genotypes,
    f64 DenseLD, the same injected probes; the trajectories hold to 1e-8."""
    from sgvamp_torch import PriorState as TPrior
    from sgvamp_torch import VampConfig as TConfig
    from sgvamp_torch import VampEngine as TEngine
    from sgvamp_torch import VampInputs as TInputs
    from sgvamp_torch.core.operators import DenseLD as TDense
    from sgvamp_tpu import PriorState as JPrior
    from sgvamp_tpu import VampConfig as JConfig
    from sgvamp_tpu import VampEngine as JEngine
    from sgvamp_tpu import VampInputs as JInputs
    from sgvamp_tpu.core.operators import DenseLD as JDense

    N, M, h2, lam, iters = 2000, 64, 0.8, 0.25, 8
    G = _genotypes(5, N, M)
    p = str(tmp_path / "e2e.bed")
    tbed.write_bed(p, G)
    sim = tsimd.simulate_from_bed(p, M=M, h2=h2, lam=lam, rng=np.random.default_rng(11))
    X = (G - G.mean(axis=0)) / G.std(axis=0) / np.sqrt(N)
    R = X.T @ X
    cfg = dict(prior_update="em", dtype="float64", cg_maxit=200, cg_rtol=1e-10)
    prior = (lam, [1.0], [h2 / int(M * lam) * N])
    u = np.random.default_rng(2).choice([-1.0, 1.0], size=(iters, 1, M))
    x0 = sim.beta * np.sqrt(N)
    hj = JEngine(JInputs(op=JDense(mats=jnp.asarray(R)[None], s=0.05),
                         r=jnp.asarray(sim.r)[None], a=jnp.asarray([1.0]),
                         N=jnp.asarray([float(N)])),
                 JConfig(**cfg), JPrior.create(*prior)).run(iters, x0=x0, fixed_u=u)
    ht = TEngine(TInputs(op=TDense(mats=torch.from_numpy(R)[None], s=0.05),
                         r=torch.from_numpy(sim.r)[None], a=torch.tensor([1.0], dtype=torch.float64),
                         N=torch.tensor([float(N)], dtype=torch.float64)),
                 TConfig(**cfg), TPrior.create(*prior, device="cpu")).run(iters, x0=x0,
                                                                          fixed_u=u)
    assert max(ht["alignment"]) > 0.9
    for it in range(iters):
        np.testing.assert_allclose(ht["xhat1"][it], hj["xhat1"][it], rtol=1e-8,
                                   atol=1e-8 * np.abs(hj["xhat1"][it]).max())
    np.testing.assert_allclose(np.asarray(ht["params"]), np.asarray(hj["params"]), rtol=1e-8)
    np.testing.assert_allclose(ht["alignment"], hj["alignment"], rtol=1e-8)


# ---------------------------------------------------------------------------
# plots and vis_ld
# ---------------------------------------------------------------------------

def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")


def test_plots_read_the_csvs_as_jax_and_write_its_figure(mult):
    run = mult / "t_dense"
    params, metrics = str(run / "m_cohort_1.csv"), str(run / "m_metrics.csv")
    assert tplots.read_params(params) == jplots.read_params(params)
    assert tplots.read_metrics(metrics) == jplots.read_metrics(metrics)
    assert len(tplots.read_params(params)["it"]) == 5
    pytest.importorskip("matplotlib")
    for name, pkg in (("t_fig", tplots), ("j_fig", jplots)):
        assert pkg.main(["--csv-params", params, "--csv-metrics", metrics,
                         "--out-name", name]) == 0
    assert _png_size(run / "t_fig.png") == _png_size(run / "j_fig.png") == (3600, 3000)


@pytest.mark.parametrize("fmt", ["npy", "npz"])
def test_vis_ld_writes_the_jax_figure(mult, tmp_path, fmt):
    pytest.importorskip("matplotlib")
    path = str(mult / "m_0_R.npy")
    if fmt == "npz":
        import scipy.sparse

        path = str(tmp_path / "m_0_R.npz")
        scipy.sparse.save_npz(path, scipy.sparse.csr_matrix(np.load(mult / "m_0_R.npy")))
    for name, pkg in (("t", tvis), ("j", jvis)):
        (tmp_path / name).mkdir()
        assert pkg.main(["--ld-file", path, "--ld-format", fmt,
                         "--out-dir", str(tmp_path / name)]) == 0
    assert os.listdir(tmp_path / "t") == os.listdir(tmp_path / "j") == ["m_0_R.png"]
    assert _png_size(tmp_path / "t" / "m_0_R.png") == _png_size(tmp_path / "j" / "m_0_R.png")
    with pytest.raises(SystemExit, match="Unsupported LD format"):
        tvis.main(["--ld-file", path, "--ld-format", "csv", "--out-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# --profile-dir
# ---------------------------------------------------------------------------

def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


@pytest.mark.parametrize("fused", ["0", "1"])
def test_profile_dir_writes_a_trace_and_the_same_files(mult, tmp_path, fused, caplog):
    argv = _mult_argv(mult, tmp_path / "plain", "sym") + ["--fused", fused]
    assert tcli.main(argv) == 0
    prof = tmp_path / "prof"
    argv = _mult_argv(mult, tmp_path / "traced", "sym") + ["--fused", fused]
    with caplog.at_level("INFO", logger="sgvamp"):
        assert tcli.main(argv + ["--profile-dir", str(prof)]) == 0
    assert f"device trace written to {prof}" in caplog.messages
    traces = glob.glob(str(prof / "process0.*.pt.trace.json"))
    assert len(traces) == 1 and os.listdir(prof) == [os.path.basename(traces[0])]
    events = _trace_events(traces[0])
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not any(e.get("cat") == "kernel" for e in events)   # the CPU is traced alone
    assert _files(tmp_path / "traced") == _files(tmp_path / "plain")


def test_device_trace_without_a_directory_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for out_dir in (None, ""):
        with device_trace(out_dir, "cpu"):
            assert not torch.autograd.profiler._is_profiler_enabled
            torch.ones(3).sum()
    assert os.listdir(tmp_path) == []
    with device_trace(str(tmp_path / "d"), "cpu"):
        assert torch.autograd.profiler._is_profiler_enabled
        torch.ones(3).sum()
    assert not torch.autograd.profiler._is_profiler_enabled
    (trace,) = os.listdir(tmp_path / "d")
    assert any(e.get("name") == "aten::sum" for e in _trace_events(tmp_path / "d" / trace))


def test_traced_kernel_counts_tell_the_instantiations_apart():
    """The trace's kernel event names, by band_kernel.TRACED_KERNELS: int4 and
    hybrid are the one template's two instantiations; a band kernel under a
    name no pattern matches (here a mangled one) is counted as "other"."""
    from sgvamp_torch.ops.band_kernel import TRACED_KERNELS, traced_kernel_counts

    names = ["void sym_band_packed_kernel<128, 2, true>(signed char const*, float const*)",
             "void sym_band_packed_kernel<128, 2, true>(signed char const*, float const*)",
             "void sym_band_packed_kernel<64, 1, false>(signed char const*, float const*)",
             "void sym_band_int8_kernel<128, 2>(signed char const*)",
             "void fold_partials_kernel<float, 128, 2>(float const*)",
             "_Z22sym_band_packed_kernelILi128ELi2ELb1EEvPKaPKfPKtPfS5_ii",
             "Memcpy DtoD (Device -> Device)", "void at::native::reduce_kernel<512, 1>()"]
    counts = traced_kernel_counts(names)
    assert set(counts) == set(TRACED_KERNELS) | {"other"}
    assert counts == {k: 0 for k in counts} | {"hybrid": 2, "int4": 1, "int8": 1, "fold": 1,
                                               "other": 1}
