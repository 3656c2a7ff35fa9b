"""The port's A/B matrix (python -m sgvamp_torch.utils.ab_matrix) on the
CPU at the small size: the document of the JAX tool (tools/ab_matrix.py,
whose record is BENCH_AB.json), one cell per storage x block x layout, and
resuming by config. Timings on the CPU are the plain versions' on the host
clock; only the document's shape and routing are checked here.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from sgvamp_torch.utils import ab_matrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the port's rows hold beyond the JAX tool's
CELL_ADDED = {"kernel", "launches"}
STEP_ADDED = {"iter_ms_median_host", "launches"}
WRAPPER = {("bfloat16", "diag"): "sym_band_matvec", ("bfloat16", "slab"): "sym_slab_matvec_streamed",
           ("int8", "diag"): "sym_band_matvec_int8", ("int4", "diag"): "sym_band_matvec_int4",
           ("hybrid", "diag"): "sym_band_matvec_hybrid"}


@pytest.fixture(scope="module")
def jax_record():
    with open(os.path.join(ROOT, "BENCH_AB.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small_doc(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ab")
    mp = pytest.MonkeyPatch()
    for k in [k for k in os.environ if k.startswith("SGVAMP_BENCH_")]:
        mp.delenv(k)
    mp.setenv("SGVAMP_BENCH_CACHE_DIR", str(tmp / "cache"))
    out = str(tmp / "ab.json")
    argv = ["--platform", "cpu", "--size", "small", "--skip-solves", "--passes", "8",
            "--out", out]
    # one thread: the grid's n and 2n chains are timed by the host clock, and
    # threads descheduled by other processes could make the shorter chain the
    # slower one (a cell with no time)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        doc = ab_matrix.main(argv)
    finally:
        torch.set_num_threads(threads)
    yield doc, argv, out, mp
    mp.undo()


def test_the_document_has_the_jax_tools_shape(small_doc, jax_record):
    doc, _, out, _ = small_doc
    with open(out) as f:
        assert json.load(f) == doc
    assert set(doc) == set(jax_record)
    assert set(doc["protocol"]) == set(jax_record["protocol"])
    assert (doc["M"], doc["bandwidth"], doc["cg_maxit"], doc["passes"],
            doc["ld_passes_per_iter"]) == (16384, 128, 20, 8, 22)
    # the keys every measured (unsupported) cell of the JAX record holds
    jax_cell = set.intersection(*[set(c) for c in jax_record["matvec_grid"]
                                  if "ms_per_pass" in c])
    jax_unsupported = set.intersection(*[set(c) for c in jax_record["matvec_grid"]
                                         if "unsupported" in c])
    cells = {(c["dtype"], c["B"], c["layout"]): c for c in doc["matvec_grid"]}
    assert len(cells) == len(doc["matvec_grid"]) == 16
    for (dtype, B, layout), cell in cells.items():
        if dtype != "bfloat16" and layout == "slab":
            assert set(cell) == jax_unsupported
            assert cell["unsupported"] == "quantized storage is diag-only"
            continue
        assert set(cell) == jax_cell | CELL_ADDED, cell
        assert cell["kernel"] == WRAPPER[dtype, layout] and cell["ms_per_pass"] > 0
        assert cell["iter_s_est"] == round(1e3 / (cell["ms_per_pass"] * 22), 3)
        assert cell["launches"] == {}   # the CPU runs the plain versions
    assert set(doc["fastest_cell"]) == set(jax_record["fastest_cell"])
    jax_step = set(next(iter(jax_record["step_by_dtype"].values())))
    assert set(doc["step_by_dtype"]) == set(ab_matrix.DTYPES)
    for dtype, row in doc["step_by_dtype"].items():
        assert set(row) == jax_step | STEP_ADDED, (dtype, row)
        assert row["B"] == 256 and row["iter_ms_median"] > 0 and row["iter_ms_median_host"] > 0
        assert row["align_stop"] > 0.95
    assert doc["solve_by_dtype"] == {}


def test_a_rerun_resumes_by_config(small_doc, monkeypatch):
    doc, argv, out, _ = small_doc

    def no_work(*a, **k):
        raise AssertionError("a resumed matrix measured a row again")

    monkeypatch.setattr(ab_matrix, "run_kernel_bench", no_work)
    monkeypatch.setattr(ab_matrix, "run_bench_child", no_work)
    again = ab_matrix.main(argv)
    assert again == doc
    # another config measures again: its rows never stand under this header
    with pytest.raises(AssertionError, match="measured a row again"):
        ab_matrix.main([a if a != "8" else "9" for a in argv])


def test_a_row_with_an_error_makes_the_tool_exit_non_zero(small_doc, tmp_path):
    """python -m sgvamp_torch.utils.ab_matrix exits 0 over a whole document
    (resumed: nothing is measured) and 1, after writing the row, when a
    step child fails (its layout knob refused by every operator)."""
    doc, argv, _, _ = small_doc
    assert ab_matrix.failures(doc) == []
    out = str(tmp_path / "ab.json")
    part = dict(doc, step_by_dtype={k: v for k, v in doc["step_by_dtype"].items()
                                    if k != "int4"})
    with open(out, "w") as f:
        json.dump(doc, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "sgvamp_torch.utils.ab_matrix"] + argv[:-1] + [out]
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(out, "w") as f:
        json.dump(part, f)
    env["SGVAMP_BENCH_LAYOUT"] = "bogus"
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr[-2000:]
    with open(out) as f:
        got = json.load(f)
    assert "layout must be" in got["step_by_dtype"]["int4"]["error"]
    assert [r["row"] for r in ab_matrix.failures(got)] == ["step int4"]


def test_out_is_required_and_the_card_is_the_default(monkeypatch):
    with pytest.raises(SystemExit):
        ab_matrix.main(["--platform", "cpu", "--size", "small"])
    with pytest.raises(SystemExit, match="--platform tpu"):
        ab_matrix.main(["--platform", "tpu", "--out", "x.json"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default platform runs")
    with pytest.raises(RuntimeError, match="--platform cpu"):
        ab_matrix.main(["--size", "small", "--out", "x.json"])
