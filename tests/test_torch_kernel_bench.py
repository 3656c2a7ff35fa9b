"""The port's kernel A/B tool (python -m sgvamp_torch.utils.kernel_bench)
on the CPU, at a small M: one JSON line for every variant of the grammar,
each routed to the wrapper the variant names, and an error line for a
variant that the JAX tool (tools/kernel_bench.py) refuses too.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import sgvamp_torch
from sgvamp_torch.utils import kernel_bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(sgvamp_torch.__file__)))
SMALL = ["--M", "1000", "--bandwidth", "100", "--B", "64", "--passes", "2"]   # nb=16, hb=2

# variant -> the wrapper that must run it (float32 blocks)
GRAMMAR = {
    "einsum": "torch.einsum",
    "resident": "sym_band_matvec_resident", "resident8": "sym_band_matvec_resident",
    "streamed": "sym_band_matvec", "streamed4": "sym_band_matvec",
    "window": "sym_band_matvec_window", "window2": "sym_band_matvec_window",
    "slab": "sym_slab_matvec_resident",            # mode "auto": it fits
    "slabstreamed": "sym_slab_matvec_streamed", "slabstreamed16": "sym_slab_matvec_streamed",
    "slabresident": "sym_slab_matvec_resident", "slabresident4": "sym_slab_matvec_resident",
    "slabwindow": "sym_slab_matvec_resident",      # window is a diag-layout flag
    "8": "sym_band_matvec_resident",               # a bare G: diag, mode "auto"
}
REFUSED = {"resident3": "rows_per_step=3 must divide nb=16",
           "slabresident5": "rows_per_step=5 must divide nb=16",
           "streamed1": "rows_per_step=1 must divide nb=16 and be >= hb=2",
           "slabstreamed3": "rows_per_step=3 must divide nb=16 and be >= hb=2"}


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_line_for_every_variant_of_the_grammar(capsys, dtype):
    rows = kernel_bench.main(SMALL + ["--dtype", dtype, "--platform", "cpu",
                                      "--variants", ",".join(GRAMMAR)])
    printed = _lines(capsys)
    assert printed == rows and [r["variant"] for r in rows] == list(GRAMMAR)
    for row in rows:
        assert "error" not in row, row
        assert row["kernel"] == GRAMMAR[row["variant"]], row
        assert row["device"] == "cpu" and row["dtype"] == dtype
        assert (row["M"], row["K"], row["S"], row["B"], row["bandwidth"]) == (1000, 1, 2, 64, 100)
        assert row["ms_per_pass"] >= 0 and np.isfinite(row["GBps"])


def test_cg_option_and_cohorts(capsys):
    rows = kernel_bench.main(SMALL + ["--dtype", "float32", "--platform", "cpu", "--K", "2",
                                      "--S", "1", "--cg", "--variants", "slabstreamed,einsum"])
    assert [r["variant"] for r in rows] == ["slabstreamed", "einsum"]
    for row in rows:
        assert "error" not in row and row["K"] == 2 and row["S"] == 1
        assert row["ms_per_cg_iter"] > 0 and "vector_overhead_ms" in row


def test_refused_variants_print_an_error_line_and_the_rest_runs(capsys):
    rows = kernel_bench.main(SMALL + ["--dtype", "float32", "--platform", "cpu", "--variants",
                                      ",".join(REFUSED) + ",memread,streamed"])
    by = {r["variant"]: r for r in rows}
    for variant, message in REFUSED.items():
        assert by[variant]["error"] == f"ValueError: {message}"
    # the read probe has no CPU version to time: no number under its name
    assert "no read-probe kernel for device cpu" in by["memread"]["error"]
    assert "ms_per_pass" in by["streamed"]
    # quantized storage: streamed only, diag only
    rows = kernel_bench.main(SMALL + ["--dtype", "int8", "--platform", "cpu", "--variants",
                                      "streamed,resident,slab"])
    assert rows[0]["kernel"] == "sym_band_matvec_int8" and "error" not in rows[0]
    assert "no resident kernel" in rows[1]["error"]
    assert "diag layout only" in rows[2]["error"]


def test_the_jax_tool_refuses_the_same_variants():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "kernel_bench.py"), *SMALL,
         "--dtype", "float32", "--platform", "cpu", "--variants", ",".join(REFUSED)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    rows = {r["variant"]: r for r in map(json.loads, proc.stdout.splitlines())}
    for variant, message in REFUSED.items():
        assert rows[variant]["error"] == f"ValueError: {message}", rows[variant]


def test_module_entry_point_runs_without_jax():
    code = ("import sys\n"
            "from sgvamp_torch.utils import kernel_bench\n"
            f"rows = kernel_bench.main({SMALL + ['--dtype', 'float32', '--platform', 'cpu', '--variants', 'slab,einsum']!r})\n"
            "assert len(rows) == 2 and not any('error' in r for r in rows), rows\n"
            "bad = [m for m in ('jax', 'sgvamp_tpu', 'triton', 'pandas') if m in sys.modules]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    proc = subprocess.run([sys.executable, "-m", "sgvamp_torch.utils.kernel_bench", *SMALL,
                           "--dtype", "float32", "--platform", "cpu", "--variants", "window"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1])["kernel"] == "sym_band_matvec_window"


def test_default_platform_is_the_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default platform runs")
    with pytest.raises(RuntimeError, match="--platform cpu"):
        kernel_bench.main(SMALL + ["--variants", "streamed"])
    with pytest.raises(SystemExit, match="--platform tpu"):
        kernel_bench.main(SMALL + ["--platform", "tpu"])
