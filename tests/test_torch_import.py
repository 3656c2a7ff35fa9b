"""The port imports without jax and pandas, and without CUDA, nvcc, Triton
or matplotlib (cli/plots.py and cli/vis_ld.py import it in main())."""

import os
import subprocess
import sys

import pytest

import sgvamp_torch

MODULES = [
    "sgvamp_torch",
    "sgvamp_torch.bench",
    "sgvamp_torch.cli",
    "sgvamp_torch.cli.main",
    "sgvamp_torch.cli.plink2np",
    "sgvamp_torch.cli.plots",
    "sgvamp_torch.cli.simulate",
    "sgvamp_torch.cli.vis_ld",
    "sgvamp_torch.config",
    "sgvamp_torch.core.cg",
    "sgvamp_torch.core.denoiser",
    "sgvamp_torch.core.operators",
    "sgvamp_torch.core.precond",
    "sgvamp_torch.core.prior",
    "sgvamp_torch.core.vamp",
    "sgvamp_torch.data.bed",
    "sgvamp_torch.data.harmonize",
    "sgvamp_torch.data.loaders",
    "sgvamp_torch.data.plink",
    "sgvamp_torch.data.simulate",
    "sgvamp_torch.dryrun",
    "sgvamp_torch.interop",
    "sgvamp_torch.io.checkpoint",
    "sgvamp_torch.io.writers",
    "sgvamp_torch.native",
    "sgvamp_torch.ops._build",
    "sgvamp_torch.ops.band_kernel",
    "sgvamp_torch.ops.membench",
    "sgvamp_torch.parallel",
    "sgvamp_torch.parallel.multihost",
    "sgvamp_torch.parallel.sharding",
    "sgvamp_torch.utils",
    "sgvamp_torch.utils.ab_matrix",
    "sgvamp_torch.utils.kernel_bench",
    "sgvamp_torch.utils.kernel_diag",
    "sgvamp_torch.utils.profiling",
]


def test_module_list_is_complete():
    root = os.path.dirname(sgvamp_torch.__file__)
    found = set()
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), os.path.dirname(root))
                mod = rel[:-3].replace(os.sep, ".")
                found.add(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    assert found - {"sgvamp_torch.core", "sgvamp_torch.data", "sgvamp_torch.io",
                    "sgvamp_torch.ops"} == set(MODULES)


def test_cli_main_imports_its_modules_without_jax():
    """cli.main imports the engine inside main(): a run on the CPU must leave
    jax, pandas, triton and the JAX package unimported too."""
    code = ("import sys\n"
            "from sgvamp_torch.cli import main\n"
            "try:\n"
            "    main.main(['--ld-files', 'none.npy', '--r-files', 'none.npy', '--N', '1',\n"
            "               '--M', '1', '--platform', 'cpu'])\n"
            "except FileNotFoundError:\n"
            "    pass\n"
            "assert 'sgvamp_torch.core.vamp' in sys.modules\n"
            "bad = [m for m in ('jax', 'sgvamp_tpu', 'triton', 'pandas') if m in sys.modules]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(sgvamp_torch.__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", MODULES)
def test_imports_without_jax(module):
    code = (f"import sys, {module}\n"
            "bad = [m for m in ('jax', 'sgvamp_tpu', 'triton', 'pandas', 'matplotlib')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(sgvamp_torch.__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
