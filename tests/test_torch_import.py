"""The port imports without jax, and without CUDA, nvcc or Triton."""

import os
import subprocess
import sys

import pytest

import sgvamp_torch

MODULES = [
    "sgvamp_torch",
    "sgvamp_torch.config",
    "sgvamp_torch.core.cg",
    "sgvamp_torch.core.denoiser",
    "sgvamp_torch.core.operators",
    "sgvamp_torch.core.prior",
    "sgvamp_torch.core.vamp",
    "sgvamp_torch.data.simulate",
    "sgvamp_torch.interop",
    "sgvamp_torch.io.writers",
    "sgvamp_torch.ops._build",
    "sgvamp_torch.ops.band_kernel",
    "sgvamp_torch.ops.membench",
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


@pytest.mark.parametrize("module", MODULES)
def test_imports_without_jax(module):
    code = (f"import sys, {module}\n"
            "bad = [m for m in ('jax', 'sgvamp_tpu', 'triton') if m in sys.modules]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(sgvamp_torch.__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
