"""Which kernels of two builds of a library have the same machine code.

    python -m sgvamp_torch.utils.sass_diff PARENT.so CHANGE.so

Reads each build's SASS with the CUDA toolkit's cuobjdump, keeps each
kernel's instructions without their addresses and encodings, and compares
the two builds kernel by kernel under the demangled name. Trailing `false`
template arguments are dropped from the name, so that a kernel that gained
flags which are off (the streamed kernels' TILED, the int8 kernel's and
the folds' LANES) is held against its instance from before. Prints how many kernels are the same, how many
differ, and how many are in one build only, then the names of those that
differ. Needs the CUDA toolkit (cuobjdump and cu++filt under torch's
CUDA_HOME or on PATH); run it where the libraries were built
(sgvamp_torch/build/ after `python -c "from sgvamp_torch.ops import
_build; _build.build()"`).
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import sys


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME, "bin", name) if CUDA_HOME else None
    found = path if path and os.path.exists(path) else shutil.which(name)
    if found is None:
        raise SystemExit(f"{name} not found: sass_diff needs the CUDA toolkit")
    return found


def kernels(lib: str) -> dict:
    """{kernel name: (instruction count, hash of the instructions)} of lib."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    code, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            code[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
        if name and m:
            code[name].append(m.group(1).strip())
    names = list(code)
    plain = subprocess.run([_tool("cu++filt")], input="\n".join(names), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    res = {}
    for mangled, demangled in zip(names, plain):
        m = re.match(r"(?:void )?(.*?>)\(", demangled)
        key = re.sub(r"\(anonymous namespace\)::|<unnamed>::|sgv::", "", m[1] if m else demangled)
        while (plain := re.sub(r", \(bool\)0>$|, false>$", ">", key)) != key:
            key = plain
        key = key.replace("(bool)1", "true")
        body = code[mangled]
        res[key] = (len(body), hashlib.md5("\n".join(body).encode()).hexdigest()[:12])
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit("usage: python -m sgvamp_torch.utils.sass_diff PARENT.so CHANGE.so")
    a, b = kernels(argv[0]), kernels(argv[1])
    same = sorted(k for k in a if k in b and a[k] == b[k])
    diff = sorted(k for k in a if k in b and a[k] != b[k])
    print(f"{os.path.basename(argv[1])}: {len(same)} kernels with the parent's SASS, "
          f"{len(diff)} with other SASS, {len(set(a) - set(b))} only in the parent, "
          f"{len(set(b) - set(a))} only here")
    for k in diff:
        print(f"  differs: {k} parent {a[k][0]} instructions, here {b[k][0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
