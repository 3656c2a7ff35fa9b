"""A temporary copy of the benchmark's data files with one cell added as
files and entries only: configuration "tiny" (the first configuration's
settings at M=4096, K=2), its cell under the first cell's traffic, and its
limits (the first cell's, but gam1's: see add_tiny). The harness's code
stays where it is; run_cell reads the copy through its `root` argument."""

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = "tiny.fixed-cg"


def copy(dst: str) -> str:
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def add_tiny(root: str, M: int = 4096, K: int = 2, traffic: str = None, dtype: str = None,
             reference_operator: str = None) -> str:
    """Adds the tiny cell to the copy at root, under the first cell's
    traffic or `traffic`, with the first configuration's storage or
    `dtype` and its reference operator or `reference_operator`; returns
    its name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    first = spec["workloads"][0]
    conf_entry = next(c for c in spec["configs"] if c["name"] == first["config"])
    with open(os.path.join(root, conf_entry["file"])) as f:
        conf = json.load(f)
    conf.update(name="tiny", M=M, K=K)
    if dtype is not None:
        conf["operator"]["args"]["dtype"] = dtype
    if reference_operator is not None:
        conf["reference_operator"] = reference_operator
    with open(os.path.join(root, "benchmark", "configs", "tiny.json"), "w") as f:
        json.dump(conf, f)
    spec["configs"].append({"name": "tiny", "source": conf_entry["source"],
                            "file": "benchmark/configs/tiny.json", "reduced": ["M", "K"],
                            "why": "tests on the CPU"})
    spec["workloads"].append({"name": TINY, "config": "tiny",
                              "traffic": traffic or first["traffic"],
                              "chips": 1, "why": "tests on the CPU"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(TINY)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    # the first cell's limits, but gam1's: at M=4096 Hutchinson's estimate
    # over few markers moves gam1 more, 2.2e-8 to 4.0e-3 over the first four
    # steps on the CPU (8 seeds), against 9.0e-3 to 3.7e-2 for the int4 path
    with open(os.path.join(root, "benchmark", "limits", first["name"] + ".json")) as f:
        limits = json.load(f)
    limits["gam1_gap"] = 0.02
    with open(os.path.join(root, "benchmark", "limits", TINY + ".json"), "w") as f:
        json.dump(limits, f)
    return TINY
