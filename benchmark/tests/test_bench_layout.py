"""BENCHMARK.json against the contract's shape, and a cell, configuration,
traffic mix and metric added as files and entries only."""

import json
import os
import re

import pytest

import bench_tiny
from benchmark import harness

ROOT = bench_tiny.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keys_and_names():
    s = spec()
    assert list(s) == ["command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"]
    assert s["paths"] == ["benchmark"] and 1 <= s["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in s[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in s["end_to_end"]} >= {"setup_s"}
    assert all(m["bound"] <= 0.25 for m in s["end_to_end"])
    for w in s["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = {m["name"] for m in s["end_to_end"]}
    assert all(m["moves"] in e2e for m in s["per_layer"])


@pytest.mark.parametrize("kind", ["configs", "traffic", "loops", "config_files", "limits",
                                  "metrics"])
def test_every_entry_has_its_file(kind):
    s = spec()
    here = os.path.join(ROOT, "benchmark")
    if kind == "configs":
        paths = [os.path.join(ROOT, c["file"]) for c in s["configs"]]
    elif kind == "traffic":
        paths = [os.path.join(here, "traffic", w["traffic"] + ".json") for w in s["workloads"]]
    elif kind == "loops":
        paths = [os.path.join(here, "loops", harness.cell(w["name"])["traffic"]["loop"]
                              + ".py") for w in s["workloads"]]
    elif kind == "config_files":
        paths = [os.path.join(ROOT, harness.load_json(os.path.join(ROOT, c["file"]))[k])
                 for c in s["configs"] for k in ("system", "reference", "reference_operator")]
    elif kind == "limits":
        paths = [os.path.join(here, "limits", w["name"] + ".json") for w in s["workloads"]]
    else:
        paths = [os.path.join(here, "metrics", m["name"] + ".py")
                 for m in s["end_to_end"] + s["per_layer"]]
    assert all(os.path.exists(p) for p in paths), [p for p in paths if not os.path.exists(p)]


def test_a_cell_added_as_files_is_found(tmp_path):
    root = bench_tiny.copy(str(tmp_path))
    # a new traffic mix and a new per-layer metric, as files and entries
    with open(os.path.join(root, "benchmark", "traffic", "fixed-cg.json")) as f:
        traffic = json.load(f)
    traffic["steps_per_fit"] = 3
    with open(os.path.join(root, "benchmark", "traffic", "short-fits.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(root, "benchmark", "metrics", "fits_done.py"), "w") as f:
        f.write("def read(r):\n    return r['counters']['fits']\n")
    name = bench_tiny.add_tiny(root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        s = json.load(f)
    s["workloads"][-1]["traffic"] = "short-fits"
    s["per_layer"].append({"name": "fits_done", "unit": "count", "better": "higher",
                           "source": "program_counter", "layer": "fused engine",
                           "moves": "iter_ms", "workloads": [name]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(s, f)
    c = harness.cell(name, root)
    assert c["config"]["M"] == 4096 and c["traffic"]["steps_per_fit"] == 3
    assert "fits_done" in [m["name"] for m in c["per_layer"]]
    assert harness.reader("fits_done", root)({"counters": {"fits": 7}}) == 7


# a second loop, added as a file: each fit runs as two calls of half its
# steps, the state handed from the first to the second
CHUNKED = """
def one_fit(sut, traffic, inputs, j):
    t = time.perf_counter()
    n = traffic["steps_per_fit"]
    u = inputs["probes"][j]
    state, a = sut.engine.run_scan(n // 2, state=sut.engine.init_state(), fixed_u=u[:n // 2])
    _, b = sut.engine.run_scan(n - n // 2, state=state, fixed_u=u[n // 2:])
    aux = type(a)(*[torch.cat([x, y]) for x, y in zip(a, b)])
    estimate = aux.xhat1[best_step(aux.gam1, aux.xhat1)].cpu().numpy()
    return Fit(probe_set=j, estimate=estimate, gam1=aux.gam1, steps=n,
               seconds=time.perf_counter() - t, cg_passes=aux.cg_passes)
"""

# a storage the benchmark does not hold yet, added as a file: the reference's
# operator over bfloat16 blocks (the port's bfloat16 operator rounds the
# band's blocks and each pass's lanes to bfloat16)
BF16_BAND = """
import torch

from benchmark.reference import int8_band


class Bf16Band(int8_band.Int8Band):
    def __init__(self, band, B, dtype):
        up = int8_band.upper_blocks(band, B)
        self.blocks = up.to(torch.bfloat16).to(dtype)
        self.nb, self.hb, self.B = up.shape[0], up.shape[1] - 1, B
        self.dtype = dtype


def operator(band, conf, dtype):
    return Bf16Band(band, conf["B"], dtype)
"""


def test_a_second_loop_and_storage_added_as_files_run(tmp_path):
    root = bench_tiny.copy(str(tmp_path))
    here = os.path.join(root, "benchmark")
    with open(os.path.join(here, "loops", "fits.py")) as f:
        base = f.read()
    start = base.index("def one_fit(")
    end = base.index("def warm_up(")
    with open(os.path.join(here, "loops", "chunked.py"), "w") as f:
        f.write(base[:start] + CHUNKED.lstrip() + "\n\n" + base[end:])
    with open(os.path.join(here, "reference", "bf16_band.py"), "w") as f:
        f.write(BF16_BAND)
    with open(os.path.join(here, "traffic", "fixed-cg.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(here, "traffic", "chunked-cg.json"), "w") as f:
        json.dump(dict(traffic, loop="chunked"), f)
    name = bench_tiny.add_tiny(root, traffic="chunked-cg", dtype="bfloat16",
                               reference_operator="benchmark/reference/bf16_band.py")
    c = harness.cell(name, root)
    assert c["traffic"]["loop"] == "chunked"
    assert c["config"]["operator"]["args"]["dtype"] == "bfloat16"
    out = harness.run_cell(name, 12, 1.0, False, device="cpu", root=root)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["xhat1_gap"]["value"] > 0


def test_an_unknown_workload_is_refused():
    with pytest.raises(harness.Refused):
        harness.cell("no-such-cell")
