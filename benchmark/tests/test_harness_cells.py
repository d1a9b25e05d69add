"""The benchmark's cells resolve to their files by name, and a cell added
as files and entries is found with no edit to any file."""

import hashlib
import json
import re
import shutil

import pytest

from benchmark.harness import spec
from benchmark.tests._tiny import workloads

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    return spec.load_json(spec.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("workload", workloads())
def test_every_cell_resolves(workload):
    cell = spec.resolve(workload)
    assert cell.traffic["route"] in cell.config["routes"]
    assert cell.limits, "every cell compares at least one number"
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(spec.metric_reader(m["name"]))


def test_benchmark_json_keeps_its_format():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in b[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/") and (
            spec.ROOT / c["file"]).exists()
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
    assert 1 <= b["run_seconds"] <= 51


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_an_added_cell_is_found_without_editing_a_file(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    before = _digest(tmp_path / "benchmark")
    here = tmp_path / "benchmark"
    cfg = json.loads((here / "configs" / "s2gp.json").read_text())
    cfg["model"]["N_iters"] = 3
    (here / "configs" / "s2gp-nit3.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "serve_u8_b32.json")
                         .read_text())
    traffic["batch"] = 48
    (here / "traffic" / "serve_u8_b48.json").write_text(json.dumps(traffic))
    (here / "limits" / "s2gp-nit3-serve-b48.json").write_text(
        json.dumps({"pose_gap_max": 0.5}))
    (here / "metrics" / "batch_frames.serve.py").write_text(
        "def read(t):\n    return float(t.traffic['batch'])\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "s2gp-nit3", "source": "x",
                         "file": "benchmark/configs/s2gp-nit3.json",
                         "reduced": ["N_iters"], "why": "test"})
    b["workloads"].append({"name": "s2gp-nit3-serve-b48",
                           "config": "s2gp-nit3", "traffic": "serve_u8_b48",
                           "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "batch_frames.serve", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "serving API", "moves": "serve_fps",
                           "workloads": ["s2gp-nit3-serve-b48"]})
    for m in b["end_to_end"]:
        if m["name"] == "serve_fps":
            m["workloads"].append("s2gp-nit3-serve-b48")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.resolve("s2gp-nit3-serve-b48", root=tmp_path)
    assert cell.config["model"]["N_iters"] == 3
    assert cell.traffic["batch"] == 48
    assert cell.limits == {"pose_gap_max": 0.5}
    assert [m["name"] for m in cell.per_layer] == ["batch_frames.serve"]
    read = spec.metric_reader("batch_frames.serve", root=tmp_path)

    class T:
        traffic = cell.traffic
    assert read(T()) == 48.0
    after = _digest(here)
    assert all(after[p] == h for p, h in before.items())
