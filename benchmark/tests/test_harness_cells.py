"""The benchmark's cells resolve to their files by name, and a cell, or a
model family, added as files and entries is found and run with no edit to
any file; no harness module names a family."""

import ast
import hashlib
import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from benchmark.harness import runner, spec
from benchmark.tests._tiny import tiny_cell, workloads

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


def _checkout(tmp_path) -> Path:
    """A copy of the benchmark's folder and BENCHMARK.json in tmp_path;
    its folder."""
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    return tmp_path / "benchmark"


def _add_cell(root, workload, config, traffic, limits_of):
    """Entries for ``workload`` (of ``config``, a file ``configs/<config>
    .json`` already written) in root's BENCHMARK.json, its limits those
    of the cell ``limits_of``, and the cell on the end-to-end metrics its
    route reports."""
    here = root / "benchmark"
    shutil.copy(here / "limits" / f"{limits_of}.json",
                here / "limits" / f"{workload}.json")
    b = json.loads((root / "BENCHMARK.json").read_text())
    if config not in {c["name"] for c in b["configs"]}:
        b["configs"].append({"name": config, "source": "x", "reduced": [],
                             "file": f"benchmark/configs/{config}.json",
                             "why": "test"})
    b["workloads"].append({"name": workload, "config": config,
                           "traffic": traffic, "chips": 1, "why": "test"})
    route = json.loads((here / "traffic" / f"{traffic}.json").read_text())[
        "route"]
    for m in b["end_to_end"]:
        if m["name"] == f"{route}_fps":
            m["workloads"].append(workload)
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def _run(workload, root):
    cell = tiny_cell(workload, root)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return cell, runner.execute(cell, 2 ** 31 + 23, 0.0, False, "cpu",
                                    time.perf_counter())
    finally:
        torch.set_num_threads(n)


def test_an_added_cell_is_found_without_editing_a_file(tmp_path):
    here = _checkout(tmp_path)
    before = _digest(here)
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


def test_an_added_family_runs_without_editing_a_file(tmp_path):
    """A configuration whose reference module exists only as a new file
    (here the S2GP reference under another name) is served and trained,
    each run correct, with every file that was there unchanged."""
    here = _checkout(tmp_path)
    before = _digest(here)
    shutil.copy(here / "reference" / "s2gp.py",
                here / "reference" / "kitti_twin.py")
    cfg = json.loads((here / "configs" / "s2gp.json").read_text())
    cfg["reference"] = "kitti_twin"
    (here / "configs" / "twin.json").write_text(json.dumps(cfg))
    _add_cell(tmp_path, "twin-serve-b128", "twin", "serve_u8_b128",
              "s2gp-serve-b128")
    _add_cell(tmp_path, "twin-train-b16", "twin", "train_b16",
              "s2gp-train-b16")
    for workload in ("twin-serve-b128", "twin-train-b16"):
        cell, r = _run(workload, tmp_path)
        assert Path(cell.reference.__file__) == (here / "reference"
                                                 / "kitti_twin.py")
        assert r["correct"], (workload, r["checks"])
        assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    after = _digest(here)
    assert all(after[p] == h for p, h in before.items())


@pytest.mark.parametrize("fault", (None, "state_unchanged"))
def test_g2sp_trains_from_its_configuration_alone(tmp_path, fault,
                                                  monkeypatch):
    """G2SP, which no cell trains, gets a train route in a copy of its
    configuration: the step's model and inputs come from its reference
    module, and the run is correct under the S2GP training cell's limits
    (and not correct where the step leaves its state unchanged)."""
    here = _checkout(tmp_path)
    cfg = json.loads((here / "configs" / "g2sp.json").read_text())
    cfg["routes"]["train"] = json.loads(
        (here / "configs" / "s2gp.json").read_text())["routes"]["train"]
    (here / "configs" / "g2sp-trainable.json").write_text(json.dumps(cfg))
    _add_cell(tmp_path, "g2sp-train-b16", "g2sp-trainable", "train_b16",
              "s2gp-train-b16")
    if fault:
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a: None)
    _, r = _run("g2sp-train-b16", tmp_path)
    assert r["correct"] == (fault is None), r["checks"]


def test_a_configuration_must_name_its_reference(tmp_path):
    here = _checkout(tmp_path)
    cfg = json.loads((here / "configs" / "s2gp.json").read_text())
    del cfg["reference"]
    (here / "configs" / "s2gp.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="names no reference module"):
        spec.resolve("s2gp-serve-b128", root=tmp_path)
    cfg["reference"] = "absent"
    (here / "configs" / "s2gp.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="there is no"):
        spec.resolve("s2gp-serve-b128", root=tmp_path)


def test_the_harness_names_no_family():
    """No harness module names a family, reads the direction or imports a
    family's reference module: of the references only ``vgg``, the
    backbone every family shares."""
    for path in sorted((spec.HERE / "harness").glob("*.py")):
        text = path.read_text()
        for word in ("S2GP", "G2SP", "direction"):
            assert word not in text, (path.name, word)
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            for name in names:
                parts = name.split(".")
                if parts[:2] == ["benchmark", "reference"]:
                    assert parts[2:3] == ["vgg"], (path.name, name)
