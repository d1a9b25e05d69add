"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cell's configuration and traffic; each lives in a
file of its own under this folder (``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<workload>.json``), and each
per-layer metric is a reader ``metrics/<name>.py`` (or one
``metrics/<base>.py`` for every ``<base>.<suffix>``).  A configuration
names its model family's plain reference, ``reference/<name>.py``, which
answers everything that differs by family.  Adding a cell, or a family,
adds files and entries; no code here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]       # the benchmark's folder
ROOT = HERE.parent                                # the checkout
CACHE = ROOT / "build" / "benchmark_cache"


def use_checkout_caches():
    """Keep every compiled artifact at a fixed path inside the checkout
    (nvcc's extensions, Triton's kernels), and keep ``transformers`` from
    loading JAX; called before torch is imported."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    limits: dict          # limits/<workload>.json
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list
    reference: object     # reference/<config's "reference">.py, loaded

    @property
    def route(self) -> dict:
        """The configuration's route that the traffic drives (serve or
        train): its model settings, numerics and sampler."""
        return self.config["routes"][self.traffic["route"]]


def _reports(metric: dict, workload: str, e2e_names) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json, with its files
    read; raises KeyError for a workload it does not hold."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    here = root / HERE.name
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    config_file = configs[w["config"]]["file"]
    config = load_json(root / config_file)
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(here / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per_layer,
                reference=reference_module(config, config_file, root))


def reference_module(config: dict, config_file: str, root: Path = ROOT):
    """The module ``reference/<name>.py`` that ``config`` names under
    ``"reference"``; raises ValueError where it names none, or no such
    file."""
    name = config.get("reference")
    if not isinstance(name, str) or not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise ValueError(f"{config_file} names no reference module: it "
                         f"needs \"reference\": \"<name>\" of a file "
                         f"{HERE.name}/reference/<name>.py")
    path = root / HERE.name / "reference" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"{config_file} names the reference {name!r}, "
                         f"but there is no {path.relative_to(root)}")
    return _load(f"benchmark_reference_{name}", path)


def _load(module_name: str, path: Path):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py`` or, where there is
    none, of ``metrics/<base>.py``, ``base`` the name up to its first dot:
    one reader serves ``mfu.serve`` and ``mfu.train``."""
    folder = root / HERE.name / "metrics"
    path = folder / f"{name}.py"
    if not path.exists():
        path = folder / f"{name.split('.', 1)[0]}.py"
    return _load(f"benchmark_metric_{name.replace('.', '_')}", path).read
