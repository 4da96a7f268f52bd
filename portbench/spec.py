"""What ``BENCHMARK.json`` names, found by name: cells, configurations
(``configs/<name>.json``), traffic mixes (``traffic/<name>.json``), metric
readers (``metrics/<name>.py``) and references
(``reference/<family>.py``). A later change adds a configuration, a mix or
a metric by adding its file and its entry; no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    entry: dict

    def applies_to(self, cell: str) -> bool:
        cells = self.entry.get("workloads")
        return cells is None or cell in cells


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: list


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"no BENCHMARK.json in {root}")
    return load_json(path)


def cell(bench: dict, name: str, root: Path, trace: bool) -> Cell:
    """The cell ``name`` with its configuration, traffic mix and the
    metrics it reports: its end-to-end metrics (``trace`` false) or its
    per-layer ones (true)."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    kind = "per_layer" if trace else "end_to_end"
    metrics = [Metric(m["name"], m["unit"], m) for m in bench[kind]]
    return Cell(name, int(entry["chips"]), load_json(root / conf["file"]),
                load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                [m for m in metrics if m.applies_to(name)])


def reader(name: str, directory: Path = HERE / "metrics"):
    """The ``read(ctx)`` function of metric ``name`` (its file
    ``metrics/<name>.py``; a name may hold dots)."""
    path = directory / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader {path} for metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(family: str):
    """The reference module of a model family (``reference/<family>.py``)."""
    return importlib.import_module(f"portbench.reference.{family}")
