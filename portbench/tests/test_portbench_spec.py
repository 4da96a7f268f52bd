"""What BENCHMARK.json names is found by name, and a new metric needs only
a new file; the file keeps to the benchmark's contract."""

import json
import re

import pytest

from portbench import spec

ROOT = spec.HERE.parent
BENCH = spec.benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_each_cell_finds_its_config_traffic_and_readers(cell, trace):
    c = spec.cell(BENCH, cell, ROOT, trace)
    assert c.config["launch"] and c.traffic["loop"] in ("open", "closed")
    assert c.metrics, "a cell reports at least one metric of each kind"
    for m in c.metrics:
        assert callable(spec.reader(m.name))
    assert spec.reference(c.config["family"]).make_reference
    if not trace:
        names = {m.name for m in c.metrics}
        assert "setup_s" in names and len(names) >= 2


def test_a_new_metric_is_one_new_file(tmp_path):
    (tmp_path / "throwaway_metric.py").write_text(
        "def read(ctx):\n    return ctx.stats['x'] * 2\n")

    class Ctx:
        stats = {"x": 21}

    assert spec.reader("throwaway_metric", tmp_path)(Ctx()) == 42
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric", tmp_path)


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert all(k in conf for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    # every cell reports set-up, another end-to-end and a per-layer metric
    for cell in cells:
        assert len([m for m in BENCH["end_to_end"]
                    if cell in m.get("workloads", cells)]) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])


def test_the_run_refuses_without_a_card():
    """Without CUDA the run names what it lacks on standard error, exits
    non-zero and prints no result (skipped where a card is present)."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         BENCH["workloads"][0]["name"], "--seed", str(2**31 + 9),
         "--seconds", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr
