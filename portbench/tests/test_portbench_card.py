"""On the card, at each cell's own size and load: a run prints the line
the benchmark's contract fixes; the control (the reference in float8 in
the program's place) fails the cell's limits on three seeds while the
program passes them; each fault of the served path makes ``correct``
false. Run on the chip from the repository root:
``python3 -m pytest portbench/tests/test_portbench_card.py -q -m cuda``
(about 25 minutes: one server start per seed)."""

import json
import subprocess
import sys

import pytest

from portbench import spec

ROOT = spec.HERE.parent
CELLS = [w["name"] for w in spec.benchmark(ROOT)["workloads"]]
SEEDS = "2147484501,2147484502,2147484503"

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _lines(args: list, timeout: int) -> list:
    out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_contract_line(card, cell):
    line = _lines(["portbench.run", "--workload", cell, "--seed",
                   "2147484500", "--seconds", "5", "--trace", "0"], 900)[-1]
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert line["device"]["platform"] == "gpu" and line["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes(card, cell):
    conf = spec.cell(spec.benchmark(ROOT), cell, ROOT, False).config
    limits = conf["check"]["limits"]
    for r in _lines(["portbench.control", "--workload", cell, "--seeds",
                     SEEDS, "--seconds", "5", "--control"], 1800):
        assert r["correct"], r
        assert any(r["ctl_" + k] > limits[k] for k in limits
                   if "ctl_" + k in r), r


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["token", "pcm"])
def test_a_fault_is_not_correct(card, cell, fault):
    for r in _lines(["portbench.control", "--workload", cell, "--seeds",
                     SEEDS.split(",")[0], "--seconds", "5", "--fault",
                     fault], 900):
        assert not r["correct"], r
