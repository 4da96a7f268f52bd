"""The benchmark's pieces for CosyVoice2's detokenizer, on the CPU:

* ``portbench/flow_work.py`` counts, for one window, exactly the FLOPs
  ``torch.utils.flop_counter.FlopCounterMode`` sees in the reference's
  ``flow_forward`` and ``hift_decode`` at the ``TINY`` size of
  ``portbench/tests/test_portbench_reference_cosy.py``: every ``mm``,
  ``bmm`` and ``convolution`` (the transposed ones too). Neither counts
  the ops the counter does not see: the STFT and iSTFT (``torch.fft``),
  the overlap-add (``F.fold``), the embedding lookup, the elementwise ops,
  norms and softmax;
* the TF32 control's rounding (``reference/tf32.py``) on hand-built
  values: a mantissa on TF32's rounding boundary rounds away from zero,
  one just below it rounds down, a value TF32 holds is unchanged;
* the four readers of the cell ``cosyvoice2.closed-8`` on a synthetic
  stats and trace context, and on one from a program without the
  counters and spans, where each returns None and none raises.
"""

import json
import types
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flow_work, spec
from portbench.reference import cosyvoice2 as ref
from portbench.reference.common import Precision
from portbench.reference.tf32 import TF32, round_tf32
from portbench.tests.test_portbench_reference_cosy import TINY

ROOT = Path(__file__).resolve().parents[1]
CELL = "cosyvoice2.closed-8"
NEW = ("flow_device_ms.closed", "hift_device_ms.closed",
       "detok_pad_pct.closed", "detok_mfu_pct.closed")


@pytest.fixture(scope="module")
def weights():
    return ref.make_weights(TINY, 5, "cpu")


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("length", [28, 53, 103])
def test_flow_count_matches_the_flop_counter(weights, length):
    f = TINY["flow"]
    T = flow_work.FLOW_CTX + length
    g = torch.Generator().manual_seed(length)
    tokens = torch.randint(0, f["vocab_size"], (1, T), generator=g)
    valid = torch.ones((1, T), dtype=torch.bool)
    counted = _counted(lambda: ref.flow_forward(
        weights["flow"], f, tokens, valid, weights["noise"][length],
        Precision()))
    assert flow_work.flow_flops(f, T) == counted


@pytest.mark.parametrize("length", [28, 53, 103])
def test_hift_count_matches_the_flop_counter(weights, length):
    h = TINY["hift"]
    frames = (flow_work.HIFT_CTX_FRAMES
              + (length - flow_work.OVERLAP) * TINY["flow"]["token_mel_ratio"])
    up = 8 * 5 * 3 * h["hop_len"]
    mel = torch.randn((1, h["in_channels"], frames),
                      generator=torch.Generator().manual_seed(length))
    counted = _counted(lambda: ref.hift_decode(
        weights["hift"], h, mel,
        torch.zeros((1, 1, flow_work.HIFT_CTX_FRAMES * up)), Precision()))
    assert flow_work.hift_flops(h, frames) == counted
    assert flow_work.window_flops(TINY, length) == (
        flow_work.flow_flops(TINY["flow"], flow_work.FLOW_CTX + length)
        + flow_work.hift_flops(h, frames))


def test_tf32_rounding_on_hand_built_values():
    bits = torch.tensor([
        0x3F800000,   # 1.0: held exactly
        0x3F801000,   # 1 + 2^-11: half of TF32's last bit, a tie
        0x3F800FFF,   # just below the tie
        0x3F802000,   # 1 + 2^-10: held exactly
        0xBF801000 - 2**32,  # -(1 + 2^-11): the tie, negative
        0x3FFFF000,   # 2 - 2^-11: the tie that carries into the exponent
        0x40490FDB,   # pi
    ], dtype=torch.int32)
    got = round_tf32(bits.view(torch.float32)).view(torch.int32).tolist()
    assert got == [0x3F800000, 0x3F802000, 0x3F800000, 0x3F802000,
                   0xBF802000 - 2**32, 0x40000000, 0x40490000]
    x = torch.tensor([1.5, -0.375, 3.0e-3], dtype=torch.float32)
    held = round_tf32(x)
    assert torch.equal(round_tf32(held), held)
    assert TF32().name == "tf32"
    assert torch.equal(TF32().q(x), held)


def _ctx(stats: dict, trace: dict, model: dict):
    return types.SimpleNamespace(stats=stats, trace=trace, model=model)


@pytest.fixture(scope="module")
def cell():
    return spec.cell(spec.benchmark(ROOT), CELL, ROOT, True)


def test_the_cell_reports_the_new_metrics(cell):
    names = [m.name for m in cell.metrics]
    assert set(NEW) <= set(names)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL] and m["moves"] == "ttfa_p50_ms"


def test_readers_on_a_synthetic_context(cell):
    model = cell.config["model"]
    stats = {
        "phase_stats": {"detok.flow": [0.5, 4], "detok.hift": [0.1, 4],
                        "detok.windows": [6.0, 4], "detok.rows": [8.0, 4],
                        "round": [2.0, 40]},
        "requests": [{"detok_windows": [[0, 28], [25, 53]]},
                     {"detok_windows": [[0, 28]]}],
    }
    trace = {"ranges": [
        {"name": "pb_detok:2", "device_s": 0.3, "k1": 0.0, "k3": 0.0},
        {"name": "pb_detok:1", "device_s": 0.1, "k1": 0.0, "k3": 0.0},
        {"name": "pb_decode:8:800", "device_s": 0.05, "k1": 0.01,
         "k3": 0.0}]}
    ctx = _ctx(stats, trace, model)
    read = {n: spec.reader(n) for n in NEW}
    assert read["flow_device_ms.closed"](ctx) == pytest.approx(125.0)
    assert read["hift_device_ms.closed"](ctx) == pytest.approx(25.0)
    assert read["detok_pad_pct.closed"](ctx) == pytest.approx(25.0)
    per_window = (2 * flow_work.window_flops(model, 28)
                  + flow_work.window_flops(model, 53)) / 3
    want = 100.0 * 3 * per_window / (0.4 * 989e12)
    assert read["detok_mfu_pct.closed"](ctx) == pytest.approx(want)
    assert 0 < want < 100


def test_readers_on_a_program_without_the_counters(cell):
    """The parent's stats: no detok.rows, no device-timed parts, and a
    trace without detokenize calls: every reader returns None."""
    stats = {"phase_stats": {"detok.windows": [6.0, 4], "round": [2.0, 40]},
             "requests": []}
    trace = {"ranges": [{"name": "pb_decode:8:800", "device_s": 0.05,
                         "k1": 0.01, "k3": 0.0}]}
    ctx = _ctx(stats, trace, cell.config["model"])
    for name in NEW:
        assert spec.reader(name)(ctx) is None, name
