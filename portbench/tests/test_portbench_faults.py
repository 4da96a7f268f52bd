"""The harness's decision without the look for a chip: small port models
served in process with the timed path broken underneath (the daemon
wrapper's faults: a token altered where it is produced, a PCM chunk
altered where it is sent) are judged by the same reference, worst-of and
limits as a run, and ``correct`` comes out false; the sound stream comes
out true. The control (the reference in float8 in the program's place)
reads several times what the program reads at this size; at the cells'
own size it fails their limits (``test_portbench_card.py``)."""

import json

import pytest
import torch

from portbench import spec
from portbench.run import decide, judge
from portbench.tests import test_portbench_reference as q3
from portbench.tests import test_portbench_reference_cosy as cosy
from portbench.tests.served import serve_small

CASES = {
    "qwen3_tts": (q3, "qwen3-tts-1.7b", 60, q3.KW),
    "cosyvoice2": (cosy, "cosyvoice2-0.5b", 100, None),
}


def _limits(conf_name: str) -> dict:
    path = spec.HERE / "configs" / f"{conf_name}.json"
    return json.loads(path.read_text())["check"]["limits"]


def _serve(family: str, fault):
    mod, _, max_tokens, kw = CASES[family]
    model = (mod._port_model(torch.bfloat16) if family == "qwen3_tts"
             else mod._port_model())
    return serve_small(model, mod.TEXTS, max_tokens, fault=fault, kwargs=kw)


@pytest.mark.parametrize("family", sorted(CASES))
@pytest.mark.parametrize("fault", [None, "token", "pcm"])
def test_a_broken_path_is_not_correct(family, fault):
    mod, conf_name, _, _ = CASES[family]
    items = _serve(family, fault)
    ref = spec.reference(family).make_reference(mod.TINY, mod.SEED, "cpu")
    correct, checks = decide(judge(items, ref), _limits(conf_name), 0)
    assert correct == (fault is None), checks


@pytest.mark.parametrize("family", sorted(CASES))
def test_the_control_reads_far_above_the_program(family):
    mod = CASES[family][0]
    items = _serve(family, None)
    fam = spec.reference(family)
    ref = fam.make_reference(mod.TINY, mod.SEED, "cpu")
    ctl = fam.make_reference(mod.TINY, mod.SEED, "cpu", "fp8")
    numbers = judge(items, ref, ctl)
    for k, floor in (("lm_gap", 1e-3), ("pcm_rmse", 1e-6)):
        assert numbers["ctl_" + k] > 3 * max(numbers[k], floor), numbers
