"""Port parity, the Zonos prefix conditioner
(vox_serve_tpu_torch/models/zonos_conditioning.py, a host-numpy copy)
against the JAX package's module, at a 64-wide output:

* ``tokenize_phonemes`` on IPA, plain text, digits and symbols outside
  the table (UNK); ``phonemize``'s fixture branch (``VOX_PHONEME_FIXTURE``,
  the IPA of tests/fixtures/zonos_phonemes.json) and its pass-through
  (numbers spelled out) equal to JAX's;
* ``init_conditioner_params`` from ``default_rng(17)`` array for array
  equal to JAX's, for the published conditioner list and one with an MLP
  speaker projection;
* ``make_cond_dict`` + ``apply_prefix_conditioner`` within 1e-6 of JAX's
  (both float32 numpy) for the default request, an uncond speaker, a
  given speaker vector, an emotion, a language and explicit fmax /
  pitch_std / speaking_rate, over parameters with non-zero uncond rows and
  a non-trivial final LayerNorm;
* ``load_conditioner_params`` and ``load_conditioner_config`` on the
  exporter's ``prefix_conditioner.*`` safetensors and ``config.json``,
  equal to JAX's loaders and to the source.
"""

import copy
import json
import os

import numpy as np
import pytest

import synthetic_checkpoints as synth
from vox_serve_tpu import weights as jweights
from vox_serve_tpu.models import zonos_conditioning as jc
from vox_serve_tpu_torch import weights
from vox_serve_tpu_torch.models import zonos_conditioning as tc

H = 64
TOL = 1e-6
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "zonos_phonemes.json")
#: the published list with the speaker projected by an MLP instead
MLP_CONDITIONERS = copy.deepcopy(tc.DEFAULT_CONDITIONERS)
MLP_CONDITIONERS[1]["projection"] = "mlp"


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, np.asarray(tree)


def assert_equal_trees(got, ref):
    g, r = dict(_leaves(got)), dict(_leaves(ref))
    assert set(g) == set(r), set(g) ^ set(r)
    for k in r:
        assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
        np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("text", [
    "ˈhɛloʊ wˈɜːld, it's mˈiː!", "Plain text, with CAPS.", "x 12 y",
    "emoji ☃ and tab\t", ""])
def test_tokenize_phonemes_matches_jax(text):
    np.testing.assert_array_equal(tc.tokenize_phonemes(text),
                                  jc.tokenize_phonemes(text))
    assert tc.PHONEME_VOCAB == jc.PHONEME_VOCAB
    assert tc.SYMBOLS == jc.SYMBOLS


def test_phonemize_fixture_branch(monkeypatch):
    monkeypatch.setenv("VOX_PHONEME_FIXTURE", FIXTURE)
    with open(FIXTURE) as f:
        table = json.load(f)
    for text, ipa in table.items():
        out = tc.phonemize(text)
        assert out == ipa == jc.phonemize(text) and out != text
        assert tc.UNK_ID not in tc.tokenize_phonemes(out)[1:-1]


@pytest.mark.parametrize("text", ["I have 42 cats.", "No digits here",
                                  "Hello world."])
def test_phonemize_pass_through(monkeypatch, text):
    """Without espeak (absent on both machines) and outside the fixture,
    the text passes through with its digits spelled out."""
    monkeypatch.setenv("VOX_PHONEME_FIXTURE", "/nonexistent/fixture.json")
    out = tc.phonemize(text, "en-us")
    assert out == jc.phonemize(text, "en-us")
    assert not any(ch.isdigit() for ch in out)
    if "42" in text:
        assert "four two" in out


@pytest.mark.parametrize("conds", [tc.DEFAULT_CONDITIONERS,
                                   MLP_CONDITIONERS],
                         ids=["published", "mlp_speaker"])
def test_init_matches_jax(conds):
    got = tc.init_conditioner_params(conds, H, np.random.default_rng(17))
    ref = jc.init_conditioner_params(conds, H, np.random.default_rng(17))
    assert_equal_trees(got, ref)
    assert tc.DEFAULT_CONDITIONERS == jc.DEFAULT_CONDITIONERS
    assert tc.SUPPORTED_LANGUAGES == jc.SUPPORTED_LANGUAGES


def _params(conds=tc.DEFAULT_CONDITIONERS, seed=3):
    """Random init with every learned uncond row, projection bias and the
    final LayerNorm drawn (zeros and ones hide mistakes)."""
    p = tc.init_conditioner_params(conds, H, np.random.default_rng(17))
    rng = np.random.default_rng(seed)
    for c in p["conditioners"]:
        if "uncond_vector" in c:
            c["uncond_vector"] = rng.standard_normal(H).astype(np.float32)
        for k, v in c.get("project", {}).items():
            if k.startswith("b"):
                c["project"][k] = 0.1 * rng.standard_normal(
                    v.shape).astype(np.float32)
    p["norm"] = {"scale": (1 + 0.2 * rng.standard_normal(H)).astype(
        np.float32), "bias": (0.2 * rng.standard_normal(H)).astype(
            np.float32)}
    return p


SPEAKER = np.random.default_rng(4).standard_normal(128).astype(np.float32)
CASES = {
    "default": {},
    "uncond_speaker": {"speaker": None},
    "speaker": {"speaker": SPEAKER},
    "emotion": {"emotion": [1, 0, 0, 0, 0, 0, 0.5, 0.2]},
    "language": {"language": "fr-fr"},
    "unknown_language": {"language": "english"},
    "scalars": {"fmax": 24000.0, "pitch_std": 45.0, "speaking_rate": 10.0},
}


@pytest.mark.parametrize("conds", [tc.DEFAULT_CONDITIONERS,
                                   MLP_CONDITIONERS],
                         ids=["published", "mlp_speaker"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefix_rows_match_jax(monkeypatch, conds, case):
    monkeypatch.setenv("VOX_PHONEME_FIXTURE", FIXTURE)
    p = _params(conds)
    kw = CASES[case]
    text = "Hello world."
    got_cond = tc.make_cond_dict(text, **kw)
    ref_cond = jc.make_cond_dict(text, **kw)
    assert got_cond.keys() == ref_cond.keys()
    got = tc.apply_prefix_conditioner(p, conds, got_cond)
    ref = jc.apply_prefix_conditioner(p, conds, ref_cond)
    # the phoneme rows (BOS + 14 IPA symbols + EOS) and six more
    assert got.shape == ref.shape == (16 + 6, H)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    if case == "uncond_speaker":
        # the learned uncond row is not projected: the speaker row differs
        # from a projected zero vector's
        spk = tc.apply_prefix_conditioner(
            p, conds, tc.make_cond_dict(text, speaker=np.zeros(128)))
        assert not np.allclose(got[16], spk[16])


@pytest.mark.parametrize("conds", [tc.DEFAULT_CONDITIONERS,
                                   MLP_CONDITIONERS],
                         ids=["published", "mlp_speaker"])
def test_loaders_on_the_exporters_files(tmp_path, conds):
    src = _params(conds, seed=8)
    weights.save_safetensors(synth.export_zonos_conditioner(src),
                             tmp_path / "model.safetensors")
    (tmp_path / "config.json").write_text(json.dumps(
        {"prefix_conditioner": {"conditioners": conds}}))
    tconds = tc.load_conditioner_config(tmp_path)
    jconds = jc.load_conditioner_config(tmp_path)
    assert tconds == jconds == conds
    tstate = {k: v.numpy() for k, v in
              weights.load_safetensors_state(tmp_path).items()}
    got = tc.load_conditioner_params(tstate, tconds)
    ref = jc.load_conditioner_params(
        jweights.load_safetensors_state(tmp_path), jconds)
    assert_equal_trees(got, ref)
    assert_equal_trees(got, src)
    # no config.json (or one without the list): the published default
    (tmp_path / "config.json").write_text("{}")
    assert (tc.load_conditioner_config(tmp_path)
            == jc.load_conditioner_config(tmp_path)
            == tc.DEFAULT_CONDITIONERS)
    assert tc.load_conditioner_config(None) == tc.DEFAULT_CONDITIONERS
