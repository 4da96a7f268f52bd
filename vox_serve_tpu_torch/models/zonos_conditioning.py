"""Zonos prefix-conditioning stack, weight-exact vs the reference (a copy
of vox_serve_tpu/models/zonos_conditioning.py: the port imports nothing of
the JAX package, and this module is host numpy in both).

The reference builds the prefill prefix from a ``ZonosPrefixConditioner``
(model/zonos.py:454-494): an ordered list of conditioners — espeak phoneme
embeddings, a learned-uncond Passthrough for the 128-d speaker LDA vector,
Fourier feature encoders for emotion/fmax/pitch_std/speaking_rate, an Integer
embedder for language id — concatenated along the sequence axis, projected,
and LayerNorm'd. The conditioner list comes from the checkpoint's
``config.json``; ``DEFAULT_CONDITIONERS`` mirrors the published
Zyphra/Zonos-v0.1-transformer configuration and is used when no config is
available (random-init/debug runs).

Everything here runs host-side at preprocess time (numpy, float32):
conditioning is a per-request step, not part of the per-token hot loop.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# phoneme vocabulary (reference model/zonos.py ZonosUtils: 4 special ids +
# punctuation + letters + IPA symbols — the exact order defines embedding rows)
# ---------------------------------------------------------------------------
PAD_ID, UNK_ID, BOS_ID, EOS_ID = 0, 1, 2, 3
_PUNCTUATION = ';:,.!?¡¿—…"«»""() *~-/\\&'
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_LETTERS_IPA = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤ"
    "ʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)
SYMBOLS = [*_PUNCTUATION, *_LETTERS, *_LETTERS_IPA]
_SYMBOL_TO_ID = {s: i + 4 for i, s in enumerate(SYMBOLS)}
PHONEME_VOCAB = 4 + len(SYMBOLS)

SUPPORTED_LANGUAGES = [
    'af', 'am', 'an', 'ar', 'as', 'az', 'ba', 'bg', 'bn', 'bpy', 'bs', 'ca',
    'cmn', 'cs', 'cy', 'da', 'de', 'el', 'en-029', 'en-gb', 'en-gb-scotland',
    'en-gb-x-gbclan', 'en-gb-x-gbcwmd', 'en-gb-x-rp', 'en-us', 'eo', 'es',
    'es-419', 'et', 'eu', 'fa', 'fa-latn', 'fi', 'fr-be', 'fr-ch', 'fr-fr',
    'ga', 'gd', 'gn', 'grc', 'gu', 'hak', 'hi', 'hr', 'ht', 'hu', 'hy',
    'hyw', 'ia', 'id', 'is', 'it', 'ja', 'jbo', 'ka', 'kk', 'kl', 'kn', 'ko',
    'kok', 'ku', 'ky', 'la', 'lfn', 'lt', 'lv', 'mi', 'mk', 'ml', 'mr', 'ms',
    'mt', 'my', 'nb', 'nci', 'ne', 'nl', 'om', 'or', 'pa', 'pap', 'pl', 'pt',
    'pt-br', 'py', 'quc', 'ro', 'ru', 'ru-lv', 'sd', 'shn', 'si', 'sk', 'sl',
    'sq', 'sr', 'sv', 'sw', 'ta', 'te', 'tn', 'tr', 'tt', 'ur', 'uz', 'vi',
    'vi-vn-x-central', 'vi-vn-x-south', 'yue',
]
LANGUAGE_TO_ID = {lang: i for i, lang in enumerate(SUPPORTED_LANGUAGES)}

DEFAULT_CONDITIONERS = [
    {"type": "EspeakPhonemeConditioner", "name": "espeak"},
    {"type": "PassthroughConditioner", "name": "speaker", "cond_dim": 128,
     "uncond_type": "learned", "projection": "linear"},
    {"type": "FourierConditioner", "name": "emotion", "input_dim": 8,
     "uncond_type": "learned"},
    {"type": "FourierConditioner", "name": "fmax", "min_val": 0.0,
     "max_val": 24000.0},
    {"type": "FourierConditioner", "name": "pitch_std", "min_val": 0.0,
     "max_val": 400.0},
    {"type": "FourierConditioner", "name": "speaking_rate", "min_val": 0.0,
     "max_val": 40.0},
    {"type": "IntegerConditioner", "name": "language_id", "min_val": -1,
     "max_val": 126},
]

# reference make_cond_dict defaults (model/zonos.py:687-760)
DEFAULT_EMOTION = [0.3077, 0.0256, 0.0256, 0.0256, 0.0256, 0.0256,
                   0.2564, 0.3077]
DEFAULT_FMAX = 22050.0
DEFAULT_PITCH_STD = 20.0
DEFAULT_SPEAKING_RATE = 15.0


def tokenize_phonemes(phonemes: str) -> np.ndarray:
    """Phoneme string -> [BOS, symbol ids (UNK for unknown), EOS]."""
    ids = [BOS_ID] + [_SYMBOL_TO_ID.get(c, UNK_ID) for c in phonemes] + [EOS_ID]
    return np.asarray(ids, np.int64)


def phonemize(text: str, language: str = "en-us") -> str:
    """espeak via phonemizer when installed; a VOX_PHONEME_FIXTURE JSON map
    (text -> espeak IPA string) drives the same phoneme branch offline;
    otherwise pass the raw text through (letters/punctuation are all in the
    symbol table, so plain text degrades gracefully rather than failing)."""
    import os

    fixture = os.environ.get("VOX_PHONEME_FIXTURE")
    if fixture:
        import json

        try:
            with open(fixture) as f:
                table = json.load(f)
        except OSError:
            table = {}
        hit = table.get(text) or table.get(_normalize_numbers(text))
        if hit is not None:
            return hit
    try:  # pragma: no cover - espeak not present in CI
        from phonemizer.backend import EspeakBackend

        backend = EspeakBackend(language, preserve_punctuation=True,
                                with_stress=True,
                                punctuation_marks=_PUNCTUATION)
        return backend.phonemize([_normalize_numbers(text)], strip=True)[0]
    except Exception:
        return _normalize_numbers(text)


def _normalize_numbers(text: str) -> str:
    """Light number spell-out (the reference uses ``inflect``, absent here;
    digits must not hit the symbol table as UNKs)."""
    import re

    units = ["zero", "one", "two", "three", "four", "five", "six", "seven",
             "eight", "nine"]

    def spell(m):
        return " ".join(units[int(d)] for d in m.group(0))

    return re.sub(r"[0-9]+", spell, text)


# ---------------------------------------------------------------------------
# conditioner parameters
# ---------------------------------------------------------------------------
def load_conditioner_config(model_dir: "Path | str | None") -> list[dict]:
    """Parse ``prefix_conditioner`` from the checkpoint's config.json
    (reference ZonosConfig.from_dict, model/zonos.py:54-61)."""
    if model_dir is not None:
        cfg_path = Path(model_dir) / "config.json"
        if cfg_path.is_file():
            try:
                raw = json.loads(cfg_path.read_text())
                pc = raw.get("prefix_conditioner") or {}
                conds = pc.get("conditioners")
                if conds:
                    return conds
            except Exception:
                pass
    return DEFAULT_CONDITIONERS


def init_conditioner_params(conditioners: list[dict], output_dim: int,
                            rng: np.random.Generator) -> dict:
    """Random-init params in the reference's shapes (parity with
    model/zonos.py Conditioner.__init__ per type)."""
    params: dict = {"conditioners": []}
    for c in conditioners:
        p: dict = {}
        typ = c["type"]
        cond_dim = c.get("cond_dim", output_dim)
        if typ == "EspeakPhonemeConditioner":
            p["phoneme_embedder"] = rng.standard_normal(
                (PHONEME_VOCAB, output_dim)).astype(np.float32)
        elif typ == "FourierConditioner":
            in_dim = c.get("input_dim", 1)
            p["weight"] = (rng.standard_normal((output_dim // 2, in_dim))
                           * c.get("std", 1.0)).astype(np.float32)
        elif typ == "IntegerConditioner":
            n = c.get("max_val", 512) - c.get("min_val", 0) + 1
            p["int_embedder"] = rng.standard_normal(
                (n, output_dim)).astype(np.float32)
        if c.get("projection") == "linear":
            p["project"] = {
                "w": rng.standard_normal((output_dim, cond_dim)).astype(
                    np.float32) * 0.02,
                "b": np.zeros((output_dim,), np.float32)}
        elif c.get("projection") == "mlp":
            p["project"] = {
                "w1": rng.standard_normal((output_dim, cond_dim)).astype(
                    np.float32) * 0.02,
                "b1": np.zeros((output_dim,), np.float32),
                "w2": rng.standard_normal((output_dim, output_dim)).astype(
                    np.float32) * 0.02,
                "b2": np.zeros((output_dim,), np.float32)}
        if c.get("uncond_type") == "learned":
            p["uncond_vector"] = np.zeros((output_dim,), np.float32)
        params["conditioners"].append(p)
    params["norm"] = {"scale": np.ones((output_dim,), np.float32),
                      "bias": np.zeros((output_dim,), np.float32)}
    return params


def load_conditioner_params(sd: dict, conditioners: list[dict]) -> dict:
    """Map ``prefix_conditioner.*`` checkpoint entries onto the pytree."""
    def arr(name):
        return np.asarray(sd[name], np.float32)

    params: dict = {"conditioners": []}
    for i, c in enumerate(conditioners):
        pre = f"prefix_conditioner.conditioners.{i}"
        p: dict = {}
        typ = c["type"]
        if typ == "EspeakPhonemeConditioner":
            p["phoneme_embedder"] = arr(f"{pre}.phoneme_embedder.weight")
        elif typ == "FourierConditioner":
            p["weight"] = arr(f"{pre}.weight")
        elif typ == "IntegerConditioner":
            p["int_embedder"] = arr(f"{pre}.int_embedder.weight")
        if c.get("projection") == "linear":
            p["project"] = {"w": arr(f"{pre}.project.weight"),
                            "b": arr(f"{pre}.project.bias")}
        elif c.get("projection") == "mlp":
            p["project"] = {"w1": arr(f"{pre}.project.0.weight"),
                            "b1": arr(f"{pre}.project.0.bias"),
                            "w2": arr(f"{pre}.project.2.weight"),
                            "b2": arr(f"{pre}.project.2.bias")}
        if c.get("uncond_type") == "learned":
            p["uncond_vector"] = arr(f"{pre}.uncond_vector")
        params["conditioners"].append(p)
    params["norm"] = {"scale": arr("prefix_conditioner.norm.weight"),
                      "bias": arr("prefix_conditioner.norm.bias")}
    return params


# ---------------------------------------------------------------------------
# forward (host-side numpy)
# ---------------------------------------------------------------------------
def _project(p: dict, x: np.ndarray) -> np.ndarray:
    if "project" not in p:
        return x
    pr = p["project"]
    if "w" in pr:
        return x @ pr["w"].T + pr["b"]
    h = x @ pr["w1"].T + pr["b1"]
    h = h / (1.0 + np.exp(-h)) * 1.0  # SiLU
    return h @ pr["w2"].T + pr["b2"]


def apply_prefix_conditioner(params: dict, conditioners: list[dict],
                             cond: dict) -> np.ndarray:
    """cond values: espeak -> phoneme string; speaker -> (128,) or None;
    scalars/lists per conditioner name, or None to use a learned uncond
    vector. Returns the (T, H) prefix feature rows."""
    rows = []
    for c, p in zip(conditioners, params["conditioners"]):
        name, typ = c["name"], c["type"]
        val = cond.get(name)
        if val is None and "uncond_vector" in p:
            # learned uncond is NOT projected (reference Conditioner.forward,
            # model/zonos.py:229-232)
            rows.append(p["uncond_vector"][None, :])
            continue
        if typ == "EspeakPhonemeConditioner":
            ids = tokenize_phonemes(val if isinstance(val, str) else "")
            out = p["phoneme_embedder"][ids]
        elif typ == "FourierConditioner":
            x = np.atleast_2d(np.asarray(val, np.float32))  # (T, in_dim)
            lo = float(c.get("min_val", 0.0))
            hi = float(c.get("max_val", 1.0))
            x = (x - lo) / (hi - lo)
            f = 2.0 * np.pi * x @ p["weight"].T
            out = np.concatenate([np.cos(f), np.sin(f)], axis=-1)
        elif typ == "IntegerConditioner":
            idx = int(val) - int(c.get("min_val", 0))
            out = p["int_embedder"][np.asarray([idx])]
        elif typ == "PassthroughConditioner":
            out = np.atleast_2d(np.asarray(val, np.float32))
        else:
            raise ValueError(f"unknown conditioner type {typ}")
        rows.append(_project(p, out.astype(np.float32)))

    x = np.concatenate(rows, axis=0)  # (T, H)
    if params.get("norm") is not None:
        mu = x.mean(-1, keepdims=True)
        var = x.var(-1, keepdims=True)
        x = (x - mu) / np.sqrt(var + 1e-5)
        x = x * params["norm"]["scale"] + params["norm"]["bias"]
    return x


def make_cond_dict(text: str = "", language: str = "en-us",
                   speaker: np.ndarray | None = None,
                   emotion: list[float] | None = None,
                   fmax: float = DEFAULT_FMAX,
                   pitch_std: float = DEFAULT_PITCH_STD,
                   speaking_rate: float = DEFAULT_SPEAKING_RATE) -> dict:
    """Reference _make_cond_dict semantics (model/zonos.py:687-760):
    emotion normalized to sum 1; language -> integer id."""
    emo = np.asarray(emotion if emotion is not None else DEFAULT_EMOTION,
                     np.float32)
    emo = emo / emo.sum()
    return {
        "espeak": phonemize(text, language),
        "speaker": speaker,
        "emotion": emo[None, :],
        "fmax": [[fmax]],
        "pitch_std": [[pitch_std]],
        "speaking_rate": [[speaking_rate]],
        "language_id": LANGUAGE_TO_ID.get(language, LANGUAGE_TO_ID["en-us"]),
    }
