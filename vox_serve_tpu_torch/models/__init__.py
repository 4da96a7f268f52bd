"""Model registry of the port (vox_serve_tpu/models/__init__.py, holding the
families ported so far: ``dummy``, Qwen3-TTS (CustomVoice, Base and
VoiceDesign at 1.7B and 0.6B), Orpheus-3B and CSM-1B).

``load_model`` resolves the class, builds it on the given device, and
applies CLI sampling overrides onto the model's defaults.
"""

from __future__ import annotations

from typing import Optional

from .backbone import BackboneConfig  # noqa: F401
from .base import BaseLM, BaseLMWithDepth, PreprocessOutput  # noqa: F401

# name/pattern -> import path (lazy so that heavy models only load on use)
_LAZY_REGISTRY: dict[str, tuple[str, str]] = {}


def _register(patterns: list[str], module: str, cls_name: str) -> None:
    for p in patterns:
        _LAZY_REGISTRY[p.lower()] = (module, cls_name)


_register(["dummy"], "vox_serve_tpu_torch.models.dummy", "DummyLM")
_register(
    [
        "qwen3-tts", "qwen3-tts-1.7b", "qwen3-tts-0.6b",
        "qwen/qwen3-tts-12hz-1.7b-customvoice",
        "qwen/qwen3-tts-12hz-1.7b-base",
        "qwen/qwen3-tts-12hz-1.7b-voicedesign",
        "qwen/qwen3-tts-12hz-0.6b-customvoice",
        "qwen/qwen3-tts-12hz-0.6b-base",
        "qwen/qwen3-tts-12hz-0.6b-voicedesign",
    ],
    "vox_serve_tpu_torch.models.qwen3_tts", "Qwen3TTSLM")
_register(["orpheus", "canopylabs/orpheus-3b-0.1-ft"],
          "vox_serve_tpu_torch.models.orpheus", "OrpheusLM")
_register(["csm", "sesame/csm-1b"], "vox_serve_tpu_torch.models.csm", "CSMLM")


def available_models() -> list[str]:
    return sorted(_LAZY_REGISTRY)


def get_model_class(model_name: str) -> type[BaseLM]:
    key = model_name.lower()
    if key not in _LAZY_REGISTRY:
        raise ValueError(
            f"unknown model {model_name!r}; available: {available_models()}")
    module_name, cls_name = _LAZY_REGISTRY[key]
    import importlib

    return getattr(importlib.import_module(module_name), cls_name)


def resolve_device(name: str) -> "torch.device":
    """The serving device, chosen explicitly: asking for CUDA where CUDA is
    unavailable raises at start-up instead of running on the CPU."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but CUDA is unavailable "
                "(pass --device cpu to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


def load_model(
    model_name: str,
    device: str = "cuda",
    seed: int = 0,
    top_p: Optional[float] = None,
    top_k: Optional[int] = None,
    min_p: Optional[float] = None,
    temperature: Optional[float] = None,
    max_tokens: Optional[int] = None,
    repetition_penalty: Optional[float] = None,
    repetition_window: Optional[int] = None,
    cfg_scale: Optional[float] = None,
    greedy: bool = False,
    detokenize_interval: Optional[int] = None,
    **model_init_kwargs,
) -> BaseLM:
    cls = get_model_class(model_name)
    if detokenize_interval is not None:
        if cls.__name__ != "Qwen3TTSLM":
            raise ValueError(
                "--detokenize-interval is only supported for Qwen3-TTS")
        model_init_kwargs["detokenize_interval"] = detokenize_interval
    model = cls(model_name, device=resolve_device(device), seed=seed,
                **model_init_kwargs)

    base = model.default_sampling_config
    overrides = {k: v for k, v in [
        ("top_p", top_p), ("top_k", top_k), ("min_p", min_p),
        ("temperature", temperature), ("max_tokens", max_tokens),
        ("repetition_penalty", repetition_penalty),
        ("repetition_window", repetition_window), ("cfg_scale", cfg_scale),
    ] if v is not None}
    if greedy:
        overrides["greedy"] = True
    from ..utils import get_logger

    if overrides.get("cfg_scale") is not None:
        # as in the JAX package: the flag is plumbed, but no model applies
        # classifier-free guidance in compute
        get_logger("models").warning(
            "--cfg-scale is accepted for reference CLI parity but "
            "classifier-free guidance is not applied by any model (the "
            "reference does not apply it either)")
    model.sampling_config = base.replace(**overrides) if overrides else base
    get_logger("models").info("loaded model %s on %s with sampling %s",
                              model_name, device, model.sampling_config)
    return model
