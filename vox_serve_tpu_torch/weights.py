"""Tokenizers while checkpoint assets are absent (port of the offline branch
of vox_serve_tpu/weights.py).

The JAX package's ``load_text_tokenizer`` tries a local Hugging Face
tokenizer, then a download, then falls back to a char-level dev tokenizer.
The port has no checkpoint loaders yet, so it keeps only that fallback:
every model serves random weights with ``DevTokenizer`` and reports
``assets_available = False``.
"""

from __future__ import annotations

from .utils import get_logger

logger = get_logger("weights")


class DevTokenizer:
    """Deterministic char-level fallback tokenizer (the JAX package's
    ``DevTokenizer``). NOT the production path: models expose
    ``assets_available`` so the server can warn."""

    def __init__(self, vocab_size: int = 128000, offset: int = 64):
        self.vocab_size = vocab_size
        self.offset = offset

    def encode(self, text: str) -> list[int]:
        return [self.offset + (ord(c) * 2654435761)
                % (self.vocab_size - self.offset - 1) for c in text]

    def __call__(self, text: str):
        return self.encode(text)


def load_text_tokenizer(model_id: str, vocab_size: int
                        ) -> tuple[DevTokenizer, bool]:
    """(tokenizer, assets_available): the dev tokenizer over
    ``vocab_size`` ids, and False."""
    logger.warning("tokenizer for %s unavailable; dev fallback", model_id)
    return DevTokenizer(vocab_size), False
