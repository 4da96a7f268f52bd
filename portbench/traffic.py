"""Seeded traffic: the arrival schedule and the prompts of a traffic mix.

A mix is a JSON file under ``portbench/traffic/`` (see ``spec.py``):

* open-loop gaps: independent draws of the exponential distribution of the
  mix's rate (Poisson arrivals), as ``benchmark/goodput.py`` draws them;
* prompt lengths: per block of ``LENGTH_BLOCK`` requests, lengths spread
  evenly over [min, max] characters (the midpoints of equal strata),
  shuffled, so that every seed asks for the same mix of lengths.
"""

from __future__ import annotations

import random
from typing import Iterator

#: the word pool the prompts are made of (common English words; no dataset
#: is downloaded)
WORDS = (
    "the quick brown fox jumps over a lazy dog while morning light falls "
    "across quiet valley roads and rivers wind past old stone bridges "
    "please confirm your order for two tickets at seven tonight our team "
    "will call you back within one hour if anything changes today the "
    "weather looks clear with a gentle breeze from the west and mild "
    "temperatures through the afternoon thank you for waiting your package "
    "has shipped and should arrive on thursday between noon and five "
    "scientists announced new results on energy storage that could help "
    "cities manage power during long winter nights the meeting moved to "
    "room four on the second floor next to the library would you like me "
    "to read the next message or set a reminder for tomorrow morning "
    "turn left at the next light then continue straight for about two "
    "miles until you see the bakery on your right the account balance is "
    "updated every evening and any payment made before six appears the "
    "same day"
).split()


#: prompts per block of evenly spread lengths
LENGTH_BLOCK = 64


def prompt_lengths(mix: dict, rng: random.Random) -> Iterator[int]:
    """Endless prompt lengths in characters: per block, the same evenly
    spread lengths over [min, max], shuffled."""
    lo, hi = mix["prompt_chars"]["min"], mix["prompt_chars"]["max"]
    block = [lo + int(round((i + 0.5) / LENGTH_BLOCK * (hi - lo)))
             for i in range(LENGTH_BLOCK)]
    while True:
        b = list(block)
        rng.shuffle(b)
        yield from b


def arrival_gaps(mix: dict, rng: random.Random) -> Iterator[float]:
    """Endless open-loop inter-arrival gaps in seconds: independent
    exponential draws at the mix's rate."""
    rate = float(mix["rate_per_s"])
    while True:
        yield rng.expovariate(rate)


def make_text(n_chars: int, rng: random.Random) -> str:
    """English-looking text of exactly ``n_chars`` characters from the word
    pool: capitalised words, ending in a full stop."""
    words: list[str] = []
    length = 0
    while length < n_chars:
        w = rng.choice(WORDS)
        words.append(w)
        length += len(w) + 1
    text = " ".join(words)
    text = text[0].upper() + text[1:n_chars - 1].rstrip() + "."
    return text.ljust(n_chars, ".")[:n_chars]


class Traffic:
    """The prompts and (open loop) arrival offsets of one run of a mix, all
    drawn from ``seed``: lengths, gaps and words from three streams of their
    own, so that the lengths and gaps do not depend on the words drawn."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self._lengths = prompt_lengths(mix, random.Random(f"len:{seed}"))
        self._gaps = (arrival_gaps(mix, random.Random(f"gap:{seed}"))
                      if mix["loop"] == "open" else None)
        self._words = random.Random(f"words:{seed}")

    def next_prompt(self) -> str:
        return make_text(next(self._lengths), self._words)

    def next_gap(self) -> float:
        return next(self._gaps)

    def form(self, text: str) -> dict:
        """The form fields of one request."""
        return {"text": text, "streaming": "true", **self.mix.get("form", {})}
