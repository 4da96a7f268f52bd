"""The seeded traffic repeats exactly; every seed asks for the same prompt
lengths in another order, and arrivals are Poisson at the mix's rate."""

import json
from collections import Counter
from itertools import islice

import pytest

from portbench.spec import HERE
from portbench.traffic import (LENGTH_BLOCK, Traffic, arrival_gaps,
                               make_text, prompt_lengths)

MIX = json.loads((HERE / "traffic" / "agent-poisson.json").read_text())
SEEDS = [0, 7, 2**31 + 11, 2**40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_schedule_and_prompts_repeat(seed):
    a, b = Traffic(MIX, seed), Traffic(MIX, seed)
    assert [a.next_prompt() for _ in range(100)] == [
        b.next_prompt() for _ in range(100)]
    assert [a.next_gap() for _ in range(100)] == [
        b.next_gap() for _ in range(100)]


def test_seeds_share_the_multiset_of_work():
    """Prompt lengths: the same multiset in another order. Gaps: drawn
    anew from each seed."""
    import random

    n = LENGTH_BLOCK * 3
    ref_len = Counter(islice(prompt_lengths(MIX, random.Random(1)), n))
    orders, gaps = set(), set()
    for seed in SEEDS:
        t = Traffic(MIX, seed)
        lens = [len(t.next_prompt()) for _ in range(n)]
        assert Counter(lens) == ref_len
        orders.add(tuple(lens))
        gaps.add(tuple(t.next_gap() for _ in range(n)))
    assert len(orders) == len(SEEDS) and len(gaps) == len(SEEDS)


def test_lengths_span_the_stated_range_and_rate():
    import random

    lens = list(islice(prompt_lengths(MIX, random.Random(3)), LENGTH_BLOCK))
    assert min(lens) >= MIX["prompt_chars"]["min"]
    assert max(lens) <= MIX["prompt_chars"]["max"]
    gaps = list(islice(arrival_gaps(MIX, random.Random(3)), 200_000))
    assert abs(len(gaps) / sum(gaps) / MIX["rate_per_s"] - 1) < 0.01


def test_arrivals_are_poisson():
    """Counts of arrivals per 64 expected ones vary as Poisson's (variance
    about the mean), and the longest gap is not cut short."""
    import math
    import random

    rate = MIX["rate_per_s"]
    span = 64 / rate
    t, counts, longest = 0.0, Counter(), 0.0
    for g in islice(arrival_gaps(MIX, random.Random(11)), 64 * 2000):
        t += g
        longest = max(longest, g)
        counts[int(t // span)] += 1
    per = [counts[i] for i in range(1990)]
    mean = sum(per) / len(per)
    var = sum((c - mean) ** 2 for c in per) / (len(per) - 1)
    assert abs(mean / 64 - 1) < 0.02
    assert 0.85 < var / mean < 1.15
    assert longest * rate > math.log(64 * 2000) - 3


@pytest.mark.parametrize("n", [1, 2, 5, 40, 100, 240])
def test_text_has_the_exact_length(n):
    import random

    t = make_text(n, random.Random(n))
    assert len(t) == n and t.isascii()


def test_closed_loop_mix_has_no_gaps():
    closed = json.loads((HERE / "traffic" / "closed-8.json").read_text())
    t = Traffic(closed, 5)
    assert closed["loop"] == "closed" and closed["clients"] == 8
    assert len(t.next_prompt()) >= closed["prompt_chars"]["min"]
    with pytest.raises(TypeError):
        t.next_gap()
