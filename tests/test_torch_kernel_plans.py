"""The host-side plans of the port's attention kernels (ops/kernels.py) and
the split-KV merge arithmetic of the decode kernel, on the CPU.

* ``plan_decode_splits`` / ``decode_split_ranges``: at least one split,
  one split where (B, KH) already fills the SMs, never more CTAs than one
  extra wave, and every token (so every page) of a sequence in exactly one
  split, in whole 16-token tiles.
* ``plan_prefill_tiles``: the query tile holds whole head groups (fewer
  than G rows left over where G does not divide it) and the grid covers
  every token exactly once, for every GQA group the JAX families use
  (G in {1, 2, 3, 4, 7, 8, 16}).
* The decode kernel's head groups: every query head of a KV group in
  exactly one CTA, a G that 4 does not divide masking the tail.
* A pure-PyTorch emulation of the decode kernel's arithmetic: each split's
  tiles taken round-robin by four warps with a base-2 online softmax per
  tile, the warps merged, then the splits merged by the log-sum-exp rule,
  against ``paged_decode_attention_plain`` at 1e-5 in float32.
* ``decode_scratch_size`` / ``DecodeScratch``: a workspace sized once for
  a max batch and a block-table limit holds every launch under both.
"""

import math

import numpy as np
import pytest
import torch

from vox_serve_tpu_torch.ops import kernels

torch.set_num_threads(1)
N_SM = 132


@pytest.mark.parametrize("B", [1, 2, 4, 8, 16, 17, 64, 128])
@pytest.mark.parametrize("KH,head_groups", [(1, 1), (2, 1), (8, 1), (8, 2),
                                             (4, 2), (2, 4)])
def test_plan_decode_splits_fills_the_card_within_limits(B, KH,
                                                         head_groups):
    ctas = B * KH * head_groups
    for max_pages in (1, 2, 4, 7, 8, 32, 63, 256, 4096):
        for page in (8, 16, 32):
            s = kernels.plan_decode_splits(B, KH, max_pages, N_SM, page,
                                           head_groups)
            assert 1 <= s <= 256
            if ctas >= N_SM:
                assert s == 1
            else:
                # at most one partial wave beyond the SMs
                assert ctas * s < N_SM + ctas
                tiles = -(-max_pages * page // kernels.DECODE_TILE)
                # no split narrower than one tile per warp of the table
                assert s <= max(1, -(-tiles // kernels.DECODE_WARPS))


def test_plan_decode_splits_at_the_served_shapes():
    # the flagship talker: KH=8, page 16
    assert kernels.plan_decode_splits(64, 8, 63) == 1
    assert kernels.plan_decode_splits(1, 8, 32) == 8   # B=1, ~500 tokens
    assert kernels.plan_decode_splits(4, 8, 8) == 2    # B=4, ~120 tokens
    assert kernels.plan_decode_splits(4, 8, 3) == 1    # B=4, ~40 tokens


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8, 16, 17])
def test_decode_split_ranges_cover_every_token_and_page_once(splits):
    page = 16
    for n_tok in (0, 1, 15, 16, 17, 40, 120, 500, 1000, 4096):
        ranges = kernels.decode_split_ranges(n_tok, splits)
        assert len(ranges) == splits
        covered = []
        for a, b in ranges:
            assert 0 <= a <= b <= n_tok
            assert a % kernels.DECODE_TILE == 0 or a == n_tok
            covered += list(range(a, b))
        assert covered == list(range(n_tok))
        pages = [sorted({t // page for t in range(a, b)}) for a, b in ranges]
        flat = [p for ps in pages for p in ps]
        assert sorted(flat) == list(range(-(-n_tok // page)))
        assert len(flat) == len(set(flat))


@pytest.mark.parametrize("H,KH", [(16, 8), (16, 16), (32, 8), (16, 4),
                                  (16, 2), (32, 1), (24, 8), (6, 2),
                                  (28, 4), (14, 2), (32, 2), (20, 4)])
def test_plan_prefill_tiles_cover_every_token_once(H, KH):
    G = H // KH
    for T in (1, 17, 64, 168, 256, 1000, 1024, 4096):
        warps, bq, tiles = kernels.plan_prefill_tiles(T, H, KH, N_SM)
        assert warps in (2, 4)
        # whole head groups; fewer than G rows of the tile left over
        assert bq >= 1 and bq * G <= 16 * warps
        assert 16 * warps - bq * G < G
        assert (tiles - 1) * bq < T <= tiles * bq
        big = -(-T // (64 // G)) * KH
        assert (warps == 4) == (big >= N_SM)


def test_plan_prefill_tiles_at_the_served_shapes():
    assert kernels.plan_prefill_tiles(168, 16, 8) == (2, 16, 11)
    assert kernels.plan_prefill_tiles(1024, 16, 8) == (4, 32, 32)
    with pytest.raises(ValueError):
        kernels.plan_prefill_tiles(64, 64, 1)


def test_kernels_take_the_orpheus_head_group():
    """Orpheus's Llama-3.2-3B: 24 query heads over 8 KV heads (G = 3),
    which neither divides K3's tile nor fits the decode kernel's groups of
    1, 2 or 4 without a G = 3 instance."""
    assert kernels.plan_prefill_tiles(168, 24, 8, N_SM) == (2, 10, 17)
    assert kernels.plan_prefill_tiles(1024, 24, 8, N_SM) == (4, 21, 49)
    kernels._check_heads(24, 8, 128, kernels.MAX_GROUP)
    assert kernels.decode_heads_per_cta(24, 8) == 3
    assert kernels.decode_head_groups(24, 8) == 1
    # G = 7 (CosyVoice2, Step-Audio 2) as 4 + 3 heads, G = 16 as 4 x 4
    assert kernels.decode_head_groups(28, 4) == 2
    assert kernels.decode_head_groups(32, 2) == 4
    with pytest.raises(ValueError):
        kernels._check_heads(66, 1, 128, kernels.MAX_GROUP)


def test_kernels_take_the_glm_head_group():
    """GLM-4-Voice-9B: 32 query heads over 2 KV heads (G = 16) at head dim
    128. K3's tile holds 2 tokens of 16 heads at two warps (T = 168) and 4
    at four (T = 1024); the decode kernel runs 4 CTAs of 4 heads per KV
    head, split over the tokens where the grid does not fill the card."""
    assert kernels.plan_prefill_tiles(168, 32, 2, N_SM) == (2, 2, 84)
    assert kernels.plan_prefill_tiles(1024, 32, 2, N_SM) == (4, 4, 256)
    kernels._check_heads(32, 2, 128, kernels.MAX_GROUP)
    assert kernels.decode_heads_per_cta(32, 2) == 4
    assert kernels.decode_head_groups(32, 2) == 4
    # B = 4 over ~1,000-token streams (prompt ~850 + generation): 32 CTAs
    # split 5 ways (160 CTAs); B = 64 fills the card unsplit
    assert kernels.plan_decode_splits(4, 2, 63, N_SM, 16, 4) == 5
    assert kernels.plan_decode_splits(64, 2, 63, N_SM, 16, 4) == 1


def test_kernels_take_the_step_audio2_head_group():
    """Step-Audio-2-mini's Qwen2.5-7B: 28 query heads over 4 KV heads (G =
    7) at head dim 128. K3's tile holds 4 tokens of 7 heads (28 of 32
    rows) at two warps (T = 168: 42 tiles per KV head) and 9 at four (T =
    1024); the decode kernel runs 2 CTAs (4 + 3 heads) per KV head, split
    over the tokens at B = 4 and unsplit at B = 64 (512 CTAs)."""
    assert kernels.plan_prefill_tiles(168, 28, 4, N_SM) == (2, 4, 42)
    assert kernels.plan_prefill_tiles(1024, 28, 4, N_SM) == (4, 9, 114)
    kernels._check_heads(28, 4, 128, kernels.MAX_GROUP)
    assert kernels.decode_heads_per_cta(28, 4) == 4
    assert kernels.decode_head_groups(28, 4) == 2
    # B = 4 over ~130-token prompts (8 pages) to 2,048 positions (128)
    assert kernels.plan_decode_splits(4, 4, 8, N_SM, 16, 2) == 2
    assert kernels.plan_decode_splits(4, 4, 63, N_SM, 16, 2) == 5
    for pages in (8, 63, 128):
        assert kernels.plan_decode_splits(64, 4, pages, N_SM, 16, 2) == 1


@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 7, 8, 16])
def test_decode_head_groups_cover_every_head_once(G):
    """The kernel's head index arithmetic (hgroups = ceil(G / kG), heads
    g0 .. g0 + nh of grid row hy): every query head of every KV head in
    exactly one CTA, no CTA past the group."""
    KH = 2
    kG = kernels.decode_heads_per_cta(G * KH, KH)
    hgroups = kernels.decode_head_groups(G * KH, KH)
    seen = []
    for hy in range(KH * hgroups):
        kvh = hy // hgroups
        g0 = (hy - kvh * hgroups) * kG
        nh = min(kG, G - g0)
        assert 1 <= nh <= kG <= kernels.DECODE_MAX_HEADS
        seen += [kvh * G + g0 + g for g in range(nh)]
    assert seen == list(range(G * KH))


def _emulated_decode(q, pool, layer, tables, seq, splits, scale=None):
    """The decode kernel's arithmetic in float64-free f32 PyTorch: split
    ranges, warps round-robin over 16-token tiles, base-2 online softmax
    per tile, merge of the warps, then of the splits (log-sum-exp)."""
    B, H, D = q.shape
    KH = pool.shape[3] // 2
    G = H // KH
    page = pool.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    log2e = 1.0 / math.log(2.0)
    out = torch.zeros((B, H, D), dtype=torch.float32)
    tile = kernels.DECODE_TILE
    for b in range(B):
        n = int(seq[b])
        toks = torch.arange(n)
        pids = tables[b, toks // page].long()
        kv = pool[layer, pids, toks % page].float()  # (n, 2KH, D)
        for h in range(KH):
            k, v = kv[:, 2 * h], kv[:, 2 * h + 1]
            qg = q[b, h * G:(h + 1) * G].float() * (scale * log2e)
            states = []
            for a, e in kernels.decode_split_ranges(n, splits):
                warp_states = []
                for w in range(kernels.DECODE_WARPS):
                    m = torch.full((G,), -math.inf)
                    l = torch.zeros(G)
                    acc = torch.zeros((G, D))
                    for t0 in range(a + w * tile, e, kernels.DECODE_WARPS
                                    * tile):
                        t1 = min(t0 + tile, e)
                        s = qg @ k[t0:t1].T                 # (G, tokens)
                        m_new = torch.maximum(m, s.max(dim=1).values)
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(s - m_new[:, None])
                        l = l * alpha + p.sum(dim=1)
                        acc = acc * alpha[:, None] + p @ v[t0:t1]
                        m = m_new
                    warp_states.append((m, l, acc))
                states.append(_merge(warp_states))
            m, l, acc = _merge(states)
            res = torch.where(l[:, None] > 0, acc / l.clamp_min(1e-30)[:, None],
                              torch.zeros_like(acc))
            out[b, h * G:(h + 1) * G] = res
    return out


def _merge(states):
    """Log-sum-exp merge of (max, sum, acc) states, skipping empty ones."""
    m = torch.stack([s[0] for s in states]).max(dim=0).values
    l = torch.zeros_like(states[0][1])
    acc = torch.zeros_like(states[0][2])
    for ms, ls, accs in states:
        w = torch.where(torch.isinf(ms), torch.zeros_like(ms),
                        torch.exp2(ms - torch.where(torch.isinf(m),
                                                    torch.zeros_like(m), m)))
        l = l + ls * w
        acc = acc + accs * w[:, None]
    return m, l, acc


@pytest.mark.parametrize("B,seq_max,page,splits,H", [
    (1, 500, 16, None, 16),    # the planned split at B=1
    (4, 120, 16, None, 16),    # the served batch
    (3, 300, 16, 5, 16),
    (2, 37, 8, 4, 16),         # tiles span two pages; more splits than tiles
    (2, 70, 32, 3, 16),        # pages hold two tiles
    (4, 120, 16, None, 24),    # Orpheus's G = 3 at the served batch
    (1, 500, 16, None, 24),
    (4, 700, 16, None, 32),    # GLM-4-Voice's G = 16 (KH = 2 below)
    (4, 700, 16, None, 28),    # Step-Audio 2's G = 7 (KH = 4 below)
])
def test_split_kv_merge_emulation_matches_plain(B, seq_max, page, splits, H):
    rng = np.random.default_rng(B * 1000 + seq_max)
    KH = {32: 2, 28: 4}.get(H, 8)
    D, L, P = 64, 2, 200
    maxp = -(-seq_max // page)
    pool = torch.from_numpy(rng.standard_normal(
        (L, P, page, 2 * KH, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    seq = torch.from_numpy(rng.integers(1, seq_max + 1, B).astype(np.int32))
    seq[0] = seq_max
    tables = torch.from_numpy(rng.permutation(P - 1)[: B * maxp].reshape(
        B, maxp).astype(np.int32) + 1)
    if splits is None:
        splits = kernels.plan_decode_splits(
            B, KH, maxp, N_SM, page, kernels.decode_head_groups(H, KH))
        assert splits > 1
    got = _emulated_decode(q, pool, 1, tables, seq, splits)
    ref = kernels.paged_decode_attention_plain(q, pool, 1, tables, seq)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("max_batch", [1, 4, 64])
@pytest.mark.parametrize("H,KH,D", [(16, 8, 128), (8, 8, 64), (16, 2, 128),
                                    (32, 1, 64), (24, 8, 128), (28, 4, 128),
                                    (32, 2, 128)])
def test_decode_scratch_covers_every_launch_of_its_owner(max_batch, H, KH,
                                                         D):
    """A scratch sized for (max batch, block-table limit) holds the states
    and counters of every launch at or under both, so a worker never has to
    grow (and so replace) it."""
    max_pages = 40
    floats, counters = kernels.decode_scratch_size(max_batch, H, KH, D,
                                                   max_pages, N_SM)
    for B in range(1, max_batch + 1):
        for width in range(1, max_pages + 1):
            splits, f, c = kernels._split_need(B, H, KH, D, width, N_SM, 16)
            assert f <= floats and c <= counters
            if splits == 1:
                assert f == c == 0
            else:
                groups = kernels.decode_head_groups(H, KH)
                assert c == B * KH * groups
                assert f == c * splits * kernels.decode_heads_per_cta(
                    H, KH) * (D + 2)


def test_decode_scratch_is_allocated_once_at_its_size():
    s = kernels.DecodeScratch("cpu", 4, 16, 8, 128, 20)
    floats, counters = kernels.decode_scratch_size(4, 16, 8, 128, 20, N_SM)
    assert floats > 0 and counters > 0  # B=1..4 split at 20 pages
    assert s.part.numel() == floats and s.part.dtype == torch.float32
    assert s.counters.numel() == counters
    assert int(s.counters.abs().sum()) == 0
    # a width that never splits needs no workspace at all
    assert kernels.decode_scratch_size(4, 16, 8, 128, 1, N_SM) == (0, 0)
