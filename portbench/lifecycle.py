"""The daemon's own stamps and round timers, as the per-layer metrics read
them.

Time to first audio in parts: each finished window request with a first
PCM byte is joined, by the first 8 characters of its id, to its record in
the stats file's ``lifecycle`` (the daemon's stamps on
``time.monotonic()``, the clock the client's ``time.perf_counter()`` reads
on Linux). The parts, means in ms over the joined requests, add up with
the client's own lateness (``send_t - due_t``) to their mean TTFA:

* ``api``: send -> the API server's first frame (HTTP, the form parse);
* ``intake``: that frame -> the scheduler's intake at the top of a round
  (the API's sender thread, ZMQ, the wait for the round boundary);
* ``queue``: intake -> admission (the prefill or cold chain dispatched);
* ``frames``: admission -> the dispatch of the device work of the first
  PCM (prefill, then decode rounds until the first window's frames exist);
* ``detok``: that dispatch -> the first chunk sent to the result socket
  (the codec and its readback);
* ``hop_out``: that send -> the client's first PCM byte (ZMQ, the API's
  result thread and stream poll, HTTP).

The parts add up by construction; what shows that the two processes'
stamps share a clock is that each part of each request is non-negative
(``request_parts_ms``).

Where a daemon records no stamps (a program without them) or a joined
request lacks one, the parts are None. The round split reads the
``phase_stats`` entries ``round`` and ``round.wait`` (None without them).
"""

from __future__ import annotations

#: the daemon's stamps, in the order a request passes them
STAMPS = ("api", "recv", "prefill_dispatch", "first_detok", "first_audio")

#: part -> (from, to): stamps of the daemon, or the client's ``send_t`` /
#: ``first_pcm_t``
PARTS = {
    "api": ("send_t", "api"),
    "intake": ("api", "recv"),
    "queue": ("recv", "prefill_dispatch"),
    "frames": ("prefill_dispatch", "first_detok"),
    "detok": ("first_detok", "first_audio"),
    "hop_out": ("first_audio", "first_pcm_t"),
}


def joined(ctx) -> list[tuple] | None:
    """(client request, daemon record) of every finished window request
    with a first PCM byte; None unless each has a record with every
    stamp."""
    records = {rec["rid"][:8]: rec
               for rec in ctx.stats.get("lifecycle", [])}
    out = []
    for r in ctx.window_requests:
        if r.failed or r.first_pcm_t is None:
            continue
        rec = records.get(r.rid8)
        if rec is None or any(k not in rec for k in STAMPS):
            return None
        out.append((r, rec))
    return out or None


def _at(req, rec: dict, name: str) -> float:
    return getattr(req, name) if name.endswith("_t") else rec[name]


def request_parts_ms(ctx) -> list[dict] | None:
    """Per joined request, ms of each part, of the client's lateness
    (``late``) and of TTFA (``ttfa``)."""
    pairs = joined(ctx)
    if pairs is None:
        return None
    out = []
    for r, rec in pairs:
        row = {name: (_at(r, rec, b) - _at(r, rec, a)) * 1e3
               for name, (a, b) in PARTS.items()}
        row["late"] = (r.send_t - r.due_t) * 1e3
        row["ttfa"] = (r.first_pcm_t - r.due_t) * 1e3
        out.append(row)
    return out


def ttfa_parts_ms(ctx) -> dict | None:
    """The means of ``request_parts_ms`` over the joined requests."""
    rows = request_parts_ms(ctx)
    if rows is None:
        return None
    return {k: sum(row[k] for row in rows) / len(rows) for k in rows[0]}


def ttfa_part_ms(ctx, name: str) -> float | None:
    parts = ttfa_parts_ms(ctx)
    return None if parts is None else parts[name]


def round_ms(ctx, part: str) -> float | None:
    """ms per scheduler round that did work: ``host`` (its wall time less
    its waits on the card) or ``wait``."""
    ph = ctx.stats["phase_stats"]
    if "round" not in ph or "round.wait" not in ph:
        return None
    wall, rounds = ph["round"]
    wait = ph["round.wait"][0]
    if not rounds:
        return None
    return (wall - wait if part == "host" else wait) / rounds * 1e3
