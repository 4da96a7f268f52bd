"""Client-side arithmetic of the end-to-end metrics: percentiles, time to
first audio, per-stream real-time factor and audio delivered in a window.

A request's record (``client.Request``) holds its due time (open loop: its
scheduled send time; closed loop: its send time), and the arrival time and
size of every PCM chunk after the 44-byte WAV header. A failed request
counts as missing: its time to first audio is infinite and its real-time
factor 0.
"""

from __future__ import annotations

import math

INF = float("inf")
BYTES_PER_SAMPLE = 2


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between the
    closest ranks (numpy's default method); infinite values sort last."""
    if not values:
        raise ValueError("percentile of no values")
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    if v[hi] == INF:
        return v[lo] if pos == lo else INF
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def ttfa_s(req) -> float:
    """Seconds from the request's due time to its first PCM byte."""
    if req.failed or req.first_pcm_t is None:
        return INF
    return req.first_pcm_t - req.due_t


def audio_seconds(nbytes: int, sample_rate: int) -> float:
    return nbytes / BYTES_PER_SAMPLE / sample_rate


def stream_rtf(req, sample_rate: int) -> float:
    """Audio seconds received over the seconds from the first PCM byte to
    the last; 0 for a failed request, infinite for a stream that arrived
    in one piece."""
    if req.failed or req.first_pcm_t is None:
        return 0.0
    span = req.last_pcm_t - req.first_pcm_t
    audio = audio_seconds(req.pcm_bytes, sample_rate)
    return audio / span if span > 0 else INF


def audio_in_window(requests, t0: float, t1: float,
                    sample_rate: int) -> float:
    """PCM seconds of every chunk that arrived in [t0, t1), whichever
    request it belongs to."""
    nbytes = sum(n for r in requests for t, n in r.chunks if t0 <= t < t1)
    return audio_seconds(nbytes, sample_rate)
