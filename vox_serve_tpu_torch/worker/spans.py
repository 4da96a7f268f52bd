"""The span recorder of ``--enable-profiling`` (``WorkerConfig.
enable_profiling``): named host spans, each with its start, end and the
span open around it on its thread, kept in memory (the last
``SPAN_LIMIT``) and written as Chrome trace events.

Stamps are ``time.time_ns()``, the clock ``torch.profiler`` stamps its
events with, so a span file opens in Perfetto beside a profiler trace of the
same process, and a profiler event falls inside the span whose host code
issued it. The scheduler records each round that did work (``round``), the
worker each step dispatch (the JAX worker's trace annotation names) and each
blocking wait on the card (``wait``).
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time

#: spans kept (the oldest go first)
SPAN_LIMIT = 200_000


class Span:
    """One span; ``parent`` is the id of the span open around it (None at
    the top)."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "tid",
                 "closed_before")

    def __init__(self, name: str, sid: int, parent, tid: int,
                 closed_before: int):
        self.name = name
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.id = sid
        self.parent = parent
        self.tid = tid
        #: spans closed before this one opened (finds its children)
        self.closed_before = closed_before


class _Scope:
    """``with recorder.span(name):``"""

    __slots__ = ("rec", "name", "span")

    def __init__(self, rec: "SpanRecorder", name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        self.span = self.rec.begin(self.name)
        return self.span

    def __exit__(self, *exc):
        self.rec.end(self.span)


class SpanRecorder:
    """Nested host spans per thread, the last ``limit`` kept."""

    def __init__(self, limit: int = SPAN_LIMIT):
        #: closed spans, in the order they closed (a child before its
        #: parent)
        self.spans: collections.deque = collections.deque(maxlen=limit)
        #: spans closed since the start (the deque keeps the last limit)
        self.closed = 0
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str) -> _Scope:
        return _Scope(self, name)

    def begin(self, name: str) -> Span:
        """Open a span inside the one open on this thread."""
        stack = self._stack()
        s = Span(name, next(self._ids), stack[-1].id if stack else None,
                 threading.get_native_id(), self.closed)
        stack.append(s)
        return s

    def end(self, s: Span, keep: bool = True) -> None:
        """Close ``s`` (the innermost open span of its thread). With
        ``keep`` false it is not recorded, and the spans recorded inside it
        take its parent."""
        s.end_ns = time.time_ns()
        stack = self._stack()
        if stack and stack[-1] is s:
            stack.pop()
        if keep:
            self.spans.append(s)
            self.closed += 1
            return
        inside = min(self.closed - s.closed_before, len(self.spans))
        for i in range(len(self.spans) - inside, len(self.spans)):
            if self.spans[i].parent == s.id:
                self.spans[i].parent = s.parent

    def chrome_trace(self) -> dict:
        """The recorded spans as Chrome trace events (``"ph": "X"``, ``ts``
        and ``dur`` in microseconds on the epoch clock). A span still open
        (the round a daemon was in when it was stopped) is left out; the
        spans closed inside it keep its id as their parent."""
        pid = os.getpid()
        return {"displayTimeUnit": "ms", "traceEvents": [
            {"name": s.name, "ph": "X", "ts": s.start_ns / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid, "tid": s.tid,
             "args": {"id": s.id, "parent": s.parent}}
            for s in list(self.spans)]}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
