"""The HTTP client of a run: streamed ``POST /generate`` requests under an
open loop (arrivals on a schedule) or a closed loop (N callers, each sending
its next request when its previous one ends), over one asyncio event loop.

Timeline of a run, in ``time.perf_counter`` seconds: traffic starts at
``t_start``; the warm-in lasts ``warm_in_s``; the measured window is [t0,
t1); after it the traffic goes on, so that the window's requests finish
under the same load, until every request due in the window has ended or
``drain_limit_s`` has passed; then sending stops and the requests still
open are closed. A window request still open then is failed.

The chunk framing (44-byte WAV header, then int16 PCM) and the request id
taken from ``Content-Disposition`` follow ``chip_smoke.py``'s
``stream_generate``; the request loop follows ``benchmark/goodput.py``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Callable, Optional

WAV_HEADER_BYTES = 44


@dataclasses.dataclass
class Request:
    text: str
    due_t: float                  # scheduled (open) or actual (closed) send
    send_t: float = 0.0
    status: Optional[int] = None
    rid8: str = ""
    first_pcm_t: Optional[float] = None
    last_pcm_t: Optional[float] = None
    pcm_bytes: int = 0
    chunks: list = dataclasses.field(default_factory=list)  # (t, nbytes)
    pcm: Optional[bytearray] = None  # kept for requests due in the window
    done: bool = False
    error: Optional[str] = None

    @property
    def failed(self) -> bool:
        """Not answered in full: an error, another status than 200, or
        still open at the end of the drain. (A stream that ends before its
        first PCM byte is answered; it has no time to first audio.)"""
        return (not self.done or self.error is not None
                or self.status != 200)


@dataclasses.dataclass
class Timeline:
    t_start: float
    t0: float
    t1: float
    drain_until: float


async def _one(session, url: str, form: dict, req: Request,
               keep_pcm: bool) -> None:
    import aiohttp

    req.send_t = time.perf_counter()
    if keep_pcm:
        req.pcm = bytearray()
    header = 0
    try:
        data = aiohttp.FormData(form)
        async with session.post(url, data=data) as resp:
            req.status = resp.status
            disp = resp.headers.get("Content-Disposition", "")
            req.rid8 = disp.rsplit("stream_", 1)[-1].split(".")[0]
            async for chunk in resp.content.iter_any():
                now = time.perf_counter()
                if header < WAV_HEADER_BYTES:
                    take = min(WAV_HEADER_BYTES - header, len(chunk))
                    header += take
                    chunk = chunk[take:]
                    if not chunk:
                        continue
                if req.first_pcm_t is None:
                    req.first_pcm_t = now
                req.last_pcm_t = now
                req.pcm_bytes += len(chunk)
                req.chunks.append((now, len(chunk)))
                if keep_pcm:
                    req.pcm += chunk
        req.done = True
    except asyncio.CancelledError:
        req.error = "closed at the end of the drain"
        raise
    except Exception as e:  # recorded; the run counts the request failed
        req.error = repr(e)


class Sender:
    """Sends one traffic mix against ``base_url`` and records every
    request. ``on_tick(now)`` is called every 50 ms from the event loop
    (the run's hooks: trace start and stop, memory samples)."""

    def __init__(self, base_url: str, traffic, warm_in_s: float,
                 seconds: float, drain_limit_s: float,
                 on_tick: Optional[Callable[[float, Timeline], None]] = None):
        self.url = base_url + "/generate"
        self.traffic = traffic
        self.warm_in_s = warm_in_s
        self.seconds = seconds
        self.drain_limit_s = drain_limit_s
        self.on_tick = on_tick
        self.requests: list[Request] = []
        self.max_late_s = 0.0  # open loop: the generator's worst lateness
        self.timeline: Optional[Timeline] = None
        self._tasks: set = set()
        self._stop = False

    def in_window(self, req: Request) -> bool:
        tl = self.timeline
        return tl.t0 <= req.due_t < tl.t1

    def window_requests(self) -> list[Request]:
        return [r for r in self.requests if self.in_window(r)]

    def _window_open(self) -> bool:
        """True while a request due in the window has not ended."""
        return any(not (r.done or r.error) for r in self.window_requests())

    def _start(self, session, req: Request) -> asyncio.Task:
        self.requests.append(req)
        task = asyncio.ensure_future(_one(
            session, self.url, self.traffic.form(req.text), req,
            keep_pcm=self.in_window(req)))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    async def _open_loop(self, session) -> None:
        tl = self.timeline
        due = tl.t_start
        while not self._stop:
            now = time.perf_counter()
            if due > now:
                await asyncio.sleep(due - now)
                if self._stop:
                    break
            self.max_late_s = max(self.max_late_s,
                                  time.perf_counter() - due)
            self._start(session, Request(self.traffic.next_prompt(), due))
            due += self.traffic.next_gap()

    async def _caller(self, session) -> None:
        while not self._stop:
            req = Request(self.traffic.next_prompt(), time.perf_counter())
            await self._start(session, req)

    async def _supervise(self) -> None:
        tl = self.timeline
        while True:
            now = time.perf_counter()
            if self.on_tick is not None:
                self.on_tick(now, tl)
            if now >= tl.t1 and (not self._window_open()
                                 or now >= tl.drain_until):
                break
            await asyncio.sleep(0.05)
        self._stop = True

    async def _run(self) -> None:
        import aiohttp

        now = time.perf_counter()
        t0 = now + self.warm_in_s
        t1 = t0 + self.seconds
        self.timeline = Timeline(now, t0, t1, t1 + self.drain_limit_s)
        connector = aiohttp.TCPConnector(limit=0, force_close=True)
        timeout = aiohttp.ClientTimeout(total=None, sock_connect=30)
        async with aiohttp.ClientSession(connector=connector,
                                         timeout=timeout) as session:
            mix = self.traffic.mix
            if mix["loop"] == "open":
                senders = [asyncio.ensure_future(self._open_loop(session))]
            else:
                senders = [asyncio.ensure_future(self._caller(session))
                           for _ in range(mix["clients"])]
            await self._supervise()
            for t in senders:
                t.cancel()
            for t in list(self._tasks):
                t.cancel()
            await asyncio.gather(*senders, *self._tasks,
                                 return_exceptions=True)

    def run(self) -> Timeline:
        asyncio.run(self._run())
        return self.timeline
