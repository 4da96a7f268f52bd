"""APIServer: scheduler process management + ZMQ request/result routing.

Behavioral parity with the reference's APIServer (launch.py:32-775): spawns
one scheduler daemon per data-parallel rank, round-robins requests over
per-rank ZMQ PUSH sockets, drains results on one PULL socket in a background
thread, buffers per-request audio chunks, bounds the send queue (429 on
saturation), and absorbs late messages for recently-completed requests with
a TTL map.

The port's copy of vox_serve_tpu/server/api.py. It differs only in its
imports and in ``_start_schedulers``, which starts
``python -m vox_serve_tpu_torch.scheduler_entry`` per rank, pins each rank
to one card with ``CUDA_VISIBLE_DEVICES`` when there is more than one rank,
and drops the TPU device-pinning variables from the daemon's environment.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import queue
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path
from typing import Optional

import zmq

from ..utils import get_logger

#: the JAX server's TPU pinning variables, never passed to the port's daemon
_TPU_ENV = ("TPU_VISIBLE_DEVICES", "TPU_CHIPS_PER_PROCESS_BOUNDS",
            "TPU_PROCESS_BOUNDS")


class APIError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


class APIServer:
    def __init__(
        self,
        model_name: str = "dummy",
        scheduler_type: str = "base",
        output_dir: str = "/tmp/vox_serve_audio",
        upload_dir: str = "/tmp/vox_serve_uploads",
        timeout_seconds: float = 600.0,
        max_batch_size: int = 8,
        dp_size: int = 1,
        socket_suffix: str = "",
        spawn_schedulers: bool = True,
        scheduler_args: Optional[dict] = None,
        sample_rate: Optional[int] = None,
    ):
        self.logger = get_logger("api")
        self.model_name = model_name
        self.scheduler_type = scheduler_type
        self.timeout_seconds = timeout_seconds
        self.max_batch_size = max_batch_size
        self.dp_size = dp_size
        self.socket_suffix = socket_suffix
        self.scheduler_args = scheduler_args or {}
        self.sample_rate = sample_rate  # resolved lazily if None

        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.upload_dir = Path(upload_dir)
        self.upload_dir.mkdir(parents=True, exist_ok=True)

        self.pending_requests: dict[str, dict] = {}
        self.ready_ranks: set[int] = set()
        self.dead_ranks: set[int] = set()
        self.assets_available = True  # any rank on dev assets flips this
        self.recently_completed: "collections.OrderedDict[str, float]" = (
            collections.OrderedDict())
        self.recently_completed_ttl_sec = 5.0
        self.request_lock = threading.Lock()
        self.running = True
        self.dp_request_counter = 0

        self.scheduler_processes: list[subprocess.Popen] = []
        if spawn_schedulers:
            self._start_schedulers()
            time.sleep(1.0)

        self.context = zmq.Context()
        self.request_sockets = []
        for rank in range(dp_size):
            s = self.context.socket(zmq.PUSH)
            s.setsockopt(zmq.SNDHWM, 256)
            s.setsockopt(zmq.LINGER, 0)
            s.connect(f"ipc:///tmp/vox_serve_request_{rank}{socket_suffix}.ipc")
            self.request_sockets.append(s)
        self.result_socket = self.context.socket(zmq.PULL)
        self.result_socket.setsockopt(zmq.RCVHWM, 1024)
        self.result_socket.setsockopt(zmq.LINGER, 0)
        self.result_socket.bind(f"ipc:///tmp/vox_serve_result{socket_suffix}.ipc")

        #: (payload, rank) — rank affinity: every frame of a request goes
        #: to the rank that owns it (round-robin only assigns the FIRST
        #: frame; input-streaming TEXT_UPDATE/TEXT_COMPLETE must follow)
        self.to_scheduler: "queue.Queue[tuple[bytes, int]]" = queue.Queue(
            maxsize=max(1, max_batch_size * 2 * dp_size))
        self.sender_thread = threading.Thread(target=self._sender_loop,
                                              daemon=True)
        self.sender_thread.start()
        self.message_thread = threading.Thread(target=self._process_messages,
                                               daemon=True)
        self.message_thread.start()
        self.monitor_thread = threading.Thread(target=self._monitor_schedulers,
                                               daemon=True)
        self.monitor_thread.start()
        atexit.register(self.cleanup)

    def _monitor_schedulers(self) -> None:
        """Fail fast when a scheduler daemon dies (the reference never detects
        this, SURVEY §5.3): error out that rank's pending requests, remove
        the rank from rotation, flip /health unhealthy, and KEEP monitoring
        the remaining ranks."""
        while self.running:
            time.sleep(1.0)
            for i, p in enumerate(self.scheduler_processes):
                if i in self.dead_ranks:
                    continue
                rc = p.poll()
                if rc is not None:
                    self.logger.error(
                        "scheduler rank %d died (exit code %s); failing its "
                        "pending requests", i, rc)
                    self.dead_ranks.add(i)
                    self.ready_ranks.discard(i)
                    with self.request_lock:
                        for rid, data in self.pending_requests.items():
                            if data.get("rank") == i:
                                data["error"] = (
                                    f"scheduler process died (exit {rc})")
                                data["event"].set()

    # ------------------------------------------------------------------
    # scheduler subprocess management
    # ------------------------------------------------------------------
    def _start_schedulers(self) -> None:
        for rank in range(self.dp_size):
            env = os.environ.copy()
            for k in _TPU_ENV:
                env.pop(k, None)
            if self.dp_size > 1:
                # pin each DP replica to one card (the reference's
                # CUDA_VISIBLE_DEVICES, launch.py:188-213)
                env["CUDA_VISIBLE_DEVICES"] = str(rank)
            cmd = [
                sys.executable, "-m", "vox_serve_tpu_torch.scheduler_entry",
                "--model", self.model_name,
                "--scheduler-type", self.scheduler_type,
                "--rank", str(rank),
                "--max-batch-size", str(self.max_batch_size),
                "--socket-suffix", self.socket_suffix,
            ]
            for k, v in self.scheduler_args.items():
                flag = "--" + k.replace("_", "-")
                if isinstance(v, bool):
                    if v:
                        cmd.append(flag)
                elif v is not None:
                    cmd.extend([flag, str(v)])
            self.logger.info("starting scheduler rank %d: %s", rank,
                             " ".join(cmd))
            self.scheduler_processes.append(
                subprocess.Popen(cmd, env=env))

    def schedulers_alive(self) -> bool:
        return all(p.poll() is None for p in self.scheduler_processes)

    @property
    def ready(self) -> bool:
        if not self.scheduler_processes:  # in-process/test mode
            return True
        return (not self.dead_ranks
                and len(self.ready_ranks) >= self.dp_size)

    # ------------------------------------------------------------------
    # threads
    # ------------------------------------------------------------------
    def _sender_loop(self) -> None:
        backoff_initial, backoff_max = 0.001, 0.02
        while self.running:
            try:
                payload, rank = self.to_scheduler.get(timeout=0.1)
            except queue.Empty:
                continue
            sock = self.request_sockets[rank]
            backoff = backoff_initial
            while self.running:
                try:
                    sock.send(payload, flags=zmq.DONTWAIT)
                    break
                except zmq.Again:
                    time.sleep(backoff)
                    backoff = min(backoff * 2, backoff_max)
                except Exception as e:  # pragma: no cover
                    self.logger.error("sender error: %s", e)
                    break

    def _process_messages(self) -> None:
        while self.running:
            try:
                message = self.result_socket.recv(flags=zmq.NOBLOCK)
            except zmq.Again:
                time.sleep(0.001)
                continue
            except Exception as e:  # pragma: no cover
                if self.running:
                    self.logger.error("result recv error: %s", e)
                continue
            parts = message.split(b"|", 2)
            if len(parts) < 3:
                self.logger.warning("malformed result message: %r",
                                    message[:100])
                continue
            rid = parts[0].decode()
            mtype = parts[1].decode()
            data = parts[2]
            if rid == "__scheduler__" and mtype == "READY":
                try:
                    payload = json.loads(data.decode())
                except Exception:
                    payload = {}
                rank = payload.get("rank", 0)
                self.ready_ranks.add(rank)
                if not payload.get("assets_available", True):
                    self.assets_available = False
                    self.logger.warning(
                        "rank %s serving with DEV assets (random weights / "
                        "fallback tokenizer) — /health will flag it", rank)
                self.logger.info("scheduler rank %s ready (%d/%d)", rank,
                                 len(self.ready_ranks), self.dp_size)
                continue
            with self.request_lock:
                now = time.time()
                while self.recently_completed:
                    k, ts = next(iter(self.recently_completed.items()))
                    if now - ts > self.recently_completed_ttl_sec:
                        self.recently_completed.popitem(last=False)
                    else:
                        break
                if rid in self.pending_requests:
                    if mtype == "AUDIO":
                        self.pending_requests[rid]["chunks"].append(data)
                    elif mtype == "COMPLETION":
                        # a malformed payload must not kill this thread —
                        # every future request would hang to timeout
                        try:
                            info = json.loads(data.decode())
                        except Exception:
                            info = {"status": "completed",
                                    "note": "unparseable completion payload"}
                        self.logger.info("request %s completed: %s", rid, info)
                        self.pending_requests[rid]["event"].set()
                        self.recently_completed[rid] = now
                elif rid in self.recently_completed:
                    pass  # late message, drop silently
                else:
                    self.logger.warning("message %s for unknown request %s",
                                        mtype, rid)

    # ------------------------------------------------------------------
    # request entry points
    # ------------------------------------------------------------------
    def _enqueue_request(self, payload: bytes, rank: int) -> None:
        try:
            self.to_scheduler.put_nowait((payload, rank))
        except queue.Full:
            raise APIError(429, "Server busy; please retry shortly") from None

    def _pick_rank(self) -> int:
        live = [r for r in range(self.dp_size) if r not in self.dead_ranks]
        if not live:
            raise APIError(503, "all scheduler ranks are dead")
        rank = live[self.dp_request_counter % len(live)]
        self.dp_request_counter += 1
        return rank

    def _register(self, rid: str, entry: dict, payload: bytes) -> None:
        """Insert the pending entry and enqueue the first frame; on queue
        saturation the entry is removed again (it leaked one dict entry per
        429 before)."""
        with self.request_lock:
            self.pending_requests[rid] = entry
        try:
            self._enqueue_request(payload, entry["rank"])
        except APIError:
            self._finish_request(rid)
            raise

    def _finish_request(self, rid: str) -> None:
        """Drop a pending entry and its uploaded reference audio (the upload
        lives until the request is done — a fixed timer deleted it before a
        loaded scheduler had read it)."""
        with self.request_lock:
            data = self.pending_requests.pop(rid, None)
            self.recently_completed[rid] = time.time()
        if data and data.get("upload_path"):
            try:
                p = Path(data["upload_path"])
                if p.exists():
                    p.unlink()
            except OSError:
                pass

    def start_streaming_request(self, text: str = None,
                                audio_path: str = None,
                                model_kwargs: dict = None) -> str:
        rid = str(uuid.uuid4())
        rank = self._pick_rank()
        entry = {
            "chunks": [], "event": threading.Event(),
            "streaming": True, "consumed_chunks": 0,
            "rank": rank, "upload_path": audio_path,
        }
        msg = json.dumps({
            "request_id": rid, "prompt": text, "audio_path": audio_path,
            "is_streaming": True, "model_kwargs": model_kwargs or {},
        }).encode() + b"|audio_data_placeholder"
        self._register(rid, entry, msg)
        return rid

    def start_input_streaming_request(self, audio_path: str = None,
                                      model_kwargs: dict = None) -> str:
        rid = str(uuid.uuid4())
        rank = self._pick_rank()
        entry = {
            "chunks": [], "event": threading.Event(),
            "streaming": True, "input_streaming": True,
            "consumed_chunks": 0, "rank": rank, "upload_path": audio_path,
        }
        cfg = {"audio_path": audio_path, "model_kwargs": model_kwargs or {}}
        self._register(rid, entry,
                       rid.encode() + b"|TEXT_STREAM_START|"
                       + json.dumps(cfg).encode())
        return rid

    def send_text_chunk(self, rid: str, text: str) -> bool:
        with self.request_lock:
            data = self.pending_requests.get(rid)
            if not data:
                raise APIError(404, f"Request {rid} not found")
            if not data.get("input_streaming"):
                raise APIError(
                    400, f"Request {rid} is not an input streaming request")
            if data["event"].is_set():
                raise APIError(400, f"Request {rid} already completed")
            rank = data["rank"]
        self._enqueue_request(rid.encode() + b"|TEXT_UPDATE|" + text.encode(),
                              rank)
        return True

    def end_input_streaming(self, rid: str) -> None:
        with self.request_lock:
            data = self.pending_requests.get(rid)
            if data is None:
                raise APIError(404, f"Request {rid} not found")
            if not data.get("input_streaming"):
                raise APIError(
                    400, f"Request {rid} is not an input streaming request")
            rank = data["rank"]
        self._enqueue_request(rid.encode() + b"|TEXT_COMPLETE|", rank)

    # ------------------------------------------------------------------
    # chunk consumption
    # ------------------------------------------------------------------
    async def async_stream_chunks(self, rid: str):
        import asyncio

        start = time.time()
        try:
            while True:
                if time.time() - start > self.timeout_seconds:
                    raise APIError(500, "Generation timed out")
                new_chunks, done = [], False
                with self.request_lock:
                    data = self.pending_requests.get(rid)
                    if data:
                        avail = len(data["chunks"])
                        consumed = data.get("consumed_chunks", 0)
                        new_chunks = data["chunks"][consumed:avail]
                        data["consumed_chunks"] = avail
                        done = data["event"].is_set()
                    else:
                        done = True
                for c in new_chunks:
                    yield c
                if done:
                    remaining, error = [], None
                    with self.request_lock:
                        data = self.pending_requests.get(rid)
                        if data:
                            consumed = data.get("consumed_chunks", 0)
                            remaining = data["chunks"][consumed:]
                            error = data.get("error")
                    for c in remaining:
                        yield c
                    if error:
                        raise APIError(500, error)
                    break
                await asyncio.sleep(0.001)
        finally:
            # runs on normal completion, timeout, AND generator abandonment
            # (client disconnect / handler cancellation): without it the
            # orphaned entry kept accumulating PCM forever
            self._finish_request(rid)

    def collect_all_chunks(self, rid: str) -> bytes:
        """Blocking wait for completion (non-streaming /generate path)."""
        with self.request_lock:
            data = self.pending_requests.get(rid)
        if data is None:
            raise APIError(404, f"Request {rid} not found")
        try:
            if not data["event"].wait(timeout=self.timeout_seconds):
                raise APIError(500, "Generation timed out")
            if data.get("error"):
                raise APIError(500, data["error"])
            return b"".join(data["chunks"])
        finally:
            self._finish_request(rid)

    def has_request(self, rid: str) -> Optional[dict]:
        with self.request_lock:
            return self.pending_requests.get(rid)

    # ------------------------------------------------------------------
    def cleanup(self) -> None:
        if not self.running:
            return
        self.logger.info("cleaning up API server...")
        self.running = False
        for t in ("message_thread", "sender_thread"):
            th = getattr(self, t, None)
            if th and th.is_alive():
                th.join(timeout=1)
        try:
            for s in self.request_sockets:
                s.close()
            self.result_socket.close()
            self.context.term()
        except Exception as e:  # pragma: no cover
            self.logger.error("zmq cleanup error: %s", e)
        for i, p in enumerate(self.scheduler_processes):
            if p.poll() is None:
                try:
                    p.terminate()
                    try:
                        p.wait(timeout=2)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait(timeout=2)
                except Exception as e:  # pragma: no cover
                    self.logger.error("error stopping scheduler %d: %s", i, e)
