"""The ranks of a tensor-parallel replica: one process per card.

There is no counterpart in the JAX package, where one process drives the
whole ``('dp', 'tp')`` mesh and GSPMD places the shards and derives the
collectives. Here ``ProcessGroupNCCL`` takes one card per process, so the
worker (rank 0, in the scheduler daemon, on the LM's card) spawns one
shard process per other card (ranks 1..tp-1, ``spawn``: CUDA is already
initialised in rank 0) and joins them in a ``torch.distributed`` group,
``nccl`` on the card and ``gloo`` on the CPU:

* start-up (``ShardRanks``): each rank sets its device and reports over
  its pipe; the group forms and makes one eager all-reduce, before any
  graph captures a collective; rank 0 sends each rank a ``ShardSpec`` and
  then its backbone shard over the group (``shard_params`` of the tree
  rank 0 built or loaded and, under ``weight_quant="int8"``, quantized
  whole), leaf by leaf; the rank packs it for K5 itself, allocates its KV
  pool (its own KV heads only) and its kernels' workspaces, and reports
  ready. A rank that fails to start, to join or to set up fails rank 0's
  start-up (``TPStartupError``), which stops every rank;
* steps (``ShardRanks`` as the step cache's mirror): for every prefill
  and decode step key of rank
  0 (every kind but ``detok``), rank 0 sends the key and the step's int32
  pack over the rank's pipe, in order, before it runs the step itself;
  the rank runs the same key's step, a graph of its own on its card
  (``worker/graphs.py``), captured when rank 0 captures that key, probed
  when rank 0 probes it. A rank's step holds the key's backbone calls
  only: it takes x from rank 0 by broadcast, runs its layers with the
  two all-reduces a layer, and drops the final hidden (``TPGroup``,
  ``models/backbone.py``). The pack rides the message, not a broadcast:
  the positions, page ids, block tables and lengths reach the rank's
  graph through its own pinned staging, like rank 0's;
* shutdown: a rank ends at the end of its pipe (rank 0 closed it or
  exited), or when its parent process is gone;
* stats: each rank's graphs, replays, eager calls, kernel counts per
  replay, graph pool and KV pool bytes, read over its pipe.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import socket
import threading
import time
import traceback
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils import get_logger

#: seconds a rank may take to start, join the group or set up
STARTUP_TIMEOUT_S = 300.0
#: seconds the group's rendezvous and its collectives may wait on a rank
GROUP_TIMEOUT_S = 300.0
#: seconds to wait for a rank's stats before reporting it unavailable
STATS_TIMEOUT_S = 10.0


class TPStartupError(RuntimeError):
    """A rank of a tensor-parallel replica failed to start, join the
    group or set up."""


class TPGroup:
    """This process's rank of a tensor-parallel backbone: the collectives
    ``backbone_forward`` makes over the default process group (the
    replica's ranks)."""

    def __init__(self, rank: int, size: int):
        self.rank = rank
        self.size = size

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """x from rank 0, in place."""
        dist.broadcast(x, src=0)
        return x

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the ranks, in place."""
        dist.all_reduce(t)
        return t


@dataclasses.dataclass
class ShardSpec:
    """What a rank needs to mirror rank 0's steps: the whole backbone's
    config and the replica's ``tp``, its KV pool's config (local heads),
    the kernels' workspace sizes and the pack layouts' parameters, and
    the layout of the shard tree that follows over the group."""

    cfg: Any                    # BackboneConfig, the whole backbone's
    tp: int
    kv: Any                     # KVCacheConfig of the rank's pool
    weight_quant: str
    max_batch: int              # DecodeScratch's rows
    max_pages_per_seq: int
    n_codebooks: int
    max_prefill_requests: int
    cold_chain_batch: Optional[int]   # the cold chain's decode bucket
    cold_chain_width: int             # and block-table width
    n_staging: int
    #: (path, shape, dtype) of every leaf of the shard tree, in send order
    layout: list = dataclasses.field(default_factory=list)


def tree_layout(tree: dict, prefix: tuple = ()) -> list:
    """(path, shape, dtype) of every tensor leaf of a nested dict, in a
    fixed order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += tree_layout(v, prefix + (k,))
        else:
            out.append((prefix + (k,), tuple(v.shape), v.dtype))
    return out


def _leaf(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_group(backend: str, port: int, rank: int, size: int,
                device: torch.device) -> None:
    """Join the replica's group and make its first collective, eagerly
    (NCCL makes its communicator there, before any capture)."""
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=size,
        rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if int(probe.item()) != size:
        raise RuntimeError(f"the group's first all-reduce gave "
                           f"{probe.item()}, expected {size}")


def all_reduce_ms(device: torch.device, rows: list[int], hidden: int,
                  dtype: torch.dtype, iters: int) -> dict:
    """ms per all-reduce of a (rows, hidden) tensor at each of ``rows``:
    on the card the device time of ``iters`` all-reduces captured in one
    CUDA graph (as the step graphs hold them), on the CPU the host's. Every
    rank of the group must call it with the same arguments."""
    out = {}
    for n in rows:
        t = torch.zeros((n, hidden), dtype=dtype, device=device)
        dist.all_reduce(t)
        if device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                dist.all_reduce(t)
            out[n] = (time.perf_counter() - t0) * 1e3 / iters
            continue
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(iters):
                dist.all_reduce(t)
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out[n] = start.elapsed_time(end) / iters
    return out


# ---------------------------------------------------------------------------
# rank 0
# ---------------------------------------------------------------------------


class ShardRanks:
    """Rank 0's handle on ranks 1..tp-1: start-up, the step channel,
    stats and shutdown (see the module docstring)."""

    def __init__(self, devices: list[torch.device]):
        self.logger = get_logger("tp")
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.device = self.devices[0]
        self.backend = "nccl" if self.device.type == "cuda" else "gloo"
        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        self.procs, self.conns = [], []
        self._closing = False
        try:
            for rank in range(1, self.size):
                here, there = ctx.Pipe()
                proc = ctx.Process(
                    target=shard_main, name=f"vox-tp-rank{rank}",
                    args=(rank, self.size, str(self.devices[rank]),
                          self.backend, port, there, os.getpid()),
                    daemon=True)
                proc.start()
                there.close()
                self.procs.append(proc)
                self.conns.append(here)
            for rank in range(1, self.size):
                self._expect(rank, "started")
            _init_group(self.backend, port, 0, self.size, self.device)
            for rank in range(1, self.size):
                self._expect(rank, "joined")
        except BaseException:
            self.close()
            raise
        self.group = TPGroup(0, self.size)
        #: host seconds spent sending run messages, and their count
        self.run_s = 0.0
        self.runs = 0

    def _expect(self, rank: int, tag: str,
                timeout: float = STARTUP_TIMEOUT_S) -> None:
        """Wait for the next message of ``rank``, which must be ``tag``; a
        rank's error, exit or silence raises ``TPStartupError``."""
        conn, proc = self.conns[rank - 1], self.procs[rank - 1]
        t0 = time.monotonic()
        while True:
            if conn.poll(0.2):
                try:
                    msg = conn.recv()
                except EOFError:
                    msg = ("error", "its pipe closed")
                if msg[0] == "error":
                    raise TPStartupError(f"tensor-parallel rank {rank} "
                                         f"({self.devices[rank]}) failed: "
                                         f"{msg[1]}")
                if msg[0] != tag:
                    raise TPStartupError(f"tensor-parallel rank {rank} "
                                         f"sent {msg[0]!r}, expected {tag!r}")
                return
            if not proc.is_alive():
                raise TPStartupError(f"tensor-parallel rank {rank} "
                                     f"({self.devices[rank]}) exited with "
                                     f"code {proc.exitcode} before {tag!r}")
            if time.monotonic() - t0 > timeout:
                raise TPStartupError(f"tensor-parallel rank {rank} sent no "
                                     f"{tag!r} within {timeout:.0f} s")

    def distribute(self, spec: ShardSpec, shard_of) -> None:
        """Send each rank r its spec and then its tree ``shard_of(r)`` over
        the group, one rank at a time (rank 0 holds one other rank's slice
        at a time, and none after), and wait until every rank is set up. A
        failure stops every rank."""
        try:
            for rank in range(1, self.size):
                tree = shard_of(rank)
                layout = tree_layout(tree)
                self.conns[rank - 1].send(
                    ("spec", dataclasses.replace(spec, layout=layout)))
                for path, _, _ in layout:
                    dist.send(_leaf(tree, path).contiguous(), dst=rank)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                del tree
            for rank in range(1, self.size):
                self._expect(rank, "ready")
        except BaseException:
            self.close()
            raise
        threading.Thread(target=self._watch, name="tp-ranks-watch",
                         daemon=True).start()

    def send(self, *msg) -> None:
        for conn in self.conns:
            conn.send(msg)

    # the step cache's mirror (``worker/graphs.py``): each LM key's capture
    # (with its padded warm-up pack), run (with its pack) and probe, in
    # rank 0's order; ``detok`` keys hold no backbone call

    @staticmethod
    def mirrors(key: tuple) -> bool:
        return key[0] != "detok"

    def capture(self, key: tuple, pack: np.ndarray) -> None:
        self.send("capture", key, pack)

    def run(self, key: tuple, pack: np.ndarray) -> None:
        t0 = time.perf_counter()
        self.send("run", key, pack)
        self.run_s += time.perf_counter() - t0
        self.runs += 1

    def probe(self, key: tuple) -> None:
        self.send("probe", key)

    def time_all_reduce(self, rows: list[int], hidden: int,
                        dtype: torch.dtype, iters: int = 20) -> dict:
        """Device ms per all-reduce of a (rows, hidden) tensor, at each of
        ``rows``, every rank taking part (``all_reduce_ms``); rank 0's
        times."""
        self.send("time_all_reduce", rows, hidden, dtype, iters)
        return all_reduce_ms(self.device, rows, hidden, dtype, iters)

    def stats(self) -> list[dict]:
        """Each rank's stats (``{"rank": r, "unavailable": reason}`` for a
        rank that does not answer)."""
        self.send("stats")
        out = []
        for rank, conn in enumerate(self.conns, 1):
            try:
                if conn.poll(STATS_TIMEOUT_S):
                    out.append(conn.recv()[1])
                    continue
                reason = f"no answer within {STATS_TIMEOUT_S:.0f} s"
            except (EOFError, OSError) as e:
                reason = f"pipe: {e}"
            out.append({"rank": rank, "unavailable": reason})
        return out

    def _watch(self) -> None:
        """Once the ranks are up: a rank that exits while rank 0 serves
        leaves rank 0 waiting on the card in its next collective, so end
        this process (a replica cannot step without its ranks; the API
        server then fails its requests)."""
        while not self._closing:
            for rank, proc in enumerate(self.procs, 1):
                if not proc.is_alive() and not self._closing:
                    self.logger.error(
                        "tensor-parallel rank %d (%s) exited with code %s; "
                        "ending rank 0", rank, self.devices[rank],
                        proc.exitcode)
                    os._exit(1)
            time.sleep(0.5)

    def close(self) -> None:
        """End every rank (its pipe closes). On the CPU rank 0 also leaves
        the group; an NCCL group stays with the process (leaving it waits
        on ranks that have ended), so on the card a process holds one
        replica's group."""
        self._closing = True
        for conn in self.conns:
            conn.close()
        for proc in self.procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        self.conns, self.procs = [], []
        if dist.is_initialized() and self.backend == "gloo":
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# ranks 1..tp-1
# ---------------------------------------------------------------------------


class _Shard:
    """A rank's backbone shard, KV pool and step graphs."""

    def __init__(self, rank: int, spec: ShardSpec, params: dict,
                 device: torch.device):
        from ..models.backbone import (pack_backbone_params,
                                       w8a16_groups)
        from ..ops.kernels import DecodeScratch, W8A16Scratch
        from ..ops.kv_cache import alloc_kv_pages
        from ..worker.graphs import StepCache

        self.rank, self.spec, self.device = rank, spec, device
        self.group = TPGroup(rank, spec.tp)
        self.linear_scratch = self.decode_scratch = None
        if spec.weight_quant == "int8":
            params = pack_backbone_params(params)
            if device.type == "cuda":
                torch.cuda.empty_cache()
                self.linear_scratch = W8A16Scratch(device,
                                                   w8a16_groups(params))
        self.params = params
        kv = spec.kv
        self.k_pages, self.v_pages = alloc_kv_pages(kv, device)
        if device.type == "cuda":
            self.decode_scratch = DecodeScratch(
                device, spec.max_batch, spec.cfg.num_heads // spec.tp,
                kv.num_kv_heads, kv.head_dim, spec.max_pages_per_seq,
                kv.page_size)
        self.eager_calls: dict[str, int] = {}
        self._warm: dict[tuple, np.ndarray] = {}
        gen = torch.Generator(device=device)  # draws nothing
        self.steps = StepCache(device, self._build, gen, spec.n_staging)

    def _backbone(self, T: int, positions, meta) -> None:
        """One backbone call: x from rank 0, the final hidden dropped."""
        from ..models.backbone import backbone_forward

        cfg = self.spec.cfg
        x = torch.empty((T, cfg.hidden_size), dtype=cfg.dtype,
                        device=self.device)
        backbone_forward(self.params, cfg, x, positions, meta, self.k_pages,
                         self.v_pages, self.spec.kv.kv_scales, tp=self.group)

    def _prefill(self, pack, T: int, B: int) -> None:
        from ..ops.attention import AttnMetadata
        from ..worker.base import ModelWorker

        (_, pos, seg, page_ids, offsets, _,
         _) = ModelWorker._prefill_pack_views(pack, T, B,
                                              self.spec.n_codebooks)
        meta = AttnMetadata(True, page_ids, offsets, segment_ids=seg,
                            q_positions=pos,
                            linear_scratch=self.linear_scratch)
        self._backbone(T, pos, meta)

    def _multi(self, pack, K: int, B: int, W: int) -> None:
        from ..ops.attention import AttnMetadata
        from ..worker.base import ModelWorker

        (_, _, positions, page_ids, offsets, _, seq_lens0, _,
         tables) = ModelWorker._multi_pack_views(pack, K, B,
                                                 self.spec.n_codebooks, W)
        for i in range(K):
            meta = AttnMetadata(False, page_ids[i], offsets[i],
                                block_tables=tables, seq_lens=seq_lens0 + i,
                                decode_scratch=self.decode_scratch,
                                linear_scratch=self.linear_scratch)
            self._backbone(B, positions[i], meta)

    def _build(self, key: tuple):
        """(body, warm inputs) of an LM step key: its backbone calls, over
        the pack rank 0 uses."""
        from ..ops.attention import AttnMetadata
        from ..worker.base import ModelWorker

        spec, kind = self.spec, key[0]
        C = spec.n_codebooks

        def count():
            if self.device.type == "cuda" and not self.steps.capturing:
                self.eager_calls[kind] = self.eager_calls.get(kind, 0) + 1

        if kind == "prefill":
            _, T, B = key

            def body(pack):
                count()
                self._prefill(pack, T, B)
        elif kind == "decode":
            def body(pack):
                count()
                (_, _, _, positions, page_ids, offsets, seq_lens, _,
                 tables) = ModelWorker._decode_pack_views(pack, C)
                meta = AttnMetadata(False, page_ids, offsets,
                                    block_tables=tables.contiguous(),
                                    seq_lens=seq_lens.contiguous(),
                                    decode_scratch=self.decode_scratch,
                                    linear_scratch=self.linear_scratch)
                self._backbone(pack.shape[0], positions, meta)
        elif kind in ("decode_multi", "decode_multi_detok"):
            _, B, K, W = key

            def body(pack):
                count()
                self._multi(pack, K, B, W)
        elif kind == "cold_chain":
            _, T, K = key
            Bp = spec.max_prefill_requests
            n_prefill = T * (C + 4) + 2 * Bp

            def body(pack):
                count()
                self._prefill(pack[:n_prefill], T, Bp)
                self._multi(pack[n_prefill:], K, spec.cold_chain_batch,
                            spec.cold_chain_width)
        else:
            raise ValueError(f"step key {key} holds no backbone call")
        return body, (self._warm.pop(key),)

    def capture(self, key: tuple, pack: np.ndarray) -> None:
        self._warm[key] = pack
        self.steps.get(key)

    def stats(self) -> dict:
        from ..ops import kernels

        steps = self.steps
        out = {
            "rank": self.rank, "device": str(self.device),
            "pid": os.getpid(),
            "graphs": [list(k) for k in steps.steps],
            "replays": steps.replays(),
            "eager_calls": dict(self.eager_calls),
            "captured": steps.captured_counts(),
            "probe_ms": {" ".join(map(str, k)): ms
                         for k, ms in steps.probe_ms.items()},
            "launches": kernels.launch_counts(),
            "kv_pool_bytes": sum(
                t.numel() * t.element_size()
                for t in (self.k_pages, self.v_pages) if t is not None),
            "kv_pool_shape": list(self.k_pages.shape),
        }
        if self.device.type == "cuda":
            out["pool_mib"] = steps.pool_bytes() / 2**20
        return out

    def reset(self) -> None:
        from ..ops import kernels

        kernels.reset_launch_counts()
        self.steps.reset_counts()
        self.eager_calls = {}


def _watch_parent(parent_pid: int) -> None:
    """End this rank when its parent (rank 0's process) is gone, even
    while its main thread waits on the card."""
    while True:
        time.sleep(1.0)
        if os.getppid() != parent_pid:
            os._exit(1)


def shard_main(rank: int, size: int, device_name: str, backend: str,
               port: int, conn, parent_pid: int) -> None:
    """A shard process: start-up, then rank 0's messages until its pipe
    ends (see the module docstring)."""
    threading.Thread(target=_watch_parent, args=(parent_pid,),
                     daemon=True).start()
    try:
        torch.set_num_threads(1)
        device = torch.device(device_name)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        conn.send(("started", os.getpid()))
        _init_group(backend, port, rank, size, device)
        conn.send(("joined",))
        tag, spec = conn.recv()
        params: dict = {}
        for path, shape, dtype in spec.layout:
            t = torch.empty(shape, dtype=dtype, device=device)
            dist.recv(t, src=0)
            node = params
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        shard = _Shard(rank, spec, params, device)
        conn.send(("ready",))
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        finally:
            os._exit(1)
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                break
            op = msg[0]
            if op == "run":
                shard.steps.run(msg[1], msg[2])
            elif op == "capture":
                shard.capture(msg[1], msg[2])
            elif op == "probe":
                shard.steps.probe(msg[1])
            elif op == "stats":
                conn.send(("stats", shard.stats()))
            elif op == "reset":
                shard.reset()
            elif op == "time_all_reduce":
                all_reduce_ms(device, *msg[1:])
            else:
                raise ValueError(f"unknown message {op!r}")
    except BaseException:
        traceback.print_exc()
        os._exit(1)
    os._exit(0)
