"""One run of one cell of the port's benchmark:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``vox_serve_tpu_torch``). It

1. refuses without a CUDA card (or with fewer than the cell asks for),
   after naming the device on standard error;
2. starts the port's launcher (``portbench.serve``: the launcher with the
   harness's daemon hooks) with the configuration's flags, the seed, a free
   port, a socket suffix of its own and a stats file, and times set-up to
   the first 200 of ``GET /health`` (``setup_s``);
3. sends the cell's traffic (``client.py``): a warm-in, the measured
   window of ``--seconds``, then a drain of the window's requests; with
   ``--trace 1`` the daemon's profiler runs over the first
   ``TRACE_SECONDS`` of the window;
4. stops the launcher with SIGTERM (the daemon writes its stats file),
   then judges a sample of the window's requests against the plain
   reference (``reference/<family>.py``) on the same card;
5. prints the metrics the cell reports (its end-to-end metrics, or with
   ``--trace 1`` its per-layer ones, each read by ``metrics/<name>.py``)
   as the last line of standard output, a JSON object.

Everything the run writes goes under ``TMPDIR`` (one directory per run,
removed at the end) and the kernel caches under ``.portbench_cache/`` in
the checkout. The port's IPC sockets are the one fixed path it uses
(``/tmp/vox_serve_*<suffix>.ipc``); the run's own suffix keeps runs apart.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

from portbench import spec
from portbench.client import Sender
from portbench.traffic import Traffic

#: seconds of the window the profiler traces in a ``--trace 1`` run
TRACE_SECONDS = 4.0
#: limit on set-up (model build, kernel build, graph capture)
SETUP_LIMIT_S = 240.0
#: modules that must not be loaded in this process (compared by their
#: whole top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "vox_serve_tpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def nvidia_smi(query: str) -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=30)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def device_info(chips: int) -> dict:
    """The card(s), or SystemExit when there is none or too few."""
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false")
        raise SystemExit(3)
    count = torch.cuda.device_count()
    name = torch.cuda.get_device_name(0)
    try:
        limits = nvidia_smi("power.limit")
    except (OSError, subprocess.SubprocessError):
        limits = []
    log(f"device: {name} x {count}, power.limit {limits} W")
    if count < chips:
        log(f"the cell needs {chips} cards; this machine has {count}")
        raise SystemExit(3)
    return {"kind": name, "count": chips, "power_limit_w": limits[:chips]}


def memory_used_bytes(chips: int) -> int:
    """The fullest used card's memory (every process on it), by
    nvidia-smi."""
    used = [int(float(x)) for x in nvidia_smi("memory.used")[:chips]]
    return max(used) * 2**20


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def health(port: int) -> int:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=2) as r:
            return r.status
    except OSError:
        return 0


@dataclasses.dataclass
class Context:
    """What the metric readers read."""
    model: dict
    family: object
    sample_rate: int
    setup_s: float
    requests: list
    window_requests: list
    timeline: object
    stats: dict
    counts: dict
    trace: dict | None


class Server:
    """The launcher process and the run's directory."""

    def __init__(self, root: Path, run_dir: Path, config: dict, seed: int,
                 trace: bool, env_extra: dict | None = None):
        self.run_dir = run_dir
        self.port = free_port()
        self.log_path = run_dir / "server.log"
        cache = root / ".portbench_cache"
        hub = run_dir / "hub"  # empty: the port serves its random init
        hub.mkdir()
        env = dict(os.environ)
        env.update({
            "PORTBENCH_CTL": str(run_dir),
            "PORTBENCH_TRACE": "1" if trace else "0",
            "HF_HUB_CACHE": str(hub), "HF_HOME": str(run_dir / "hf"),
            "TRITON_CACHE_DIR": str(cache / "triton"),
            "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "USE_FLAX": "0", "USE_TF": "0", "USE_JAX": "0",
            "PYTHONPATH": os.pathsep.join(
                [str(root)] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else [])),
        })
        env.pop("PORTBENCH_FAULT", None)
        env.update(env_extra or {})
        cmd = [sys.executable, "-m", "portbench.serve", *config["launch"],
               "--seed", str(seed), "--host", "127.0.0.1",
               "--port", str(self.port),
               "--socket-suffix", f"_pb{os.getpid()}_{self.port}",
               "--stats-file", str(run_dir / "stats.json"),
               "--log-level", "warning"]
        self._log = open(self.log_path, "wb")
        self.t_start = time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=root, env=env,
                                     stdout=self._log,
                                     stderr=subprocess.STDOUT,
                                     start_new_session=True)

    def wait_ready(self, limit_s: float) -> float:
        """Seconds from the launch to the first 200 of /health."""
        while True:
            if health(self.port) == 200:
                return time.perf_counter() - self.t_start
            if self.proc.poll() is not None:
                raise RuntimeError(f"the launcher exited with "
                                   f"{self.proc.returncode} during set-up")
            if time.perf_counter() - self.t_start > limit_s:
                raise RuntimeError(f"no /health 200 within {limit_s} s")
            time.sleep(0.2)

    def daemon_pid(self) -> int | None:
        p = self.run_dir / "pid"
        return int(p.read_text()) if p.exists() else None

    def stop(self) -> None:
        """SIGTERM to the launcher (which stops its daemon, which writes
        its stats file); then every process of the session is killed."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        pid = self.daemon_pid()
        deadline = time.monotonic() + 10
        while pid is not None and _alive(pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        if self.proc.poll() is None:
            self.proc.wait(timeout=30)
        self._log.close()

    def log_tail(self, n: int = 6000) -> str:
        try:
            return self.log_path.read_bytes()[-n:].decode(errors="replace")
        except OSError:
            return ""


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    # a zombie child of the launcher counts as ended
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def read_records(path: Path) -> dict:
    """The daemon's completed requests by the first 8 characters of their
    id (the id the client sees)."""
    out = {}
    if path.exists():
        for line in path.read_text().splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # a line still being written
            out[rec["rid"][:8]] = rec
    return out


def request_counts(path: Path, timeout_s: float = 20.0) -> dict:
    """Ask the daemon wrapper for its step counters."""
    (path.parent / "counts_request").touch()
    deadline = time.monotonic() + timeout_s
    while not path.exists():
        if time.monotonic() > deadline:
            raise RuntimeError("the daemon wrote no step counts")
        time.sleep(0.1)
    return json.loads(path.read_text())


class Hooks:
    """What the run does from the client's event loop: profiler start and
    stop (SIGUSR2 to the daemon) and memory samples."""

    def __init__(self, server: Server, trace: bool, chips: int):
        self.server = server
        self.trace = trace
        self.chips = chips
        self.trace_state = 0   # 0 not started, 1 running, 2 stopped
        self.memory: list[int] = []
        self._sampled: set = set()
        self._threads: list[threading.Thread] = []

    def sample_memory(self) -> None:
        try:
            self.memory.append(memory_used_bytes(self.chips))
        except (OSError, subprocess.SubprocessError, ValueError):
            pass

    def on_tick(self, now: float, tl) -> None:
        if self.trace and self.trace_state == 0 and now >= tl.t0:
            os.kill(self.server.daemon_pid(), signal.SIGUSR2)
            self.trace_state = 1
        elif (self.trace and self.trace_state == 1
              and now >= tl.t0 + min(TRACE_SECONDS, tl.t1 - tl.t0)):
            os.kill(self.server.daemon_pid(), signal.SIGUSR2)
            self.trace_state = 2
        for mark, t in (("t0", tl.t0), ("mid", (tl.t0 + tl.t1) / 2),
                        ("t1", tl.t1)):
            if now >= t and mark not in self._sampled:
                self._sampled.add(mark)
                th = threading.Thread(target=self.sample_memory)
                th.start()
                self._threads.append(th)

    def join(self) -> None:
        for th in self._threads:
            th.join(timeout=60)


def wait_file(path: Path, timeout_s: float) -> dict:
    deadline = time.monotonic() + timeout_s
    while not path.exists():
        if time.monotonic() > deadline:
            raise RuntimeError(f"{path.name} not written within "
                               f"{timeout_s} s")
        time.sleep(0.2)
    return json.loads(path.read_text())


def sample_items(cell: spec.Cell, seed: int, sender: Sender,
                 records: dict) -> list[dict]:
    """The finished window requests to judge: the longest one and
    ``check.requests - 1`` more drawn from the seed, each with its served
    rows and windows (the daemon's record) and the PCM the client got."""
    import numpy as np

    done = [r for r in sender.window_requests()
            if not r.failed and r.rid8 in records]
    if not done:
        raise RuntimeError("no finished window request to judge")
    done.sort(key=lambda r: (-records[r.rid8]["audio_tokens"], r.rid8))
    rest = done[1:]
    random.Random(f"sample:{seed}").shuffle(rest)
    items = []
    for r in [done[0]] + rest[:cell.config["check"]["requests"] - 1]:
        rec = records[r.rid8]
        items.append({"prompt": rec["prompt"], "tokens": rec["tokens"],
                      "windows": rec["windows"],
                      "audio_tokens": rec["audio_tokens"],
                      "pcm": np.frombuffer(bytes(r.pcm), np.int16)})
    return items


def judge(items: list[dict], ref, control=None) -> dict:
    """The numbers of ``items`` (``ref.judge``): each gap and length
    difference the worst over them; ``pcm_rmse`` (and the control's) the
    root mean square of the served PCM's difference from the reference's,
    in full-scale units, over all their samples."""
    worst: dict = {}
    sums: dict = {}
    for item in items:
        for k, v in ref.judge(item, control).items():
            if k.endswith(("_sq_err", "_samples")):
                sums[k] = sums.get(k, 0.0) + v
            else:
                worst[k] = max(worst.get(k, v), v)
    n = max(sums.get("pcm_samples", 0.0), 1.0)
    for k in ("pcm", "ctl_pcm"):
        if k + "_sq_err" in sums:
            worst[k + "_rmse"] = (sums[k + "_sq_err"] / n) ** 0.5
    return worst


def device_s_by_step(summary: dict) -> dict:
    """Device seconds of the traced window by the kind of worker call that
    launched them (prefill, decode, detok), and outside any."""
    from portbench.trace import parse_range

    out: dict = {}
    for r in summary["ranges"]:
        kind = parse_range(r["name"])[0]
        out[kind] = out.get(kind, 0.0) + r["device_s"]
    out["other"] = summary["busy_s"] - sum(out.values())
    return out


def decide(numbers: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit: every window
    request finished and every number at or under its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return (failed == 0 and all(c["value"] <= c["limit"]
                                for c in checks.values()), checks)


@dataclasses.dataclass
class Served:
    """What one served run of a cell left: the client's requests, the
    daemon's records, counts, stats and trace, set-up and memory."""
    sender: Sender
    records: dict
    counts: dict
    stats: dict
    trace: dict | None
    setup_s: float
    memory_peak: int | None

    @property
    def failed(self) -> list:
        return [r for r in self.sender.window_requests() if r.failed]


def serve_once(root: Path, cell: spec.Cell, seed: int, seconds: float,
               trace: bool, env_extra: dict | None = None) -> Served:
    """Start the cell's server, send its traffic, stop the server; every
    process it started has ended when it returns."""
    conf, mix = cell.config, cell.traffic
    run_dir = Path(tempfile.mkdtemp(prefix="portbench-"))
    server = None
    try:
        server = Server(root, run_dir, conf, seed, trace, env_extra)
        setup_s = server.wait_ready(SETUP_LIMIT_S)
        log(f"set-up {setup_s:.2f} s; traffic {cell.name}: {mix['loop']} "
            + (f"loop at {mix['rate_per_s']} req/s" if mix["loop"] ==
               "open" else f"loop of {mix['clients']} callers"))
        hooks = Hooks(server, trace, cell.chips)
        hooks.sample_memory()
        sender = Sender(f"http://127.0.0.1:{server.port}",
                        Traffic(mix, seed), mix["warm_in_s"], seconds,
                        mix["drain_limit_s"], hooks.on_tick)
        sender.run()
        hooks.join()
        window = sender.window_requests()
        failed = [r for r in window if r.failed]
        log(f"{len(sender.requests)} requests sent, {len(window)} due in the "
            f"window, {len(failed)} failed; generator late by at most "
            f"{sender.max_late_s * 1e3:.1f} ms")
        for r in failed[:5]:
            log(f"failed: status {r.status} error {r.error}")
        # every finished window request's record, then the step counts
        rec_path = run_dir / "records.jsonl"
        want = {r.rid8 for r in window if not r.failed}
        deadline = time.monotonic() + 30
        records = read_records(rec_path)
        while not want <= set(records) and time.monotonic() < deadline:
            time.sleep(0.2)
            records = read_records(rec_path)
        counts = request_counts(run_dir / "counts.json")
        summary = wait_file(run_dir / "trace.json", 120) if trace else None
        server.stop()
        stats = json.loads((run_dir / "stats.json").read_text())
        if any(stats["checkpoint"].get(k) for k in stats["checkpoint"]):
            raise RuntimeError(f"a checkpoint was loaded: "
                               f"{stats['checkpoint']}")
        if summary is not None:
            if "error" in summary:
                raise RuntimeError(f"trace reduction failed: "
                                   f"{summary['error']}")
            if summary["busy_s"] <= 0 or summary["device_events"] == 0:
                raise RuntimeError("the profiler recorded no device time")
            log(f"trace: {summary['device_events']} device events, busy "
                f"{summary['busy_s']:.3f} of {summary['window_s']:.3f} s, "
                f"{summary['device_s_in_ranges']:.3f} s in marked steps, "
                f"reduced in {summary.get('reduce_s', 0):.1f} s")
        return Served(sender, records, counts, stats, summary, setup_s,
                      max(hooks.memory) if hooks.memory else None)
    except BaseException:
        if server is not None:
            log("server log tail:\n" + server.log_tail())
        raise
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(run_dir, ignore_errors=True)


def run(args) -> int:
    root = Path.cwd()
    cell = spec.cell(spec.benchmark(root), args.workload, root,
                     bool(args.trace))
    conf = cell.config
    dev = device_info(cell.chips)
    sv = serve_once(root, cell, args.seed, args.seconds, bool(args.trace))
    items = sample_items(cell, args.seed, sv.sender, sv.records)
    t = time.perf_counter()
    fam = spec.reference(conf["family"])
    numbers = judge(items, fam.make_reference(conf["model"], args.seed,
                                              "cuda"))
    log(f"judged {len(items)} requests ("
        f"{sum(i['audio_tokens'] for i in items)} served frames) in "
        f"{time.perf_counter() - t:.1f} s")
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 4
    window = sv.sender.window_requests()
    ctx = Context(conf["model"], fam, conf["sample_rate"],
                  sv.setup_s, sv.sender.requests, window, sv.sender.timeline,
                  sv.stats, sv.counts, sv.trace)
    metrics = {}
    for m in cell.metrics:
        v = spec.reader(m.name)(ctx)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    correct, checks = decide(numbers, conf["check"]["limits"],
                             len(sv.failed))
    device = {"platform": "gpu", "kind": dev["kind"], "count": dev["count"],
              "memory_peak_bytes": sv.memory_peak,
              "power_limit_w": dev["power_limit_w"]}
    result = {"correct": correct, "attempted": len(window),
              "failed": len(sv.failed), "metrics": metrics, "device": device}
    if sv.trace is not None:
        device["busy_s"] = sv.trace["busy_s"]
        device["window_s"] = sv.trace["window_s"]
        result["breakdown"] = {"device_ops": sv.trace["device_ops"],
                               "idle_gaps": sv.trace["idle_gaps"]}
        result["device_s_by_step"] = device_s_by_step(sv.trace)
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> None:
    sys.exit(run(parse_args(argv)))


if __name__ == "__main__":
    main()
