"""Data-parallel replicas of the port: ``python -m
vox_serve_tpu_torch.launch --model dummy --device cpu --dp-size 2`` starts
two scheduler daemons and assigns requests round robin (the oracle is
``tests/test_dp.py``, the JAX launcher's). Four concurrent requests all
complete, and each daemon's stats file (rank 1 writes ``PATH.rank1``)
lists the two it served, within 60 s."""

import json
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import httpx

ROOT = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_dp2_serves_round_robin(tmp_path):
    port = _free_port()
    stats = tmp_path / "stats.json"
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "vox_serve_tpu_torch.launch",
         "--model", "dummy", "--device", "cpu", "--dp-size", "2",
         "--port", str(port), "--host", "127.0.0.1",
         "--socket-suffix", f"_tdp{port}", "--stats-file", str(stats)],
        cwd=ROOT)
    base = f"http://127.0.0.1:{port}"
    results = []
    try:
        while True:
            assert proc.poll() is None, "server died during start-up"
            try:
                if httpx.get(base + "/health", timeout=2).status_code == 200:
                    break
            except httpx.HTTPError:
                pass
            assert time.monotonic() - t0 < 60, "not healthy within 60 s"
            time.sleep(0.3)

        def go(i):
            r = httpx.post(base + "/generate",
                           data={"text": f"dp request {i}",
                                 "streaming": "false"}, timeout=60)
            results.append((r.status_code, len(r.content)))

        threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5)
    assert time.monotonic() - t0 < 60
    assert len(results) == 4
    assert all(status == 200 and size > 44 for status, size in results)
    served = {}
    for rank, path in enumerate((stats, Path(f"{stats}.rank1"))):
        for _ in range(100):
            if path.exists() and path.stat().st_size:
                break
            time.sleep(0.1)
        st = json.loads(path.read_text())
        assert st["rank"] == rank
        assert st["max_batch_size"] == 8 and st["num_pages"] == 256
        served[rank] = len(st["requests"])
    assert served == {0: 2, 1: 2}
