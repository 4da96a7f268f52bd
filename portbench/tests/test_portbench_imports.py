"""No module the harness's run loads, nor the daemon side it starts, is
JAX or the JAX package (top-level names compared whole: the port's name
begins with the JAX package's); the references load nothing of the
port either."""

import json
import os
import subprocess
import sys

import pytest

from portbench.spec import HERE

ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "vox_serve_tpu"}


def _loaded(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for k in ("JAX_PLATFORMS",):
        env.pop(k, None)
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_run_loads_no_jax():
    mods = _loaded("import portbench.run, portbench.control, "
                   "portbench.sweep, portbench.run as r\n"
                   "r.spec.reader('decode_mfu_pct')")
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_served_side_loads_no_jax():
    mods = _loaded("import portbench.serve, portbench.daemon\n"
                   "import vox_serve_tpu_torch.launch\n"
                   "import vox_serve_tpu_torch.scheduler_entry\n"
                   "import vox_serve_tpu_torch.worker\n"
                   "import vox_serve_tpu_torch.models.qwen3_tts\n"
                   "import vox_serve_tpu_torch.models.cosyvoice2")
    assert not mods & FORBIDDEN, mods & FORBIDDEN
    assert "vox_serve_tpu_torch" in mods


@pytest.mark.parametrize("family", ["qwen3_tts", "cosyvoice2"])
def test_the_references_load_nothing_of_the_port(family):
    mods = _loaded(f"import portbench.reference.{family}")
    assert not mods & (FORBIDDEN | {"vox_serve_tpu_torch"}), mods


def test_the_harness_sources_name_no_jax():
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for bad in ("import jax", "from jax", "import vox_serve_tpu\n",
                    "from vox_serve_tpu ", "from vox_serve_tpu.",
                    "import vox_serve_tpu.", "from benchmark",
                    "import benchmark"):
            assert bad not in text, (path, bad)
