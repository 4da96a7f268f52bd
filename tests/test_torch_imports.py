"""The port imports torch and never jax: checked in a fresh interpreter
(the test process itself imports jax for the parity tests), and by source.
Also: the serving device is explicit, and asking for CUDA without it fails
at start-up."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "vox_serve_tpu_torch"

torch.set_num_threads(1)

_ENTRY_MODULES = [
    "vox_serve_tpu_torch.launch",
    "vox_serve_tpu_torch.scheduler_entry",
    "vox_serve_tpu_torch.worker.base",
    "vox_serve_tpu_torch.worker.graphs",
    "vox_serve_tpu_torch.models.qwen3_tts",
    "vox_serve_tpu_torch.models.dummy",
    "vox_serve_tpu_torch.models.orpheus",
    "vox_serve_tpu_torch.codecs.snac",
    "vox_serve_tpu_torch.models.csm",
    "vox_serve_tpu_torch.codecs.mimi",
    "vox_serve_tpu_torch.watermark",
    "vox_serve_tpu_torch.watermark.spectral",
    "vox_serve_tpu_torch.watermark.silentcipher",
    "vox_serve_tpu_torch.weights",
    "vox_serve_tpu_torch.server.api",
    "vox_serve_tpu_torch.params",
    "vox_serve_tpu_torch.ops.kv_cache",
    "vox_serve_tpu_torch.ops.attention",
    "vox_serve_tpu_torch.ops.resunit",
    "vox_serve_tpu_torch.codecs.qwen3_codec",
    "vox_serve_tpu_torch.scheduler.input_streaming",
    "vox_serve_tpu_torch.scheduler.offline",
]


def test_port_imports_no_jax_in_a_fresh_interpreter():
    code = (
        "import sys, importlib\n"
        f"for m in {_ENTRY_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import vox_serve_tpu_torch.scheduler as s\n"
        "s.load_scheduler\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []
    # nothing of the JAX package either: the shared host modules are copies
    allowed = set()
    used = set()
    pkg_import = re.compile(r"^\s*(?:from|import) vox_serve_tpu(?:\.([\w.]+))?"
                            r"(?=[\s,]|$)", re.M)
    for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        used |= {m or "vox_serve_tpu"
                 for m in pkg_import.findall(p.read_text())}
    assert used <= allowed, used - allowed


def test_server_and_daemon_load_nothing_of_the_jax_package(tmp_path):
    """The HTTP server (launch, the app built over an APIServer), the
    scheduler daemon's entry and chip_smoke.py, in a fresh interpreter,
    load no module whose top-level name is vox_serve_tpu."""
    code = (
        "import sys, importlib\n"
        "for m in ('vox_serve_tpu_torch.launch',\n"
        "          'vox_serve_tpu_torch.server.app',\n"
        "          'vox_serve_tpu_torch.server.api',\n"
        "          'vox_serve_tpu_torch.scheduler_entry', 'chip_smoke'):\n"
        "    importlib.import_module(m)\n"
        "from vox_serve_tpu_torch.server.api import APIServer\n"
        "from vox_serve_tpu_torch.server.app import build_app\n"
        f"d = {str(tmp_path)!r}\n"
        "srv = APIServer(output_dir=d + '/a', upload_dir=d + '/u',\n"
        "                spawn_schedulers=False,\n"
        "                socket_suffix='_imports_test')\n"
        "app = build_app(srv, sample_rate=24000)\n"
        "assert app.router is not None\n"
        "srv.cleanup()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'vox_serve_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("rate,channels,bits,data_len", [
    (24000, 1, 16, None), (16000, 1, 16, 0), (44100, 2, 16, 123456),
    (48000, 2, 24, None), (22050, 1, 8, 4096), (8000, 6, 32, 2 ** 31)])
def test_wav_header_bytes_equal_the_jax_package(rate, channels, bits,
                                                data_len):
    from vox_serve_tpu.native import wav_header as jax_wav_header

    from vox_serve_tpu_torch.native import wav_header

    got = wav_header(rate, channels, bits, data_len)
    assert len(got) == 44
    assert got == jax_wav_header(rate, channels, bits, data_len)


def test_chip_smoke_process_imports_nothing_of_the_jax_package():
    """chip_smoke.py and the port modules it imports in its own process
    load neither jax nor any module of vox_serve_tpu."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import vox_serve_tpu_torch.ops.kernels\n"
        "import vox_serve_tpu_torch.models.backbone\n"
        "import vox_serve_tpu_torch.ops.attention\n"
        "import vox_serve_tpu_torch.ops.kv_cache\n"
        "import vox_serve_tpu_torch.ops.resunit\n"
        "import vox_serve_tpu_torch.codecs.layers\n"
        "import vox_serve_tpu_torch.params\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'vox_serve_tpu'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import jax|from jax)\b", src, re.M)
    assert "vox_serve_tpu." not in src.replace("vox_serve_tpu_torch", "")


def test_cuda_device_is_required_when_asked_for():
    from vox_serve_tpu_torch.models import load_model, resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the failure path needs a CPU-"
                    "only machine")
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        load_model("dummy")  # the default device is cuda
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_launch_fails_fast_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    out = subprocess.run(
        [sys.executable, "-m", "vox_serve_tpu_torch.launch", "--model",
         "dummy", "--port", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "CUDA is unavailable" in out.stderr
