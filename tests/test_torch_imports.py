"""The port imports torch and never jax: checked in a fresh interpreter
(the test process itself imports jax for the parity tests), and by source.
Also: the serving device is explicit, and asking for CUDA without it fails
at start-up; and the checkpoint loaders work with the card's installation,
which has none of safetensors, huggingface_hub, transformers, yaml or
ml_dtypes (a fresh interpreter in which they cannot be imported resolves
and reads a bf16 snapshot through the hub cache and loads a Qwen3
checkpoint, a SilentCipher snapshot and the dev tokenizer)."""

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
    "vox_serve_tpu_torch.encoders.ecapa",
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
    for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py",
              ROOT / "synthetic_checkpoints.py"]:
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
        "import synthetic_checkpoints\n"
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


_CARD_INSTALL = """
import importlib.abc, os, sys, tempfile
from pathlib import Path

MISSING = {"safetensors", "huggingface_hub", "transformers", "yaml",
           "ml_dtypes", "jax", "jaxlib", "vox_serve_tpu"}


class Missing(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in MISSING:
            raise ImportError(f"No module named {name!r}")
        return None


sys.meta_path.insert(0, Missing())
cache = Path(tempfile.mkdtemp())
os.environ["HF_HUB_CACHE"] = str(cache)
import torch

import synthetic_checkpoints as synth
from vox_serve_tpu_torch import weights
from vox_serve_tpu_torch.codecs.qwen3_codec import Qwen3CodecConfig
from vox_serve_tpu_torch.encoders.ecapa import EcapaConfig, init_ecapa
from vox_serve_tpu_torch.models.backbone import BackboneConfig
from vox_serve_tpu_torch.models.depth import DepthConfig
from vox_serve_tpu_torch.models.qwen3_tts import Qwen3TTSLM
from vox_serve_tpu_torch.params import tree_leaves, tree_map
from vox_serve_tpu_torch.watermark import silentcipher as sc
from vox_serve_tpu_torch.watermark import spectral

g = torch.Generator().manual_seed(0)
src = {"w": torch.randn(5, 7, generator=g).to(torch.bfloat16),
       "i": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
snap = synth.snapshot_dir(cache, "Org/tiny")
synth.write_shards(snap, src, 1)
assert weights.resolve_model_dir("Org/tiny") == snap
back = weights.load_safetensors_state(snap)
assert back["w"].dtype == torch.bfloat16
assert torch.equal(back["w"].view(torch.int16), src["w"].view(torch.int16))
assert torch.equal(back["i"], src["i"])

name = "Qwen/Qwen3-TTS-12Hz-1.7B-Base"
bb = BackboneConfig(vocab_size=3072, hidden_size=32, num_layers=2,
                    num_heads=2, num_kv_heads=1, head_dim=16,
                    intermediate_size=48, qk_norm=True)
dp = DepthConfig(hidden_size=16, num_layers=1, num_heads=2, num_kv_heads=1,
                 head_dim=8, intermediate_size=24, max_seq=17, qk_norm=True)
codec = Qwen3CodecConfig(codebook_dim=16, latent_dim=16, decoder_dim=16,
                         hidden_size=16, intermediate_size=16, head_dim=8,
                         num_heads=2, num_kv_heads=2, num_layers=1,
                         sliding_window=8, upsample_rates=(2,),
                         upsampling_ratios=(2,), vq_dim=8)
m = Qwen3TTSLM(name, device="cpu", debug_backbone=bb, debug_depth=dp,
               debug_codec=codec)
spk = init_ecapa(EcapaConfig(mel_dim=128, enc_dim=32,
                             channels=(8, 8, 8, 8, 24), se_channels=4,
                             attention_channels=4), g, "cpu")
synth.write_shards(synth.snapshot_dir(cache, name),
                   synth.export_qwen3(m.params, spk, torch.bfloat16))
loaded = m._load_checkpoint()
assert loaded is not None and m._spk_enc_params is not None
same = tree_map(lambda a, b: torch.equal(a, b), loaded, m.params)
assert all(tree_leaves(same)), "talker"
assert all(tree_leaves(tree_map(
    lambda a, b: torch.equal(a, b.to(torch.bfloat16).float()),
    m._spk_enc_params, spk))), "speaker encoder"

cfg = sc.SilentCipherConfig(message_band_size=512)
synth.write_silentcipher(synth.snapshot_dir(cache, "sony/silentcipher"),
                         sc.init_silentcipher(cfg, g, "cpu"), cfg)
wm = spectral.init_watermarker(spectral.WatermarkConfig(), g, "cpu")
assert spectral.watermark_kind(wm) == "silentcipher"
assert wm["_sc_cfg"] == cfg

(snap / "tokenizer.json").write_text("{}")
tok, ok = weights.load_text_tokenizer("Org/tiny", 1000)
assert not ok and isinstance(tok, weights.DevTokenizer)
bad = sorted(k for k in sys.modules if k.split(".")[0] in MISSING)
assert not bad, bad
print("ok")
"""


def test_loaders_work_without_the_sandbox_only_packages():
    out = subprocess.run([sys.executable, "-c", _CARD_INSTALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
