"""The port's serving profiles (``vox_serve_tpu_torch/profiles.py``)
against the JAX package's (``vox_serve_tpu/profiles.py``, the oracle of
``tests/test_profiles.py``): with both packages' tables patched to one
shared table, every argv case of the JAX test leaves the same flags in
both launchers, bar the two documented differences (no ``enable_pallas``
in the port; ``fused_min_batch`` dropped with the lattices under a
conflicting ``--max-batch-size``). Then the port's own profiles: each,
alone and under ``--max-batch-size 16``, builds a valid ``WorkerConfig``
through the daemon's construction, from the flags the launcher passes."""

import pytest

import vox_serve_tpu.profiles as jp
import vox_serve_tpu_torch.profiles as tp
from vox_serve_tpu.launch import build_parser as jax_parser
from vox_serve_tpu_torch import launch as tlaunch
from vox_serve_tpu_torch import scheduler_entry
from vox_serve_tpu_torch.server.api import scheduler_flags

#: one table for both packages (the JAX one gets its enable_pallas)
SHARED_DEFAULT = dict(tp.DEFAULT_PROFILE)
SHARED = {
    "qwen3": {"max_batch_size": 144, "max_num_pages": 3072,
              "page_size": 16, "pipeline_depth": 2,
              "first_chunk_frames": 3, "fused_decode_steps": 5,
              "fused_decode_buckets": "1,32,96,144",
              "fused_k_schedule": "5,2,2,5", "fused_min_batch": 65,
              "detok_pipeline_depth": 2, "codec_dtype": "bfloat16",
              "decode_buckets": "1,32,96,144", "detok_buckets": "16,80",
              "prefill_buckets": "64,128,256", "max_prefill_requests": 5,
              "kv_reserve_fraction": 0.05},
    "csm": {"max_batch_size": 64, "max_num_pages": 3072,
            "fused_decode_steps": 5, "fused_decode_buckets": "1,64",
            "decode_buckets": "1,64", "detok_buckets": "16,64",
            "codec_dtype": "bfloat16"},
    "orpheus": {"max_batch_size": 64, "max_num_pages": 2048,
                "decode_buckets": "1,64", "codec_dtype": "bfloat16"},
    "dummy": {"max_batch_size": 8, "max_num_pages": 256, "page_size": 8},
}
KEYS = list(SHARED_DEFAULT) + ["max_batch_size"]

#: the argv cases of tests/test_profiles.py (less --disable-pallas, which
#: the port does not have), and whether the batch conflicts with the
#: profile's
CASES = [
    (["--model", "qwen3-tts"], False),
    (["--model", "qwen3-tts", "--max-batch-size", "16",
      "--codec-dtype", "float32"], True),
    (["--model", "qwen3-tts", "--max-batch-size", "16"], True),
    (["--model", "csm-1b"], False),
    (["--model", "orpheus-3b"], False),
    (["--model", "zonos"], False),
    (["--model", "qwen3-tts", "--max-batch-size", "144"], False),
    (["--model", "qwen3-tts", "--decode-buckets", "1,32"], True),
    (["--model", "dummy"], False),
]


@pytest.fixture
def shared_tables(monkeypatch):
    monkeypatch.setattr(tp, "DEFAULT_PROFILE", dict(SHARED_DEFAULT))
    monkeypatch.setattr(tp, "SERVING_PROFILES",
                        {k: dict(v) for k, v in SHARED.items()})
    monkeypatch.setattr(jp, "DEFAULT_PROFILE",
                        {**SHARED_DEFAULT, "enable_pallas": False})
    monkeypatch.setattr(jp, "SERVING_PROFILES",
                        {k: {**v, "enable_pallas": k != "dummy"}
                         for k, v in SHARED.items()})


def _port(argv):
    args = tlaunch.build_parser().parse_args(argv)
    tp.apply_profile(args)
    return args


def _jax(argv):
    args = jax_parser().parse_args(argv)
    jp.apply_profile(args)
    return args


@pytest.mark.parametrize("argv,conflicting", CASES,
                         ids=[" ".join(c[0][1:]) for c in CASES])
def test_apply_profile_matches_jax(shared_tables, argv, conflicting):
    port, ref = _port(argv), _jax(argv)
    want = {k: getattr(ref, k) for k in KEYS}
    if conflicting:
        # the repair: the JAX launcher keeps the profile's regime boundary
        want["fused_min_batch"] = None
    assert {k: getattr(port, k) for k in KEYS} == want
    assert not hasattr(port, "enable_pallas")


def test_resolve_profile_matches_jax(shared_tables):
    for name in ("Qwen/Qwen3-TTS-12Hz-1.7B-CustomVoice", "dummy",
                 "sesame/csm-1b", "glm", ""):
        ref = jp.resolve_profile(name)
        ref.pop("enable_pallas")
        assert tp.resolve_profile(name) == ref


def test_fused_min_batch_dropped_under_a_smaller_batch(shared_tables,
                                                      monkeypatch):
    """The JAX launcher leaves a boundary of 65 under --max-batch-size 16
    (a batch of 16 never reaches it, so fused rounds never run); the
    port's leaves it unset, and the worker takes None."""
    argv = ["--model", "qwen3-tts", "--max-batch-size", "16"]
    assert _jax(argv).fused_min_batch == 65
    port = _port(argv)
    assert port.fused_min_batch is None
    assert port.fused_decode_steps == 5  # not batch-scaled: kept
    cfg = _worker_config(argv, monkeypatch)
    assert cfg.fused_min_batch is None
    assert cfg.fused_decode_steps == 5
    # the profile's own batch keeps it
    assert _port(["--model", "qwen3-tts", "--max-batch-size",
                  "144"]).fused_min_batch == 65


def test_explicit_flags_override_the_profile(shared_tables):
    a = _port(["--model", "qwen3-tts", "--codec-dtype", "float32",
               "--pipeline-depth", "0", "--max-num-pages", "99"])
    assert (a.codec_dtype, a.pipeline_depth, a.max_num_pages) == (
        "float32", 0, 99)
    assert a.max_batch_size == 144  # the rest from the profile


class _Spawned(Exception):
    """Raised by the fake APIServer with what the launcher gave it."""


def _worker_config(argv, monkeypatch):
    """The daemon's WorkerConfig from the flags ``launch.main`` passes its
    daemon for ``argv`` (the launcher stopped where it would spawn it)."""
    import vox_serve_tpu_torch.server.api as api

    def spawn(**kw):
        raise _Spawned(kw)

    monkeypatch.setattr(api, "APIServer", spawn)
    with pytest.raises(_Spawned) as e:
        tlaunch.main([*argv, "--device", "cpu"])
    kw = e.value.args[0]
    d = scheduler_entry.build_parser().parse_args(
        ["--model", kw["model_name"], "--max-batch-size",
         str(kw["max_batch_size"]), *scheduler_flags(kw["scheduler_args"])])
    return scheduler_entry.worker_config(d)


def _check(cfg):
    """What the worker would refuse at start-up."""
    assert cfg.decode_buckets[-1] == cfg.max_batch_size
    assert cfg.detok_buckets[-1] <= cfg.max_batch_size
    assert max(cfg.fused_decode_buckets) <= cfg.max_batch_size
    if cfg.fused_k_schedule is not None:
        assert len(cfg.fused_k_schedule) == len(cfg.fused_decode_buckets)
        assert all(1 <= k <= cfg.fused_decode_steps
                   for k in cfg.fused_k_schedule)
    if cfg.fused_min_batch is not None:
        assert cfg.fused_min_batch <= cfg.max_batch_size


@pytest.mark.parametrize("key", list(tp.SERVING_PROFILES))
@pytest.mark.parametrize("batch", [None, 16])
def test_port_profiles_build_a_valid_worker_config(key, batch,
                                                   monkeypatch):
    argv = ["--model", key]
    if batch is not None:
        argv += ["--max-batch-size", str(batch)]
    cfg = _worker_config(argv, monkeypatch)
    _check(cfg)
    prof = tp.resolve_profile(key)
    assert cfg.max_batch_size == (batch or prof["max_batch_size"])
    assert cfg.num_pages == prof["max_num_pages"]
    if batch is None:
        if prof["decode_buckets"]:
            assert ",".join(map(str, cfg.decode_buckets)) == \
                prof["decode_buckets"]
        assert cfg.fused_min_batch == prof["fused_min_batch"]
    else:
        assert cfg.fused_min_batch is None


def test_port_profiles_hold_no_tpu_switch():
    for prof in tp.SERVING_PROFILES.values():
        assert "enable_pallas" not in prof
        assert set(prof) <= set(tp.DEFAULT_PROFILE)


def test_unprofiled_model_gets_the_generic_defaults():
    a = _port(["--model", "zonos"])
    assert a.max_batch_size == 8
    assert a.max_num_pages == 2048
    assert a.page_size == 16
    assert a.pipeline_depth == 0
    assert a.fused_decode_steps == 0
