"""Port parity, CosyVoice2's voice cloning (vox_serve_tpu_torch/encoders/
whisper_exact.py, s3_exact.py, campplus.py, mel.py, speaker.py and
onnx_reader.py) against the JAX package's counterparts, on the CPU in
float32, with the same weights in both packages.

* ``slaney_mel_filters``, ``whisper_log_mel`` and ``kaldi_fbank`` (numpy
  copies): bit-equal;
* S3 v2 at the dev config (256 wide, 4 heads, 2 layers) on 2 s of audio:
  the FSQ head's pre-quantization values within 1e-4 of JAX's, and the
  tokens equal except where one of JAX's eight values lies within 1e-4 of
  a rounding boundary (+-0.5); the number of such tokens is asserted (0 on
  this input);
* CAMPPlus at the published widths (random weights in the published
  names): the x-vector within 1e-4 of max |ref|; the dev log-mel and dev
  x-vector encoder within 1e-5;
* ``onnx_reader`` on a hand-encoded model (raw and packed floats, int64,
  float16, a node entry to skip) and on ``synthetic_checkpoints.write_onnx``
  output: equal to JAX's reader; both packages' S3 v2 and CAMPPlus loaders
  on the same ONNX files give the same tree, leaf for leaf;
* a clone through the model's ``preprocess`` (S3 v2 dev config, CAMPPlus)
  equal to JAX's: prompt ids and rows, the cache row's context tokens and
  ``tok_pos``, the x-vector within 1e-4; an unreadable reference serves
  the neutral voice in both;
* a multipart clone upload (WAV + ``ref_text``) through the port's app
  over an in-process scheduler: the prompt exactly as long as its rows.
"""

import struct
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_checkpoints as sc
from test_torch_cosyvoice2 import (FLOW, _JCosy, overlap_pcm_samples,
                                   small_model)
from vox_serve_tpu import onnx_reader as jonnx
from vox_serve_tpu.encoders import campplus as jcamp
from vox_serve_tpu.encoders import mel as jmel
from vox_serve_tpu.encoders import s3_exact as js3
from vox_serve_tpu.encoders import speaker as jspk
from vox_serve_tpu.encoders import whisper_exact as jwhisper
from vox_serve_tpu_torch import onnx_reader as tonnx
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.encoders import campplus as tcamp
from vox_serve_tpu_torch.encoders import mel as tmel
from vox_serve_tpu_torch.encoders import s3_exact as ts3
from vox_serve_tpu_torch.encoders import speaker as tspk
from vox_serve_tpu_torch.encoders import whisper_exact as twhisper
from vox_serve_tpu_torch.models.backbone import seeded_generator

torch.set_num_threads(1)

S3_TOL = 1e-4
CAMP_TOL = 1e-4
DEV_TOL = 1e-5


def _audio(n, seed=0, sr=16000):
    t = np.arange(n) / sr
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 180 * t) + 0.2 * np.sin(
        2 * np.pi * 523 * t) + 0.05 * rng.standard_normal(n)).astype(
            np.float32)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tparams.tree_map(lambda t: t.numpy(),
                                                      tree))


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(got.detach().numpy() - ref).max() / np.abs(ref).max()


def test_front_ends_bit_equal():
    for n_mels in (80, 128):
        np.testing.assert_array_equal(twhisper.slaney_mel_filters(n_mels),
                                      jwhisper.slaney_mel_filters(n_mels))
    for n in (3000, 32000):
        wav = _audio(n, n)
        np.testing.assert_array_equal(twhisper.whisper_log_mel(wav),
                                      jwhisper.whisper_log_mel(wav))
        np.testing.assert_array_equal(tcamp.kaldi_fbank(wav),
                                      jcamp.kaldi_fbank(wav))
    np.testing.assert_array_equal(tcamp.kaldi_fbank(_audio(100)),
                                  jcamp.kaldi_fbank(_audio(100)))


def _jax_s3_projection(params, cfg, mel, monkeypatch):
    """JAX's S3 v2 tokens and the FSQ values it rounds (captured at its
    ``jnp.round``)."""
    seen = {}

    class _Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def round(x):
            seen["h"] = x
            return jnp.round(x)

    monkeypatch.setattr(js3, "jnp", _Jnp())
    toks = js3.s3v2_encode(params, cfg, mel)
    return np.asarray(toks), np.asarray(seen["h"])


def test_s3v2_matches_jax(monkeypatch):
    cfg = ts3.S3V2Config(n_state=256, heads=4, layers=2)
    jcfg = js3.S3V2Config(n_state=256, heads=4, layers=2)
    tp = ts3.init_s3v2_params(seeded_generator("cpu", 29), cfg, "cpu")
    mel = twhisper.whisper_log_mel(_audio(32000, 1), n_mels=cfg.n_mels)
    got_h = ts3.s3v2_project(tp, cfg, torch.from_numpy(mel)[None])
    got = ts3.s3v2_encode(tp, cfg, torch.from_numpy(mel)[None]).numpy()
    ref, ref_h = _jax_s3_projection(_to_jax(tp), jcfg,
                                    jnp.asarray(mel)[None], monkeypatch)
    assert got.shape == ref.shape == (1, mel.shape[1] // 4)
    assert got.dtype == np.int32
    assert np.abs(got_h.numpy() - ref_h).max() <= S3_TOL
    near = (np.abs(np.abs(ref_h) - 0.5) <= S3_TOL).any(-1)   # (1, T)
    assert int(near.sum()) == 0
    np.testing.assert_array_equal(got[~near], ref[~near])
    assert len(np.unique(got)) > 5 and got.max() < cfg.vocab_size


@pytest.fixture(scope="module")
def campplus():
    sd = sc.campplus_state(torch.Generator().manual_seed(4))
    return (tcamp.load_campplus_params(sd),
            jcamp.load_campplus_params({k: v.numpy() for k, v in sd.items()}))


def test_campplus_matches_jax(campplus):
    tp, jp = campplus
    feat = tcamp.kaldi_fbank(_audio(24000, 2))
    got = tcamp.campplus_embed(tp, torch.from_numpy(feat)[None])
    ref = jax.jit(jcamp.campplus_embed)(jp, jnp.asarray(feat)[None])
    assert tuple(got.shape) == ref.shape == (1, 192)
    assert _rel(got, ref) <= CAMP_TOL


def test_dev_xvector_matches_jax():
    cfg = tspk.SpeakerEncoderConfig(n_mels=80, out_dim=FLOW["spk_dim"])
    jcfg = jspk.SpeakerEncoderConfig(n_mels=80, out_dim=FLOW["spk_dim"])
    tp = tspk.init_speaker_encoder(cfg, seeded_generator("cpu", 31), "cpu")
    wav = _audio(20000, 3)[None]
    mcfg = tmel.MelConfig(sample_rate=16000, n_mels=80)
    got_mel = tmel.log_mel_spectrogram(torch.from_numpy(wav), mcfg)
    ref_mel = jmel.log_mel_spectrogram(jnp.asarray(wav),
                                       jmel.MelConfig(sample_rate=16000,
                                                      n_mels=80))
    assert _rel(got_mel, ref_mel) <= DEV_TOL
    got = tspk.speaker_embed(tp, cfg, got_mel)
    ref = jspk.speaker_embed(_to_jax(tp), jcfg, ref_mel)
    assert _rel(got, ref) <= DEV_TOL


# -- onnx_reader ------------------------------------------------------------


def _tensor_msg(name: str, arr: np.ndarray, raw=True) -> bytes:
    body = b"".join(sc._field(1, 0, sc._varint(d)) for d in arr.shape)
    dt = {np.float32: 1, np.int64: 7, np.float16: 10}[arr.dtype.type]
    body += sc._field(2, 0, sc._varint(dt)) + sc._field(8, 2, name.encode())
    if raw:
        return body + sc._field(9, 2, arr.tobytes())
    return body + sc._field(4, 2, b"".join(struct.pack("<f", x)
                                           for x in arr.ravel()))


def test_onnx_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"layer.weight": rng.standard_normal((3, 4)).astype(np.float32),
              "ids": rng.integers(0, 100, (5,)).astype(np.int64),
              "half": rng.standard_normal((2, 2, 2)).astype(np.float16)}
    packed = rng.standard_normal((6,)).astype(np.float32)
    graph = (b"".join(sc._field(5, 2, _tensor_msg(k, v))
                      for k, v in arrays.items())
             + sc._field(1, 2, b"\x08\x01")         # a node entry to skip
             + sc._field(5, 2, _tensor_msg("packed", packed, raw=False)))
    path = tmp_path / "tiny.onnx"
    path.write_bytes(sc._field(1, 0, sc._varint(8)) + sc._field(7, 2, graph))
    got = tonnx.load_onnx_initializers(path)
    ref = jonnx.load_onnx_initializers(path)
    assert set(got) == set(ref) == {*arrays, "packed"}
    for k, v in {**arrays, "packed": packed}.items():
        np.testing.assert_array_equal(got[k], v)
        np.testing.assert_array_equal(got[k], ref[k])
        assert got[k].dtype == v.dtype
    # the synthetic-checkpoint writer, read back by both readers
    w = {"a.weight": arrays["layer.weight"], "b": arrays["ids"]}
    n = sc.write_onnx(tmp_path / "w.onnx", w)
    assert n == (tmp_path / "w.onnx").stat().st_size
    for reader in (tonnx, jonnx):
        back = reader.load_onnx_initializers(tmp_path / "w.onnx")
        for k, v in w.items():
            np.testing.assert_array_equal(back[k], v)


def test_encoder_loaders_match_jax_on_onnx_files(tmp_path, campplus):
    cfg = ts3.S3V2Config(n_state=256, heads=4, layers=2)
    jcfg = js3.S3V2Config(n_state=256, heads=4, layers=2)
    tp = ts3.init_s3v2_params(seeded_generator("cpu", 7), cfg, "cpu")
    sc.write_onnx(tmp_path / "speech_tokenizer_v2.onnx", sc.export_s3v2(tp))
    sc.write_onnx(tmp_path / "campplus.onnx",
                  sc.campplus_state(torch.Generator().manual_seed(4)))
    s3_sd = tonnx.load_onnx_initializers(tmp_path / "speech_tokenizer_v2.onnx")
    camp_sd = tonnx.load_onnx_initializers(tmp_path / "campplus.onnx")
    pairs = [
        (ts3.load_s3v2_params(s3_sd, cfg), js3.load_s3v2_params(
            jonnx.load_onnx_initializers(
                tmp_path / "speech_tokenizer_v2.onnx"), jcfg), tp),
        (tcamp.load_campplus_params(camp_sd), jcamp.load_campplus_params(
            jonnx.load_onnx_initializers(tmp_path / "campplus.onnx")),
         campplus[0]),
    ]
    for got, ref, src in pairs:
        flat = [jax.tree.leaves(t) for t in (got, ref, src)]
        assert len({len(f) for f in flat}) == 1
        for g, r, s in zip(*flat):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
            np.testing.assert_array_equal(g.numpy(), s.numpy())


# -- the clone through the model -----------------------------------------


def _write_wav(path, n, sr=24000, seed=0):
    t = np.arange(n)
    pcm = (np.sin(t * 0.07) * 6000 + np.sin(t * 0.31) * 3000
           + np.random.default_rng(seed).standard_normal(n) * 300
           ).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return str(path)


@pytest.fixture(scope="module")
def clone_pair(campplus):
    """The small CosyVoice2 in both packages, with the port's S3 v2 (dev
    config) and full-width CAMPPlus in both."""
    tm = small_model(seed=8)
    jm = _JCosy(tm)
    s3p, s3cfg = tm.s3v2
    jm.__dict__["_s3v2"] = (_to_jax(s3p), js3.S3V2Config(
        n_state=s3cfg.n_state, heads=s3cfg.heads, layers=s3cfg.layers))
    # CAMPPlus with an 8-wide x-vector: the small flow's spk_dim
    sd = sc.campplus_state(torch.Generator().manual_seed(4),
                           embed_dim=FLOW["spk_dim"])
    tm.campplus = tcamp.load_campplus_params(sd)
    jm.__dict__["_campplus"] = jcamp.load_campplus_params(
        {k: v.numpy() for k, v in sd.items()})
    return jm, tm


def test_clone_preprocess_matches_jax(clone_pair, tmp_path, monkeypatch):
    jm, tm = clone_pair
    # JAX's x-vector net jitted (its eager op-by-op first call is slow)
    monkeypatch.setattr(jcamp, "campplus_embed",
                        jax.jit(jcamp.campplus_embed))
    ref_wav = _write_wav(tmp_path / "ref.wav", 36000)
    for ref_text in ("a reference", None):
        got = tm.preprocess(prompt="hi there", audio_path=ref_wav,
                            ref_text=ref_text)
        ref = jm.preprocess(prompt="hi there", audio_path=ref_wav,
                            ref_text=ref_text)
        np.testing.assert_array_equal(got.input_tokens, ref.input_tokens)
        np.testing.assert_array_equal(got.input_features, ref.input_features)
        # 1.5 s at 16 kHz: 150 mel frames, two stride-2 convs: 38 tokens
        n_text = len("a reference") if ref_text else 0
        assert len(got.input_tokens) == 1 + n_text + 8 + 1 + 38
        g, r = got.decoder_cache_init, ref.decoder_cache_init
        for k in ("ctx_tokens", "tok_pos", "prompt_len"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]))
        assert int(g["tok_pos"]) == 38
        assert _rel(g["spk"], r["spk"]) <= CAMP_TOL
    # an unreadable reference: the neutral voice in both
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav")
    got = tm.preprocess(prompt="hi", audio_path=str(bad))
    ref = jm.preprocess(prompt="hi", audio_path=str(bad))
    assert got.decoder_cache_init is None and ref.decoder_cache_init is None
    np.testing.assert_array_equal(got.input_tokens, ref.input_tokens)


def test_http_clone_upload(clone_pair, tmp_path):
    """POST /generate with an uploaded WAV and its ``ref_text`` as
    multipart form data (the body ``chip_smoke.py`` sends), through the
    port's app over an in-process scheduler: the prompt holds the
    reference's S3 tokens and the stream's PCM follows the trim rule."""
    import asyncio
    import threading

    from aiohttp.test_utils import TestClient, TestServer

    from chip_smoke import multipart
    from vox_serve_tpu_torch.scheduler import load_scheduler
    from vox_serve_tpu_torch.server.api import APIServer
    from vox_serve_tpu_torch.server.app import build_app
    from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

    _, tm = clone_pair
    ref_wav = _write_wav(tmp_path / "ref.wav", 36000)
    n_prompt = len(tm.preprocess(prompt="hi there", audio_path=ref_wav,
                                 ref_text="a reference").input_tokens)
    tm.sampling_config = tm.sampling_config.replace(greedy=True,
                                                    max_tokens=n_prompt + 40)
    suffix = f"_torch_cosy_clone_{id(tmp_path)}"
    worker = ModelWorker(tm, WorkerConfig(
        max_batch_size=2, num_pages=560, page_size=16,
        prefill_token_buckets=(128,), max_prefill_requests=2))
    sched = load_scheduler("online", model_worker=worker, max_batch_size=2,
                           socket_suffix=suffix)
    stop = threading.Event()

    def loop():
        sched._send(b'__scheduler__|READY|{"rank": 0}')
        while not stop.is_set():
            if not sched._step():
                stop.wait(0.002)

    server = APIServer(model_name="cosyvoice2", max_batch_size=2,
                       socket_suffix=suffix, spawn_schedulers=False,
                       output_dir=str(tmp_path / "out"),
                       upload_dir=str(tmp_path / "up"), sample_rate=24000)
    th = threading.Thread(target=loop, daemon=True)
    th.start()
    with open(ref_wav, "rb") as f:
        body, ctype = multipart({"text": "hi there",
                                 "ref_text": "a reference"},
                                {"audio": ("ref.wav", f.read())})

    async def round_trip():
        async with TestClient(TestServer(build_app(
                server, sample_rate=24000))) as client:
            for _ in range(200):
                if (await client.get("/health")).status == 200:
                    break
                await asyncio.sleep(0.05)
            r = await client.post("/generate", data=body,
                                  headers={"Content-Type": ctype})
            assert r.status == 200
            return await r.read()

    try:
        wav = asyncio.run(asyncio.wait_for(round_trip(), 120))
    finally:
        stop.set()
        th.join(timeout=30)
        server.cleanup()
        sched.request_socket.close()
        sched.result_socket.close()
    assert wav[:4] == b"RIFF"
    (done,) = sched.completed
    assert done["prompt_tokens"] == n_prompt
    pcm = np.frombuffer(wav[44:], np.int16)
    assert pcm.size == overlap_pcm_samples(done["audio_tokens"]) > 0
