"""Port parity, the Qwen3-TTS Base (voice clone) and VoiceDesign variants
(vox_serve_tpu_torch/models/qwen3_tts.py) against the JAX package's
Qwen3TTSLM, on the CPU at debug widths with the same weights in both
(the port's random ones, converted): a small ECAPA speaker encoder and a
small 32-codebook Mimi encoder stand in for the checkpoint's.

* Base ``preprocess``: tokens and masks exactly equal, features within one
  bf16 ulp (bf16 tables, as served), for the x-vector prompt (uploaded
  audio, ``x_vector_only_mode``), no audio (a zero x-vector), ICL from
  ``ref_codes`` and from the audio (the codes exactly equal to JAX's
  ``_encode_audio_to_codes``: the first 16 of 32 codebooks); the fallback
  to x-vector only without ``ref_text`` and the ``ValueError`` for ICL
  with input streaming, in both packages;
* VoiceDesign: ``instruct`` rows and no speaker row; the 0.6B ids drop
  ``instruct``; CustomVoice's dialect language id from a ``config.json``;
* the registry serves the Base and VoiceDesign ids;
* one greedy Base ICL stream (reference WAV + ``ref_text``) through the
  port's worker and scheduler against the JAX worker and scheduler:
  tokens equal, PCM within 1e-4 of max |ref| plus one int16 step.
"""

import json
import logging
import wave

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_fused_decode import _audio, _drive
from vox_serve_tpu.codecs import mimi as jmimi
from vox_serve_tpu.codecs.qwen3_codec import Qwen3CodecConfig as JCodecCfg
from vox_serve_tpu.encoders import ecapa as jecapa
from vox_serve_tpu.models import qwen3_tts as jqwen3_mod
from vox_serve_tpu.models.backbone import BackboneConfig as JBB
from vox_serve_tpu.models.depth import DepthConfig as JDepth
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.scheduler.base import Scheduler as JScheduler
from vox_serve_tpu.weights import DevTokenizer
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.codecs import mimi as tmimi
from vox_serve_tpu_torch.codecs.qwen3_codec import Qwen3CodecConfig
from vox_serve_tpu_torch.encoders import ecapa as tecapa
from vox_serve_tpu_torch.models import get_model_class
from vox_serve_tpu_torch.models.backbone import BackboneConfig
from vox_serve_tpu_torch.models.depth import DepthConfig
from vox_serve_tpu_torch.models.qwen3_tts import (CODEC_PAD, LANGUAGE_IDS,
                                                  Qwen3TTSLM)
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.scheduler import load_scheduler
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)

BB = dict(vocab_size=3072, hidden_size=64, num_layers=2, num_heads=4,
          num_kv_heads=2, head_dim=16, intermediate_size=128, qk_norm=True,
          rope_theta=1e6)
DEPTH = dict(hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=64, max_seq=17, qk_norm=True)
CODEC = dict(codebook_dim=32, codebook_size=2048, latent_dim=48,
             decoder_dim=64, hidden_size=32, intermediate_size=64,
             head_dim=16, num_heads=4, num_kv_heads=4, num_layers=2,
             num_quantizers=16, sliding_window=48, upsample_rates=(4, 3),
             upsampling_ratios=(2, 2), vq_dim=16)
#: the codec checkpoint's encoder at small widths: 32 codebooks of 2048,
#: 24 samples per frame
ENC = dict(n_codebooks=32, codebook_size=2048, vq_dim=8, num_filters=8,
           upsample_ratios=(4, 3), hidden_size=16, intermediate_size=32,
           head_dim=8, num_heads=2, num_kv_heads=2, num_layers=2,
           sliding_window=6)
ECAPA = dict(mel_dim=128, enc_dim=64, channels=(32, 32, 32, 32, 96),
             se_channels=8, attention_channels=8)
REF_SAMPLES = 1200  # 50 encoder frames; 4 mel frames (each reflect pad 4)


class _JQwen3(jqwen3_mod.Qwen3TTSLM):
    """The JAX model with its weights supplied by the test."""

    def _init_params(self):
        self.params, self.codec_params = {}, {}


def _to_np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tparams.tree_map(_to_np, tree))


def make_pair(name, dtype="bfloat16", encoders=True, **kw):
    """The debug Qwen3 variant ``name`` in both packages with the port's
    random weights (and, for Base, the same small speaker and codec
    encoders)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tm = Qwen3TTSLM(name, dtype=tdt, device="cpu", seed=5,
                    debug_backbone=BackboneConfig(**BB, dtype=tdt),
                    debug_depth=DepthConfig(**DEPTH, dtype=tdt),
                    debug_codec=Qwen3CodecConfig(**CODEC), **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqwen3_mod, "load_text_tokenizer",
                   lambda n, vocab: (DevTokenizer(vocab), False))
        jm = _JQwen3(name, dtype=jdt, debug_backbone=JBB(**BB, dtype=jdt),
                     debug_depth=JDepth(**DEPTH, dtype=jdt),
                     debug_codec=JCodecCfg(**CODEC), **kw)
    jm.params, jm.codec_params = _to_jax(tm.params), _to_jax(tm.codec_params)
    if encoders:
        g = torch.Generator().manual_seed(12)
        tm._spk_enc_cfg = tecapa.EcapaConfig(**ECAPA)
        tm._spk_enc_params = tecapa.init_ecapa(tm._spk_enc_cfg, g, "cpu")
        tm._enc_mimi_cfg = tmimi.MimiConfig(**ENC)
        tm._codec_encoder = tmimi.init_mimi_encoder(tm._enc_mimi_cfg, g,
                                                    "cpu")
        jm._spk_enc_cfg = jecapa.EcapaConfig(**ECAPA)
        jm._spk_enc_params = _to_jax(tm._spk_enc_params)
        jm._enc_mimi_cfg = jmimi.MimiConfig(**ENC)
        jm._codec_encoder = _to_jax(tm._codec_encoder)
    return tm, jm


@pytest.fixture(scope="module")
def base_pair():
    return make_pair("Qwen/Qwen3-TTS-12Hz-1.7B-Base")


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.wav"
    t = np.arange(REF_SAMPLES)
    pcm = (np.sin(t * 0.07) * 6000 + np.sin(t * 0.31) * 3000
           ).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(24000)
        w.writeframes(pcm.tobytes())
    return str(path)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def assert_prompts_match(got, ref):
    np.testing.assert_array_equal(got.input_tokens, ref.input_tokens)
    np.testing.assert_array_equal(got.input_masks, ref.input_masks)
    f, rf = got.input_features, np.asarray(ref.input_features)
    assert f.dtype == np.float32 and f.shape == rf.shape
    assert (np.abs(f - rf) <= bf16_ulp(rf)).all(), np.abs(f - rf).max()


def test_registry_serves_every_variant():
    for size in ("1.7B", "0.6B"):
        for variant, kind in (("CustomVoice", "custom_voice"),
                              ("Base", "base"),
                              ("VoiceDesign", "voice_design")):
            name = f"Qwen/Qwen3-TTS-12Hz-{size}-{variant}"
            assert get_model_class(name) is Qwen3TTSLM
            assert get_model_class(name.lower()) is Qwen3TTSLM
            with torch.device("meta"):
                m = Qwen3TTSLM(name, device="meta")
            assert m.tts_model_type == kind
            assert m.supports_audio_input == (kind == "base")
            assert m.tts_model_size == ("0b6" if size == "0.6B" else "1b7")


@pytest.mark.parametrize("mode", ["x_vector_audio", "no_audio"])
def test_base_xvector_prompt_matches_jax(base_pair, ref_wav, mode):
    tm, jm = base_pair
    kw = dict(prompt="clone me", language="english")
    if mode == "x_vector_audio":
        kw.update(audio_path=ref_wav, x_vector_only_mode=True,
                  ref_text="ignored here")
    got, ref = tm.preprocess(**kw), jm.preprocess(**kw)
    assert_prompts_match(got, ref)
    # role 3 + think prefix 4 + x-vector row + tts_bos + text + eos + bos
    assert len(got.input_tokens) == 3 + 4 + 1 + 1 + len("clone me") + 2
    pad = tm.params["codec_embedding"][CODEC_PAD].float().numpy()
    row = got.input_features[7]
    if mode == "no_audio":
        np.testing.assert_array_equal(row, -pad)
    else:
        assert np.abs(row + pad).max() > 0  # an x-vector was added
    assert not got.input_features[8:].any()


def test_base_icl_from_ref_codes_matches_jax(base_pair):
    tm, jm = base_pair
    codes = np.random.default_rng(3).integers(0, 2048, (7, 16))
    kw = dict(prompt="new words", ref_text="old words", ref_codes=codes,
              language="auto")
    got, ref = tm.preprocess(**kw), jm.preprocess(**kw)
    assert_prompts_match(got, ref)
    T = len(got.input_tokens)
    assert T == 3 + 3 + 1 + 1 + len("old words") + len("new words") + 2 + 7
    np.testing.assert_array_equal(got.input_tokens[-7:, 0], codes[:, 0])
    # the reference frames' features are their summed depth embeddings
    de = tm.params["depth"]["embeds"].float()
    want = sum(de[i][torch.from_numpy(codes[:, i + 1])] for i in range(15))
    assert np.abs(got.input_features[-7:] - want.numpy()).max() < 0.02


def test_base_icl_from_audio_matches_jax(base_pair, ref_wav):
    tm, jm = base_pair
    codes = tm._encode_audio_to_codes(ref_wav)
    jcodes = jm._encode_audio_to_codes(ref_wav)
    assert codes.shape == (REF_SAMPLES // 24, 16)
    np.testing.assert_array_equal(codes, np.asarray(jcodes))
    kw = dict(prompt="speak", audio_path=ref_wav, ref_text="the reference",
              language="english")
    got, ref = tm.preprocess(**kw), jm.preprocess(**kw)
    assert_prompts_match(got, ref)
    np.testing.assert_array_equal(got.input_tokens[-len(codes):, 0],
                                  codes[:, 0])


def test_icl_without_ref_text_falls_back_to_x_vector(base_pair, ref_wav):
    tm, jm = base_pair
    kw = dict(prompt="hello", audio_path=ref_wav, language="english")
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    tm.logger.addHandler(handler)
    try:
        got = tm.preprocess(**kw)
    finally:
        tm.logger.removeHandler(handler)
    assert any("falling back to x-vector" in m for m in seen), seen
    assert_prompts_match(got, jm.preprocess(**kw))
    xv = tm.preprocess(**kw, x_vector_only_mode=True)
    np.testing.assert_array_equal(got.input_tokens, xv.input_tokens)
    np.testing.assert_array_equal(got.input_features, xv.input_features)


def test_icl_with_input_streaming_raises_in_both(base_pair, ref_wav):
    tm, jm = base_pair
    kw = dict(audio_path=ref_wav, ref_text="ref", streaming_first_token=77)
    for m in (tm, jm):
        with pytest.raises(ValueError, match="input streaming"):
            m.preprocess(**kw)
    # x-vector only streams
    kw["x_vector_only_mode"] = True
    assert_prompts_match(tm.preprocess(**kw), jm.preprocess(**kw))


@pytest.mark.parametrize("size", ["1.7B", "0.6B"])
def test_voice_design_prompt_matches_jax(size):
    tm, jm = make_pair(f"Qwen/Qwen3-TTS-12Hz-{size}-VoiceDesign",
                       encoders=False)
    for kw in (dict(prompt="a calm line", instruct="warm, low voice",
                    language="english"),
               dict(prompt="no brief", language="auto")):
        got, ref = tm.preprocess(**kw), jm.preprocess(**kw)
        assert_prompts_match(got, ref)
        n_instr = (len("<|im_start|>user\nwarm, low voice<|im_end|>\n")
                   if "instruct" in kw and size == "1.7B" else 0)
        prefix = 4 if kw["language"] == "english" else 3
        # no speaker row: the think prefix is followed by tts_bos
        assert len(got.input_tokens) == (n_instr + 3 + prefix + 1
                                         + len(kw["prompt"]) + 2)
        assert not got.input_features.any()


def test_dialect_language_id_from_config_json(tmp_path):
    d = tmp_path / "Qwen3-TTS-12Hz-1.7B-CustomVoice"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"talker_config": {
        "spk_id": {"Ryan": 2090, "Dylan": 2099},
        "spk_is_dialect": {"Dylan": "beijing_dialect", "Ryan": False}}}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jqwen3_mod.LANGUAGE_IDS, "beijing_dialect", 2074)
        tm, jm = make_pair(str(d), encoders=False)
        assert tm.spk_ids == jm.spk_ids == {"ryan": 2090, "dylan": 2099}
        assert tm.spk_dialects == jm.spk_dialects == {
            "dylan": "beijing_dialect"}
        assert "beijing_dialect" not in LANGUAGE_IDS
        for kw in (dict(prompt="hi", speaker="Ryan", language="auto"),
                   dict(prompt="hi", speaker="Dylan", language="english")):
            assert_prompts_match(tm.preprocess(**kw), jm.preprocess(**kw))
        # an unknown dialect language falls back to no language id in
        # both; a known one is picked from the table
        mp.setitem(LANGUAGE_IDS, "beijing_dialect", 2074)
        got = tm.preprocess(prompt="hi", speaker="Dylan", language="auto")
        ref = jm.preprocess(prompt="hi", speaker="Dylan", language="auto")
        assert_prompts_match(got, ref)
        assert got.input_tokens[5, 0] == 2074


def test_worker_icl_stream_matches_jax_worker(ref_wav):
    tm, jm = make_pair("Qwen/Qwen3-TTS-12Hz-1.7B-Base", dtype="float32",
                       detokenize_interval=4)
    kw = dict(ref_text="a reference", language="english")
    n_prompt = len(tm.preprocess(prompt="hi there", audio_path=ref_wav,
                                 **kw).input_tokens)
    for m in (jm, tm):
        m.sampling_config = m.sampling_config.replace(
            greedy=True, max_tokens=n_prompt + 10)
    cfg = dict(max_batch_size=2, num_pages=256, page_size=16,
               prefill_token_buckets=(128,), max_prefill_requests=2)
    jw = JWorker(jm, JWorkerConfig(warmup=False, **cfg))
    tw = ModelWorker(tm, WorkerConfig(**cfg))
    jreq = JRequest(request_id="j0", prompt="hi there", audio_path=ref_wav,
                    model_kwargs=kw, is_streaming=True)
    treq = Request(request_id="t0", prompt="hi there", audio_path=ref_wav,
                   model_kwargs=kw, is_streaming=True)
    jmsgs = _drive(JScheduler(model_worker=jw, max_batch_size=2,
                              connect=False), [jreq])
    tsched = load_scheduler("base", model_worker=tw, max_batch_size=2,
                            connect=False)
    tmsgs = _drive(tsched, [treq])
    assert jreq.done_all and treq.done_all
    assert treq.input_length == jreq.input_length == n_prompt
    np.testing.assert_array_equal(np.stack(treq.lm_output_tokens),
                                  np.stack(jreq.lm_output_tokens))
    assert len(treq.lm_output_audio_tokens) >= 8
    ja = np.frombuffer(_audio(jmsgs, "j0"), np.int16).astype(np.int32)
    ta = np.frombuffer(_audio(tmsgs, "t0"), np.int16).astype(np.int32)
    assert ta.size == ja.size > 0
    assert np.abs(ta - ja).max() <= 1e-4 * np.abs(ja).max() + 1
    (done,) = tsched.completed
    assert done["prompt_tokens"] == n_prompt


def test_http_voice_clone_upload(ref_wav, tmp_path):
    """POST /generate with an uploaded reference WAV, its transcript and
    the text as multipart form data (the body ``chip_smoke.py`` sends), to
    the port's app over an in-process scheduler: the Base model's ICL
    prompt holds the reference's frames, and the stream's PCM follows the
    trim rule."""
    import asyncio
    import threading

    from aiohttp.test_utils import TestClient, TestServer

    from chip_smoke import multipart
    from vox_serve_tpu_torch.server.api import APIServer
    from vox_serve_tpu_torch.server.app import build_app

    tm, _ = make_pair("Qwen/Qwen3-TTS-12Hz-1.7B-Base", dtype="float32",
                      detokenize_interval=4)
    fields = {"text": "hi there", "ref_text": "a reference",
              "language": "english"}
    n_prompt = len(tm.preprocess(prompt="hi there", audio_path=ref_wav,
                                 ref_text="a reference").input_tokens)
    assert n_prompt == 3 + 4 + 1 + 1 + len("a reference") + 8 + 2 + 50
    tm.sampling_config = tm.sampling_config.replace(
        greedy=True, max_tokens=n_prompt + 9)
    suffix = f"_torch_qwen3_clone_{id(tmp_path)}"
    worker = ModelWorker(tm, WorkerConfig(
        max_batch_size=2, num_pages=400, page_size=16,
        prefill_token_buckets=(128,), max_prefill_requests=2))
    sched = load_scheduler("online", model_worker=worker, max_batch_size=2,
                           socket_suffix=suffix)
    stop = threading.Event()

    def loop():
        sched._send(b'__scheduler__|READY|{"rank": 0}')
        while not stop.is_set():
            if not sched._step():
                stop.wait(0.002)

    server = APIServer(model_name="qwen3-tts", max_batch_size=2,
                       socket_suffix=suffix, spawn_schedulers=False,
                       output_dir=str(tmp_path / "out"),
                       upload_dir=str(tmp_path / "up"), sample_rate=24000)
    th = threading.Thread(target=loop, daemon=True)
    th.start()
    with open(ref_wav, "rb") as f:
        body, ctype = multipart(fields, {"audio": ("ref.wav", f.read())})

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
    n = done["audio_tokens"]
    fs = 48  # samples per frame at the debug codec's rates (4 x 3 x 2 x 2)
    pcm = np.frombuffer(wav[44:], np.int16)
    assert pcm.size == fs * n - (0 if n % 4 == 0 else fs // 2) > 0


@pytest.mark.parametrize("sched_type", ["base", "online"])
def test_deferred_prefill_is_not_starved_by_held_slots(ref_wav, sched_type):
    """Two voice clones whose prompts (the reference's 50 frames each)
    cannot share the largest prefill bucket, though the scheduler's
    estimate from the text says they can: the worker takes a slot for
    both, prefills the first and defers the second, which keeps its slot.
    The scheduler prefills it on the next round. (The JAX scheduler asks
    ``can_admit`` for a free slot, so there the second prompt waits until
    the first stream has finished.)"""
    tm, _ = make_pair("Qwen/Qwen3-TTS-12Hz-1.7B-Base", dtype="float32",
                      detokenize_interval=4)
    tm.sampling_config = tm.sampling_config.replace(greedy=True,
                                                    max_tokens=120)
    w = ModelWorker(tm, WorkerConfig(max_batch_size=2, num_pages=256,
                                     page_size=16,
                                     prefill_token_buckets=(128,),
                                     max_prefill_requests=2))
    s = load_scheduler(sched_type, model_worker=w, max_batch_size=2,
                       connect=False)
    reqs = [Request(request_id=f"r{i}", prompt="hi", audio_path=ref_wav,
                    model_kwargs={"ref_text": "a reference"},
                    is_streaming=True) for i in range(2)]
    for r in reqs:
        s.enqueue_request(r)
    prefilled_at = {}
    for step in range(30):
        s._step()
        for r in reqs:
            if r.done_lm_prefill:
                prefilled_at.setdefault(r.request_id, step)
        if len(prefilled_at) == 2:
            break
    assert reqs[0].input_length + reqs[1].input_length > 128
    assert set(prefilled_at) == {"r0", "r1"}, prefilled_at
    assert prefilled_at["r1"] - prefilled_at["r0"] <= 1, prefilled_at
    assert not reqs[0].done_lm_generation
