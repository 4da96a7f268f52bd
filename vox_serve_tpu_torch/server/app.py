"""HTTP application (aiohttp) — endpoint parity with the reference FastAPI app
(launch.py:794-1087): POST /generate (multipart form, streaming WAV or full
WAV), POST /generate/stream/start, POST /generate/stream/{id}/text,
GET /generate/stream/{id}/audio, POST /generate/stream/{id}/end, GET /health.

The port's copy of vox_serve_tpu/server/app.py: the same routes, chunk
streaming and WAV framing over the port's ``APIServer`` and ``native``.
"""

from __future__ import annotations

import asyncio
import io
import json
import uuid
import wave
from pathlib import Path

from aiohttp import web

from ..utils import get_logger
from .api import APIError, APIServer

logger = get_logger("http")

MODEL_FORM_FIELDS = ("language", "speaker", "ref_text", "instruct",
                     "x_vector_only_mode")


# RIFF header framing (the port's native.py: the bytes of the JAX package's
# native/voxaudio.c header)
from ..native import wav_header  # noqa: E402


def _json_error(status: int, detail: str) -> web.Response:
    return web.json_response({"detail": detail}, status=status)


async def _parse_form(request: web.Request) -> tuple[dict, str | None]:
    """Parse multipart/urlencoded form; save an uploaded 'audio' file.
    Returns (fields, audio_path)."""
    fields: dict = {}
    audio_path = None
    server: APIServer = request.app["server"]
    if request.content_type and "multipart" in request.content_type:
        reader = await request.multipart()
        async for part in reader:
            if part.name == "audio" and part.filename:
                fname = f"{uuid.uuid4()}_{Path(part.filename).name}"
                audio_path = str(server.upload_dir / fname)
                data = await part.read(decode=False)
                await asyncio.get_running_loop().run_in_executor(
                    None, Path(audio_path).write_bytes, data)
            else:
                fields[part.name] = (await part.text())
    else:
        data = await request.post()
        for k, v in data.items():
            fields[k] = v
    return fields, audio_path


def _model_kwargs_from(fields: dict) -> dict:
    out = {}
    for k in MODEL_FORM_FIELDS:
        if k in fields and fields[k] not in (None, ""):
            v = fields[k]
            if k == "x_vector_only_mode":
                v = str(v).lower() in ("1", "true", "yes", "on")
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# handlers
# ---------------------------------------------------------------------------


async def generate(request: web.Request) -> web.StreamResponse:
    server: APIServer = request.app["server"]
    fields, audio_path = await _parse_form(request)
    text = fields.get("text")
    if text is None:
        return _json_error(422, "Field 'text' is required")
    streaming = str(fields.get("streaming", "true")).lower() not in (
        "false", "0", "no")
    model_kwargs = _model_kwargs_from(fields)
    sample_rate = request.app["sample_rate"]

    try:
        # the uploaded reference audio is deleted when the request finishes
        # (api._finish_request) — a fixed 60 s timer deleted it before a
        # loaded scheduler had read it
        rid = server.start_streaming_request(text, audio_path, model_kwargs)
    except APIError as e:
        return _json_error(e.status, e.detail)

    if streaming:
        resp = web.StreamResponse(
            status=200,
            headers={
                "Content-Type": "audio/wav",
                "Content-Disposition":
                    f"attachment; filename=stream_{rid[:8]}.wav",
                "Cache-Control": "no-cache",
            },
        )
        await resp.prepare(request)
        await resp.write(wav_header(sample_rate))
        try:
            async for chunk in server.async_stream_chunks(rid):
                await resp.write(chunk)
        except APIError as e:
            logger.error("stream %s failed: %s", rid, e.detail)
        await resp.write_eof()
        return resp

    # non-streaming: accumulate on the event loop (parking an executor
    # thread per request for up to timeout_seconds starved the shared
    # default executor under concurrency)
    try:
        parts = []
        async for chunk in server.async_stream_chunks(rid):
            parts.append(chunk)
        pcm = b"".join(parts)
    except APIError as e:
        return _json_error(e.status, e.detail)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm)
    return web.Response(
        body=buf.getvalue(), content_type="audio/wav",
        headers={"Content-Disposition": f"attachment; filename={rid}.wav"})


async def stream_start(request: web.Request) -> web.Response:
    server: APIServer = request.app["server"]
    fields, audio_path = await _parse_form(request)
    model_kwargs = _model_kwargs_from(fields)
    try:
        rid = server.start_input_streaming_request(audio_path, model_kwargs)
    except APIError as e:
        return _json_error(e.status, e.detail)
    return web.json_response({"request_id": rid})


async def stream_text(request: web.Request) -> web.Response:
    server: APIServer = request.app["server"]
    rid = request.match_info["request_id"]
    fields, _ = await _parse_form(request)
    text = fields.get("text")
    if text is None:
        return _json_error(422, "Field 'text' is required")
    try:
        server.send_text_chunk(rid, text)
    except APIError as e:
        return _json_error(e.status, e.detail)
    return web.json_response({"status": "accepted", "request_id": rid})


async def stream_audio(request: web.Request) -> web.StreamResponse:
    server: APIServer = request.app["server"]
    rid = request.match_info["request_id"]
    data = server.has_request(rid)
    if not data:
        return _json_error(404, f"Request {rid} not found")
    if not data.get("input_streaming"):
        return _json_error(400, f"Request {rid} is not an input streaming request")
    resp = web.StreamResponse(
        status=200,
        headers={
            "Content-Type": "audio/wav",
            "Content-Disposition": f"attachment; filename=stream_{rid[:8]}.wav",
            "Cache-Control": "no-cache",
        },
    )
    await resp.prepare(request)
    await resp.write(wav_header(request.app["sample_rate"]))
    try:
        async for chunk in server.async_stream_chunks(rid):
            await resp.write(chunk)
    except APIError as e:
        logger.error("stream %s failed: %s", rid, e.detail)
    await resp.write_eof()
    return resp


async def stream_end(request: web.Request) -> web.Response:
    server: APIServer = request.app["server"]
    rid = request.match_info["request_id"]
    try:
        server.end_input_streaming(rid)
    except APIError as e:
        return _json_error(e.status, e.detail)
    return web.json_response({"status": "completed", "request_id": rid})


async def health(request: web.Request) -> web.Response:
    server: APIServer = request.app["server"]
    if not server.ready:
        return web.json_response({"status": "warming"}, status=503)
    body = {"status": "healthy"}
    if not getattr(server, "assets_available", True):
        # dev fallback in play: output is NOT real model audio
        body["assets_available"] = False
        body["warning"] = ("serving with dev assets (random weights or "
                           "fallback tokenizer)")
    return web.json_response(body)


@web.middleware
async def cors_middleware(request: web.Request, handler):
    if request.method == "OPTIONS":
        resp = web.Response()
        _set_cors(resp.headers)
        return resp
    return await handler(request)


def _set_cors(headers) -> None:
    headers["Access-Control-Allow-Origin"] = "*"
    headers["Access-Control-Allow-Methods"] = "*"
    headers["Access-Control-Allow-Headers"] = "*"


async def _on_prepare(request, response) -> None:
    # set at prepare time: mutating headers AFTER a StreamResponse has
    # prepared is a silent no-op, so streamed WAVs went out without CORS
    _set_cors(response.headers)


def build_app(server: APIServer, sample_rate: int = 24000) -> web.Application:
    app = web.Application(middlewares=[cors_middleware],
                          client_max_size=64 * 1024 * 1024)
    app.on_response_prepare.append(_on_prepare)
    app["server"] = server
    app["sample_rate"] = sample_rate
    app.router.add_post("/generate", generate)
    app.router.add_post("/generate/stream/start", stream_start)
    app.router.add_post("/generate/stream/{request_id}/text", stream_text)
    app.router.add_get("/generate/stream/{request_id}/audio", stream_audio)
    app.router.add_post("/generate/stream/{request_id}/end", stream_end)
    app.router.add_get("/health", health)
    return app
