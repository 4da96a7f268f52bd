"""Minimal ONNX initializer extractor, with no ``onnx`` package (a copy of
vox_serve_tpu/onnx_reader.py, numpy only, which the port keeps so that it
imports nothing of the JAX package).

CosyVoice2 publishes two checkpoints only as ONNX: the CAMPPlus x-vector
net (``campplus.onnx``) and the S3 v2 speech tokenizer
(``speech_tokenizer_v2.onnx``). An ``.onnx`` file is a protobuf:
``ModelProto.graph`` (field 7) holds ``GraphProto.initializer`` (field 5),
a repeated ``TensorProto`` carrying every weight. This module walks the
protobuf wire format directly and returns ``{name: np.ndarray}``.
``torch.onnx.export`` keeps the state-dict names of parameters, so the
tensors map onto the same loaders the torch-format checkpoints use; an
export with mangled names fails the mapping, and the model then serves its
random-init fallback.
"""

from __future__ import annotations

import struct

import numpy as np

# TensorProto.DataType -> numpy
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: memoryview, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(buf, pos)
        return pos
    if wire_type == 1:  # fixed64
        return pos + 8
    if wire_type == 2:  # length-delimited
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire_type == 5:  # fixed32
        return pos + 4
    raise ValueError(f"unsupported wire type {wire_type}")


def _iter_fields(buf: memoryview):
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + n]
            pos += n
        elif wire == 1:
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        elif wire == 5:
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        else:
            pos = _skip_field(buf, pos, wire)


def _parse_tensor(buf: memoryview) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype = 1
    name = ""
    raw = None
    float_data: list[float] = []
    int64_data: list[int] = []
    int32_data: list[int] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:  # dims
            if wire == 0:
                dims.append(val)
            else:  # packed
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(v)
        elif field == 2 and wire == 0:
            dtype = val
        elif field == 8 and wire == 2:
            name = bytes(val).decode("utf-8", "replace")
        elif field == 9 and wire == 2:
            raw = bytes(val)
        elif field == 4:  # float_data
            if wire == 5:
                float_data.append(struct.unpack("<f", bytes(val))[0])
            elif wire == 2:
                float_data.extend(np.frombuffer(bytes(val), "<f4").tolist())
        elif field == 7:  # int64_data (packed varints)
            if wire == 0:
                int64_data.append(val)
            elif wire == 2:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int64_data.append(v)
        elif field == 5:  # int32_data
            if wire == 0:
                int32_data.append(val)
            elif wire == 2:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int32_data.append(v)
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        return name, None  # e.g. bfloat16/string: caller decides
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    elif int32_data:
        arr = np.asarray(int32_data, np.int32)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr


def load_onnx_initializers(path) -> dict:
    """Parse an .onnx file and return its initializer tensors by name."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    out: dict = {}
    for field, wire, val in _iter_fields(data):
        if field == 7 and wire == 2:  # ModelProto.graph
            for gfield, gwire, gval in _iter_fields(val):
                if gfield == 5 and gwire == 2:  # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    if arr is not None and name:
                        out[name] = arr
    return out
