"""WAV framing for the port's HTTP server.

The JAX package builds ``native/voxaudio.c`` for this and for its host-side
PCM conversion. The port converts PCM on the device (``worker/base.py``), so
it needs only the 44-byte RIFF header, written here with ``struct``: the
bytes equal those of vox_serve_tpu/native.py ``wav_header`` (native or
fallback) for every rate, channel count, width and length.
"""

from __future__ import annotations

import struct

#: RIFF streaming sentinel: unknown-length sizes (players treat the data
#: chunk as extending to EOF; a literal 0 makes spec-strict readers decode
#: zero frames from a saved stream). Chosen so both the RIFF size
#: (data_len + 36) and the data-chunk size wrap to ~0xFFFFFFFF.
STREAMING_DATA_LEN = 0xFFFFFFFF - 36


def wav_header(sample_rate: int, channels: int = 1, bits: int = 16,
               data_len: int | None = None) -> bytes:
    """44-byte RIFF/WAVE header. data_len=None means a live stream of
    unknown length (sentinel sizes); pass the real byte count for files."""
    if data_len is None:
        data_len = STREAMING_DATA_LEN
    byte_rate = sample_rate * channels * (bits // 8)
    block_align = channels * (bits // 8)
    return (b"RIFF"
            + struct.pack("<I", (data_len + 36) & 0xFFFFFFFF)
            + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                          byte_rate, block_align, bits)
            + b"data" + struct.pack("<I", data_len & 0xFFFFFFFF))
