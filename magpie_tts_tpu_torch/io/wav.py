"""WAV I/O: 16-bit PCM mono RIFF (reference src/magpie-tts.cpp:30-68 contract)."""

from __future__ import annotations

import struct

import numpy as np


def write_wav(path: str, samples: np.ndarray, sample_rate: int = 22050) -> None:
    """samples: float waveform in [-1, 1] (clamped, scaled by 32767) or
    already-scaled int16 PCM (passed through — the engine can produce PCM16
    on device)."""
    samples = np.asarray(samples)
    if samples.dtype == np.int16:
        pcm = samples
    else:
        pcm = np.clip(samples.astype(np.float32), -1.0, 1.0)
        pcm = (pcm * 32767.0).astype(np.int16)
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                            sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def read_wav(path: str):
    """Minimal reader for tests. Returns (samples float32 in [-1,1], sample_rate)."""
    with open(path, "rb") as f:
        raw = f.read()
    assert raw[:4] == b"RIFF" and raw[8:12] == b"WAVE"
    pos = 12
    sample_rate = None
    while pos < len(raw):
        chunk_id = raw[pos:pos + 4]
        size = struct.unpack_from("<I", raw, pos + 4)[0]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", raw, pos + 8)
            sample_rate = fmt[2]
        elif chunk_id == b"data":
            pcm = np.frombuffer(raw, dtype="<i2", count=size // 2, offset=pos + 8)
            return pcm.astype(np.float32) / 32767.0, sample_rate
        pos += 8 + size + (size & 1)
    raise ValueError(f"{path}: no data chunk")
