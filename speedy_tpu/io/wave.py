"""Minimal RIFF/WAVE reader and writer (16-bit PCM centric).

Replacement for the reference's external `wave.h` dependency
(component C20 in SURVEY.md; used by speedy_wave.cc:162-233 and every test).
Implemented with numpy so waveforms land directly in host arrays ready for
device transfer; no external audio libraries.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def read_wave(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file.

    Returns (samples, sample_rate). `samples` is an int16 array of shape
    [num_frames, num_channels] for multichannel audio or [num_frames] for
    mono, in interleaved frame order (matching the reference's short-sample
    convention where "one sample" spans all channels, sonic2.h:56-59).
    """
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            pcm = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned
    if fmt is None or pcm is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, num_channels, sample_rate, _, _, bits = fmt
    if audio_format not in (1, 0xFFFE):  # PCM (or extensible-PCM)
        raise ValueError(f"{path}: unsupported audio format {audio_format}")
    if bits == 16:
        samples = np.frombuffer(pcm, dtype="<i2").astype(np.int16)
    elif bits == 8:
        samples = (np.frombuffer(pcm, dtype=np.uint8).astype(np.int16) - 128) << 8
    elif bits == 32:
        samples = (np.frombuffer(pcm, dtype="<i4") >> 16).astype(np.int16)
    else:
        raise ValueError(f"{path}: unsupported bit depth {bits}")
    if num_channels > 1:
        n = (len(samples) // num_channels) * num_channels
        samples = samples[:n].reshape(-1, num_channels)
    return samples, int(sample_rate)


def write_wave(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write an int16 (or float in [-1, 1)) array as a 16-bit PCM WAV file.

    `samples` may be [num_frames] (mono) or [num_frames, num_channels].
    """
    samples = np.asarray(samples)
    if samples.dtype != np.int16:
        samples = np.clip(np.round(samples * 32768.0), -32768, 32767).astype(np.int16)
    num_channels = 1 if samples.ndim == 1 else samples.shape[-1]
    pcm = samples.astype("<i2").tobytes()
    byte_rate = sample_rate * num_channels * 2
    block_align = num_channels * 2
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(pcm)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, num_channels, sample_rate, byte_rate, block_align, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(pcm)))
        f.write(pcm)
