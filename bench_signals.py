"""Seeded synthetic audio: the benchmark's signal families and a
speech-like test signal. Nothing is downloaded; every signal is a pure
function of its arguments."""

from __future__ import annotations

import numpy as np


def speechlike(
    sample_rate: int,
    n: int,
    f0_base: float = 110.0,
    f0_mod: float = 30.0,
    f0_rate: float = 0.7,
    syll_hz: float = 2.5,
    n_harm: int = 5,
) -> np.ndarray:
    """Voiced speech stand-in: n_harm harmonics of a pitch contour
    f0_base + f0_mod*sin(2*pi*f0_rate*t), gated by a half-wave syllable
    envelope at syll_hz. float32 in about ±0.45."""
    t = np.arange(n) / sample_rate
    f0 = f0_base + f0_mod * np.sin(2 * np.pi * f0_rate * t)
    phase = np.cumsum(2 * np.pi * f0 / sample_rate)
    voiced = sum(np.sin(k * phase) / k for k in range(1, n_harm + 1))
    envelope = np.clip(np.sin(2 * np.pi * syll_hz * t), 0, None)
    return (voiced * envelope * 0.2).astype(np.float32)


def bench_families(sample_rate: int, n: int, seed: int = 0) -> np.ndarray:
    """The benchmark's four signal families, [4, n] float32: male-ish
    speech, female-ish speech with faster syllables, unvoiced noise
    bursts, and a pitch-chirped sweep. Pitch structure, speed trajectory
    and output length all depend on content, so a batch interleaves
    them (row b runs family b % 4)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sample_rate
    fam0 = speechlike(sample_rate, n, 110.0, 30.0, 0.7, 2.5, 5)
    fam1 = speechlike(sample_rate, n, 210.0, 45.0, 1.3, 4.0, 7)
    bursts = (np.sin(2 * np.pi * 3.1 * t) > 0.3).astype(np.float32)
    fam2 = (rng.standard_normal(n) * 0.12 * bursts).astype(np.float32)
    chirp_f0 = 90.0 + 160.0 * (0.5 + 0.5 * np.sin(2 * np.pi * 0.11 * t))
    phase_c = np.cumsum(2 * np.pi * chirp_f0 / sample_rate)
    fam3 = (
        (np.sin(phase_c) + 0.5 * np.sin(2 * phase_c))
        * np.clip(np.sin(2 * np.pi * 1.8 * t + 0.7), 0, None)
        * 0.2
    ).astype(np.float32)
    return np.stack([fam0, fam1, fam2, fam3])


def corpus_durations(n_utt: int, seed: int = 7) -> np.ndarray:
    """Utterance lengths in seconds for a corpus benchmark: log-uniform
    2-30 s (a typical utterance corpus) with min(8, max(1, n/32)) long
    outliers of 40-90 s that exceed the batch engine's length bound and
    take the streaming route."""
    rng = np.random.default_rng(seed)
    durs = np.exp(rng.uniform(np.log(2.0), np.log(30.0), size=n_utt))
    n_long = min(8, max(1, n_utt // 32))
    durs[:n_long] = rng.uniform(40.0, 90.0, size=n_long)
    rng.shuffle(durs)
    return durs


def corpus_utterance(sample_rate: int, seconds: float, rng) -> np.ndarray:
    """One int16 PCM corpus utterance: a speech-like tone with a random
    pitch contour and syllable rate, plus a low noise floor."""
    n = int(seconds * sample_rate)
    t = np.arange(n) / sample_rate
    f0 = rng.uniform(100, 240) + 30 * np.sin(2 * np.pi * rng.uniform(0.4, 1.2) * t)
    phase = np.cumsum(2 * np.pi * f0 / sample_rate)
    x = (
        sum(np.sin(k * phase) / k for k in range(1, 5))
        * np.clip(np.sin(2 * np.pi * rng.uniform(1.5, 3.5) * t), 0, None)
        * 0.25
        + 0.003 * rng.standard_normal(n)
    )
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
