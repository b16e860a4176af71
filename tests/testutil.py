"""Shared test utilities: golden-data loaders and the reference's
cross-correlation SNR (speedy_test.cc:787-857), replicated exactly."""

from __future__ import annotations

import functools
import os
import pathlib

import numpy as np

# Golden dumps + test WAVs from the reference checkout (read-only data
# fixtures; location overridable for standalone runs).
TEST_DATA_DIR = pathlib.Path(
    os.environ.get("SPEEDY_TEST_DATA", "/root/reference/test_data")
)


def have_test_data() -> bool:
    return TEST_DATA_DIR.is_dir()


def speech_like(sample_rate: int = 16000, n: int = 50381, seed: int = 0) -> np.ndarray:
    """Seeded speech stand-in (the benchmark's voiced family plus a low
    noise floor), float32 in ±1. The defaults match tapestry.wav's rate
    and length (sonic_classic_test.cc:524-526)."""
    from bench_signals import speechlike

    rng = np.random.default_rng(seed)
    x = speechlike(sample_rate, n) + 0.002 * rng.standard_normal(n)
    return x.astype(np.float32)


def speech_pcm(sample_rate: int = 16000, n: int = 50381, seed: int = 0) -> np.ndarray:
    """speech_like as 16-bit PCM, the form read_wave returns."""
    x = speech_like(sample_rate, n, seed)
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def write_speech_wav(path, sample_rate: int = 16000, n: int = 50381, seed: int = 0) -> str:
    """Write speech_pcm to a mono wav file; returns the path as a str."""
    from speedy_tpu.io import write_wave

    write_wave(str(path), speech_pcm(sample_rate, n, seed), sample_rate)
    return str(path)


def stream_tension(x: np.ndarray, sr: int) -> np.ndarray:
    """Per-frame tension from the sample-serial NumPy front end, fed the
    batch engine's integer-step frames (frame t = x[t*step : t*step+W])."""
    from speedy_tpu.streaming import SpeedyFrontEndStream

    fe = SpeedyFrontEndStream(sr)
    W, step = fe.input_frame_size(), fe.input_frame_step()
    T = (len(x) - W) // step + 1
    fut = fe.cfg.hysteresis_future
    out = []
    for t in range(T):
        fe.add_data(x[t * step : t * step + W], t)
        if t >= fut:
            out.append(fe.compute_tension(t - fut))
    return np.asarray(out, np.float32)


@functools.lru_cache(maxsize=8)
def load_golden(name: str) -> np.ndarray:
    return np.loadtxt(TEST_DATA_DIR / name)


@functools.lru_cache(maxsize=8)
def load_wave(name: str):
    from speedy_tpu.io import read_wave

    return read_wave(str(TEST_DATA_DIR / name))


def compute_snr(signal: np.ndarray, estimate: np.ndarray) -> float:
    """speedy_test.cc:807-811 (linear power ratio, not dB). Exact matches
    return inf explicitly instead of warning on the 0/0 divide."""
    err_power = float(np.sum((signal - estimate) ** 2))
    if err_power == 0.0:
        return np.inf
    return float(np.sum(signal**2) / err_power)


def cross_correlation_snr(a: np.ndarray, b: np.ndarray, num_delays: int = 10):
    """speedy_test.cc:840-857 FindCrossCorrelation: SNR(a vs b) at delays
    -num_delays..num_delays, windows trimmed like the reference."""
    out = []
    for d in range(-num_delays, num_delays + 1):
        if d < 0:
            n = len(a) + d
            aa, bb = a[-d : -d + n], b[:n]
        else:
            n = len(a) - d
            aa, bb = a[:n], b[d : d + n]
        out.append(compute_snr(aa, bb))
    return np.array(out)


def best_delay_and_snr(computed: np.ndarray, expected: np.ndarray, num_delays: int = 10):
    snrs = cross_correlation_snr(computed, expected, num_delays)
    i = int(np.argmax(snrs))
    return i - num_delays, float(snrs[i])


def exact_spectrogram_f64(x: np.ndarray, cfg, T: int) -> np.ndarray:
    """Float64 magnitude spectrogram of every AddData frame — the exact
    (rounding-free) reference math for attribution predicates. Mirrors
    speedy.c:416-474 with integer-step (shim) framing."""
    from speedy_tpu.ops import framing

    starts = framing.frame_starts(cfg, T, integer_step=True)
    W = cfg.window_size
    idx = starts[:, None] + np.arange(W)[None, :]
    frames = x[np.clip(idx, 0, len(x) - 1)].astype(np.float64)
    prev_last = x[np.clip(starts[:-1] + W - 1, 0, len(x) - 1)].astype(np.float64)
    state = np.concatenate([[0.0], prev_last])
    prev = np.concatenate([state[:, None], frames[:, :-1]], axis=1)
    pre = frames - 0.97 * prev
    i = np.arange(W, dtype=np.float64)
    win = 0.54 - 0.46 * np.cos(2.0 * np.pi * i / (W - 1.0))
    n = np.arange(W, dtype=np.float64)[:, None]
    k = np.arange(W + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / (2.0 * W)
    fw = pre * win[None, :]
    re = fw @ np.cos(ang)
    im = fw @ (-np.sin(ang))
    return np.sqrt(re * re + im * im)  # [T, W+1]


def assert_tension_outliers_are_mask_edges(
    x: np.ndarray,
    cfg,
    T: int,
    diffs: np.ndarray,
    outlier_thresh: float = 1e-4,
    edge_rel_eps: float = 1e-4,
):
    """Attribute HIGH-precision tension outliers to 40 dB mask-edge frames.

    The only documented way bf16x3 (HIGH, ~2^-16 relative rounding) moves
    tension by more than ~1e-4 is a mask-membership flip: a non-DC bin of
    the current or previous frame sitting within rounding distance of the
    40 dB threshold max(cur[1:])/100 (speedy.c:705-709), whose |log-ratio|
    term then enters/leaves the spectral-difference sum. For every frame
    with |tension - oracle| > outlier_thresh, recompute the spectrogram in
    float64 and assert some bin's RELATIVE distance to the threshold is
    < edge_rel_eps. On tapestry.wav the two real outliers sat at margins
    2.1e-5 / 5.9e-6 while only 5/304 clean frames fell under 1e-4 — a
    regression elsewhere cannot hide in the budget by chance."""
    diffs = np.asarray(diffs)
    out_idx = np.where(diffs > outlier_thresh)[0]
    if out_idx.size == 0:
        return
    spec = exact_spectrogram_f64(np.asarray(x, np.float32), cfg, T)
    W = spec.shape[1] - 1
    T_out = diffs.shape[0]
    cur = spec[:T_out, 1:W]
    last = np.concatenate([np.zeros((1, W - 1)), spec[: T_out - 1, 1:W]])
    thresh = cur.max(axis=1, keepdims=True) / 100.0
    d = np.minimum(np.abs(cur - thresh), np.abs(last - thresh))
    margins = d.min(axis=1) / thresh[:, 0]
    for t in out_idx:
        assert margins[t] < edge_rel_eps, (
            "tension outlier is NOT a 40 dB mask-edge frame",
            int(t),
            float(diffs[t]),
            float(margins[t]),
        )


def assert_period_flips_are_ties(
    segs,
    per_a,
    per_b,
    taps: int,
    minp: int,
    maxp: int,
    mask=None,
    rel_tol: float = 1e-4,
    max_flip_frac: float = 0.02,
):
    """Attribute integer-argmin disagreements between two pitch paths.

    For every cell where |per_a - per_b| > 0.5 (and ``mask``, if given),
    recompute the exact SSD objective in float64 with a naive numpy loop
    (wsola_fast._pitch_ssd's definition: template = seg[:taps],
    SSD(d) = sum((seg[:taps] - seg[d:d+taps])**2) over the seg_w window)
    at BOTH chosen integer lags. A benign re-ranking has
    |SSD(a) - SSD(b)| within f32 summation noise of the curve scale;
    one path picking a genuinely worse lag fails loudly. Uniform
    per-utterance gain cancels in the relative margin, so raw segments
    are fine."""
    per_a = np.asarray(per_a, np.float64)
    per_b = np.asarray(per_b, np.float64)
    d = np.abs(per_a - per_b)
    flip_mask = d > 0.5
    if mask is not None:
        flip_mask &= np.asarray(mask)
        total = int(np.count_nonzero(mask))
    else:
        total = d.size
    flips = np.argwhere(flip_mask)
    assert flips.shape[0] <= max(1, int(max_flip_frac * total)), (
        "too many integer period flips",
        flips.shape[0],
        total,
    )
    seg_w = taps + maxp
    lags = np.arange(minp, maxp + 1)
    for b, g in flips:
        seg = np.asarray(segs[b, g][:seg_w], np.float64)

        def ssd(lag):
            i = int(round(float(lag)))
            return float(np.sum((seg[:taps] - seg[i : i + taps]) ** 2))

        scale = max(max(ssd(l) for l in lags), 1e-30)
        margin = abs(ssd(per_a[b, g]) - ssd(per_b[b, g])) / scale
        assert margin < rel_tol, (
            "period flip is NOT an SSD tie",
            int(b),
            int(g),
            float(per_a[b, g]),
            float(per_b[b, g]),
            margin,
        )
