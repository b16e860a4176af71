"""DTW unit tests (dynamic_time_warping_test.cc, exact costs/paths) and the
DTW warp-slope verification of compressed speech (sonic_test.cc:641-724)."""

import jax.numpy as jnp
import numpy as np
import pytest

import testutil
from speedy_tpu.config import SpeedyConfig
from speedy_tpu.ops import dft
from speedy_tpu.ops.dtw import (
    DynamicTimeWarping,
    accumulate,
    best_path,
    directions,
    euclidean_cost_matrix,
)
from speedy_tpu.pipeline import linear_time_scale, nonlinear_speedup


def seq(vals):
    return np.asarray(vals, np.float32).reshape(-1, 1)


def test_identical_sequences():
    s = seq([0, 1, 2, 3, 4])
    dtw = DynamicTimeWarping(1)
    cost = dtw.compute(s, s)
    assert cost == pytest.approx(0.0)
    p1, p2 = dtw.best_path_sequence()
    assert p1 == p2


def test_shifted_sequences():
    s1 = seq([0, 1, 2, 3, 4])
    s2 = seq([-2, -1, 0, 1, 2])
    dtw = DynamicTimeWarping(1)
    cost = dtw.compute(s1, s2)
    assert cost == pytest.approx(6.0)
    p1, p2 = dtw.best_path_sequence()
    assert p1 == [0, 0, 0, 1, 2, 3, 4]
    assert p2 == [0, 1, 2, 3, 4, 4, 4]


def test_downsampled_sequence():
    s1 = seq([0, 1, 2, 3, 4])
    s2 = seq([0, 2, 4])
    dtw = DynamicTimeWarping(1)
    cost = dtw.compute(s1, s2)
    assert cost == pytest.approx(2.0)
    p1, p2 = dtw.best_path_sequence()
    assert p1 == [0, 1, 2, 3, 4]
    assert p2 == [0, 0, 1, 1, 2]


def test_accumulate_matches_bruteforce():
    rng = np.random.default_rng(0)
    cost = rng.uniform(0, 1, size=(17, 23)).astype(np.float32)
    total, acc = accumulate(jnp.asarray(cost))
    ref = cost.copy()
    for j in range(1, 23):
        ref[0, j] += ref[0, j - 1]
    for i in range(1, 17):
        ref[i, 0] += ref[i - 1, 0]
    for i in range(1, 17):
        for j in range(1, 23):
            ref[i, j] += min(ref[i - 1, j], ref[i, j - 1], ref[i - 1, j - 1])
    np.testing.assert_allclose(np.asarray(acc), ref, rtol=1e-5, atol=1e-5)
    assert float(total) == pytest.approx(ref[-1, -1], rel=1e-5)


# --- the speech verification path (sonic_test.cc TestSpeechSample) ---

def compute_block_spectrogram(samples, cfg):
    """Non-overlapping |DFT| frames like ComputeSpectrogram
    (sonic_test.cc:211-238): frame step == frame size, no preemphasis."""
    w = cfg.window_size
    n = (len(samples) - 1) // w
    frames = samples[: n * w].astype(np.float32).reshape(n, w)
    return np.asarray(dft.magnitude_spectrogram(jnp.asarray(frames), cfg))[:, :w]


def linear_slope(x, y):
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = len(x)
    return (n * np.sum(x * y) - x.sum() * y.sum()) / (
        n * np.sum(x * x) - x.sum() ** 2
    )


def slopes_everywhere(x, y, half_width):
    return np.array(
        [
            linear_slope(x[i - half_width : i + half_width], y[i - half_width : i + half_width])
            for i in range(half_width, len(x) - half_width)
        ]
    )


@pytest.mark.parametrize("engine", ["scan", "grid"])
@pytest.mark.parametrize("mode,slope_tol", [("linear", 0.02), ("speedy", 0.1)])
def test_dtw_slope_of_compressed_speech(mode, slope_tol, engine):
    samples, sr = testutil.speech_pcm(16000, 50381), 16000
    cfg = SpeedyConfig(sr)
    speed = 3.0
    orig_spec = compute_block_spectrogram(samples, cfg)
    if mode == "linear":
        out = linear_time_scale(samples, cfg, speed, engine=engine).output
    else:
        out = nonlinear_speedup(samples, cfg, speed, 1.0, 0.1, engine=engine).output
    comp_spec = compute_block_spectrogram(out, cfg)

    cost = euclidean_cost_matrix(jnp.asarray(orig_spec), jnp.asarray(comp_spec))
    _, acc = accumulate(cost)
    p1, p2 = best_path(np.asarray(directions(cost, acc)))
    slope = linear_slope(p1, p2)
    assert slope == pytest.approx(1.0 / speed, abs=slope_tol)
    local = slopes_everywhere(p1, p2, 10)
    assert np.mean(local) == pytest.approx(slope, abs=0.02)
    assert np.std(local) < 0.2  # sonic_test.cc:699,723
