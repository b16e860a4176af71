"""Cross-engine resynthesis fidelity gate: grid engine vs the
sonic-exact scan engine (round-4 verdict item 3).

The scan engine (ops/wsola.py) re-implements libsonic's per-step
speed-change algebra exactly and is the repo's strongest available
fidelity anchor for C19 (libsonic itself is an external, unbuildable
dependency — /root/reference/Makefile:7,17). The grid engine
(ops/wsola_fast.py) is the production path with a different pitch
search (regular-grid SSD vs AMDF-at-cursor) and synthesis schedule, so
outputs are not bitwise-comparable; the correct harness is the
reference's own cross-output shape (sonic_test.cc:641-724): DTW-align
block spectrograms of the two outputs and bound the aligned distance.

Gate bounds come from experiments/cross_engine_probe.py (CPU, 4
synthetic bench families + tapestry at 2.0x/3.5x):

  measured scan-vs-grid:  len_rel <= 0.025, DTW cost/frame <= 0.62,
                          loud-frame aligned dist mean <= 0.52
  degraded control (naive resample, pitch-shifted): loud dist mean
                          >= 0.82 on tonal/speech content

so the bounds below (len 0.04 / cost 0.80 / dist 0.65) sit with
~25% headroom above engine disagreement and clearly below a real
resynthesis-quality regression. The noise family saturates the spectral
metric (control 0.63 vs engines 0.60 — stochastic frames decorrelate
regardless) and is gated on length/cost only.

A final test proves the metric's POWER: the naive-resample control must
FAIL the distance bound, so a silent metric regression cannot turn the
gate vacuous.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import testutil
from speedy_tpu.config import SpeedyConfig
from speedy_tpu.ops import dft
from speedy_tpu.ops.dtw import (
    accumulate,
    best_path,
    directions,
    euclidean_cost_matrix,
)
from speedy_tpu.pipeline import nonlinear_speedup

SR = 16000
LEN_REL_BOUND = 0.04
COST_PF_BOUND = 0.80
DIST_BOUND = 0.65


def _families(secs=4.0):
    """The bench's synthetic families (bench.py) at probe length."""
    t = np.arange(int(SR * secs)) / SR
    rng = np.random.default_rng(0)

    def speechlike(f0_base, f0_mod, f0_rate, syll_hz, n_harm):
        f0 = f0_base + f0_mod * np.sin(2 * np.pi * f0_rate * t)
        phase = np.cumsum(2 * np.pi * f0 / SR)
        voiced = sum(np.sin(k * phase) / k for k in range(1, n_harm + 1))
        envelope = np.clip(np.sin(2 * np.pi * syll_hz * t), 0, None)
        return (voiced * envelope * 0.2).astype(np.float32)

    fams = {
        "male": speechlike(110.0, 30.0, 0.7, 2.5, 5),
        "female": speechlike(210.0, 45.0, 1.3, 4.0, 7),
    }
    bursts = (np.sin(2 * np.pi * 3.1 * t) > 0.3).astype(np.float32)
    fams["noise"] = (rng.standard_normal(t.size) * 0.12 * bursts).astype(
        np.float32
    )
    chirp_f0 = 90.0 + 160.0 * (0.5 + 0.5 * np.sin(2 * np.pi * 0.11 * t))
    phase_c = np.cumsum(2 * np.pi * chirp_f0 / SR)
    fams["chirp"] = (
        (np.sin(phase_c) + 0.5 * np.sin(2 * phase_c))
        * np.clip(np.sin(2 * np.pi * 1.8 * t + 0.7), 0, None)
        * 0.2
    ).astype(np.float32)
    return fams


def _signal(name):
    if name == "tapestry":
        # tapestry.wav's shape as a seeded speech stand-in.
        return testutil.speech_like(SR, 50381)
    return _families()[name]


def _block_spec(x, cfg):
    """Non-overlapping |DFT| frames like ComputeSpectrogram
    (sonic_test.cc:211-238)."""
    w = cfg.window_size
    n = (len(x) - 1) // w
    frames = np.asarray(x[: n * w], np.float32).reshape(n, w)
    return np.asarray(dft.magnitude_spectrogram(jnp.asarray(frames), cfg))[
        :, :w
    ]


def aligned_metrics(ys, yg, cfg):
    """DTW-align block spectrograms of two same-rate outputs; return
    (cost_per_frame_normalized, loud-frame aligned relative distances)."""
    a = _block_spec(ys, cfg)
    b = _block_spec(yg, cfg)
    cost = euclidean_cost_matrix(jnp.asarray(a), jnp.asarray(b))
    total, acc = accumulate(cost)
    p1, p2 = best_path(np.asarray(directions(cost, acc)))
    p1, p2 = np.asarray(p1), np.asarray(p2)
    norms_a = np.linalg.norm(a, axis=1)
    norms_b = np.linalg.norm(b, axis=1)
    cost_pf = float(total) / len(p1) / max(float(np.mean(norms_a)), 1e-9)
    d = np.linalg.norm(a[p1] - b[p2], axis=1) / np.maximum(
        np.maximum(norms_a[p1], norms_b[p2]), 1e-9
    )
    # Relative distance is meaningless on near-silent frames (syllable
    # gaps): gate on frames carrying real signal on either side.
    loud = np.maximum(norms_a[p1], norms_b[p2]) >= 0.2 * np.mean(norms_a)
    return cost_pf, d[loud]


@pytest.mark.parametrize(
    "name,rate",
    [
        ("tapestry", 2.0),
        ("tapestry", 3.5),
        ("male", 3.5),
        ("female", 2.0),
        ("chirp", 3.5),
        pytest.param("male", 2.0, marks=pytest.mark.slow),
        pytest.param("female", 3.5, marks=pytest.mark.slow),
        pytest.param("chirp", 2.0, marks=pytest.mark.slow),
        pytest.param("noise", 2.0, marks=pytest.mark.slow),
        pytest.param("noise", 3.5, marks=pytest.mark.slow),
    ],
)
def test_grid_engine_matches_scan_engine(name, rate):
    x = _signal(name)
    cfg = SpeedyConfig(SR)
    ys = np.asarray(nonlinear_speedup(x, cfg, rate, 1.0, 0.1, engine="scan").output)
    yg = np.asarray(nonlinear_speedup(x, cfg, rate, 1.0, 0.1, engine="grid").output)
    len_rel = abs(len(ys) - len(yg)) / max(len(ys), 1)
    assert len_rel < LEN_REL_BOUND, (len(ys), len(yg))
    cost_pf, d = aligned_metrics(ys, yg, cfg)
    assert cost_pf < COST_PF_BOUND, cost_pf
    if name != "noise":  # stochastic frames saturate the metric (docstring)
        assert d.mean() < DIST_BOUND, float(d.mean())


def test_cross_engine_metric_detects_degradation():
    """The gate's power: naive linear-interp resampling at the same rate
    (a genuinely degraded 'resynthesis' — it pitch-shifts everything up
    by the rate) must FAIL the distance bound against the scan engine."""
    x = _signal("tapestry")
    cfg = SpeedyConfig(SR)
    ys = np.asarray(nonlinear_speedup(x, cfg, 3.5, 1.0, 0.1, engine="scan").output)
    bad = np.interp(
        np.linspace(0, len(x) - 1, len(ys)), np.arange(len(x)), x
    ).astype(np.float32)
    _, d = aligned_metrics(ys, bad, cfg)
    assert d.mean() > DIST_BOUND, float(d.mean())
