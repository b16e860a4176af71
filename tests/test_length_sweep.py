"""Tier-4 real-speech length-sweep parity (sonic_classic_test.cc:518-576).

The reference gates the classic (linear, constant-speed) WSOLA engine on:
  * TestFullSpeechRange  (:518-534): tapestry.wav (16 kHz, 50381 samples;
    here a seeded speech-like signal of that rate and length),
    speedups 1.1 -> 6.3 step 0.25, output length within +-14 ms.
  * TestFullNoiseRange   (:557-576): 50k samples of Gaussian noise at
    16 kHz, same sweep, within 1.5 * sr / 100 samples.
  * TestLongStereoSpeechRange (:537-555): long 48 kHz stereo, speedups
    1.1 -> 6.3 step 0.5, within 300 ms. (The referenced capture_1_00x.wav
    is ABSENT from the reference's test_data/ — SURVEY.md §4 — so this
    rebuild gates the same contract on a synthesized long stereo signal.)

Both rebuild engines are swept: the grid engine (throughput path) and
the scan engine (sonic-exact algebra). Each engine compiles ONE program
per signal shape — speed is a dynamic input and the capacity plan is
fixed at min_speed_bound=1.0 — so the 21-point sweep costs one compile.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import testutil
from speedy_tpu.config import SpeedyConfig
from speedy_tpu.ops import wsola, wsola_fast

# for (float s = 1.1; s < 6.3; s += 0.25): 21 points, last 6.1.
SWEEP = [1.1 + 0.25 * k for k in range(21)]
SWEEP_COARSE = [1.1 + 0.5 * k for k in range(11)]  # stereo test's step 0.5


def _load_tapestry():
    """tapestry.wav's shape (16 kHz, 50381 samples, sonic_classic_test.cc:
    524-526) as a seeded speech stand-in."""
    return testutil.speech_like(16000, 50381), 16000


def _noise_16k(n=50000, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.normal(0.0, 1.0, n) * 8096
    return (np.clip(f, -32000, 32000).astype(np.int16) / 32768.0).astype(
        np.float32
    ), 16000


def _sweep_scan(x, sr, speeds_list, tol_samples):
    """Scan engine: one jitted program (fixed plan at bound 1.0), dynamic
    constant speed."""
    cfg = SpeedyConfig(sr)
    L = len(x)
    _, _, cap, steps = wsola.plan(cfg, L, 1.0)
    xj = jnp.asarray(x)
    errs = {}
    for sp in speeds_list:
        r = wsola.time_scale(
            xj, jnp.asarray([sp], jnp.float32), cfg,
            min_speed_bound=1.0, capacity=cap, num_steps=steps,
        )
        got = int(r.valid_length)
        expected = L / sp
        errs[sp] = got - expected
        assert abs(got - expected) < tol_samples, (
            f"scan engine at {sp}x: {got} vs {expected:.0f} "
            f"(err {got - expected:.0f}, tol {tol_samples})"
        )
    return errs


def _sweep_grid(x, sr, speeds_list, tol_samples):
    """Grid engine: one jitted program, dynamic constant speed."""
    cfg = SpeedyConfig(sr)
    L = len(x)
    xj = jnp.asarray(x)
    for sp in speeds_list:
        F = max(1, L // cfg.frame_step_int)
        r = wsola_fast.time_scale_grid(
            xj, jnp.full((F,), sp, jnp.float32), cfg, min_speed_bound=1.0
        )
        got = int(r.valid_length)
        expected = L / sp
        assert abs(got - expected) < tol_samples, (
            f"grid engine at {sp}x: {got} vs {expected:.0f}"
        )
        # The length must be REAL audio, not a zero-padded tail: the last
        # 20 ms before valid_length must carry energy for speech input.
        tail = np.asarray(r.output[max(0, got - sr // 50) : got])
        assert np.abs(tail).max() > 1e-4


def test_full_speech_range_scan_engine():
    x, sr = _load_tapestry()
    _sweep_scan(x, sr, SWEEP, 14 * sr // 1000)  # +-14 ms


def test_full_speech_range_grid_engine():
    x, sr = _load_tapestry()
    _sweep_grid(x, sr, SWEEP, 14 * sr // 1000)


def test_full_noise_range_scan_engine():
    x, sr = _noise_16k()
    _sweep_scan(x, sr, SWEEP, int(1.5 * sr / 100))


def test_full_noise_range_grid_engine():
    x, sr = _noise_16k()
    _sweep_grid(x, sr, SWEEP, int(1.5 * sr / 100))


def _long_stereo_48k(seconds=10.0, sr=48000, seed=1):
    """Speech-like long stereo: pitch-modulated harmonics with syllabic
    envelopes, channels related but not identical (slight delay + gain),
    standing in for the absent capture_1_00x.wav."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120.0 + 25.0 * np.sin(2 * np.pi * 0.4 * t)
    phase = np.cumsum(2 * np.pi * f0 / sr)
    voiced = sum(np.sin(k * phase) / k for k in range(1, 7))
    env = np.clip(np.sin(2 * np.pi * 2.2 * t), 0, None)
    left = (voiced * env * 0.25 + 0.003 * rng.standard_normal(t.size)).astype(
        np.float32
    )
    right = (0.8 * np.roll(left, 17) + 0.002 * rng.standard_normal(t.size)).astype(
        np.float32
    )
    return np.stack([left, right], axis=1), sr  # [L, 2]


def test_long_stereo_speech_range_grid_engine():
    """48 kHz stereo sweep at step 0.5 within 300 ms
    (sonic_classic_test.cc:537-555). Channels are resynthesized with
    mono-derived positions (the reference shim's multichannel contract),
    so both channels share one valid length."""
    stereo, sr = _long_stereo_48k()
    cfg = SpeedyConfig(sr)
    L = stereo.shape[0]
    mono = stereo.mean(axis=1)
    hop, cap, K = wsola_fast.plan_grid(cfg, L, 1.0)
    tol = 300 * sr // 1000
    for sp in SWEEP_COARSE:
        r = wsola_fast._wsola_grid_batch(
            jnp.asarray(mono)[None],
            jnp.asarray([L], jnp.int32),
            jnp.asarray([[sp]], jnp.float32),
            cfg.wsola_min_period,
            cfg.wsola_max_period,
            cfg.frame_step_int,
            hop,
            cap,
            K,
            xs_channels=jnp.asarray(stereo.T)[None],
        )
        got = int(r.valid_length[0])
        expected = L / sp
        assert abs(got - expected) < tol, (sp, got, expected)
        y = np.asarray(r.output[0])  # [2, cap]
        assert y.shape[0] == 2
        assert np.abs(y[:, : got]).max() > 1e-3
        assert not np.abs(y[:, got:]).any()
