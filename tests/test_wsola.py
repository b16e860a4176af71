"""WSOLA resynthesis contracts, mirroring sonic_test.cc tiers:
output-length accuracy, Teager sinusoid integrity (speedup, slowdown,
float path), nonlinear speech speedup rate, and negative_speed edge case."""

import numpy as np
import pytest

import testutil
from speedy_tpu.config import SpeedyConfig
from speedy_tpu.ops.teager import teager_stats
from speedy_tpu.pipeline import linear_time_scale, nonlinear_speedup

SR = 22050
CFG = SpeedyConfig(SR)
PITCH = 237.0  # sonic_test.cc:299


def make_sinusoid(sample_rate=SR, seconds=1.0, amplitude=32000):
    i = np.arange(int(sample_rate * seconds))
    period = sample_rate / PITCH
    return (amplitude * np.sin(i * 2 * np.pi / period)).astype(np.int16)


def check_teager(inp, out, skip_tail, mean_tol=0.01, rel_sigma=0.01):
    im, iv = teager_stats(inp.astype(np.float32) / 32768.0)
    om, ov = teager_stats(out[: len(out) - skip_tail].astype(np.float32) / 32768.0)
    assert abs(om - im) < mean_tol * im  # sonic_test.cc:528
    assert np.sqrt(iv) / im < rel_sigma
    assert np.sqrt(ov) / om < rel_sigma


@pytest.mark.parametrize("engine", ["scan", "grid"])
@pytest.mark.parametrize("speed", [3.0, 2.0, 1.5])
def test_sinusoid_speedup_length_and_teager(speed, engine):
    """sonic_test.cc:479-531 (TestWithSinusoids, speed 3.0) + extra speeds,
    held for both the sonic-exact scan engine and the grid-parallel one."""
    sinusoid = make_sinusoid()
    r = linear_time_scale(sinusoid, CFG, speed, engine=engine)
    expected = len(sinusoid) / speed
    assert abs(len(r.output) - expected) < 0.015 * expected
    check_teager(sinusoid, r.output, 300)


@pytest.mark.parametrize("engine", ["scan", "grid"])
def test_sinusoid_slowdown_length_and_teager(engine):
    """sonic_test.cc:536-589 (TestWithSinusoidsSlowdown, speed 0.4)."""
    sinusoid = make_sinusoid()
    r = linear_time_scale(sinusoid, CFG, 0.4, engine=engine)
    expected = len(sinusoid) / 0.4
    assert abs(len(r.output) - expected) < 0.015 * expected
    check_teager(sinusoid, r.output, 1000)


def test_float_path_matches_short_path():
    """sonic_test.cc:597-637: float samples in ±1 give the same result."""
    sinusoid = make_sinusoid()
    xf = sinusoid.astype(np.float32) / 32768.0
    r = linear_time_scale(xf, CFG, 3.0)
    expected = len(xf) / 3.0
    assert abs(len(r.output) - expected) < 0.03 * expected
    rs = linear_time_scale(sinusoid, CFG, 3.0)
    assert len(r.output) == len(rs.output)
    np.testing.assert_allclose(
        r.output, rs.output.astype(np.float32) / 32768.0, atol=2e-4
    )


def test_nearly_linear_nonlinear_path():
    """nonlinearFactor=1e-5 forces the full speedy machinery but an
    essentially linear speed (sonic_test.cc:487,497-507)."""
    sinusoid = make_sinusoid()
    r = nonlinear_speedup(sinusoid, CFG, 3.0, nonlinear_factor=1e-5)
    expected = len(sinusoid) / 3.0
    assert abs(len(r.output) - expected) < 0.015 * expected
    check_teager(sinusoid, r.output, 300)


@pytest.mark.parametrize("engine", ["scan", "grid"])
def test_speech_nonlinear_rate(engine):
    """Nonlinear speech speedup achieves roughly the requested rate with
    duration feedback (speedy_test.cc:653-711 contract at pipeline level)."""
    samples, sr = testutil.speech_pcm(16000, 50381), 16000
    cfg = SpeedyConfig(sr)
    r = nonlinear_speedup(samples, cfg, 3.0, 1.0, 0.1, engine=engine)
    assert abs(r.achieved_rate - 3.0) < 0.3  # within 10%
    assert np.max(np.abs(r.output.astype(np.int32))) > 1000  # actual audio


def test_duration_feedback_improves_rate():
    """Excess duration strictly shrinks as feedback strength grows, through
    the full pipeline (speedy_test.cc:696-711)."""
    samples, sr = testutil.speech_pcm(16000, 50381), 16000
    cfg = SpeedyConfig(sr)
    desired = 3.0
    errors = []
    for strength in (0.0, 0.1, 0.4):
        r = nonlinear_speedup(samples, cfg, desired, 1.0, strength)
        errors.append(abs(len(r.output) - len(samples) / desired))
    assert errors[0] > errors[1] > errors[2]


def test_negative_speed_wav_slowdown_no_crash():
    """speedy_test.cc:1059-1076: 24 kHz audio at speed 0.25 with nonlinear
    speedup must process without blowing up."""
    samples, sr = testutil.speech_pcm(24000, 36000), 24000
    cfg = SpeedyConfig(sr)
    r = nonlinear_speedup(samples, cfg, 0.25, 1.0, 0.1, min_speed_bound=0.1)
    assert np.all(np.isfinite(r.output.astype(np.float32)))
    assert len(r.output) > len(samples)  # it's a slowdown


def test_speed_one_passthrough():
    sinusoid = make_sinusoid(seconds=0.3)
    r = linear_time_scale(sinusoid, CFG, 1.0)
    assert len(r.output) == len(sinusoid)
    np.testing.assert_array_equal(r.output, sinusoid)


def test_speed_one_passthrough_grid():
    """Grid engine at speed 1.0 reduces to (near-)exact passthrough."""
    sinusoid = make_sinusoid(seconds=0.3)
    r = linear_time_scale(sinusoid, CFG, 1.0, engine="grid")
    assert len(r.output) == len(sinusoid)
    assert np.max(np.abs(r.output.astype(np.int32) - sinusoid.astype(np.int32))) <= 1


@pytest.mark.parametrize("speed", [1.1, 6.3])
def test_length_contract_extremes(speed):
    """Speed sweep endpoints of sonic_classic_test.cc:529-534 (±14 ms)."""
    sinusoid = make_sinusoid(seconds=2.0)
    r = linear_time_scale(sinusoid, CFG, speed)
    expected = len(sinusoid) / speed
    assert abs(len(r.output) - expected) < 0.014 * SR + 0.015 * expected


def test_grid_engine_max_speed_bound_parity():
    """With speeds below the plan ceiling, the speed clamp is a no-op:
    the output must be identical to the unbounded engine's."""
    import jax.numpy as jnp

    from speedy_tpu.ops import wsola_fast

    cfg = SpeedyConfig(SR)
    t = np.arange(SR * 3) / SR
    x = (
        0.4 * np.sin(2 * np.pi * 220 * t)
        * np.clip(np.sin(2 * np.pi * 3 * t), 0, None)
    ).astype(np.float32)
    T = cfg.num_frames(len(x), integer_step=True)
    speeds = (3.5 + np.sin(np.arange(T) * 0.1)).astype(np.float32)
    r1 = wsola_fast.time_scale_grid(
        jnp.asarray(x), jnp.asarray(speeds), cfg, min_speed_bound=1.0
    )
    r2 = wsola_fast.time_scale_grid(
        jnp.asarray(x), jnp.asarray(speeds), cfg, min_speed_bound=1.0,
        max_speed_bound=6.6,
    )
    assert int(r1.valid_length) == int(r2.valid_length)
    v = int(r1.valid_length)
    np.testing.assert_array_equal(
        np.asarray(r1.output)[:v], np.asarray(r2.output)[:v]
    )
