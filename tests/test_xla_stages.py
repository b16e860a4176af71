"""Reference checks of the grid pipeline's XLA stages against plain NumPy:
the synthesis gather/interp/OLA, the analysis chain against the
sample-serial SpeedyFrontEndStream, the pitch SSD against a float64 brute
force, the row gather, and the fused input gain."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import testutil
from speedy_tpu.config import SpeedyConfig
from speedy_tpu.ops import wsola_fast


def _synth_reference_np(x, starts, af, hop):
    """NumPy loop form of wsola_fast._synth_slots."""
    B, K = starts.shape
    wn = 2 * hop
    i = np.arange(wn, dtype=np.float64) + 0.5
    win = (0.5 - 0.5 * np.cos(2.0 * np.pi * i / wn)).astype(np.float32)
    out = np.zeros((B, K, hop), np.float32)
    for b in range(B):
        prev_second = None
        for k in range(K):
            row = x[b, starts[b, k] : starts[b, k] + wn + 1]
            raw = row[:-1] * (1.0 - af[b, k]) + row[1:] * af[b, k]
            w = raw * win
            out[b, k] = raw[:hop] if k == 0 else w[:hop] + prev_second
            prev_second = w[hop:]
    return out


@pytest.mark.parametrize(
    "hop,K",
    [
        (160, 300),  # 16 kHz frame step
        (220, 256),  # 22.05 kHz
        (128, 130),
        (96, 140),
    ],
)
def test_synth_slots_match_numpy(hop, K):
    rng = np.random.default_rng(7)
    B, L = 3, 40000
    width = 2 * hop + 1
    x = rng.standard_normal((B, L)).astype(np.float32)
    steps = rng.uniform(hop * 0.5, hop * 5.5, (B, K))
    starts = np.minimum(np.cumsum(steps, axis=1).astype(np.int32), L - width - 1)
    af = rng.uniform(0.0, 1.0, (B, K)).astype(np.float32)
    got = np.asarray(
        jax.jit(wsola_fast._synth_slots, static_argnums=3)(
            jnp.asarray(x), jnp.asarray(starts), jnp.asarray(af), hop
        )
    )
    ref = _synth_reference_np(x, starts, af, hop)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_gather_rows_matches_numpy():
    rng = np.random.default_rng(11)
    B, K, width, L = 3, 64, 321, 40000
    x = rng.standard_normal((B, L)).astype(np.float32)
    starts = rng.integers(0, L - width, size=(B, K)).astype(np.int32)
    got = np.asarray(
        wsola_fast._gather_rows(jnp.asarray(x), jnp.asarray(starts), width)
    )
    ref = np.stack(
        [np.stack([x[b, s : s + width] for s in starts[b]]) for b in range(B)]
    )
    np.testing.assert_array_equal(got, ref)


def _analysis_test_batch(sr, L):
    rng = np.random.default_rng(7)
    t = np.arange(L) / sr
    voiced = (
        np.sin(2 * np.pi * 180 * t) * np.clip(np.sin(2 * np.pi * 2.3 * t), 0, None)
    ).astype(np.float32) * 0.4
    noise = rng.standard_normal(L).astype(np.float32) * 0.05
    bursty = np.zeros(L, np.float32)
    bursty[L // 8 : L // 3] = voiced[: L // 3 - L // 8]
    return np.stack([voiced, noise, bursty])


@pytest.mark.parametrize(
    "sr,W,step,L",
    [
        (16000, 240, 160, 32000),
        (16000, 240, 160, 340000),
        (22050, 330, 220, 66150),
        (22050, 330, 220, 441000),
        (24000, 360, 240, 96000),
    ],
)
def test_analysis_chain_matches_numpy_stream(sr, W, step, L):
    """batched_analysis (the XLA chain, at HIGHEST) == the NumPy
    SpeedyFrontEndStream frame by frame: float32 noise everywhere, and any
    frame off by more than 1e-4 is a 40 dB mask-edge flip."""
    from speedy_tpu.parallel.batch import batched_analysis

    cfg = SpeedyConfig(sr)
    assert (cfg.window_size, cfg.frame_step_int) == (W, step)
    xs = _analysis_test_batch(sr, L)
    T = cfg.num_frames(L, integer_step=True)
    got = np.asarray(
        jax.jit(lambda x: batched_analysis(x, cfg, T))(jnp.asarray(xs))
    )
    for b in range(xs.shape[0]):
        ref = testutil.stream_tension(xs[b], sr)
        assert got[b].shape == ref.shape
        d = np.abs(got[b] - ref)
        assert d.mean() < 1e-5, (b, d.mean())
        testutil.assert_tension_outliers_are_mask_edges(xs[b], cfg, T, d)


@pytest.mark.parametrize("sr", [16000, 22050, 44100])
def test_pitch_periods_match_float64_bruteforce(sr):
    """pitch_period_grid (DFT-matmul SSD, HIGHEST) vs a float64 loop over
    lags on the same grid: integer argmin flips only at float64 SSD ties,
    and the refined periods agree closely elsewhere."""
    import chip_smoke

    cfg = SpeedyConfig(sr)
    minp, maxp = cfg.wsola_min_period, cfg.wsola_max_period
    G = wsola_fast.pitch_grid_stride(cfg)
    rng = np.random.default_rng(5)
    L = sr * 2
    t = np.arange(L) / sr
    f0 = 140.0 + 40.0 * np.sin(2 * np.pi * 0.6 * t)
    xs = np.stack([
        (0.4 * np.sin(np.cumsum(2 * np.pi * f0 / sr))
         * np.clip(np.sin(2 * np.pi * 2.3 * t), 0, None)),
        rng.standard_normal(L) * 0.05,
    ]).astype(np.float32)
    got = np.asarray(
        jax.jit(lambda x: wsola_fast.pitch_period_grid(x, G, minp, maxp))(xs)
    )
    ref, segs = chip_smoke.pitch_reference_f64(xs.astype(np.float64), G, minp, maxp)
    assert got.shape == ref.shape
    testutil.assert_period_flips_are_ties(segs, got, ref, maxp, minp, maxp)
    d = np.abs(got - ref)
    assert np.mean(d[d <= 0.5] > 0.05) < 0.01, np.sort(d.ravel())[-10:]


def test_gain_matches_prescaled_input():
    """gain= through the full pipeline equals prescaling the input."""
    from speedy_tpu.parallel.batch import batched_nonlinear_speedup

    cfg = SpeedyConfig(16000)
    rng = np.random.default_rng(11)
    B, L = 3, 12000
    t = np.arange(L) / 16000.0
    base = (
        0.3 * np.sin(2 * np.pi * np.array([150.0, 220.0, 95.0])[:, None] * t)
        * np.clip(np.sin(2 * np.pi * 2.5 * t), 0, None)
        + 0.002 * rng.standard_normal((B, L))
    ).astype(np.float32)
    lengths = jnp.asarray([L, L - 1700, L], jnp.int32)
    g = jnp.asarray([0.5, 0.9, 1.2], jnp.float32)
    ref = batched_nonlinear_speedup(jnp.asarray(base) * g[:, None], lengths, cfg, 3.0)
    got = batched_nonlinear_speedup(jnp.asarray(base), lengths, cfg, 3.0, gain=g)
    np.testing.assert_array_equal(
        np.asarray(got.valid_length), np.asarray(ref.valid_length)
    )
    np.testing.assert_allclose(
        np.asarray(got.output), np.asarray(ref.output), atol=1e-3
    )
