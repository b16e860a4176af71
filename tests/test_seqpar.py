"""Sequence-parallel analysis gates (parallel/seqpar.py): one utterance's
frame axis sharded over the 8-virtual-device mesh must reproduce the
single-device front-end — halo exchanges and the distributed LPF scan
change layout, not values (beyond scan-tree ulps)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import testutil
from speedy_tpu.config import SpeedyConfig
from speedy_tpu.ops.analysis import analyze
from speedy_tpu.parallel.mesh import make_mesh
from speedy_tpu.parallel.seqpar import analysis_seq_parallel

CFG16 = SpeedyConfig(16000)


def _full(x, cfg):
    return np.asarray(
        jax.jit(
            lambda u: analyze(
                u, cfg, num_frames=cfg.num_frames(len(x), True),
                integer_step=True,
            ).tension
        )(jnp.asarray(x))
    )


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_seqpar_matches_single_device_tapestry():
    x, sr = testutil.speech_like(16000, 50381), 16000
    cfg = SpeedyConfig(sr)
    mesh = make_mesh(tp=1)
    got = np.asarray(analysis_seq_parallel(jnp.asarray(x), cfg, mesh))
    full = _full(x, cfg)
    assert got.shape == full.shape
    np.testing.assert_allclose(got, full, rtol=0, atol=2e-5)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_seqpar_long_utterance_and_boundaries():
    """60 s utterance: every shard boundary's hysteresis/spectral halos
    must be exact; also an odd length that pads the last shard."""
    sr = 16000
    rng = np.random.default_rng(4)
    t = np.arange(int(sr * 60.3)) / sr
    f0 = 120.0 + 40.0 * np.sin(2 * np.pi * 0.31 * t)
    phase = np.cumsum(2 * np.pi * f0 / sr)
    x = (
        np.sin(phase) * np.clip(np.sin(2 * np.pi * 2.3 * t), 0, None) * 0.3
        + 0.01 * rng.standard_normal(t.size)
    ).astype(np.float32)
    mesh = make_mesh(tp=1)
    got = np.asarray(analysis_seq_parallel(jnp.asarray(x), CFG16, mesh))
    full = _full(x, CFG16)
    assert got.shape == full.shape
    d = np.abs(got - full)
    assert d.max() < 2e-5, d.max()
    # The interesting samples: frames within ±(past+fut) of every shard
    # boundary (halo correctness) — must be just as tight.
    T = len(full)
    Ts = -(-(CFG16.num_frames(len(x), True)) // jax.device_count())
    for b in range(1, jax.device_count()):
        lo, hi = max(0, b * Ts - 21), min(T, b * Ts + 21)
        assert d[lo:hi].max() < 2e-5, (b, d[lo:hi].max())


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_seqpar_on_dp_tp_mesh_devices():
    """The helper flattens whatever mesh it is given into one seq ring."""
    x = (0.3 * np.sin(np.arange(40000) * 0.05)).astype(np.float32)
    mesh = make_mesh(dp=4, tp=2)
    got = np.asarray(analysis_seq_parallel(jnp.asarray(x), CFG16, mesh))
    full = _full(x, CFG16)
    np.testing.assert_allclose(got, full, rtol=0, atol=2e-5)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_seqpar_short_input():
    """T smaller than the device count still works (shards with no valid
    frames mask out)."""
    x = (0.2 * np.sin(np.arange(2000) * 0.1)).astype(np.float32)
    mesh = make_mesh(tp=1)
    got = np.asarray(analysis_seq_parallel(jnp.asarray(x), CFG16, mesh))
    full = _full(x, CFG16)
    assert got.shape == full.shape
    if full.size:
        np.testing.assert_allclose(got, full, atol=2e-5)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_wsola_seq_parallel_matches_single_device():
    """Slot-sharded WSOLA for one utterance == single-device grid engine
    (same pitch cells, same time map, same global phase clock; shards
    only recompute their overlap chunk)."""
    from speedy_tpu.ops import wsola_fast
    from speedy_tpu.parallel.seqpar import wsola_seq_parallel

    sr = 16000
    rng = np.random.default_rng(6)
    t = np.arange(sr * 6) / sr
    x = (
        0.4
        * np.sin(2 * np.pi * (160 + 40 * np.sin(2 * np.pi * 0.5 * t)) * t)
        * np.clip(np.sin(2 * np.pi * 2.5 * t), 0, None)
        + 0.002 * rng.standard_normal(t.size)
    ).astype(np.float32)
    F = len(x) // CFG16.frame_step_int
    speeds = np.clip(
        2.5 + 1.2 * np.sin(np.arange(F) * 0.05), 1.0, 6.0
    ).astype(np.float32)

    ref = wsola_fast.time_scale_grid(
        jnp.asarray(x), jnp.asarray(speeds), CFG16,
        min_speed_bound=1.0, max_speed_bound=6.0,
    )
    v_ref = int(ref.valid_length)

    mesh = make_mesh(tp=1)
    y, valid = wsola_seq_parallel(
        jnp.asarray(x), jnp.asarray(speeds), CFG16, mesh,
        min_speed_bound=1.0, max_speed_bound=6.0,
    )
    assert int(valid) == v_ref
    ref_y = np.asarray(ref.output[:v_ref])
    got_y = np.asarray(y[:v_ref])
    d = np.abs(got_y - ref_y)
    # Each shard computes pitch on its sliced source span: identical
    # cells, but shard-local einsum shapes round differently by ulps
    # (measured max 4.2e-4, mean 9e-6).
    assert d.max() < 1e-3, d.max()
    assert d.mean() < 1e-4, d.mean()


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_nonlinear_speedup_seq_parallel_end_to_end():
    """Full single-utterance multi-chip pipeline vs the batched engine at
    B=1: same tension math (to scan-tree ulps), same speeds, same audio."""
    from speedy_tpu.parallel.batch import batched_nonlinear_speedup
    from speedy_tpu.parallel.seqpar import nonlinear_speedup_seq_parallel

    sr = 16000
    rng = np.random.default_rng(8)
    t = np.arange(sr * 8) / sr
    x = (
        0.35
        * np.sin(2 * np.pi * (140 + 35 * np.sin(2 * np.pi * 0.4 * t)) * t)
        * np.clip(np.sin(2 * np.pi * 2.8 * t), 0, None)
        + 0.002 * rng.standard_normal(t.size)
    ).astype(np.float32)
    ref = batched_nonlinear_speedup(
        jnp.asarray(x)[None], jnp.asarray([len(x)], np.int32), CFG16, 3.0
    )
    v_ref = int(ref.valid_length[0])

    mesh = make_mesh(tp=1)
    y, valid, tension, speeds = nonlinear_speedup_seq_parallel(
        jnp.asarray(x), CFG16, mesh, 3.0
    )
    assert abs(int(valid) - v_ref) <= 2, (int(valid), v_ref)
    n = min(int(valid), v_ref)
    d = np.abs(np.asarray(y[:n]) - np.asarray(ref.output[0, :n]))
    assert d.max() < 2e-3 and d.mean() < 1e-4, (d.max(), d.mean())
    np.testing.assert_allclose(
        np.asarray(tension), np.asarray(ref.tension[0]), atol=2e-5
    )
