"""Gates for the production path on an NVIDIA GPU. They skip elsewhere;
`python chip_smoke.py` runs them on the card (its gpu-tests phase). The
batch phase of chip_smoke.py covers 16 and 22.05 kHz at full width; these
add 44.1 kHz, stereo, and the fused input gain."""

import numpy as np
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_gpu_batch_checks_44k(gpu):
    """Tension vs the NumPy front end, periods vs the float64 brute force
    and lengths vs the scan engine at 44.1 kHz, at the production 1.33
    capacity factor on 10 s rows (long enough for the duration feedback to
    hold every family under it; the noise bursts end near 1.31)."""
    res = chip_smoke.phase_batch(44100, 8, 10.0, devices=[gpu])
    assert res["valid_max"] < res["cap"]


def test_gpu_truncated_rows_are_retried_44k(gpu):
    """On 3 s rows that fill their 2^17-sample bucket the duration
    feedback has not yet pulled the noise-burst family under the 1.33
    capacity factor: the step reports valid == capacity (the truncation
    contract) and CorpusEngine reruns the row at the worst-case plan, so
    every output matches a worst-case run."""
    from bench_signals import bench_families
    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.parallel.batch import CorpusEngine

    cfg = SpeedyConfig(44100)
    utts = list(bench_families(44100, 1 << 17))
    kw = dict(batch_size=4, long_utterance_samples=None)
    eng = CorpusEngine(cfg, chip_smoke.RATE, capacity_factor=chip_smoke.CAP_FACTOR, **kw)
    with pytest.warns(RuntimeWarning, match="output cap"):
        got = eng.process(utts)
    assert eng.stats["capacity_retries"] >= 1, eng.stats
    ref = CorpusEngine(cfg, chip_smoke.RATE, **kw).process(utts)
    for b, (g, r) in enumerate(zip(got, ref)):
        chip_smoke._diff_gate(f"row {b}", g, r, cfg.frame_step_int)


def test_gpu_identical_stereo_channels_match_mono(gpu):
    import jax.numpy as jnp

    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.parallel import batch as pb
    from bench_signals import bench_families

    cfg = SpeedyConfig(16000)
    x = bench_families(16000, 40000)[:2]
    lengths = jnp.asarray([40000, 38500], jnp.int32)
    st = jnp.asarray(np.stack([x, x], axis=-1))
    r_mc = pb.batched_nonlinear_speedup_multichannel(st, lengths, cfg, 3.0)
    r_mono = pb.batched_nonlinear_speedup(jnp.asarray(x), lengths, cfg, 3.0)
    np.testing.assert_array_equal(
        np.asarray(r_mc.valid_length), np.asarray(r_mono.valid_length)
    )
    y = np.asarray(r_mc.output)
    np.testing.assert_array_equal(y[:, 0], y[:, 1])
    for b in range(2):
        chip_smoke._diff_gate(f"stereo row {b}", y[b, 0], np.asarray(r_mono.output)[b],
                              cfg.frame_step_int)


def test_gpu_gain_matches_prescaled_input(gpu):
    import jax.numpy as jnp

    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.parallel.batch import batched_nonlinear_speedup
    from bench_signals import bench_families

    cfg = SpeedyConfig(16000)
    x = jnp.asarray(bench_families(16000, 48000))
    lengths = jnp.full((4,), 48000, jnp.int32)
    g = jnp.asarray([0.5, 0.9, 1.2, 0.7], jnp.float32)
    ref = batched_nonlinear_speedup(x * g[:, None], lengths, cfg, 3.5)
    got = batched_nonlinear_speedup(x, lengths, cfg, 3.5, gain=g)
    vr, vg = np.asarray(ref.valid_length), np.asarray(got.valid_length)
    for b in range(4):
        chip_smoke._diff_gate(f"gain row {b}", np.asarray(got.output)[b, : vg[b]],
                              np.asarray(ref.output)[b, : vr[b]], cfg.frame_step_int)
