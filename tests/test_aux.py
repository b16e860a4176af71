"""Auxiliary subsystems: checkpoint/resume exactness, profiling helpers,
and the tier-1 DFT sanity check (kiss_fft_test.cc equivalent)."""

import numpy as np
import pytest

import testutil
from speedy_tpu.checkpoint import load_stream, restore_stream, save_stream, snapshot_stream
from speedy_tpu.profiling import StageTimer, feature_names
from speedy_tpu.streaming import SonicStream


def make_input(n=44100):
    i = np.arange(n)
    return (
        20000
        * np.sin(i * 2 * np.pi * 237.0 / 22050)
        * (0.5 + 0.5 * np.sin(i * 2 * np.pi * 2.0 / 22050))
    ).astype(np.int16)


def drain(st, out):
    while True:
        r = st.read_short(256)
        if len(r) == 0:
            return
        out.append(r)


def test_checkpoint_resume_exact():
    """Splitting a stream at an arbitrary point via snapshot/restore must
    reproduce the unbroken stream bit-exactly."""
    x = make_input()
    half = 17003  # deliberately unaligned with any buffer boundary

    ref_st = SonicStream(22050, 1)
    ref_st.set_speed(2.5)
    ref_st.enable_nonlinear_speedup(1.0)
    ref_out = []
    ref_st.write_short(x)
    drain(ref_st, ref_out)
    ref_st.flush()
    drain(ref_st, ref_out)
    ref = np.concatenate(ref_out)

    st = SonicStream(22050, 1)
    st.set_speed(2.5)
    st.enable_nonlinear_speedup(1.0)
    out = []
    st.write_short(x[:half])
    drain(st, out)
    st2 = restore_stream(snapshot_stream(st))
    del st
    st2.write_short(x[half:])
    drain(st2, out)
    st2.flush()
    drain(st2, out)
    got = np.concatenate(out)
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got, ref)


def test_checkpoint_file_roundtrip(tmp_path):
    x = make_input(22050)
    st = SonicStream(22050, 1)
    st.set_speed(3.0)
    st.enable_nonlinear_speedup(1.0)
    st.write_short(x[:9000])
    path = str(tmp_path / "state.npz")
    save_stream(st, path)
    st2 = load_stream(path)
    out1, out2 = [], []
    st.write_short(x[9000:])
    st.flush()
    drain(st, out1)
    st2.write_short(x[9000:])
    st2.flush()
    drain(st2, out2)
    np.testing.assert_array_equal(np.concatenate(out1), np.concatenate(out2))


def test_stage_timer():
    t = StageTimer()
    with t.stage("analysis", audio_seconds=1.0):
        pass
    with t.stage("analysis", audio_seconds=1.0):
        pass
    assert t.counts["analysis"] == 2
    assert "analysis" in t.report()


def test_feature_names_count():
    assert len(feature_names()) == 15


def test_dft_sanity_eight_point():
    """kiss_fft_test.cc:50-85 equivalent: an 8-point cosine transforms to
    exact ±N/2 peaks at the signal bin, zero elsewhere."""
    import jax.numpy as jnp

    from speedy_tpu.ops import dft

    # Use the matrices directly at window=4 (fft=8): cos of 1 cycle/8.
    cos_m, sin_m = dft.dft_matrices(4, "float64")
    x = np.cos(2 * np.pi * np.arange(4) / 8.0)  # half a cycle over the window
    re = x @ cos_m
    im = x @ sin_m
    full = np.sqrt(re**2 + im**2)
    # Compare against numpy's rFFT of the zero-padded window.
    ref = np.abs(np.fft.rfft(x, 8))
    np.testing.assert_allclose(full, ref, atol=1e-12)


def test_multi_rate_speech_sweep():
    """sonic_classic_test.cc:529-534: sweep 1.1..6.3 in 0.65 steps on
    speech; output length within ±14 ms of input/speed."""
    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.pipeline import linear_time_scale

    samples, sr = testutil.speech_pcm(16000, 50381), 16000
    cfg = SpeedyConfig(sr)
    for speed in np.arange(1.1, 6.31, 0.65):
        r = linear_time_scale(samples, cfg, float(speed), engine="grid")
        expected = len(samples) / speed
        assert abs(len(r.output) - expected) < 0.014 * sr + 3, speed


def test_noise_input_length():
    """sonic_classic_test.cc:558-576: white noise (no pitch) still honors
    the length contract."""
    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.pipeline import linear_time_scale

    rng = np.random.default_rng(0)
    noise = (rng.normal(size=22050) * 8000).astype(np.int16)
    cfg = SpeedyConfig(22050)
    for engine in ("scan", "grid"):
        r = linear_time_scale(noise, cfg, 3.0, engine=engine)
        expected = len(noise) / 3.0
        assert abs(len(r.output) - expected) < 0.02 * expected, engine


def test_paper_mode_hysteresis():
    """MATCH_MATLAB=False swaps hysteresis future/past to 12/8 (the
    paper's orientation, speedy.h:142-146); verify the swapped ramp."""
    import jax.numpy as jnp

    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.ops.hysteresis import tapered_max_hysteresis

    cfg = SpeedyConfig(22050, match_matlab=False)
    assert (cfg.hysteresis_future, cfg.hysteresis_past) == (12, 8)
    correct = ([0] * 5 + [i / 24.0 for i in range(1, 12)] + [1.0]
               + [i / 16.0 for i in range(7, 0, -1)] + [0] * 8)
    values = np.zeros(32, np.float32)
    values[16] = 1.0
    got = np.asarray(tapered_max_hysteresis(jnp.asarray(values), 12, 8, 32))
    np.testing.assert_allclose(got, np.array(correct, np.float32), atol=1e-7)


def test_paper_mode_end_to_end():
    """The full pipeline runs in paper mode with its longer lookahead."""
    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.ops.analysis import analyze_jit

    cfg = SpeedyConfig(16000, match_matlab=False)
    x = (0.3 * np.sin(np.arange(16000) * 0.06)).astype(np.float32)
    res = analyze_jit(x, cfg)
    T = cfg.num_frames(16000)
    assert res.tension.shape[0] == T - 12  # 120 ms lookahead
    assert np.all(np.isfinite(np.asarray(res.tension)))


def test_paper_mode_tension_vs_reference_oracle(tmp_path):
    """Tension-level paper-mode gate: the shipped reference library builds
    WITHOUT MATCH_MATLAB (hysteresis 12/8, Makefile:13) but its tests pin
    the Matlab configuration — so paper mode has no golden dump. Build the
    reference itself in paper mode (the exact-DFT oracle recipe,
    tools/oracle/) and hold our match_matlab=False analysis to it."""
    import os
    import shutil
    import subprocess

    if shutil.which("gcc") is None:
        pytest.skip("no C toolchain")
    if not os.path.exists("/root/reference/speedy.c"):
        pytest.skip("reference not available")
    if not testutil.have_test_data():
        pytest.skip("no test data")
    import pathlib

    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.ops.analysis import analyze_jit

    oracle_dir = pathlib.Path(__file__).resolve().parent.parent / "tools" / "oracle"
    exe = tmp_path / "oracle_paper"
    subprocess.run(
        [
            "gcc", "-O2", "-DKISS_FFT",  # no -DMATCH_MATLAB: paper mode
            "-I", str(oracle_dir), "-I", "/root/reference",
            str(oracle_dir / "driver.c"), "/root/reference/speedy.c",
            "-o", str(exe), "-lm",
        ],
        check=True, capture_output=True,
    )
    samples, sr = testutil.load_wave("tapestry22050.wav")
    x = (samples.astype(np.float32) / 32768.0).astype(np.float32)
    raw = tmp_path / "tap.f32"
    x.tofile(raw)
    feat_p = tmp_path / "feat.txt"
    subprocess.run(
        [str(exe), str(raw), str(sr), str(feat_p), str(tmp_path / "spec.txt")],
        check=True, capture_output=True,
    )
    feat = np.loadtxt(feat_p)
    cfg = SpeedyConfig(sr, match_matlab=False)
    res = analyze_jit(x, cfg)
    t_ours = np.asarray(res.tension)
    t_oracle = feat[:, -1]
    assert t_ours.shape == t_oracle.shape == (302,)  # 314 - 12 lookahead
    np.testing.assert_allclose(t_ours, t_oracle, atol=2e-5)


def test_streaming_latency_contract():
    """First output appears once the analysis lookahead is satisfied:
    the shim needs (future+2) frames buffered (kMinBufferSize contract,
    soniclib.c:91) — i.e. ~100 ms of input at 100 frames/s — before the
    first resynthesized samples emerge."""
    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.streaming import SonicStream

    sr = 16000
    cfg = SpeedyConfig(sr)
    step = cfg.frame_step_int
    x = (20000 * np.sin(np.arange(sr) * 0.09)).astype(np.int16)
    st = SonicStream(sr, 1)
    st.set_speed(2.0)
    st.enable_nonlinear_speedup(1.0)
    first_out_at = None
    for t in range(0, len(x), step):
        st.write_short(x[t : t + step])
        if st.samples_available() > 0:
            first_out_at = t + step
            break
    assert first_out_at is not None
    # End-to-end latency = analysis lookahead (8 frames + shim slack) plus
    # the WSOLA engine's fill requirement (2*max_period + chunk samples
    # before its first synthesis step).
    engine_fill = 3 * cfg.wsola_max_period
    bound = (cfg.hysteresis_future + 2) * step + engine_fill + step
    assert first_out_at <= bound, (first_out_at, bound)
    assert first_out_at >= cfg.hysteresis_future * step
