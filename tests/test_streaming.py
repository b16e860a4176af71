"""Streaming shim tests, mirroring sonic_test.cc's chunked-I/O harness
(TimeCompressVector, sonic_test.cc:364-443) and its mono/stereo and
callback contracts."""

import numpy as np
import pytest

import testutil
from speedy_tpu.config import SpeedyConfig
from speedy_tpu.ops.teager import teager_stats
from speedy_tpu.streaming import SonicStream

SR = 22050
PITCH = 237.0


def make_sinusoid(sample_rate=SR, channels=1, matching=1, seconds=1.0, amp=32000):
    """CreateSinusoidTest (sonic_test.cc:302-320)."""
    n = int(sample_rate * seconds)
    period = sample_rate / PITCH
    mono = (amp * np.sin(np.arange(n) * 2 * np.pi / period)).astype(np.int16)
    if channels == 1:
        return mono
    chans = [mono] + [mono * matching] * (channels - 1)
    return np.stack(chans, axis=1).reshape(-1)


def time_compress(x, sample_rate, channels, speed, nonlinear, feedback=None,
                  use_float=False):
    """TimeCompressVector (sonic_test.cc:364-403): write 128-sample chunks,
    read back interleaved, flush, drain."""
    st = SonicStream(sample_rate, channels)
    st.set_speed(speed)
    st.enable_nonlinear_speedup(nonlinear)
    if feedback is not None:
        st.set_duration_feedback_strength(feedback)
    tensions, feat_tensions, speeds = [], [], []
    st.on_tension = lambda s, t, v: tensions.append(v)
    st.on_features = lambda s, t, f: feat_tensions.append(f[11])
    st.on_speed = lambda s, t, v: speeds.append(v)
    out = []
    n = len(x) // channels
    for t in range(0, n, 128):
        cnt = min(128, n - t)
        if use_float:
            st.write_float(np.asarray(x[t * channels : (t + cnt) * channels], np.float32) / 32768.0)
            out.append(st.read_float(128))
        else:
            st.write_short(x[t * channels : (t + cnt) * channels])
            out.append(st.read_short(128))
    st.flush()
    while True:
        r = st.read_float(128) if use_float else st.read_short(128)
        if len(r) == 0:
            break
        out.append(r)
    return np.concatenate(out), np.array(tensions), np.array(feat_tensions), np.array(speeds)


def check_teager(inp, out, skip_tail):
    im, iv = teager_stats(np.asarray(inp, np.float32) / 32768.0)
    om, ov = teager_stats(np.asarray(out[: len(out) - skip_tail], np.float32) / 32768.0)
    assert abs(om - im) < 0.01 * im
    assert np.sqrt(iv) / im < 0.01
    assert np.sqrt(ov) / om < 0.01


def test_sinusoid_streaming_speedup():
    """TestWithSinusoids (sonic_test.cc:479-531)."""
    x = make_sinusoid()
    st_probe = SonicStream(SR, 1)
    assert st_probe.get_buffer_size() == 0  # before buffers allocated
    out, tensions, feat_tensions, _ = time_compress(x, SR, 1, 3.0, 1e-5)
    expected = len(x) / 3.0
    assert abs(len(out) - expected) < 0.015 * expected
    check_teager(x, out, 300)
    assert len(tensions) > 0
    np.testing.assert_allclose(tensions, feat_tensions, atol=0)  # same source


def test_sinusoid_streaming_slowdown():
    """TestWithSinusoidsSlowdown (sonic_test.cc:536-589), speed 0.4."""
    x = make_sinusoid()
    out, _, _, _ = time_compress(x, SR, 1, 0.4, 1e-5)
    expected = len(x) / 0.4
    assert abs(len(out) - expected) < 0.015 * expected
    check_teager(x, out, 1000)


def test_float_streaming_path():
    """TestWithFloatSinusoids (sonic_test.cc:597-637)."""
    x = make_sinusoid()
    out, _, _, _ = time_compress(x, SR, 1, 3.0, 1e-5, use_float=True)
    expected = len(x) / 3.0
    assert abs(len(out) - expected) < 0.03 * expected
    out16 = np.clip(np.round(out * 32768.0), -32768, 32767).astype(np.int16)
    check_teager(x, out16, 300)


def test_mono_stereo_equivalence():
    """sonic_test.cc:871-947: identical stereo channels give tension equal
    to mono (±1e-5 relative) and per-sample outputs within ±1."""
    samples, sr = testutil.speech_pcm(16000, 50381), 16000
    out_m, tens_m, _, _ = time_compress(samples, sr, 1, 3.0, 1.0)
    stereo = np.repeat(samples, 2)
    out_s, tens_s, _, _ = time_compress(stereo, sr, 2, 3.0, 1.0)
    assert len(tens_m) == len(tens_s)
    np.testing.assert_allclose(tens_s, tens_m, rtol=1e-5, atol=1e-7)
    out_s = out_s.reshape(-1, 2)
    assert len(out_s) == len(out_m)
    assert np.max(np.abs(out_s[:, 0].astype(np.int32) - out_m.astype(np.int32))) <= 1
    assert np.array_equal(out_s[:, 0], out_s[:, 1])


def test_stereo_teager_per_channel():
    """sonic_test.cc:759-862: each channel of a stereo sped-up sinusoid
    stays a clean sinusoid."""
    x = make_sinusoid(channels=2, matching=1)
    out, _, _, _ = time_compress(x, SR, 2, 3.0, 1e-5)
    out = out.reshape(-1, 2)
    for ch in range(2):
        check_teager(make_sinusoid(), out[: len(out) - 300, ch], 0)


def test_linear_passthrough_shortcircuit():
    """nonlinearFactor == 0 bypasses speedy entirely (soniclib.c:397-399):
    no tension callbacks fire and output is pure WSOLA."""
    x = make_sinusoid()
    out, tensions, _, _ = time_compress(x, SR, 1, 3.0, 0.0)
    assert len(tensions) == 0
    expected = len(x) / 3.0
    assert abs(len(out) - expected) < 0.015 * expected


def test_negative_speed_streaming():
    """TestNegativeSpeedInput (speedy_test.cc:1059-1076), on 1.5 s of
    24 kHz speech-like audio (negative_speed.wav's rate)."""
    samples, sr = testutil.speech_pcm(24000, 36000), 24000
    st = SonicStream(sr, 1)
    st.set_speed(0.25)
    st.enable_nonlinear_speedup(1.0)
    assert st.write_short(samples)
    st.flush()
    out = st.read_short(10 * len(samples))
    assert np.all(np.isfinite(out.astype(np.float32)))


def test_streaming_matches_batch_rate():
    """The streaming shim and the batched pipeline achieve the same rate on
    speech (they share the algorithm; alignment differs by the shim's
    one-frame AddData offset)."""
    from speedy_tpu.pipeline import nonlinear_speedup

    samples, sr = testutil.speech_pcm(16000, 50381), 16000
    out_stream, _, _, _ = time_compress(samples, sr, 1, 3.0, 1.0)
    r = nonlinear_speedup(samples, SpeedyConfig(sr), 3.0, 1.0, 0.1)
    assert abs(len(out_stream) - len(r.output)) < 0.05 * len(r.output)


def test_incremental_availability():
    """Output becomes available while writing (streaming-chunk contract of
    TimeCompressVector), not only after flush."""
    x = make_sinusoid(seconds=2.0)
    st = SonicStream(SR, 1)
    st.set_speed(2.0)
    st.enable_nonlinear_speedup(1.0)
    got_early = False
    for t in range(0, len(x), 128):
        st.write_short(x[t : t + 128])
        if t > len(x) // 2 and st.samples_available() > 0:
            got_early = True
            break
    assert got_early


def test_callbacks_fire_with_monotone_times():
    x = make_sinusoid()
    st = SonicStream(SR, 1)
    st.set_speed(2.0)
    st.enable_nonlinear_speedup(1.0)
    spec_times, norm_times, tension_times = [], [], []
    st.on_spectrogram = lambda s, t, v: spec_times.append(t)
    st.on_normalized_spectrogram = lambda s, t, v: norm_times.append(t)
    st.on_tension = lambda s, t, v: tension_times.append(t)
    st.write_short(x)
    assert spec_times == sorted(spec_times) and len(spec_times) > 0
    assert tension_times == list(range(len(tension_times)))
    assert st.spectrogram_size() == SpeedyConfig(SR).fft_size
    assert st.get_buffer_size() == SpeedyConfig(SR).frame_step_int


def test_whitebox_api_decomposition():
    """The decomposed white-box API (speedy.h:61-121) reproduces add_data /
    compute_tension exactly: same call graph as the C (preemphasis ->
    spectrogram -> save -> local energy; spectral difference -> tension)."""
    from speedy_tpu.streaming import SpeedyFrontEndStream

    rng = np.random.default_rng(7)
    a = SpeedyFrontEndStream(SR)
    b = SpeedyFrontEndStream(SR)
    w, step = a.input_frame_size(), a.input_frame_step()
    x = rng.standard_normal(w + 30 * step).astype(np.float32) * 0.3

    for t in range(24):
        frame = x[t * step : t * step + w]
        spec_a = a.add_data(frame, t)
        # Manual decomposition on the twin stream (speedy.c:540-551 order).
        buf = b.preemphasis_filter(frame)
        full = b.compute_spectrogram(buf)
        assert full.shape == (b.fft_size(),)
        np.testing.assert_array_equal(full[1 : b.cfg.half_fft], full[-1 : -b.cfg.half_fft : -1])
        b.save_spectrogram_data(full, t)
        b.compute_local_energy(t)
        b.current_time = t
        np.testing.assert_array_equal(spec_a, b.spectrogram)
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.get_spectrogram_at_time(t), b.get_spectrogram_at_time(t))
        ta, tb = a.compute_tension(t - 8), b.compute_tension(t - 8)
        assert (ta is None) == (tb is None)
        if ta is not None:
            assert ta == tb

    # Getter surface (speedy.c:340-396,525-527,737-744).
    assert a.get_current_time() == 23
    assert a.freq_to_bin(a.bin_to_freq(17)) == 17
    assert a.get_internal_state() is a.features
    assert a.get_energy_compressed() == float(a.features[3])
    assert a.get_speech_changes() == float(a.features[10])
    assert a.get_spectrogram().shape == (a.fft_size(),)
    assert a.get_normalized_spectrogram().shape == (a.cfg.half_fft,)
    energy, norm = a.normalize_by_energy(a.get_spectrogram()[: a.cfg.half_fft])
    assert energy > 0 and abs(float(np.sum(norm[1:] ** 2)) - 1.0) < 1e-3

    # add_to_hysteresis_buffer is the ring the hysteresis window reads.
    c = SpeedyFrontEndStream(SR)
    for t in range(30):
        c.add_to_hysteresis_buffer(1.0 if t == 20 else 0.0, t)
    assert c.evaluate_hysteresis(20) == pytest.approx(1.0)
