"""Native C++ runtime tests: the sonic2-ABI library must match the Python
streaming shim (shared algorithm spec) and pass the same golden gates as
the device path."""

import shutil
import subprocess

import numpy as np
import pytest

import testutil

native = pytest.importorskip("speedy_tpu.native")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="no C++ toolchain"
)


@pytest.fixture(scope="module")
def lib():
    if not native.native_available():
        pytest.skip("native library failed to build")
    return native.load()


def time_compress(StreamCls, x, sr, ch, speed, nonlinear, native_cbs):
    st = StreamCls(sr, ch)
    st.set_speed(speed)
    st.enable_nonlinear_speedup(nonlinear)
    tensions = []
    if native_cbs:
        st.set_on_tension(lambda s, t, v: tensions.append(v))
    else:
        st.on_tension = lambda s, t, v: tensions.append(v)
    out = []
    n = len(x) // ch
    for t in range(0, n, 128):
        st.write_short(x[t * ch : (t + min(128, n - t)) * ch])
        out.append(st.read_short(128))
    st.flush()
    while True:
        r = st.read_short(128)
        if len(r) == 0:
            break
        out.append(r)
    return np.concatenate(out), np.asarray(tensions)


def test_native_matches_python_streaming(lib):
    from speedy_tpu.streaming import SonicStream

    samples, sr = testutil.speech_pcm(16000, 50381), 16000
    out_n, t_n = time_compress(native.NativeSonicStream, samples, sr, 1, 3.0, 1.0, True)
    out_p, t_p = time_compress(SonicStream, samples, sr, 1, 3.0, 1.0, False)
    assert len(out_n) == len(out_p)
    assert len(t_n) == len(t_p)
    np.testing.assert_allclose(t_n, t_p, atol=1e-5)
    # WSOLA pitch decisions can flip on float rounding; audio stays close.
    diff = np.abs(out_n.astype(np.int32) - out_p.astype(np.int32))
    assert np.mean(diff) < 20 and diff.max() < 1500


@pytest.mark.skipif(not testutil.have_test_data(), reason="no test data")
def test_native_golden_features(lib):
    """Drive the native speedy analysis directly (AddData/ComputeTension)
    with the golden-test framing and hold it to the reference feature
    gates (speedy_test.cc:859-1057)."""
    import ctypes

    samples, sr = testutil.load_wave("tapestry22050.wav")
    x = (samples.astype(np.float32) / 32768.0).astype(np.float32)
    lib.speedyCreateStream.restype = ctypes.c_void_p
    lib.speedyAddData.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.speedyComputeTension.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.speedyGetInternalState.restype = ctypes.POINTER(ctypes.c_float)
    lib.speedyGetInternalState.argtypes = [ctypes.c_void_p]
    st = lib.speedyCreateStream(sr)
    window = lib.speedyInputFrameSize(ctypes.c_void_p(st))
    assert window == 330
    step = sr / 100.0
    frames = int((len(x) - window) / step + 1)
    tension = ctypes.c_float()
    feats = []
    out_t = 0
    for t in range(frames):
        start = int(np.floor(t * step + 0.5))
        buf = np.ascontiguousarray(x[start : start + window])
        lib.speedyAddData(
            st, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t
        )
        if lib.speedyComputeTension(st, out_t, ctypes.byref(tension)):
            ptr = lib.speedyGetInternalState(ctypes.c_void_p(st))
            feats.append(np.ctypeslib.as_array(ptr, shape=(15,)).copy())
            out_t += 1
    feats = np.stack(feats)
    assert feats.shape == (306, 15)
    expected = testutil.load_golden("tapestry_features_data.txt")
    gates = [  # same gates as test_golden.py
        (0, 2e5), (8, 7e5), (8, 4e4), (8, 9e5), (0, 320), (0, 1e8),
        (0, 19), (0, 29), (-1, 2200), (0, 28), (0, 7), (0, 8),
    ]
    for i, (want_delay, want_snr) in enumerate(gates):
        delay, snr = testutil.best_delay_and_snr(feats[:, i], expected[:, i])
        assert delay == want_delay, f"feature {i}"
        assert snr > want_snr, f"feature {i}: {snr} <= {want_snr}"


def test_native_sinusoid_contracts(lib):
    from speedy_tpu.ops.teager import teager_stats

    sr = 22050
    i = np.arange(sr)
    x = (32000 * np.sin(i * 2 * np.pi * 237.0 / sr)).astype(np.int16)
    for speed in (3.0, 0.4):
        out, _ = time_compress(native.NativeSonicStream, x, sr, 1, speed, 1e-5, True)
        expected = len(x) / speed
        assert abs(len(out) - expected) < 0.015 * expected
        skip = 300 if speed > 1 else 1000
        im, iv = teager_stats(x.astype(np.float32) / 32768)
        om, ov = teager_stats(out[: len(out) - skip].astype(np.float32) / 32768)
        assert abs(om - im) < 0.01 * im
        assert np.sqrt(ov) / om < 0.01


def test_native_stereo_equality(lib):
    sr = 22050
    i = np.arange(sr)
    mono = (20000 * np.sin(i * 2 * np.pi * 237.0 / sr)).astype(np.int16)
    stereo = np.repeat(mono, 2)
    out_m, t_m = time_compress(native.NativeSonicStream, mono, sr, 1, 3.0, 1.0, True)
    out_s, t_s = time_compress(native.NativeSonicStream, stereo, sr, 2, 3.0, 1.0, True)
    np.testing.assert_allclose(t_s, t_m, atol=1e-6)
    out_s = out_s.reshape(-1, 2)
    assert np.array_equal(out_s[:, 0], out_s[:, 1])
    assert len(out_s) == len(out_m)
    assert np.max(np.abs(out_s[:, 0].astype(np.int32) - out_m.astype(np.int32))) <= 1


def test_native_rate(lib):
    sr = 22050
    i = np.arange(sr)
    x = (20000 * np.sin(i * 2 * np.pi * 237.0 / sr)).astype(np.int16)
    st = native.NativeSonicStream(sr, 1)
    st.set_speed(2.0)
    st.set_rate(1.5)
    st.enable_nonlinear_speedup(0.0)
    st.write_short(x)
    st.flush()
    out = st.read_short(len(x))
    expected = len(x) / 3.0
    assert abs(len(out) - expected) < 0.03 * expected


def test_native_cli_binary(lib, tmp_path):
    cli = native._CSRC / "speedy_wave"
    if not cli.exists():
        subprocess.run(["make", "-C", str(native._CSRC)], check=True,
                       capture_output=True)
    out_wav = tmp_path / "out.wav"
    r = subprocess.run(
        [str(cli), "--input",
         testutil.write_speech_wav(tmp_path / "speech.wav", 22050, 69431),
         "--output", str(out_wav), "--speed", "3.0"],
        capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr
    from speedy_tpu.io import read_wave

    out, sr = read_wave(str(out_wav))
    assert sr == 22050 and 20000 < len(out) < 28000


def test_native_wave_io_roundtrip(lib, tmp_path):
    import ctypes

    lib.openOutputWaveFile.restype = ctypes.c_void_p
    lib.openOutputWaveFile.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.openInputWaveFile.restype = ctypes.c_void_p
    lib.openInputWaveFile.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.writeToWaveFile.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int]
    lib.readFromWaveFile.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int]
    lib.closeWaveFile.argtypes = [ctypes.c_void_p]

    path = str(tmp_path / "t.wav").encode()
    data = (np.sin(np.arange(4000) * 0.1) * 10000).astype(np.int16)
    wf = lib.openOutputWaveFile(path, 16000, 1)
    lib.writeToWaveFile(wf, data.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                        len(data))
    lib.closeWaveFile(wf)
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    rf = lib.openInputWaveFile(path, ctypes.byref(sr), ctypes.byref(ch))
    assert sr.value == 16000 and ch.value == 1
    buf = np.zeros(8000, np.int16)
    n = lib.readFromWaveFile(rf, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                             8000)
    lib.closeWaveFile(rf)
    assert n == len(data)
    np.testing.assert_array_equal(buf[:n], data)


def test_native_flush_bounds(lib):
    """Regression: flush used to run the pitch search past the end of the
    input buffer (UB; caught with _GLIBCXX_ASSERTIONS). Exercise the exact
    sequence — one big write, then flush — at several lengths."""
    sr = 16000
    for n in (4000, 16000, 16384):
        x = (10000 * np.sin(np.arange(n) * 0.07)).astype(np.int16)
        st = native.NativeSonicStream(sr, 1)
        st.set_speed(3.0)
        st.enable_nonlinear_speedup(1.0)
        st.write_short(x)
        st.flush()
        out = st.read_short(2 * n)
        expected = n / 3.0
        assert abs(len(out) - expected) < 0.1 * expected + 200


def test_native_whitebox_surface(lib):
    """White-box C API parity (speedy.h:89-133): FirstOrderFilter,
    preemphasis state, hysteresis ramp, normalize-by-energy."""
    import ctypes
    import math

    # FirstOrderFilter: impulse decays to e^-1 in tau steps.
    lib.CreateFirstOrderFilter.restype = ctypes.c_void_p
    lib.CreateFirstOrderFilter.argtypes = [ctypes.c_float]
    lib.IterateFirstOrderFilter.restype = ctypes.c_float
    lib.IterateFirstOrderFilter.argtypes = [ctypes.c_void_p, ctypes.c_float]
    lib.ResetFirstOrderFilter.argtypes = [ctypes.c_void_p]
    lib.DeleteFirstOrderFilter.argtypes = [ctypes.c_void_p]
    lib.speedyDestroyStream.argtypes = [ctypes.c_void_p]
    f = ctypes.c_void_p(lib.CreateFirstOrderFilter(10.0))
    first = lib.IterateFirstOrderFilter(f, 1.0)
    out = 0.0
    for _ in range(10):
        out = lib.IterateFirstOrderFilter(f, 0.0)
    assert abs(out - first * math.exp(-1)) < 1e-7
    lib.ResetFirstOrderFilter(f)
    assert abs(lib.IterateFirstOrderFilter(f, 0.0)) < 1e-7
    lib.DeleteFirstOrderFilter(f)

    lib.speedyCreateStream.restype = ctypes.c_void_p
    st = ctypes.c_void_p(lib.speedyCreateStream(22050))

    # Preemphasis impulse + cross-call state (speedy_test.cc:259-284).
    lib.speedyPreemphasisFilter.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    x = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    lib.speedyPreemphasisFilter(st, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 4)
    np.testing.assert_allclose(x, [1.0, -0.97, 0.0, 0.0], atol=1e-7)

    # Hysteresis impulse ramps (speedy_test.cc:288-313, MATCH_MATLAB arm).
    lib.speedyAddToHysteresisBuffer.argtypes = [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int64]
    lib.speedyEvaluateHysteresis.restype = ctypes.c_float
    lib.speedyEvaluateHysteresis.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    correct = ([0] * 9 + [i / 16.0 for i in range(1, 8)] + [1.0]
               + [i / 24.0 for i in range(11, 0, -1)] + [0, 0, 0, 0])
    for i in range(32):
        lib.speedyAddToHysteresisBuffer(st, 1.0 if i == 16 else 0.0, i)
    for i in range(32):
        assert abs(lib.speedyEvaluateHysteresis(st, i) - correct[i]) < 1e-7, i

    # NormalizeByEnergy (speedy_test.cc:317-328).
    lib.speedyNormalizeByEnergy.restype = ctypes.c_float
    lib.speedyNormalizeByEnergy.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    inp = np.array([0, 0, 1, 0, 1], np.float32)
    outp = np.zeros(5, np.float32)
    e = lib.speedyNormalizeByEnergy(
        inp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        outp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 5)
    assert abs(e - 2.0) < 1e-7
    np.testing.assert_allclose(outp, [0, 0, 0.7071068, 0, 0.7071068], atol=1e-6)
    lib.speedyDestroyStream(st)


def test_native_callback_getters(lib):
    """The five getSonic*Callback getters (sonic2.h:106-124): NULL before
    registration, pointer-identical to the registered callback after, and
    NULL again after clearing."""
    import ctypes

    from speedy_tpu.native import (
        _FEATURES_CB,
        _SPECTROGRAM_CB,
        _SPEED_CB,
        _TENSION_CB,
    )

    st = lib.sonicCreateStream(16000, 1)
    pairs = [
        (lib.sonicTensionCallback, lib.getSonicTensionCallback, _TENSION_CB),
        (lib.sonicSpeedCallback, lib.getSonicSpeedCallback, _SPEED_CB),
        (lib.sonicFeaturesCallback, lib.getSonicFeaturesCallback, _FEATURES_CB),
        (
            lib.sonicSpectrogramCallback,
            lib.getSonicSpectrogramCallback,
            _SPECTROGRAM_CB,
        ),
        (
            lib.sonicNormalizedSpectrogramCallback,
            lib.getSonicNormalizedSpectrogramCallback,
            _SPECTROGRAM_CB,
        ),
    ]
    cbs = []
    for setter, getter, cbty in pairs:
        assert getter(st) is None
        cb = cbty(lambda *a: None)
        cbs.append(cb)  # keep alive
        setter(st, cb)
        got = getter(st)
        want = ctypes.cast(cb, ctypes.c_void_p).value
        assert got == want, (getter.__name__, got, want)
    for setter, getter, cbty in pairs:
        setter(st, cbty(0))
        assert getter(st) is None
    lib.sonicDestroyStream(st)


def test_native_cli_dump_and_length_parity(lib, tmp_path):
    """The native binary's --length two-pass targeting and the three
    remaining dump flags (--spectrogram_file, --normalized_spectrogram_file,
    plus --tension_file as the anchor) must match the Python CLI's output
    on the same input (round-3 verdict item 6; speedy_wave.cc:269,273,275,
    428-462)."""
    cli = native._CSRC / "speedy_wave"
    if not cli.exists():
        subprocess.run(["make", "-C", str(native._CSRC)], check=True,
                       capture_output=True)
    wav = testutil.write_speech_wav(tmp_path / "speech.wav", 16000, 50381)

    def args_for(d):
        return [
            "--input", wav, "--output", str(d / "out.wav"),
            "--speed", "3.0", "--length", "1.5",
            "--tension_file", str(d / "tension.txt"),
            "--spectrogram_file", str(d / "spec.txt"),
            "--normalized_spectrogram_file", str(d / "nspec.txt"),
        ]

    nat = tmp_path / "native"
    nat.mkdir()
    r = subprocess.run([str(cli)] + args_for(nat), capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr

    from speedy_tpu import cli as py_cli

    py = tmp_path / "python"
    py.mkdir()
    assert py_cli.main(args_for(py)) == 0

    from speedy_tpu.io import read_wave

    out_n, sr = read_wave(str(nat / "out.wav"))
    out_p, _ = read_wave(str(py / "out.wav"))
    # Both runs hit the 1.5 s target (speedy_wave.cc:428-462) and agree
    # with each other closely (engines share the algorithm, not the fp
    # accumulation order).
    assert abs(len(out_n) / sr - 1.5) < 0.1, len(out_n) / sr
    assert abs(len(out_n) - len(out_p)) < 0.02 * len(out_p)

    for name, rtol in (("tension.txt", 0.0), ("spec.txt", 1e-3),
                       ("nspec.txt", 1e-3)):
        a = np.loadtxt(nat / name)
        b = np.loadtxt(py / name)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if name == "tension.txt":
            # Same final speed => same frame count; values agree to the
            # %g dump precision + engine fp noise.
            np.testing.assert_allclose(a, b, atol=2e-4)
        else:
            # Magnitude spectra: compare where values are significant
            # (tiny bins are relative-noise dominated by design).
            scale = np.abs(b).max()
            np.testing.assert_allclose(a, b, atol=rtol * scale)
