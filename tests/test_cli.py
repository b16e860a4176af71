"""CLI (speedy_wave equivalent) and rate-change tests."""

import numpy as np

import testutil
from speedy_tpu.config import SpeedyConfig
from speedy_tpu.io.wave import read_wave, write_wave

def run_cli(tmp_path, *args):
    """Run the CLI on a seeded speech wav of tapestry22050.wav's shape
    (22.05 kHz, 69431 samples)."""
    from speedy_tpu.cli import main

    inp = testutil.write_speech_wav(tmp_path / "in.wav", 22050, 69431)
    out = tmp_path / "out.wav"
    rc = main(["--input", inp, "--output", str(out), *args])
    assert rc == 0
    samples, sr = read_wave(str(out))
    return samples, sr


def test_cli_nonlinear_with_dumps(tmp_path):
    tension_f = tmp_path / "tension.txt"
    feat_f = tmp_path / "features.txt"
    samples, sr = run_cli(
        tmp_path,
        "--speed", "3.0",
        "--tension_file", str(tension_f),
        "--features_file", str(feat_f),
    )
    assert sr == 22050
    assert 20000 < len(samples) < 28000  # ~3x of 69431
    tension = np.loadtxt(tension_f)
    feats = np.loadtxt(feat_f)
    assert tension.ndim == 1 and len(tension) > 300
    assert feats.shape == (len(tension), 15)
    np.testing.assert_allclose(feats[:, 11], tension, atol=1e-5)


def test_cli_linear_exact_rate(tmp_path):
    samples, _ = run_cli(tmp_path, "--speed", "3.0", "--linear")
    expected = 69431 / 3.0
    assert abs(len(samples) - expected) < 0.015 * expected


def test_cli_length_targeting(tmp_path):
    samples, sr = run_cli(tmp_path, "--speed", "3.0", "--length", "1.5")
    assert abs(len(samples) / sr - 1.5) < 0.1  # speedy_wave.cc:428-462


def test_cli_match_nonlinear(tmp_path):
    samples, _ = run_cli(tmp_path, "--speed", "3.0", "--match_nonlinear")
    assert len(samples) > 0


def test_cli_rate_composes_with_speed(tmp_path):
    samples, _ = run_cli(tmp_path, "--speed", "2.0", "--rate", "1.5", "--linear")
    expected = 69431 / 3.0  # speed * rate
    assert abs(len(samples) - expected) < 0.03 * expected


def test_resample_op_roundtrip():
    from speedy_tpu.ops.resample import resample_linear, resample_linear_np

    x = np.sin(np.arange(4000) * 0.05).astype(np.float32)
    y, n = resample_linear(x, 2.0, len(x), 2048)
    y = np.asarray(y)[: int(n)]
    ref = resample_linear_np(x, 2.0)
    assert abs(len(y) - len(ref)) <= 1
    np.testing.assert_allclose(y, ref[: len(y)], atol=1e-5)
    # Pitch doubles: zero crossings double per unit length.
    zc = lambda a: np.sum(np.abs(np.diff(np.signbit(a))))
    assert abs(zc(y) / len(y) - 2 * zc(x) / len(x)) < 0.01


def test_cli_device_stream_engine(tmp_path):
    """--engine device-stream: the bounded-memory long-file path."""
    import numpy as np

    from speedy_tpu.cli import compress_sound
    from speedy_tpu.io import write_wave, read_wave

    sr = 16000
    t = np.arange(sr * 3) / sr
    x = (
        np.sin(2 * np.pi * (140 + 30 * np.sin(2 * np.pi * 0.6 * t)) * t)
        * np.clip(np.sin(2 * np.pi * 3 * t), 0, None)
        * 16000
    ).astype(np.int16)
    inp = str(tmp_path / "in.wav")
    outp = str(tmp_path / "out.wav")
    write_wave(inp, x, sr)
    ratio = compress_sound(inp, 3.0, 1.0, 0.1, outp, engine="device-stream")
    y, sr2 = read_wave(outp)
    assert sr2 == sr and y.dtype == np.int16
    assert 2.0 < ratio < 4.5, ratio
    assert abs(len(y) - len(x) / ratio) < 2
