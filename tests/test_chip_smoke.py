"""chip_smoke.py's phases at tiny sizes on the CPU (the full sizes run on
the card), and its refusal to run without a GPU."""

import jax
import pytest

import chip_smoke

SMALL_STREAM = dict(chunk_frames=64, segment_frames=128)


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "no GPU" in out.err


def test_phase_batch_tiny():
    res = chip_smoke.phase_batch(22050, 4, 1.5, devices=jax.devices()[:1])
    assert res["teager"]
    assert res["valid_max"] < res["cap"]
    assert res["periods"]["cells"] > 0


def test_phase_corpus_tiny():
    res = chip_smoke.phase_corpus(
        16000, [0.2, 0.5, 0.9, 2.6, 0.4], batch_size=2,
        long_samples=1 << 15, stream_kw=SMALL_STREAM, use_mesh=False,
    )
    assert len(res) == 4  # three buckets + the long utterance


def test_phase_serve_tiny():
    res = chip_smoke.phase_serve(16000, 3, 1.0, 2, stream_kw=SMALL_STREAM)
    assert res["identical"] == 3  # bitwise on the CPU backend


def test_phase_four_on_virtual_devices():
    res = chip_smoke.phase_four(n_utt=8, batch_size=8, seq_seconds=3.0)
    assert abs(res["seqpar"]["valid"] - res["seqpar"]["valid_ref"]) <= 2


def test_pitch_reference_f64_is_exact_on_a_pure_tone():
    import numpy as np

    sr, period = 16000, 150.0  # no multiple within the lag range
    x = np.sin(2 * np.pi * np.arange(sr) / period)[None]
    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.ops.wsola_fast import pitch_grid_stride

    cfg = SpeedyConfig(sr)
    per, segs = chip_smoke.pitch_reference_f64(
        x, pitch_grid_stride(cfg), cfg.wsola_min_period, cfg.wsola_max_period
    )
    n_full = (sr - 2 * cfg.wsola_max_period) // pitch_grid_stride(cfg)
    np.testing.assert_allclose(per[0, :n_full], period, atol=0.01)
    assert segs.shape[-1] == 2 * cfg.wsola_max_period


def _speech_slots(sr=16000, hop=160, n_slots=12):
    """Speech-like reference audio and its loudest 10 ms slots."""
    import numpy as np

    from bench_signals import speechlike

    ref = speechlike(sr, sr * 4).astype(np.float64)
    energy = (ref[: len(ref) // hop * hop].reshape(-1, hop) ** 2).sum(axis=1)
    return ref, np.argsort(energy)[::-1][:n_slots]


def test_diff_gate_passes_drift_and_fails_a_glitch():
    """The engine-pair gate accepts a sub-sample time drift and an
    isolated slot read one sample off, and rejects a dropped 100 ms window
    or a wrong length."""
    import numpy as np

    sr, hop = 16000, 160
    t = np.arange(sr * 4) / sr
    env = np.clip(np.sin(2 * np.pi * 2.0 * t), 0.2, None)
    ref = 0.3 * np.sin(2 * np.pi * 180.0 * t) * env
    drift = 0.3 * np.sin(2 * np.pi * 180.0 * (t + 0.02 / sr * t / t[-1])) * env
    assert chip_smoke._diff_gate("same", ref, ref, hop)["identical"]
    assert chip_smoke._diff_gate("drift", drift, ref, hop)["max"] > 0
    speech, slots = _speech_slots(sr, hop)
    for k in slots:
        off = speech.copy()  # one slot read one sample late
        off[k * hop : (k + 1) * hop] = speech[k * hop + 1 : (k + 1) * hop + 1]
        chip_smoke._diff_gate("one-sample slot", off, speech, hop)
    glitch = ref.copy()
    glitch[16000:17600] = 0.0
    with pytest.raises(AssertionError):
        chip_smoke._diff_gate("glitch", glitch, ref, hop)
    with pytest.raises(AssertionError):
        chip_smoke._diff_gate("length", ref[:-10], ref, hop)


@pytest.mark.parametrize("fault", ["zeroed_slot", "half_period_splice"])
def test_diff_gate_window_bound_catches_one_slot_faults(fault):
    """WIN_SNR_DB sits above the window SNR of a single faulty 10 ms slot
    in the loudest windows of speech-like audio: a zeroed slot reads
    6.1-7.1 dB, a slot spliced half a pitch period off 1.8-3.4 dB."""
    import numpy as np

    sr, hop = 16000, 160
    speech, slots = _speech_slots(sr, hop)
    half = int(round(sr / 110)) // 2  # half the family's base period
    worst = []
    for k in slots:
        bad = speech.copy()
        sl = slice(k * hop, (k + 1) * hop)
        if fault == "zeroed_slot":
            bad[sl] = 0.0
        else:
            bad[sl] = speech[k * hop + half : (k + 1) * hop + half]
        with pytest.raises(AssertionError):
            chip_smoke._diff_gate(fault, bad, speech, hop)
        worst.append(chip_smoke._diff_stats(bad, speech, hop)["worst_window_snr_db"])
    assert max(worst) < chip_smoke.WIN_SNR_DB - 6.0, worst


def test_equal_gate():
    import numpy as np

    a = np.linspace(-0.5, 0.5, 4000)
    res = chip_smoke._equal_gate("same", [(a, a), (a, a.copy())])
    assert res["identical"] == 2 and res["max"] == 0.0
    b = a.copy()
    b[7] += 1e-3  # one sample off: max passes, mean 1e-3 / 8000 passes
    assert chip_smoke._equal_gate("one", [(a, a), (b, a)])["identical"] == 1
    with pytest.raises(AssertionError):
        chip_smoke._equal_gate("max", [(a + np.where(a > 0.49, 3e-3, 0.0), a)])
    with pytest.raises(AssertionError):
        chip_smoke._equal_gate("mean", [(a + 2e-5, a)])
    with pytest.raises(AssertionError):
        chip_smoke._equal_gate("length", [(a[:-1], a)])
