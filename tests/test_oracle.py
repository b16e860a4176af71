"""The vendored exact-DFT C oracle must build, run, and reproduce the
pinned feature table + the feature-8 gate evidence (VERDICT r1 item 6;
tools/oracle/). This compiles the READ-ONLY reference speedy.c against
the in-tree double-DFT shim — the mechanical re-derivation of why
tests/test_golden.py gates feature 8 at 2200 instead of the shipped
2300."""

import pathlib
import shutil
import subprocess
import sys

import pytest

import testutil

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = REPO / "tools" / "oracle" / "run_oracle.py"


@pytest.mark.skipif(
    not testutil.have_test_data(), reason="reference test_data not available"
)
@pytest.mark.skipif(shutil.which("gcc") is None, reason="no gcc")
@pytest.mark.skipif(
    not pathlib.Path("/root/reference/speedy.c").exists(),
    reason="reference source not available",
)
def test_oracle_reproduces_pinned_table():
    out = subprocess.run(
        [sys.executable, str(SCRIPT)],
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ORACLE-OK" in out.stdout, out.stdout
    assert "feature8_snr=2291.9" in out.stdout, out.stdout


@pytest.mark.skipif(
    not testutil.have_test_data(), reason="reference test_data not available"
)
@pytest.mark.skipif(shutil.which("gcc") is None, reason="no gcc")
@pytest.mark.skipif(
    not pathlib.Path("/root/reference/speedy.c").exists(),
    reason="reference source not available",
)
def test_batched_analysis_matches_oracle_16k(tmp_path):
    """Golden-level gate for the production front end at 16 kHz (the
    Matlab golden dumps are 22.05 kHz only). Build the exact-DFT oracle
    (MATCH_MATLAB), run it on the 16 kHz tapestry.wav, and hold the
    batched_analysis tension to it at HIGH and HIGHEST precision."""
    import numpy as np
    import jax.numpy as jnp

    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.parallel.batch import batched_analysis

    oracle_dir = REPO / "tools" / "oracle"
    exe = tmp_path / "oracle16"
    subprocess.run(
        [
            "gcc", "-O2", "-DMATCH_MATLAB", "-DKISS_FFT",
            "-I", str(oracle_dir), "-I", "/root/reference",
            str(oracle_dir / "driver.c"), "/root/reference/speedy.c",
            "-o", str(exe), "-lm",
        ],
        check=True, capture_output=True,
    )
    samples, sr = testutil.load_wave("tapestry.wav")
    assert sr == 16000
    x = (samples.astype(np.float32) / 32768.0).astype(np.float32)
    raw = tmp_path / "tap16.f32"
    x.tofile(raw)
    feat_p = tmp_path / "feat.txt"
    subprocess.run(
        [str(exe), str(raw), str(sr), str(feat_p), str(tmp_path / "spec.txt")],
        check=True, capture_output=True,
    )
    t_oracle = np.loadtxt(feat_p)[:, -1]

    cfg = SpeedyConfig(sr)
    T = cfg.num_frames(len(x), integer_step=True)

    # Full float32 analysis is oracle-exact (max 8e-7 over tapestry's 306
    # frames). Gate: tight max and mean, no frame above 1e-4, and any
    # outlier attributed to the mask-edge class in float64.
    t_ours = np.asarray(batched_analysis(jnp.asarray(x[None]), cfg, T))[0]
    assert t_ours.shape == t_oracle.shape, (t_ours.shape, t_oracle.shape)
    d = np.abs(t_ours - t_oracle)
    n_big = int((d > 1e-4).sum())
    assert d.max() < 5e-6 and d.mean() < 5e-7 and n_big == 0, (
        d.max(), d.mean(), n_big,
    )
    testutil.assert_tension_outliers_are_mask_edges(x, cfg, T, d)
