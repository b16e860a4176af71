"""Probe: quantify scan-engine vs grid-engine output agreement to set
the cross-engine fidelity gate bounds (round-4 verdict item 3).

The scan engine (ops/wsola.py) is the sonic-exact-algebra fidelity
anchor (libsonic itself is external and unbuildable here); the grid
engine (ops/wsola_fast.py) is the production path.
They share per-step speed-quanta algebra but differ in pitch search
(AMDF argmin at the cursor vs SSD over a regular grid) and synthesis
scheduling, so outputs are NOT bitwise-comparable — the right gate is a
DTW-aligned spectral distance between the two outputs plus a
length-agreement bound (the reference's own cross-output harness shape:
sonic_test.cc:641-724).

Reports per (signal, rate):
  len_rel   |len_scan - len_grid| / len_scan
  slope     DTW path slope (expect ~1.0: same nominal rate)
  cost_pf   DTW cost / path length / mean frame L2 (normalized)
  dist_mean mean over path points of ||a-b|| / max(||a||,||b||,eps)
  dist_p95  95th percentile of the same

Run hermetically: python experiments/cross_engine_probe.py  (forces CPU)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from speedy_tpu.config import SpeedyConfig
from speedy_tpu.ops import dft
from speedy_tpu.ops.dtw import (
    accumulate,
    best_path,
    directions,
    euclidean_cost_matrix,
)
from speedy_tpu.pipeline import nonlinear_speedup

SR = 16000


def families(secs=4.0):
    t = np.arange(int(SR * secs)) / SR
    rng = np.random.default_rng(0)

    def speechlike(f0_base, f0_mod, f0_rate, syll_hz, n_harm):
        f0 = f0_base + f0_mod * np.sin(2 * np.pi * f0_rate * t)
        phase = np.cumsum(2 * np.pi * f0 / SR)
        voiced = sum(np.sin(k * phase) / k for k in range(1, n_harm + 1))
        envelope = np.clip(np.sin(2 * np.pi * syll_hz * t), 0, None)
        return (voiced * envelope * 0.2).astype(np.float32)

    fam0 = speechlike(110.0, 30.0, 0.7, 2.5, 5)
    fam1 = speechlike(210.0, 45.0, 1.3, 4.0, 7)
    bursts = (np.sin(2 * np.pi * 3.1 * t) > 0.3).astype(np.float32)
    fam2 = (rng.standard_normal(t.size) * 0.12 * bursts).astype(np.float32)
    chirp_f0 = 90.0 + 160.0 * (0.5 + 0.5 * np.sin(2 * np.pi * 0.11 * t))
    phase_c = np.cumsum(2 * np.pi * chirp_f0 / SR)
    fam3 = (
        (np.sin(phase_c) + 0.5 * np.sin(2 * phase_c))
        * np.clip(np.sin(2 * np.pi * 1.8 * t + 0.7), 0, None)
        * 0.2
    ).astype(np.float32)
    out = {"male": fam0, "female": fam1, "noise": fam2, "chirp": fam3}
    tap_path = "/root/reference/test_data/tapestry.wav"
    if os.path.exists(tap_path):
        from speedy_tpu.io import read_wave

        tap, tap_sr = read_wave(tap_path)
        assert tap_sr == SR
        out["tapestry"] = tap.astype(np.float32) / 32768.0
    return out


def block_spec(x, cfg):
    w = cfg.window_size
    n = (len(x) - 1) // w
    frames = np.asarray(x[: n * w], np.float32).reshape(n, w)
    return np.asarray(dft.magnitude_spectrogram(jnp.asarray(frames), cfg))[:, :w]


def compare(x, rate, cfg):
    rs = nonlinear_speedup(x, cfg, rate, 1.0, 0.1, engine="scan")
    rg = nonlinear_speedup(x, cfg, rate, 1.0, 0.1, engine="grid")
    ys = np.asarray(rs.output)
    yg = np.asarray(rg.output)
    len_rel = abs(len(ys) - len(yg)) / max(len(ys), 1)
    a = block_spec(ys, cfg)
    b = block_spec(yg, cfg)
    cost = euclidean_cost_matrix(jnp.asarray(a), jnp.asarray(b))
    total, acc = accumulate(cost)
    p1, p2 = best_path(np.asarray(directions(cost, acc)))
    p1 = np.asarray(p1)
    p2 = np.asarray(p2)
    n = len(p1)
    slope = (n * np.sum(p1 * p2) - p1.sum() * p2.sum()) / (
        n * np.sum(p1 * p1) - p1.sum() ** 2
    )
    norms_a = np.linalg.norm(a, axis=1)
    norms_b = np.linalg.norm(b, axis=1)
    cost_pf = float(total) / n / max(np.mean(norms_a), 1e-9)
    d = np.linalg.norm(a[p1] - b[p2], axis=1) / np.maximum(
        np.maximum(norms_a[p1], norms_b[p2]), 1e-9
    )
    # Energy mask: relative distance is meaningless on near-silent frames
    # (syllable gaps); gate on frames carrying real signal on either side.
    loud = np.maximum(norms_a[p1], norms_b[p2]) >= 0.2 * np.mean(norms_a)
    dl = d[loud]
    return dict(
        len_rel=len_rel,
        slope=float(slope),
        cost_pf=cost_pf,
        dist_mean=float(d.mean()),
        dist_p95=float(np.percentile(d, 95)),
        loud_mean=float(dl.mean()),
        loud_p95=float(np.percentile(dl, 95)),
        n_loud=int(loud.sum()),
        n_path=n,
    )


def spec_metrics(ys, yg, cfg):
    """DTW-aligned spectral metrics between two waveforms at the same
    nominal rate (shared by compare() and the negative control)."""
    a = block_spec(ys, cfg)
    b = block_spec(yg, cfg)
    cost = euclidean_cost_matrix(jnp.asarray(a), jnp.asarray(b))
    total, acc = accumulate(cost)
    p1, p2 = best_path(np.asarray(directions(cost, acc)))
    p1, p2 = np.asarray(p1), np.asarray(p2)
    n = len(p1)
    norms_a = np.linalg.norm(a, axis=1)
    norms_b = np.linalg.norm(b, axis=1)
    d = np.linalg.norm(a[p1] - b[p2], axis=1) / np.maximum(
        np.maximum(norms_a[p1], norms_b[p2]), 1e-9
    )
    loud = np.maximum(norms_a[p1], norms_b[p2]) >= 0.2 * np.mean(norms_a)
    return d[loud]


def main():
    cfg = SpeedyConfig(SR)
    for name, x in families().items():
        for rate in (2.0, 3.5):
            r = compare(x, rate, cfg)
            print(
                f"{name:9s} rate {rate}: len_rel {r['len_rel']:.4f}  "
                f"slope {r['slope']:.3f}  cost/frame {r['cost_pf']:.3f}  "
                f"dist mean {r['dist_mean']:.3f} p95 {r['dist_p95']:.3f}  "
                f"loud mean {r['loud_mean']:.3f} p95 {r['loud_p95']:.3f} "
                f"({r['n_loud']}/{r['n_path']})",
                flush=True,
            )
    # Negative control: a gate must REJECT a genuinely-degraded
    # resynthesis. Naive linear-interp resampling at the same rate
    # pitch-shifts the audio up by `rate` — the aligned spectral distance
    # to the scan engine must sit far above the scan-vs-grid band.
    print("--- negative control: naive resample vs scan engine ---")
    for name, x in families().items():
        for rate in (2.0, 3.5):
            rs = nonlinear_speedup(x, cfg, rate, 1.0, 0.1, engine="scan")
            ys = np.asarray(rs.output)
            n_out = len(ys)
            bad = np.interp(
                np.linspace(0, len(x) - 1, n_out), np.arange(len(x)), x
            ).astype(np.float32)
            dl = spec_metrics(ys, bad, cfg)
            print(
                f"{name:9s} rate {rate}: loud mean {dl.mean():.3f} "
                f"p95 {np.percentile(dl, 95):.3f}",
                flush=True,
            )


if __name__ == "__main__":
    main()
