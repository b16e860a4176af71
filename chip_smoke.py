"""Smoke run of the production paths on one NVIDIA GPU.

    python chip_smoke.py          # phases batch, corpus, serve, gpu-tests
    python chip_smoke.py --four   # only the four-GPU phase (needs 4 GPUs)

Every phase runs the system through the entry points a user calls, at
real widths, on random-but-seeded audio, and compares what comes out with
the repository's plain references; any failed comparison raises. Earlier
lines print results, compile times, memory figures and the card's name
and power limit; the last line is one JSON object naming the device.
The script refuses to run (exit code 2, no result) when JAX finds no GPU:
it never falls back to the CPU. One process touches the card.

The phase functions take their sizes as arguments, so the CPU test suite
runs them at tiny sizes (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
RATE = 3.5  # the upstream comprehension study's operating point
CAP_FACTOR = 1.33
# Equal-output gate for two runs of one program over different device
# layouts (dp mesh vs one device): equal valid lengths, max |d| and mean
# |d| over every sample below these.
EQ_MAX, EQ_MEAN = 2e-3, 1e-5
# Engine-pair gate for runs whose programs differ (batch size, stream
# lanes, sequence shards): valid lengths within 2 samples, the difference
# at least OUT_SNR_DB below the signal over the whole output and at least
# WIN_SNR_DB below it in every loud 100 ms window. On a GPU such runs
# round differently, and the closed-form phase snap reads chunk k at
# pr + k*Hs - m*P with m in the thousands after a minute: a 1-ulp period
# difference moves reads by m*dP (up to 0.15 samples), and a time map
# drifted by a fraction of a sample can move m across a half period
# (PERF.md, tools/divergence_witness.py). WIN_SNR_DB sits between the
# worst window of such pairs on the card (22.0 dB) and the planted faults
# of tests/test_chip_smoke.py (one zeroed 10 ms slot: at most 7.1 dB;
# one slot spliced half a period off: at most 3.4 dB).
OUT_SNR_DB, WIN_SNR_DB = 30.0, 14.0
# Tension vs the sample-serial NumPy front end: the CPU suite's gate
# (tests/test_xla_stages.py): mean |d| per row, and every frame off by
# more than 1e-4 must be a 40 dB mask-edge frame.
TENSION_MEAN = 1e-5
# Grid vs scan output length on the same speeds: the cross-engine bound
# of tests/test_cross_engine.py. The +-1.5% single-engine length contract
# is not met between engines on 10 s speech (2.0%, CPU and GPU alike).
GRID_SCAN_LEN_REL = 0.04


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out


def peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def compile_timed(name: str, fn, *args):
    """jit + lower + compile with the compile time and the compiled
    program's memory_analysis() printed."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    dt = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    mem = {
        k: int(getattr(ma, k))
        for k in (
            "argument_size_in_bytes",
            "output_size_in_bytes",
            "temp_size_in_bytes",
            "generated_code_size_in_bytes",
        )
        if ma is not None and hasattr(ma, k)
    }
    log(f"[{name}] compile {dt:.2f} s; memory_analysis {json.dumps(mem)}")
    return compiled


def _diff_stats(got: np.ndarray, ref: np.ndarray, hop: int) -> dict:
    """SNR of the difference over the common prefix and over its worst
    loud 100 ms window, max |d|, and the hop-sized slots where
    |d| >= 2e-3."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    n = min(len(got), len(ref))
    g, r = got[:n], ref[:n]

    def snr_db(sig, err):
        e = float(np.sum(err * err))
        return float("inf") if e == 0.0 else 10.0 * np.log10(float(np.sum(sig * sig)) / e)

    win = 10 * hop
    nw = n // win
    rw = r[: nw * win].reshape(nw, win)
    dw = (g - r)[: nw * win].reshape(nw, win)
    p = np.sum(rw * rw, axis=1)
    loud = p > 0.01 * p.mean() if nw else np.zeros(0, bool)
    worst = min(
        (snr_db(a, b) for a, b in zip(rw[loud], dw[loud])), default=float("inf")
    )
    d = np.abs(g - r)
    return {
        "snr_db": snr_db(r, g - r),
        "worst_window_snr_db": worst,
        "max": float(d.max()) if n else 0.0,
        "slots_over_2e-3": int(np.unique(np.flatnonzero(d >= 2e-3) // hop).size),
        "slots": -(-n // hop),
        "identical": bool(len(got) == len(ref) and n and d.max() == 0.0),
    }


def _diff_gate(tag: str, got: np.ndarray, ref: np.ndarray, hop: int) -> dict:
    """The engine-pair gate: lengths within 2 samples, OUT_SNR_DB overall
    and WIN_SNR_DB in every loud 100 ms window (_diff_stats)."""
    if abs(len(got) - len(ref)) > 2:
        raise AssertionError(f"{tag}: length {len(got)} vs {len(ref)}")
    res = _diff_stats(got, ref, hop)
    if res["snr_db"] < OUT_SNR_DB or res["worst_window_snr_db"] < WIN_SNR_DB:
        raise AssertionError(f"{tag}: {res}")
    return res


def _equal_gate(tag: str, pairs) -> dict:
    """The EQ_MAX / EQ_MEAN gate over (got, ref) output pairs of equal
    length; reports max and mean |d| over all samples and the count of
    bit-identical pairs."""
    tot, n, mx, same = 0.0, 0, 0.0, 0
    for j, (got, ref) in enumerate(pairs):
        if len(got) != len(ref):
            raise AssertionError(f"{tag} {j}: length {len(got)} vs {len(ref)}")
        d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
        tot, n = tot + float(d.sum()), n + d.size
        mx = max(mx, float(d.max()) if d.size else 0.0)
        same += int(not d.any())
    res = {"max": mx, "mean": tot / max(n, 1), "identical": same, "pairs": len(pairs)}
    if res["max"] >= EQ_MAX or res["mean"] >= EQ_MEAN:
        raise AssertionError(f"{tag}: {res}")
    return res


def _pcm_to_float(y: np.ndarray) -> np.ndarray:
    y = np.asarray(y)
    return y.astype(np.float32) / 32768.0 if y.dtype == np.int16 else y


# ---------------------------------------------------------------- checks


def check_tension(cfg, xs: np.ndarray, tension: np.ndarray) -> dict:
    """Production tension rows vs the sample-serial NumPy front end
    (streaming.SpeedyFrontEndStream, float64) under TENSION_MEAN and the
    mask-edge attribution of every frame off by more than 1e-4."""
    import testutil

    T = cfg.num_frames(xs.shape[1], integer_step=True)
    res = {"max": 0.0, "mean_worst_row": 0.0, "frames_over_1e-4": 0}
    for b in range(xs.shape[0]):
        ref = testutil.stream_tension(xs[b], cfg.sample_rate)
        got = np.asarray(tension[b], np.float64)
        if got.shape != ref.shape:
            raise AssertionError(f"tension row {b}: {got.shape} vs {ref.shape}")
        d = np.abs(got - ref)
        res["max"] = max(res["max"], float(d.max()))
        res["mean_worst_row"] = max(res["mean_worst_row"], float(d.mean()))
        res["frames_over_1e-4"] += int((d > 1e-4).sum())
        if d.mean() >= TENSION_MEAN:
            raise AssertionError(f"tension row {b} vs NumPy front end: {res}")
        testutil.assert_tension_outliers_are_mask_edges(xs[b], cfg, T, d)
    return res


def pitch_reference_f64(xs: np.ndarray, G: int, minp: int, maxp: int):
    """Brute-force float64 SSD periods on the engine's grid (same cells,
    template and parabolic refinement as wsola_fast.pitch_period_grid).
    Returns (periods [B, n_grid], windows [B, n_grid, 2*maxp])."""
    B, L = xs.shape
    taps, seg_w = maxp, 2 * maxp
    n_grid = -(-(L + seg_w) // G)
    xp = np.zeros((B, n_grid * G), np.float64)
    xp[:, :L] = xs
    segs = xp.reshape(B, n_grid, G)[:, :, :seg_w]
    a0 = segs[..., :taps]
    ssd = np.stack(
        [np.sum((a0 - segs[..., d : d + taps]) ** 2, axis=-1)
         for d in range(minp, maxp + 1)],
        axis=-1,
    )
    jc = np.clip(np.argmin(ssd, axis=-1), 1, ssd.shape[-1] - 2)
    take = lambda off: np.take_along_axis(ssd, (jc + off)[..., None], -1)[..., 0]
    l, m, r = take(-1), take(0), take(1)
    den = l - 2.0 * m + r
    safe = np.where(np.abs(den) > 1e-12, den, 1.0)
    frac = np.where(np.abs(den) > 1e-12, 0.5 * (l - r) / safe, 0.0)
    return minp + jc + np.clip(frac, -0.5, 0.5), segs


def check_periods(cfg, xs: np.ndarray) -> dict:
    """Device pitch grid vs the float64 brute force: every integer flip
    must be a float64 SSD tie (tests/testutil.py)."""
    import jax
    import testutil

    from speedy_tpu.ops import wsola_fast

    minp, maxp = cfg.wsola_min_period, cfg.wsola_max_period
    G = wsola_fast.pitch_grid_stride(cfg)
    per = np.asarray(
        jax.jit(lambda x: wsola_fast.pitch_period_grid(x, G, minp, maxp))(xs)
    )
    ref, segs = pitch_reference_f64(np.asarray(xs, np.float64), G, minp, maxp)
    testutil.assert_period_flips_are_ties(segs, per, ref, maxp, minp, maxp)
    d = np.abs(per - ref)
    return {"cells": int(d.size), "flips": int((d > 0.5).sum()),
            "median_abs_diff": float(np.median(d))}


def run_scan(cfg, xs, lengths, speeds):
    """The sonic-exact scan engine (ops/wsola.py) on the same per-frame
    speeds as the grid engine: (output [B, cap], valid [B])."""
    import jax

    from speedy_tpu.ops import wsola

    minp, maxp, cap, steps = wsola.plan(cfg, xs.shape[1], 1.0)
    step = cfg.frame_step_int
    r = jax.jit(jax.vmap(
        lambda x, s, l: wsola._wsola_scan(x, l, s, minp, maxp, step, cap, steps)
    ))(xs, speeds, lengths)
    return np.asarray(r.output), np.asarray(r.valid_length)


def check_teager(x: np.ndarray, y: np.ndarray, skip_tail: int = 300) -> None:
    """The resynthesis glitch contract on a sinusoid (sonic_test.cc:
    142-197): output Teager mean within 1% of the input's, rel sigma <1%."""
    from speedy_tpu.ops.teager import teager_stats

    im, iv = teager_stats(x)
    om, ov = teager_stats(y[: len(y) - skip_tail])
    if not (abs(om - im) < 0.01 * im and np.sqrt(ov) / om < 0.01):
        raise AssertionError(
            f"Teager: mean {om:.5g} vs {im:.5g}, rel sigma {np.sqrt(ov) / om:.4f}"
        )


# ---------------------------------------------------------------- phases


def phase_batch(sample_rate: int, batch: int, seconds: float, n_check: int = 4,
                devices=None, cap_factor=CAP_FACTOR) -> dict:
    """Jitted batched_nonlinear_speedup at RATE on a 1-device mesh, on the
    benchmark's interleaved 4-family mix; then the reference checks on
    n_check rows (one per family) and, at 22.05 kHz, the reference's
    sinusoid contract for both engines. cap_factor=None plans the
    worst-case output capacity (no truncation is possible)."""
    import jax
    import jax.numpy as jnp

    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.parallel.batch import (
        batched_nonlinear_speedup,
        grid_output_capacity,
    )
    from speedy_tpu.parallel.mesh import make_mesh
    from bench_signals import bench_families

    tag = f"batch {sample_rate} Hz B={batch} {seconds:g} s"
    cfg = SpeedyConfig(sample_rate)
    L = int(sample_rate * seconds)
    devices = devices or jax.devices()[:1]
    mesh = make_mesh(dp=len(devices), tp=1, devices=devices)
    fams = bench_families(sample_rate, L)
    rng = np.random.default_rng(1)
    xs = fams[np.arange(batch) % 4] * rng.uniform(0.5, 1.0, (batch, 1))
    xs = xs.astype(np.float32)
    lengths = np.full((batch,), L, np.int32)
    cap = grid_output_capacity(cfg, L, RATE, cap_factor)

    def step(x, l):
        return batched_nonlinear_speedup(
            x, l, cfg, RATE, 1.0, 0.1, mesh=mesh, capacity_factor=cap_factor
        )

    xs_d, len_d = jnp.asarray(xs), jnp.asarray(lengths)
    compiled = compile_timed(tag, step, xs_d, len_d)
    jax.block_until_ready(compiled(xs_d, len_d))  # first run
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(xs_d, len_d))
    run_s = time.perf_counter() - t0
    y = np.asarray(out.output)
    valid = np.asarray(out.valid_length)
    if not np.isfinite(y).all():
        raise AssertionError(f"{tag}: non-finite output")
    if valid.max() >= cap or valid.min() <= 0:
        raise AssertionError(f"{tag}: valid {valid.min()}..{valid.max()} cap {cap}")
    res = {"run_s": run_s, "valid_max": int(valid.max()), "cap": cap}
    log(f"[{tag}] steady run {run_s * 1e3:.2f} ms "
        f"({batch * seconds / run_s:.0f} audio-s/s), valid max {valid.max()} "
        f"< cap {cap}, peak_bytes_in_use {peak_bytes()}")

    rows = np.arange(n_check)  # one row per family
    res["tension"] = check_tension(cfg, xs[rows], np.asarray(out.tension)[rows])
    res["periods"] = check_periods(cfg, xs[rows])
    # Grid vs scan output lengths on the same speeds.
    _, v_scan = run_scan(cfg, xs[rows], lengths[rows], np.asarray(out.speeds)[rows])
    rel = np.abs(valid[rows] - v_scan) / v_scan
    if rel.max() >= GRID_SCAN_LEN_REL:
        raise AssertionError(f"{tag}: grid {valid[rows]} vs scan {v_scan}")
    res["grid_vs_scan_len_rel"] = float(rel.max())

    # The reference's resynthesis contract (sonic_test.cc:299,479-531),
    # at its own setting: a 1 s, 237 Hz tone at 22.05 kHz, through both
    # engines, at constant speed and through the (nearly linear) speedy
    # path — output length within ±1.5% and a clean tone (Teager). The
    # same tone at 10 s is reported, not gated: the grid engine's Teager
    # rel-sigma there exceeds the 1% contract (PERF.md).
    if sample_rate == 22050:
        from speedy_tpu.pipeline import linear_time_scale, nonlinear_speedup

        tone = (0.9 * np.sin(2 * np.pi * 237.0 * np.arange(sample_rate) / sample_rate))
        tone = tone.astype(np.float32)
        for engine in ("grid", "scan"):
            for name, r in (
                ("linear", linear_time_scale(tone, cfg, 3.0, engine=engine)),
                ("speedy", nonlinear_speedup(tone, cfg, 3.0, 1e-5, engine=engine)),
            ):
                y = np.asarray(r.output)
                if abs(len(y) - len(tone) / 3.0) >= 0.015 * len(tone) / 3.0:
                    raise AssertionError(f"{tag} {engine} {name}: length {len(y)}")
                check_teager(tone, y)
        res["teager"] = "grid and scan pass"
        from speedy_tpu.ops.teager import teager_stats

        tone10 = np.tile(tone, 10)
        y = np.asarray(nonlinear_speedup(tone10, cfg, 3.0, 1e-5, engine="grid").output)
        om, ov = teager_stats(y[: len(y) - 300])
        res["teager_10s_grid_rel_sigma"] = float(np.sqrt(ov) / om)
    log(f"[{tag}] checks {json.dumps(res)}")
    return res


def corpus_inputs(sample_rate: int, durations) -> list:
    """The corpus phase's seeded int16 utterances."""
    from bench_signals import corpus_utterance

    rng = np.random.default_rng(2)
    return [corpus_utterance(sample_rate, d, rng) for d in durations]


def four_inputs(sample_rate: int, n_utt: int, seq_seconds: float):
    """The four-device phase's seeded corpus (int16, at most 30 s each)
    and its long float32 utterance for sequence parallelism."""
    from bench_signals import corpus_durations, corpus_utterance

    rng = np.random.default_rng(4)
    durs = np.minimum(corpus_durations(n_utt, seed=4), 30.0)
    utts = [corpus_utterance(sample_rate, d, rng) for d in durs]
    x = corpus_utterance(sample_rate, seq_seconds, rng).astype(np.float32) / 32768.0
    return utts, x


def phase_corpus(sample_rate: int, durations, batch_size: int,
                 long_samples: int = 1 << 19, stream_kw=None,
                 use_mesh: bool = True) -> dict:
    """CorpusEngine.process on a seeded int16 corpus; long utterances take
    the streaming route. Three short outputs from distinct buckets and
    one long one are compared with their standalone runs."""
    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.parallel.batch import CorpusEngine

    cfg = SpeedyConfig(sample_rate)
    utts = corpus_inputs(sample_rate, durations)
    kw = dict(capacity_factor=CAP_FACTOR, long_utterance_samples=long_samples,
              stream_kw=stream_kw, use_mesh=use_mesh)
    eng = CorpusEngine(cfg, RATE, batch_size=batch_size, **kw)
    t0 = time.perf_counter()
    outs = eng.process(utts)
    wall = time.perf_counter() - t0
    audio = sum(len(u) for u in utts) / sample_rate
    if eng.stats["streamed_long"] < 1:
        raise AssertionError("corpus: no utterance took the streaming route")
    for y in outs:
        if y.dtype != np.int16 or len(y) == 0:
            raise AssertionError("corpus: empty or non-int16 output")
    log(f"[corpus {len(utts)} utts, {audio:.0f} s] first process {wall:.2f} s "
        f"(compiles included); stats {json.dumps(eng.stats)}; "
        f"peak_bytes_in_use {peak_bytes()}")

    longs = [j for j, u in enumerate(utts) if len(u) > long_samples]
    picked, seen = [], set()
    for j in sorted(range(len(utts)), key=lambda j: len(utts[j])):
        b = eng._bucket_length(len(utts[j]))
        if j not in longs and b not in seen:
            picked.append(j)
            seen.add(b)
    picked = picked[:3] + longs[:1]
    res = {}
    for j in picked:
        solo = CorpusEngine(cfg, RATE, batch_size=1, **kw).process([utts[j]])[0]
        res[f"utt{j}_{len(utts[j]) / sample_rate:.1f}s"] = _diff_gate(
            f"corpus utt {j}", _pcm_to_float(outs[j]), _pcm_to_float(solo),
            cfg.frame_step_int,
        )
    log(f"[corpus] vs standalone {json.dumps(res)}")
    return res


def phase_serve(sample_rate: int, n_streams: int, feed_seconds: float,
                rounds: int, stream_kw=None) -> dict:
    """MultiStreamPipeline with n_streams int16 streams over several
    feed_many rounds and a flush; every stream vs a standalone
    DeviceStreamingPipeline on the same audio."""
    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.multistream import MultiStreamPipeline
    from bench_signals import corpus_utterance
    from speedy_tpu.streaming_device import DeviceStreamingPipeline

    cfg = SpeedyConfig(sample_rate)
    kw = dict(stream_kw or {})
    rng = np.random.default_rng(3)
    feed = int(feed_seconds * sample_rate)
    xs = [corpus_utterance(sample_rate, rounds * feed_seconds * rng.uniform(0.8, 1.0), rng)
          for _ in range(n_streams)]
    ms = MultiStreamPipeline(cfg, RATE, n_streams=n_streams, wire_dtype="int16", **kw)
    sids = [ms.open() for _ in xs]
    outs = {s: [] for s in sids}
    lat = []
    for r in range(rounds):
        t0 = time.perf_counter()
        got = ms.feed_many([(s, x[r * feed : (r + 1) * feed]) for s, x in zip(sids, xs)])
        lat.append(time.perf_counter() - t0)
        for s, y in got.items():
            outs[s].append(y)
    for s in sids:
        outs[s].append(ms.flush(s))
    log(f"[serve N={n_streams}] round wall times (s, compiles in the first) "
        f"{[round(v, 4) for v in lat]}; stats {json.dumps(ms.stats)}")
    worst = {"snr_db": float("inf"), "worst_window_snr_db": float("inf"),
             "max": 0.0, "identical": 0}
    for s, x in zip(sids, xs):
        ref = DeviceStreamingPipeline(cfg, RATE, **kw).process(
            x.astype(np.float32) / 32768.0, feed_chunk=feed
        )
        ref = np.clip(np.round(ref * 32768.0), -32768, 32767).astype(np.int16)
        g = _diff_gate(f"stream {s}", _pcm_to_float(np.concatenate(outs[s])),
                       _pcm_to_float(ref), cfg.frame_step_int)
        for k in ("snr_db", "worst_window_snr_db"):
            worst[k] = min(worst[k], g[k])
        worst["max"] = max(worst["max"], g["max"])
        worst["identical"] += int(g["identical"])
    log(f"[serve] vs standalone (worst stream) {json.dumps(worst)}; "
        f"peak_bytes_in_use {peak_bytes()}")
    return worst


def phase_gpu_tests() -> dict:
    """The `gpu`-marked tests, in this process, on the card."""
    import pytest

    class Count:
        def __init__(self):
            self.n = {"passed": 0, "failed": 0, "skipped": 0}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.n[report.outcome] = self.n.get(report.outcome, 0) + 1

    count = Count()
    rc = pytest.main(
        ["-q", "-m", "gpu", "--gpu", "-p", "no:cacheprovider",
         os.path.join(REPO, "tests")],
        plugins=[count],
    )
    log(f"[gpu-tests] pytest rc={rc} {json.dumps(count.n)}")
    if rc != 0 or count.n["passed"] == 0 or count.n["skipped"]:
        raise AssertionError(f"gpu-tests failed: rc={rc} {count.n}")
    return count.n


def phase_four(sample_rate: int = 16000, n_utt: int = 32, batch_size: int = 16,
               seq_seconds: float = 60.0, devices=None) -> dict:
    """CorpusEngine over a dp mesh of all devices vs one device, and
    sequence-parallel speedup of one long utterance vs the batched
    engine."""
    import jax
    import jax.numpy as jnp

    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.parallel.batch import CorpusEngine, batched_nonlinear_speedup
    from speedy_tpu.parallel.mesh import make_mesh
    from speedy_tpu.parallel.seqpar import nonlinear_speedup_seq_parallel

    devices = devices or jax.devices()
    cfg = SpeedyConfig(sample_rate)
    utts, x = four_inputs(sample_rate, n_utt, seq_seconds)
    kw = dict(batch_size=batch_size, capacity_factor=CAP_FACTOR,
              long_utterance_samples=None)
    t0 = time.perf_counter()
    one = CorpusEngine(cfg, RATE, use_mesh=False, **kw).process(utts)
    t1 = time.perf_counter()
    eng = CorpusEngine(cfg, RATE, use_mesh=True, **kw)
    if len(devices) != jax.device_count():
        raise ValueError("CorpusEngine's mesh spans every device")
    many = eng.process(utts)
    t2 = time.perf_counter()
    dp = _equal_gate(f"dp={len(devices)} corpus vs one device",
                     [(_pcm_to_float(a), _pcm_to_float(b)) for a, b in zip(many, one)])
    log(f"[four: corpus dp={len(devices)}] {len(utts)} utts; wall 1 device "
        f"{t1 - t0:.2f} s, dp mesh {t2 - t1:.2f} s (compiles included); "
        f"vs 1 device {json.dumps(dp)}")

    mesh = make_mesh(dp=len(devices), tp=1, devices=devices)
    y_sp, v_sp, _, _ = nonlinear_speedup_seq_parallel(jnp.asarray(x), cfg, mesh, RATE)
    ref = jax.jit(lambda u, l: batched_nonlinear_speedup(u, l, cfg, RATE))(
        jnp.asarray(x)[None], jnp.asarray([len(x)], jnp.int32)
    )
    v_sp, v_ref = int(v_sp), int(ref.valid_length[0])
    seq = _diff_gate("seqpar vs batched", np.asarray(y_sp)[:v_sp],
                     np.asarray(ref.output)[0, :v_ref], cfg.frame_step_int)
    seq.update(valid=v_sp, valid_ref=v_ref)
    log(f"[four: seqpar {seq_seconds:g} s on {len(devices)} devices] "
        f"vs batched {json.dumps(seq)}")
    return {"corpus": dp, "seqpar": seq}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase (dp corpus + seqpar)")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform}); refusing to run",
              file=sys.stderr)
        return 2
    if args.four and jax.device_count() != 4:
        print(f"chip_smoke --four needs 4 GPUs, found {jax.device_count()}",
              file=sys.stderr)
        return 2
    card = card_line()
    from speedy_tpu.profiling import enable_compile_cache

    log(f"jax {jax.__version__}, {jax.device_count()} x {dev.device_kind}; "
        f"compile cache {enable_compile_cache()}")
    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_batch(16000, 128, 10.0)
        phase_batch(22050, 64, 10.0)
        from bench_signals import corpus_durations

        phase_corpus(16000, corpus_durations(64), batch_size=64)
        phase_serve(16000, 32, 4.0, 3)
        phase_gpu_tests()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": jax.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
