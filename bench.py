"""Throughput benchmark: audio-seconds processed per wall-second per GPU
for the full nonlinear-speedup pipeline at 3.5x on batched speech
(SPEEDY_BENCH_SR selects the sample rate; default 16000, 22050 is the
reference's canonical rate).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}
vs_baseline is value / 1000 (the BASELINE.json north star: >1000x real
time per card). "device" names the platform, device kind and count as JAX
reports them, and the card's name and power limit from nvidia-smi. The
benchmark refuses to run without a GPU: it never reports a CPU number.

Steady-state throughput runs all iterations inside ONE dispatched program
(lax.scan over per-iteration input gains, one checksum per iteration), so
the window holds no host dispatch; SPEEDY_BENCH_SERIAL=1 times one step
per dispatch instead.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def device_record() -> dict:
    """Platform, device kind and count, plus the card's name and power
    limit. Raises without a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX found {dev.platform}); refusing to run")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": jax.device_count(),
        "card": card,
    }


def corpus_main():
    """Corpus-level throughput: CorpusEngine.process end to end over a
    synthesized variable-length int16 corpus — host staging, bucketing,
    padding waste, capacity retries, per-batch dispatches and the
    long-utterance streaming route. A warm pass over a content-distinct
    corpus with the same length profile compiles every bucket first.

    Knobs: SPEEDY_BENCH_CORPUS_N (utterance count, default 256),
    SPEEDY_BENCH_SR, SPEEDY_BENCH_BATCH, SPEEDY_BENCH_CAP_FACTOR,
    SPEEDY_BENCH_STREAMB (long-utterance stream lanes, default 8)."""
    import jax

    from speedy_tpu.profiling import enable_compile_cache

    device = device_record()
    enable_compile_cache()

    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.parallel.batch import CorpusEngine
    from bench_signals import corpus_durations, corpus_utterance

    sample_rate = int(os.environ.get("SPEEDY_BENCH_SR", "16000"))
    cfg = SpeedyConfig(sample_rate)
    n_utt = int(os.environ.get("SPEEDY_BENCH_CORPUS_N", "256"))
    batch = int(os.environ.get("SPEEDY_BENCH_BATCH", "128"))
    cap_factor = float(os.environ.get("SPEEDY_BENCH_CAP_FACTOR", "1.33")) or None
    stream_b = int(os.environ.get("SPEEDY_BENCH_STREAMB", "8"))
    n_dev = jax.device_count()
    durs = corpus_durations(n_utt)

    def synth_corpus(seed):
        r = np.random.default_rng(seed)
        return [corpus_utterance(sample_rate, d, r) for d in durs]

    eng = CorpusEngine(
        cfg,
        3.5,
        batch_size=batch,
        use_mesh=os.environ.get("SPEEDY_BENCH_NO_MESH", "0") != "1",
        capacity_factor=cap_factor,
        stream_batch=stream_b,
    )
    t0 = time.perf_counter()
    eng.process(synth_corpus(1))  # compiles every bucket shape
    warm_dt = time.perf_counter() - t0

    corpus = synth_corpus(2)
    total_audio = sum(len(u) for u in corpus) / sample_rate
    t0 = time.perf_counter()
    results = eng.process(corpus)
    dt = time.perf_counter() - t0
    assert all(len(y) > 0 for y in results)
    attribution = {
        "total_audio_s": round(total_audio, 1),
        "output_audio_s": round(sum(len(y) for y in results) / sample_rate, 1),
        "stats": dict(eng.stats),
        "wall_s": round(dt, 3),
        "warm_wall_s": round(warm_dt, 3),
    }
    print("corpus attribution: " + json.dumps(attribution), file=sys.stderr)
    value = total_audio / dt / max(n_dev, 1)
    print(json.dumps({
        "metric": (
            "corpus audio-seconds/sec/chip at 3.5x nonlinear speedup "
            f"({sample_rate / 1000:g} kHz, CorpusEngine end-to-end, "
            f"{n_utt} utts 2-90 s)"
        ),
        "value": round(value, 1),
        "unit": "audio-s/s/chip",
        "vs_baseline": round(value / 1000.0, 3),
        "device": device,
    }))
    return 0


def main():
    if os.environ.get("SPEEDY_BENCH_CORPUS", "0") == "1":
        return corpus_main()
    import jax

    from speedy_tpu.profiling import enable_compile_cache

    device = device_record()
    enable_compile_cache()

    import jax.numpy as jnp

    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.parallel.batch import (
        batched_nonlinear_speedup,
        grid_output_capacity,
    )
    from bench_signals import bench_families

    sample_rate = int(os.environ.get("SPEEDY_BENCH_SR", "16000"))
    seconds = 10.0
    cfg = SpeedyConfig(sample_rate)
    L = int(sample_rate * seconds)
    n_dev = jax.device_count()
    # Batch per card by rate (10 s utterances); not yet tuned on the GPU.
    default_B = {16000: 128, 22050: 64, 44100: 32}.get(sample_rate, 64)
    B = int(os.environ.get("SPEEDY_BENCH_BATCH", str(default_B))) * max(n_dev, 1)
    iters = int(os.environ.get("SPEEDY_BENCH_ITERS", "64"))
    serial = os.environ.get("SPEEDY_BENCH_SERIAL", "0") == "1"

    # Four signal families interleaved across the batch (pitch structure,
    # speed trajectory and output length all depend on content).
    # SPEEDY_BENCH_FAMILY=k runs a homogeneous batch of family k instead.
    families = bench_families(sample_rate, L)
    fam_sel = os.environ.get("SPEEDY_BENCH_FAMILY", "")
    if fam_sel != "":
        k = int(fam_sel)
        if not 0 <= k < len(families):
            raise SystemExit(f"SPEEDY_BENCH_FAMILY={k}: families are 0..{len(families) - 1}")
        base_rows = np.broadcast_to(families[k], (B, L)).copy()
    else:
        base_rows = families[np.arange(B) % len(families)]  # [B, L]

    # The benchmarked program is the meshed one (analysis under sharding
    # constraints, WSOLA inside shard_map over 'dp'), even on one card.
    mesh = None
    if os.environ.get("SPEEDY_BENCH_NO_MESH", "0") != "1":
        from speedy_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(tp=1)

    # Rate-derived output capacity (batched_nonlinear_speedup's
    # capacity_factor contract); truncation fails the run below.
    cap_factor = float(os.environ.get("SPEEDY_BENCH_CAP_FACTOR", "1.33")) or None
    cap = grid_output_capacity(cfg, L, 3.5, cap_factor)

    def fn(xs, lengths, gain=None):
        out = batched_nonlinear_speedup(
            xs, lengths, cfg, 3.5, 1.0, 0.1, mesh=mesh, gain=gain,
            capacity_factor=cap_factor,
        )
        return jnp.sum(out.output), jnp.max(out.valid_length)

    rng = np.random.default_rng(0)
    lengths = jnp.asarray(np.full((B,), L, np.int32))
    if serial:
        step_fn = jax.jit(fn)

        def fresh():
            amp = rng.uniform(0.5, 1.0, size=(B, 1)).astype(np.float32)
            return jnp.asarray(base_rows * amp)

        jax.block_until_ready(step_fn(fresh(), lengths))  # compile
        times = []
        for _ in range(iters):
            xs = jax.block_until_ready(fresh())
            t0 = time.perf_counter()
            s, v = jax.block_until_ready(step_fn(xs, lengths))
            times.append(time.perf_counter() - t0)
            assert int(v) < cap, f"output truncated: valid {int(v)} == cap {cap}"
        dt = float(np.median(times))
    else:
        base_d = jnp.asarray(base_rows)

        def scan_fn(amps, lens):
            def body(_, amp):
                return 0, fn(base_d, lens, gain=amp[:, 0])

            _, (sums, vmaxes) = jax.lax.scan(body, 0, amps)
            return sums, jnp.max(vmaxes)

        scan_jit = jax.jit(scan_fn)

        def fresh_amps():
            return jnp.asarray(
                rng.uniform(0.5, 1.0, size=(iters, B, 1)).astype(np.float32)
            )

        jax.block_until_ready(scan_jit(fresh_amps(), lengths))  # compile
        window_rates = []
        vmax_all = 0
        for _ in range(3):
            amps = jax.block_until_ready(fresh_amps())
            t0 = time.perf_counter()
            sums, vmax = jax.block_until_ready(scan_jit(amps, lengths))
            dt_total = time.perf_counter() - t0
            vmax = int(vmax)
            assert vmax < cap, f"output truncated: valid {vmax} == cap {cap}"
            assert np.isfinite(np.asarray(sums)).all()
            vmax_all = max(vmax_all, vmax)
            window_rates.append(B * seconds / (dt_total / iters))
        dt = B * seconds / float(np.median(window_rates))
        print(
            "window rates (audio-s/s): "
            + ", ".join(f"{r:.0f}" for r in window_rates)
            + f"; capacity margin {cap / max(vmax_all, 1) - 1.0:+.1%} "
            f"(max valid {vmax_all} vs cap {cap})",
            file=sys.stderr,
        )

    value = B * seconds / dt / max(n_dev, 1)
    print(json.dumps({
        "metric": (
            "audio-seconds/sec/chip at 3.5x nonlinear speedup "
            f"({sample_rate / 1000:g} kHz, batched)"
        ),
        "value": round(value, 1),
        "unit": "audio-s/s/chip",
        "vs_baseline": round(value / 1000.0, 3),
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
