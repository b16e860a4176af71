"""Card-level measurements behind the precision and gather choices.

    python tools/card_probe.py [--out chiprun_out/card_probe.json]

Needs a GPU. Prints one line per reading and writes them all as JSON:

1. precision: what a float32 [4096, 240] @ [240, 241] dot at DEFAULT, HIGH
   and HIGHEST compiles to (the dot lines of the compiled HLO) and its max
   relative error against float64;
2. tension: the batched analysis at HIGH and DEFAULT against the same
   chain at HIGHEST, 16 rows x 10 s of the benchmark mix at 16, 22.05 and
   44.1 kHz;
3. step: the 16 kHz B=128 x 10 s step with the analysis at HIGH vs
   HIGHEST, ABBA-alternated medians;
4. gather: the same step with synthesis rows gathered per row (the
   production `wsola_fast._gather_rows`) vs one span per 128 rows with
   one-hot and radix-8 shift extraction (the previous design, below),
   ABBA-alternated, with the outputs compared;
5. card references: a 1 GiB elementwise copy and 8192^3 matmuls;
6. memory: `memory_analysis()` and one run of the step at CorpusEngine's
   longest bucket (2^19 samples, B=128).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def analysis_precision(prec):
    """Trace the analysis DFTs at `prec` (clears JAX's caches around it)."""
    import jax

    from speedy_tpu.ops import dft

    old = dft.ANALYSIS_PRECISION
    dft.ANALYSIS_PRECISION = prec
    jax.clear_caches()
    try:
        yield
    finally:
        dft.ANALYSIS_PRECISION = old
        jax.clear_caches()


def abba(fns: dict, args, reps: int = 5, rounds: int = 4):
    """Medians and IQRs (ms) of each compiled fn, order alternated."""
    import jax

    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in order if r % 2 == 0 else order[::-1]:
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fns[k](*args))
                times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: {"median_ms": float(np.median(v)),
                "iqr_ms": [float(np.percentile(v, 25)), float(np.percentile(v, 75))]}
            for k, v in times.items()}


def gather_rows_spans(x, starts, width, span_rows=128, w_span=122880):
    """Rows gathered as one w_span-wide span per span_rows rows, then
    extracted with a one-hot 1024-block select (a HIGHEST matmul), two
    radix-8 select ladders (128 and 16 samples) and a 4-step barrel
    shift. Same contract as wsola_fast._gather_rows."""
    import jax
    import jax.numpy as jnp

    from speedy_tpu.ops import wsola_fast

    B, K = starts.shape
    R = span_rows
    NB = -(-K // R)
    if NB * R != K:
        starts = jnp.concatenate([starts, jnp.tile(starts[:, -1:], (1, NB * R - K))], 1)
    s2 = starts.reshape(B, NB, R)
    base = jnp.min(s2, axis=2)
    offs = (s2 - base[:, :, None]).astype(jnp.int32)
    x = jnp.concatenate([x, jnp.zeros((B, w_span), x.dtype)], axis=1)
    spans = wsola_fast._gather_rows(x, base, w_span)
    dtype = x.dtype
    nsb = w_span // 1024
    w3 = -(-(width + 15) // 16) * 16 + 16
    w2 = 7 * 16 + w3
    w1 = 7 * 128 + w2
    v_extra = max(512, -(-(w1 - 1024) // 128) * 128)
    sp_pad = jnp.concatenate([spans, jnp.zeros((B, NB, 1024), dtype)], axis=-1)
    Vl = sp_pad.reshape(B, NB, nsb + 1, 1024)
    V = jnp.concatenate([Vl[:, :, :nsb], Vl[:, :, 1:, :v_extra]], axis=-1)
    qA = offs // 1024
    rA = offs - qA * 1024
    onehot = (qA[..., None] == jnp.arange(nsb, dtype=jnp.int32)).astype(dtype)
    slab = jnp.einsum("bnrj,bnjc->bnrc", onehot, V,
                      precision=jax.lax.Precision.HIGHEST)[..., :w1]

    def ladder(slab, q, unit, w_out):
        return sum(
            jnp.where((q == j)[..., None],
                      jax.lax.slice_in_dim(slab, j * unit, j * unit + w_out, axis=-1),
                      jnp.zeros((), dtype))
            for j in range(8)
        )

    qB, rB = rA // 128, rA % 128
    slab = ladder(slab, qB, 128, w2)
    qC, rC = rB // 16, rB % 16
    slab = ladder(slab, qC, 16, w3)
    for bit in range(4):
        sh = 1 << bit
        slab = jnp.where((rC & sh)[..., None] != 0, jnp.roll(slab, -sh, axis=-1), slab)
    return slab[..., :width].reshape(B, NB * R, width)[:, :K]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "card_probe.json"))
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    import chip_smoke
    from bench_signals import bench_families
    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.ops import wsola_fast
    from speedy_tpu.parallel.batch import batched_analysis, batched_nonlinear_speedup
    from speedy_tpu.parallel.mesh import make_mesh
    from speedy_tpu.profiling import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"card_probe: no GPU (JAX found {dev.platform})", file=sys.stderr)
        return 2
    enable_compile_cache()
    P = jax.lax.Precision
    res = {"card": chip_smoke.card_line(), "device_kind": dev.device_kind}
    log("card", res["card"])

    # 1. precision lowering and error
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4096, 240)).astype(np.float32)
    b = rng.standard_normal((240, 241)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    for name in ("DEFAULT", "HIGH", "HIGHEST"):
        prec = getattr(P, name)
        c = jax.jit(lambda x, y: jnp.dot(x, y, precision=prec)).lower(a, b).compile()
        hlo = [ln.strip()[:400] for ln in c.as_text().splitlines()
               if "custom-call" in ln or " dot(" in ln]
        rel = float(np.abs(np.asarray(c(a, b), np.float64) - ref).max() / np.abs(ref).max())
        res[f"dot_{name}"] = {"max_rel_err": rel, "hlo": hlo[:3]}
        log(f"[precision {name}] max rel err {rel:.3e}; {hlo[:1]}")

    mesh = make_mesh(dp=1, tp=1, devices=[dev])

    def batch(sr, B, secs=10.0):
        L = int(sr * secs)
        xs = bench_families(sr, L)[np.arange(B) % 4]
        xs = xs * np.random.default_rng(1).uniform(0.5, 1.0, (B, 1))
        return jnp.asarray(xs, jnp.float32), jnp.full((B,), L, jnp.int32)

    # 2. tension at reduced precision vs HIGHEST
    for sr in (16000, 22050, 44100):
        cfg = SpeedyConfig(sr)
        xs, lens = batch(sr, 16)
        T = cfg.num_frames(xs.shape[1], integer_step=True)
        ts = {}
        for name in ("DEFAULT", "HIGH", "HIGHEST"):
            with analysis_precision(getattr(P, name)):
                ts[name] = np.asarray(jax.jit(lambda x: batched_analysis(x, cfg, T))(xs))
        for name in ("DEFAULT", "HIGH"):
            d = np.abs(ts[name] - ts["HIGHEST"])
            res[f"tension_{sr}_{name}_vs_HIGHEST"] = {"max": float(d.max()),
                                                      "mean": float(d.mean())}
            log(f"[tension {sr} Hz {name} vs HIGHEST] max {d.max():.4g} mean {d.mean():.4g}")

    # 3. step time, HIGH vs HIGHEST analysis
    cfg = SpeedyConfig(16000)
    xs, lens = batch(16000, 128)

    def step(x, ln):
        o = batched_nonlinear_speedup(x, ln, cfg, chip_smoke.RATE, 1.0, 0.1, mesh=mesh,
                                      capacity_factor=chip_smoke.CAP_FACTOR)
        return o.output, o.valid_length

    def compiled_step():
        return jax.jit(step).lower(xs, lens).compile()

    with analysis_precision(P.HIGH):
        c_high = compiled_step()
    c_prod = compiled_step()
    res["step_16k_B128_analysis_precision"] = abba({"HIGH": c_high, "HIGHEST": c_prod},
                                                   (xs, lens))
    log("[step 16 kHz B=128 analysis precision]", res["step_16k_B128_analysis_precision"])

    # 4. synthesis gather: per row vs spans
    per_row = wsola_fast._gather_rows
    wsola_fast._gather_rows = lambda x, s, w: (
        per_row(x, s, w) if s.shape[-1] < 128 else gather_rows_spans(x, s, w))
    jax.clear_caches()
    try:
        c_span = compiled_step()
    finally:
        wsola_fast._gather_rows = per_row
        jax.clear_caches()
    y1, y2 = (np.asarray(c(xs, lens)[0]) for c in (c_prod, c_span))
    res["gather_outputs_max_diff"] = float(np.abs(y1 - y2).max())
    res["step_16k_B128_gather"] = abba(
        {"per_row": c_prod, "span": c_span, "per_row_again": c_prod}, (xs, lens))
    log(f"[gather] outputs max |d| {res['gather_outputs_max_diff']}",
        res["step_16k_B128_gather"])

    # 5. card references
    big = jnp.ones((256 * 1024 * 1024,), jnp.float32)
    cp = jax.jit(lambda v: v * 1.0001)
    jax.block_until_ready(cp(big))
    t0 = time.perf_counter()
    for _ in range(10):
        jax.block_until_ready(cp(big))
    res["copy_GBps"] = 2 * big.nbytes / ((time.perf_counter() - t0) / 10) / 1e9
    del big
    for name, dtype, prec in (("f32_HIGHEST", jnp.float32, P.HIGHEST),
                              ("f32_DEFAULT", jnp.float32, P.DEFAULT),
                              ("bf16", jnp.bfloat16, None)):
        m = jnp.ones((8192, 8192), dtype)
        mm = jax.jit(lambda u, v: jnp.dot(u, v, precision=prec,
                                          preferred_element_type=jnp.float32))
        jax.block_until_ready(mm(m, m))
        t0 = time.perf_counter()
        for _ in range(5):
            jax.block_until_ready(mm(m, m))
        res[f"matmul_{name}_TFLOPs"] = 2 * 8192**3 / ((time.perf_counter() - t0) / 5) / 1e12
    log("[references]", {k: v for k, v in res.items() if k.startswith(("copy", "matmul"))})

    # 6. memory at the longest bucket
    Lb, B = 1 << 19, 128
    xb, lb = jnp.zeros((B, Lb), jnp.float32), jnp.full((B,), Lb, jnp.int32)
    cb = jax.jit(step).lower(xb, lb).compile()
    ma = cb.memory_analysis()
    jax.block_until_ready(cb(xb, lb))
    t0 = time.perf_counter()
    jax.block_until_ready(cb(xb, lb))
    res["bucket_2^19_B128"] = {
        "temp_GiB": ma.temp_size_in_bytes / 2**30,
        "argument_GiB": ma.argument_size_in_bytes / 2**30,
        "output_GiB": ma.output_size_in_bytes / 2**30,
        "run_ms": (time.perf_counter() - t0) * 1e3,
        "peak_bytes_in_use_GiB": chip_smoke.peak_bytes() / 2**30,
    }
    log("[bucket 2^19 B=128]", res["bucket_2^19_B128"])

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
