"""Per-stage device time of the batched speedup step, from a profiler trace.

    python tools/stage_trace.py [--config 16000:128 ...] [--seconds 10]
                                [--steps 5] [--out chiprun_out]

Compiles the production step (batched_nonlinear_speedup on a 1-device
mesh, the benchmark's 4-family mix, capacity factor 1.33), warms it up,
traces `--steps` back-to-back steps with jax.profiler, and attributes
every device op to the pipeline stage whose `jax.named_scope` it carries
(analysis, speed_law, time_map, pitch, phase, synthesis; anything else is
"other"), for each `--config RATE:BATCH` in turn. The HLO instruction -> scope map comes from the compiled
module's op metadata; XLA's command buffers (CUDA graphs) are turned off
in this process so that every kernel in the trace carries the name of
its HLO op. Prints one JSON object with the per-stage device
time per step, each stage's share, the device busy share of the traced
window, and the top ops; writes it to <out>/stage_trace_<RATE>.json. The
raw trace goes to a temporary directory that is removed afterwards.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("analysis", "speed_law", "time_map", "pitch", "phase", "synthesis")


def scope_map(hlo_text: str) -> dict:
    """HLO instruction name -> stage, from op_name metadata. A fusion takes
    the stage of the first scoped instruction in its fused computation
    when its own metadata names none."""
    inst_re = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?metadata=\{[^}]*op_name=\"([^\"]*)\"")
    comp_re = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
    calls_re = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*\bcalls=%?([\w.\-]+)")

    def stage_of(op_name: str):
        for s in STAGES:
            if f"/{s}/" in op_name or op_name.endswith(f"/{s}"):
                return s
        return None

    inst_stage, comp_stage, calls = {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        m = comp_re.match(line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1)
            continue
        m = inst_re.match(line)
        if m:
            s = stage_of(m.group(2))
            if s:
                inst_stage[m.group(1)] = s
                comp_stage.setdefault(comp, s)
        m = calls_re.match(line)
        if m:
            calls[m.group(1)] = m.group(2)
    for inst, comp in calls.items():
        if inst not in inst_stage and comp in comp_stage:
            inst_stage[inst] = comp_stage[comp]
    # Kernel names spell an instruction's dots as underscores.
    inst_stage.update({k.replace(".", "_"): v for k, v in list(inst_stage.items())})
    return inst_stage


def device_events(trace_dir: str):
    """(name, hlo_op, start_ns, dur_ns, stats) of every op on the GPU
    planes of the newest trace under trace_dir, and an inventory of every
    plane's lines with their event counts."""
    import jax

    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    pd = jax.profiler.ProfileData.from_file(files[-1])
    inventory, out = [], []
    for plane in pd.planes:
        lines = list(plane.lines)
        inventory.append([plane.name, [[ln.name, len(list(ln.events))] for ln in lines]])
        if "GPU" not in plane.name:
            continue
        # Prefer the per-op line; fall back to the CUDA stream lines.
        picked = [ln for ln in lines if ln.name == "XLA Ops"] or [
            ln for ln in lines if "stream" in ln.name.lower()
        ]
        for line in picked:
            for ev in line.events:
                stats = dict(ev.stats)
                hlo = stats.get("hlo_op") or stats.get("long_name") or ""
                out.append((ev.name, str(hlo), ev.start_ns, ev.duration_ns, stats))
    return out, inventory


def reduce_events(events, inst_stage: dict, steps: int) -> dict:
    per_stage = defaultdict(float)
    per_op = defaultdict(float)
    intervals = []
    for name, hlo, start, dur, stats in events:
        key = hlo.split(":")[0].strip().lstrip("%") if hlo else name
        scoped = str(stats.get("name", ""))  # the op's name-scope path
        stage = (
            next((s for s in STAGES if f"/{s}" in scoped), None)
            or inst_stage.get(key) or inst_stage.get(name) or "other"
        )
        per_stage[stage] += dur
        per_op[(stage, key or name)] += dur
        intervals.append((start, start + dur))
    total = sum(per_stage.values())
    intervals.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:25]
    return {
        "stage_ms_per_step": {k: v / steps / 1e6 for k, v in sorted(per_stage.items())},
        "stage_share": {k: v / total for k, v in sorted(per_stage.items())} if total else {},
        "device_ms_per_step": total / steps / 1e6,
        "busy_share_of_window": busy / window if window else 0.0,
        "top_ops_ms_per_step": [[s, op, v / steps / 1e6] for (s, op), v in top],
    }


def trace_step(rate: int, batch: int, seconds: float, steps: int) -> dict:
    """Compile, warm up, time and trace the production step at one
    configuration; the per-stage reduction as a dict."""
    import jax
    import jax.numpy as jnp

    from bench_signals import bench_families
    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.parallel.batch import batched_nonlinear_speedup
    from speedy_tpu.parallel.mesh import make_mesh

    dev = jax.devices()[0]
    cfg = SpeedyConfig(rate)
    L = int(rate * seconds)
    mesh = make_mesh(dp=1, tp=1, devices=[dev])
    xs = bench_families(rate, L)[np.arange(batch) % 4]
    xs = jnp.asarray(xs * np.random.default_rng(1).uniform(0.5, 1.0, (batch, 1)),
                     jnp.float32)
    lengths = jnp.full((batch,), L, jnp.int32)

    def step(x, l):
        out = batched_nonlinear_speedup(x, l, cfg, 3.5, 1.0, 0.1, mesh=mesh,
                                        capacity_factor=1.33)
        return out.output, out.valid_length

    compiled = jax.jit(step).lower(xs, lengths).compile()
    inst_stage = scope_map(compiled.as_text())
    for _ in range(3):
        jax.block_until_ready(compiled(xs, lengths))
    t0 = time.perf_counter()
    for _ in range(steps):
        jax.block_until_ready(compiled(xs, lengths))
    wall_ms = (time.perf_counter() - t0) / steps * 1e3

    with tempfile.TemporaryDirectory() as trace_dir:
        jax.profiler.start_trace(trace_dir)
        for _ in range(steps):
            jax.block_until_ready(compiled(xs, lengths))
        jax.profiler.stop_trace()
        events, inventory = device_events(trace_dir)
    if not events:
        raise RuntimeError(f"no GPU events in the trace: {inventory}")
    res = reduce_events(events, inst_stage, steps)
    res.update(
        device=dev.device_kind, rate=rate, batch=batch, seconds=seconds,
        wall_ms_per_step_untraced=wall_ms,
        audio_s_per_s_untraced=batch * seconds / (wall_ms / 1e3),
        scoped_instructions=len(inst_stage),
    )
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", action="append", default=None,
                    help="RATE:BATCH (repeatable; default 16000:128)")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
    ).strip()
    import jax

    from chip_smoke import card_line
    from speedy_tpu.profiling import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"stage_trace: no GPU (JAX found {dev.platform})", file=sys.stderr)
        return 2
    enable_compile_cache()
    card = card_line()
    os.makedirs(args.out, exist_ok=True)
    for spec in args.config or ["16000:128"]:
        rate, batch = (int(v) for v in spec.split(":"))
        res = trace_step(rate, batch, args.seconds, args.steps)
        res["card"] = card
        with open(os.path.join(args.out, f"stage_trace_{rate}.json"), "w") as f:
            json.dump(res, f, indent=1)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
