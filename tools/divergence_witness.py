"""Why two runs of the speedup that round differently give different audio.

    python tools/divergence_witness.py stream [--out DIR]   # one GPU
    python tools/divergence_witness.py seqpar [--out DIR]   # several GPUs

Each mode runs a pair that `chip_smoke.py` compares, on the same seeded
input, and reports the pair's intermediates next to the output
difference (JSON on stdout and in DIR/witness_<mode>.json):

- stream: the corpus phase's first streamed utterance, through
  CorpusEngine's multistream lanes and through a standalone
  DeviceStreamingPipeline. Hooks on the stream pipeline record each
  run's speeds (the lanes keep tension on the device) and, per WSOLA
  segment, the engine inputs and
  the pitch period of every chunk. From these the tool rebuilds (in
  float64, with the engine's formulas) every emitted chunk's source
  position c, its phase-snap count m = round(delta / P) and its read
  position a = c + delta - m * P.
- seqpar: the four-device phase's 60 s utterance through
  nonlinear_speedup_seq_parallel and through batched_nonlinear_speedup.
  It reports both runs' tension and speeds, the float64 time maps c of
  both speed tracks, a control run of the sequence-parallel synthesis on
  the batched run's speeds, and the pitch periods of the pitch-grid
  shapes both paths compute (whole utterance vs each shard's slice).

Every 10 ms slot whose |d| reaches 2e-3 is put in one class: a different
phase-snap count (m), an integer period flip (|dP| > 0.5), or drift
(same m, periods within half a sample, different read position). Period flips are
checked against float64 SSD ties (tests/testutil.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import chip_smoke  # noqa: E402

BAD = 2e-3


def _q(v) -> dict:
    """max / median / 99th percentile of |v| (empty -> zeros)."""
    v = np.abs(np.asarray(v, np.float64))
    if v.size == 0:
        return {"max": 0.0, "median": 0.0, "p99": 0.0}
    return {"max": float(v.max()), "median": float(np.median(v)),
            "p99": float(np.percentile(v, 99))}


def bad_slots(got, ref, hop: int) -> np.ndarray:
    """Indices of the hop-sized slots where |got - ref| >= BAD."""
    n = min(len(got), len(ref))
    d = np.abs(np.asarray(got[:n], np.float64) - np.asarray(ref[:n], np.float64))
    return np.unique(np.flatnonzero(d >= BAD) // hop)


def time_map(speeds, step: int, p, in_offset: float = 0.0, length=None):
    """The engine's time map (wsola_fast._wsola_grid_batch, step 1) in
    float64: source position of output positions p under per-frame
    speeds."""
    sp = np.asarray(speeds, np.float64)
    obnd = np.concatenate([[0.0], np.cumsum(step / sp)])
    f = np.clip(np.searchsorted(obnd, p, side="right") - 1, 0, len(sp) - 1)
    c = f * step + (p - obnd[f]) * sp[f] + in_offset
    if length is not None:
        c = np.clip(c, 0.0, max(length - 1.0, 0.0))
    return c


def classify(bad, dm, dp, da, mdp, dc) -> dict:
    """Per bad output slot k, the class of chunks k-1 and k (the two
    chunks that overlap-add into slot k). Arrays are per chunk, NaN
    where a run has no record."""
    dm, dp = np.nan_to_num(dm), np.nan_to_num(dp)
    out = {"bad_slots": int(len(bad)), "snap_count_differs": 0,
           "period_flip": 0, "drift": 0}
    drift_da, drift_mdp, drift_dc = [], [], []
    n = len(dm)
    for k in bad:
        ks = [j for j in (k - 1, k) if 0 <= j < n]
        if any(dm[j] != 0 for j in ks):
            out["snap_count_differs"] += 1
        elif any(abs(dp[j]) > 0.5 for j in ks):
            out["period_flip"] += 1
        else:
            out["drift"] += 1
            j = max(ks, key=lambda j: abs(da[j]))
            drift_da.append(da[j])
            drift_mdp.append(mdp[j])
            drift_dc.append(dc[j])
    out["drift_read_position_diff"] = _q(drift_da)
    out["drift_m_times_dP"] = _q(drift_mdp)
    out["drift_dc"] = _q(drift_dc)
    return out


def period_flip_ties(x, cells_a: dict, cells_b: dict, cfg, G: int) -> dict:
    """Integer period flips between two runs' pitch cells, each checked
    to be a float64 SSD tie."""
    import testutil

    minp, maxp = cfg.wsola_min_period, cfg.wsola_max_period
    common = sorted(set(cells_a) & set(cells_b))
    pa = np.asarray([cells_a[g] for g in common], np.float64)
    pb = np.asarray([cells_b[g] for g in common], np.float64)
    xp = np.concatenate([np.asarray(x, np.float64), np.zeros(2 * maxp + G)])
    segs = np.stack([xp[g * G : g * G + 2 * maxp] for g in common])[None]
    flips = int((np.abs(pa - pb) > 0.5).sum())
    try:
        testutil.assert_period_flips_are_ties(
            segs, pa[None], pb[None], maxp, minp, maxp, max_flip_frac=1.0
        )
        ties = True
    except AssertionError as e:
        ties = f"no: {e}"
    sub = np.abs(pa - pb)[np.abs(pa - pb) <= 0.5]
    return {"cells": len(common), "flips": flips, "flips_are_ties": ties,
            "dP_without_flips": _q(sub)}


# ------------------------------------------------------------------ stream


def _install_stream_hooks():
    """Record, per stream pipeline instance, its speeds and WSOLA segments
    (engine inputs, emitted slots, periods)."""
    from speedy_tpu import multistream, streaming_device

    base = streaming_device.DeviceStreamingPipeline
    records = {}

    def rec(self):
        return records.setdefault(id(self), {"pipe": self, "speeds": [], "segs": []})

    def wrap_extend(cls):
        orig = cls._extend_speeds

        def hooked(self, tension):
            orig(self, tension)
            n = int(np.asarray(tension).size)
            if n:
                rec(self)["speeds"].extend(self._speeds[-n:])

        cls._extend_speeds = hooked

    wrap_extend(base)
    wrap_extend(multistream._Lane)
    prep, finish = base._prep_wsola_segment, base._finish_wsola_segment

    def hooked_prep(self, f_hi, out_total):
        req, meta = prep(self, f_hi, out_total)
        self._witness_req = {k: req[k] for k in
                             ("sp", "in_offset", "out_shift", "phase_ref", "s0", "seg_len")}
        self._witness_req["sp"] = np.array(req["sp"])
        return req, meta

    def hooked_finish(self, meta, y, periods):
        S, S_local0, S_next, out_total, *_ = meta
        if out_total is None:
            n_slots = S_next - S
        else:
            n_slots = -(-max(0, int(round(out_total)) - S * self.Hs) // self.Hs)
        rec(self)["segs"].append(dict(self._witness_req, S=S, S_local0=S_local0,
                                      n_slots=n_slots,
                                      periods=np.array(periods, np.float64)))
        finish(self, meta, y, periods)

    base._prep_wsola_segment = hooked_prep
    base._finish_wsola_segment = hooked_finish
    return records


def stream_chunks(r: dict) -> dict:
    """Per emitted global chunk k: c, P, m and a in global source samples
    (float64 rebuild of the engine's time map and phase snap), and the
    global pitch cell each chunk read its period from."""
    p = r["pipe"]
    Hs, step, G = p.Hs, p.step, p.G
    out = {k: {} for k in ("c", "P", "m", "a")}
    cells = {}
    for sg in r["segs"]:
        sp = np.minimum(sg["sp"].astype(np.float64), p.max_sb)
        K = len(sg["periods"])
        j = np.arange(K)
        c = time_map(sp, step, j * Hs + sg["out_shift"], sg["in_offset"], sg["seg_len"])
        P = sg["periods"]
        off = sg["in_offset"]
        delta = (sg["phase_ref"] - off) + j * Hs - (c - off)
        m = np.round(delta / P)
        a = np.clip(c + delta - m * P, 0.0, sg["seg_len"] - 1.0)
        lo = sg["S"] - sg["S_local0"]
        for jj in range(lo, min(lo + sg["n_slots"], K)):
            k = sg["S_local0"] + jj
            for name, v in (("c", c[jj] + sg["s0"]), ("P", P[jj]), ("m", m[jj]),
                            ("a", a[jj] + sg["s0"])):
                out[name][k] = float(v)
            cells[sg["s0"] // G + int(np.round(c[jj] / G))] = float(P[jj])
    return out, cells


def run_stream(durations=None, long_samples: int = 1 << 19, stream_kw=None) -> dict:
    from bench_signals import corpus_durations
    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.parallel.batch import CorpusEngine

    sr = 16000
    cfg = SpeedyConfig(sr)
    if durations is None:
        durations = corpus_durations(64)
    utts = chip_smoke.corpus_inputs(sr, durations)
    longs = [u for u in utts if len(u) > long_samples]
    u = longs[0]
    records = _install_stream_hooks()
    kw = dict(capacity_factor=chip_smoke.CAP_FACTOR, long_utterance_samples=long_samples,
              stream_kw=stream_kw)
    y_a = CorpusEngine(cfg, chip_smoke.RATE, batch_size=64, **kw).process(longs)[0]
    recs = [r for r in records.values() if r["segs"]]
    r_a = next(r for r in recs if r["pipe"]._fed == len(u))
    n_before = set(records)
    y_b = CorpusEngine(cfg, chip_smoke.RATE, batch_size=1, **kw).process([u])[0]
    r_b = next(r for k, r in records.items() if k not in n_before and r["segs"])
    y_a, y_b = chip_smoke._pcm_to_float(y_a), chip_smoke._pcm_to_float(y_b)

    ch_a, cells_a = stream_chunks(r_a)
    ch_b, cells_b = stream_chunks(r_b)
    ks = sorted(set(ch_a["c"]) & set(ch_b["c"]))
    n = max(ks) + 1
    arr = {run: {name: np.full(n, np.nan) for name in ("c", "P", "m", "a")}
           for run in "ab"}
    for run, ch in (("a", ch_a), ("b", ch_b)):
        for name in arr[run]:
            for k in ks:
                arr[run][name][k] = ch[name][k]
    A, B = arr["a"], arr["b"]
    dP = A["P"] - B["P"]
    nt = min(len(r_a["speeds"]), len(r_b["speeds"]))
    res = {
        "utterance_s": len(u) / sr,
        "output_diff": chip_smoke._diff_stats(y_a, y_b, cfg.frame_step_int),
        "speeds_diff": _q(np.subtract(r_a["speeds"][:nt], r_b["speeds"][:nt])),
        "chunks": len(ks),
        "dc": _q((A["c"] - B["c"])[ks]),
        "m_max": float(np.nanmax(np.abs(B["m"]))),
        "chunks_with_m_differing": int(np.nansum(A["m"] != B["m"])),
        "period_cells": period_flip_ties(
            np.asarray(u, np.float64) / 32768.0, cells_a, cells_b, cfg,
            r_a["pipe"].G),
        "slots": classify(bad_slots(y_a, y_b, cfg.frame_step_int),
                          A["m"] - B["m"], dP, A["a"] - B["a"], B["m"] * dP,
                          A["c"] - B["c"]),
    }
    return res


# ------------------------------------------------------------------ seqpar


def run_seqpar(seq_seconds: float = 60.0, n_utt: int = 32) -> dict:
    import jax
    import jax.numpy as jnp

    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.ops import wsola_fast
    from speedy_tpu.parallel.batch import _plan_max_speed, batched_nonlinear_speedup
    from speedy_tpu.parallel.mesh import make_mesh
    from speedy_tpu.parallel.seqpar import (
        nonlinear_speedup_seq_parallel,
        wsola_seq_parallel,
    )

    sr = 16000
    cfg = SpeedyConfig(sr)
    _, x = chip_smoke.four_inputs(sr, n_utt, seq_seconds)
    L = len(x)
    devices = jax.devices()
    mesh = make_mesh(dp=len(devices), tp=1, devices=devices)
    y_a, v_a, t_a, s_a = nonlinear_speedup_seq_parallel(jnp.asarray(x), cfg, mesh,
                                                        chip_smoke.RATE)
    ref = jax.jit(lambda u, l: batched_nonlinear_speedup(u, l, cfg, chip_smoke.RATE))(
        jnp.asarray(x)[None], jnp.asarray([L], jnp.int32))
    v_a, v_b = int(v_a), int(ref.valid_length[0])
    y_a, y_b = np.asarray(y_a)[:v_a], np.asarray(ref.output)[0, :v_b]
    t_a, t_b = np.asarray(t_a), np.asarray(ref.tension)[0]
    s_a, s_b = np.asarray(s_a, np.float64), np.asarray(ref.speeds)[0].astype(np.float64)
    nf = min(len(s_a), len(s_b))
    max_sb = _plan_max_speed(chip_smoke.RATE, 1.0)

    # Control: the sequence-parallel synthesis on the batched run's speeds.
    y_c, v_c = wsola_seq_parallel(jnp.asarray(x), jnp.asarray(s_b[:nf], jnp.float32),
                                  cfg, mesh, 1.0, max_sb)
    y_c = np.asarray(y_c)[: int(v_c)]

    hop, step = cfg.frame_step_int, cfg.frame_step_int
    minp, maxp = cfg.wsola_min_period, cfg.wsola_max_period
    G = wsola_fast.pitch_grid_stride(cfg, hop)
    K = -(-v_b // hop) + 1
    p = np.arange(K) * hop
    c_a = time_map(np.minimum(s_a[:nf], max_sb), step, p, length=L)
    c_b = time_map(np.minimum(s_b[:nf], max_sb), step, p, length=L)

    # Pitch grids of the shapes both paths compute: the whole utterance,
    # and each shard's G-aligned slice (wsola_seq_parallel's geometry).
    pgrid = jax.jit(lambda u: wsola_fast.pitch_period_grid(u, G, minp, maxp))
    whole = np.asarray(pgrid(jnp.asarray(x)[None]))[0].astype(np.float64)
    _, cap, Kp = wsola_fast.plan_grid(cfg, L, 1.0)
    n = len(devices)
    Kn = -(-Kp // n)
    front = maxp + hop + 64
    back = G // 2 + 2 * maxp + 2 * hop + 64
    L_shard = -(-int((Kn + 2) * hop * max_sb + front + back) // G) * G
    L_shard = min(L_shard, -(-(L + G) // G) * G)
    x_rep = np.concatenate([x, np.zeros(-(-L // G) * G + L_shard - L, np.float32)])
    c_sp = time_map(np.minimum(s_b[:nf], max_sb), step, np.arange(Kp) * hop)
    cells_w = {g: float(v) for g, v in enumerate(whole)}
    cells_s, owner = {}, np.zeros(K, int)
    for s in range(n):
        k_lo = max(s * Kn - 1, 0)
        s0 = int(max(c_sp[min(k_lo, Kp - 1)] - front, 0.0)) // G * G
        per = np.asarray(pgrid(jnp.asarray(x_rep[s0 : s0 + L_shard])[None]))[0]
        for i, v in enumerate(per):
            if s0 // G + i < len(whole):
                cells_s.setdefault(s, {})[s0 // G + i] = float(v)
        owner[s * Kn : (s + 1) * Kn] = s
    # End to end: each run's own time map, both reading the whole-grid
    # periods (the control shows the shard grids equal it).
    snap = {}
    for run, c in (("a", c_a), ("b", c_b)):
        cell = np.clip(np.round(c / G).astype(int), 0, len(whole) - 1)
        d = c[0] + p - c
        m_r = np.round(d / whole[cell])
        snap[run] = (whole[cell], m_r, c + d - m_r * whole[cell])
    g_idx = np.clip(np.round(c_b / G).astype(int), 0, len(whole) - 1)
    P_w = whole[g_idx]
    P_s = np.asarray([cells_s[owner[k]].get(g_idx[k], np.nan) for k in range(K)])
    delta = c_b[0] + p - c_b
    m = np.round(delta / P_w)
    m_s = np.round(delta / P_s)
    dP = P_s - P_w
    da = m * P_w - m_s * P_s
    cells_sh = {}
    for s in range(n):
        for g in set(g_idx[owner == s]):
            if g in cells_s[s]:
                cells_sh[g] = cells_s[s][g]
    res = {
        "utterance_s": L / sr,
        "devices": n,
        "output_diff": chip_smoke._diff_stats(y_a, y_b, hop),
        "tension_diff": _q(t_a[: len(t_b)] - t_b[: len(t_a)]),
        "speeds_diff": _q(s_a[:nf] - s_b[:nf]),
        "dc_from_speeds": _q(c_a - c_b),
        "control_same_speeds_output_diff": chip_smoke._diff_stats(y_c, y_b, hop),
        "m_max": float(np.nanmax(np.abs(m))),
        "period_cells_read": period_flip_ties(x, cells_sh, cells_w, cfg, G),
        "chunks_with_m_differing": int(np.sum(snap["a"][1] != snap["b"][1])),
        "slots": classify(bad_slots(y_a, y_b, hop), snap["a"][1] - snap["b"][1],
                          snap["a"][0] - snap["b"][0], snap["a"][2] - snap["b"][2],
                          snap["b"][1] * (snap["a"][0] - snap["b"][0]), c_a - c_b),
        "control_chunks_with_m_differing": int(np.nansum(m_s != m)),
        "control_slots": classify(bad_slots(y_c, y_b, hop), m_s - m, dP,
                                  da, m * dP, np.zeros(K)),
    }
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("stream", "seqpar"))
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    args = ap.parse_args(argv)
    from speedy_tpu.profiling import enable_compile_cache

    enable_compile_cache()
    res = run_stream() if args.mode == "stream" else run_seqpar()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"witness_{args.mode}.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
