"""Corpus batch engine: the throughput product (SURVEY.md §7 stage 7).

Turns the reference's one-stream-at-a-time C loop into a batched, sharded
device program: utterances are padded/bucketed, the analysis front-end runs
as one fused batched computation (not a vmap — so sharding constraints pin
real layouts), the speed law runs vmapped, and WSOLA consumes per-frame
speeds with the shim's flush-at-last-speed tail semantics. One jit per
(batch, length-bucket) shape, sharded over a (dp, tp) mesh:

  xs [B, L]            P('dp', None)        utterance data parallel
  frames [B, T, W]     P('dp', 'tp', None)  sequence parallel (frame axis)
  spectrogram [B,T,K]  P('dp', None, 'tp')  tensor parallel (DFT bins);
                                            the bin-energy reduction psums
                                            over 'tp'

(The algorithm has no layer stack or experts, so pp/ep have no counterpart
— SURVEY.md §2 identifies exactly these three parallel axes.)
"""

from __future__ import annotations

import functools
import warnings
from typing import List, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import config as C
from ..config import SpeedyConfig
from ..ops import dft, filters, framing, wsola, wsola_fast
from ..ops.speed import speed_from_tension, speed_from_tension_parallel


class BatchResult(NamedTuple):
    output: jnp.ndarray        # [B, capacity] float32
    valid_length: jnp.ndarray  # [B] int32
    tension: jnp.ndarray       # [B, T_out]
    speeds: jnp.ndarray        # [B, T_out]


def batched_analysis(
    xs: jnp.ndarray,
    cfg: SpeedyConfig,
    num_frames: int,
    mesh: Optional[Mesh] = None,
    gain: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Fused batched front-end: xs[B, L] -> tension[B, T_out].

    Semantically identical to vmap(ops.analysis.analyze) (tested), but
    structured as whole-batch tensor ops so mesh sharding constraints pin
    dp/sp/tp layouts and XLA fuses across the batch. Uses integer-step
    (shim) framing.

    gain [B] (optional): per-utterance input scale. Framing, preemphasis
    and the DFT are linear in the samples, so the scale is folded into
    the windowing multiply (`fw`) — equivalent to analyzing xs * gain
    (up to fp rounding) with no extra pass over xs.
    """
    dtype = xs.dtype
    B, L = xs.shape
    W = cfg.window_size
    fut = cfg.hysteresis_future
    T = num_frames
    T_out = cfg.num_tension_frames(T)

    def c(a, spec):
        if mesh is None:
            return a
        # Constraints are layout hints, not semantics: skip any the mesh
        # cannot legally apply (a dimension not divisible by its axis
        # size — e.g. an odd frame count under tp=2), instead of raising
        # mid-pipeline. GSPMD still propagates layouts from the
        # constraints that do apply.
        for d, ax in enumerate(spec):
            if ax is not None and a.shape[d] % mesh.shape[ax] != 0:
                return a
        return jax.lax.with_sharding_constraint(a, NamedSharding(mesh, spec))

    if T_out == 0:
        # Clip shorter than the tension lookahead: no tension frames exist
        # (the shim drains such audio at the requested speed on flush).
        return jnp.zeros((B, 0), dtype)

    # Batches not divisible by dp are zero-padded up front (the sharding
    # constraints need dp | B) and the padded rows trimmed on return —
    # mirrors _run_grid_engine.
    B0 = B
    if mesh is not None:
        pad = (-B) % mesh.shape["dp"]
        if pad:
            xs = jnp.concatenate([xs, jnp.zeros((pad, L), dtype)])
            if gain is not None:
                gain = jnp.concatenate(
                    [gain, jnp.ones((pad,), gain.dtype)]
                )
            B = B + pad

    xs = c(xs, P("dp", None))
    step = cfg.frame_step_int
    starts = jnp.asarray(framing.frame_starts(cfg, T, integer_step=True))
    # Integer-step frames are a REGULAR overlapping window: build them
    # from strided reshapes, not an element gather.
    m = -(-W // step)  # window spans m cells
    n_cells = T + m  # enough cells to cover frame T-1
    xs_pad = jnp.concatenate(
        [xs, jnp.zeros((B, n_cells * step - xs.shape[1]), dtype)], axis=1
    ) if n_cells * step > xs.shape[1] else xs[:, : n_cells * step]
    y = xs_pad.reshape(B, n_cells, step)
    frames = jnp.concatenate(
        [y[:, j : j + T] for j in range(m)], axis=-1
    )[:, :, :W]  # [B, T, W]
    prev_last = jnp.take(xs, starts[:-1] + (W - 1), axis=1, mode="clip")
    state = jnp.concatenate([jnp.zeros((B, 1), dtype), prev_last], axis=1)
    prev = jnp.concatenate([state[:, :, None], frames[:, :, :-1]], axis=2)
    pre = frames - jnp.asarray(C.PREEMPHASIS_COEF, dtype) * prev
    pre = c(pre, P("dp", "tp", None))  # sequence-parallel over frames

    win = jnp.asarray(dft.hamming_window(W, np.dtype(dtype).name))
    cos_m, sin_m = dft.dft_matrices(W, np.dtype(dtype).name)
    fw = pre * win[None, None, :]
    if gain is not None:
        fw = fw * gain.astype(dtype)[:, None, None]
    prec = dft.ANALYSIS_PRECISION
    re = jnp.dot(fw, jnp.asarray(cos_m), precision=prec)
    im = jnp.dot(fw, jnp.asarray(sin_m), precision=prec)
    spec = jnp.sqrt(re * re + im * im)  # [B, T, W+1]
    spec = c(spec, P("dp", None, "tp"))  # tensor-parallel over DFT bins

    half = spec[:, :, :W]
    energy = jnp.sum(half[:, :, 1:] ** 2, axis=-1)  # psums over 'tp'
    energy = c(energy, P("dp", None))
    energy_lp = filters.first_order_lowpass(
        energy, cfg.lpf_alpha, C.MEAN_SPECTROGRAM_ENERGY, axis=-1
    )
    energy_compressed = jnp.sqrt(jnp.minimum(energy / energy_lp, 2.0))

    # Tapered-max hysteresis, batched. The windows are REGULAR (frame t
    # reads t-past..t+fut), so build them from zero-padded static shifted
    # slices — XLA fuses the running max without the gather lowering that
    # jnp.take(t_idx + i) would produce.
    future_max = jnp.zeros((B, T_out), dtype)
    for i in range(fut + 1):
        if i >= T:  # whole window past the signal: zero contribution
            continue
        taper = (fut - i) / float(fut)
        sl = jax.lax.slice_in_dim(energy_compressed, i, min(i + T_out, T), axis=1)
        if sl.shape[1] < T_out:
            sl = jnp.concatenate(
                [sl, jnp.zeros((B, T_out - sl.shape[1]), dtype)], axis=1
            )
        future_max = jnp.maximum(future_max, sl * taper)
    past = cfg.hysteresis_past
    past_max = jnp.zeros((B, T_out), dtype)
    for i in range(past + 1):
        if i >= T_out:  # shift exceeds the output: zero contribution
            continue
        taper = (past - i) / float(past)
        sl = jax.lax.slice_in_dim(energy_compressed, 0, T_out - i, axis=1)
        sl = jnp.concatenate([jnp.zeros((B, i), dtype), sl], axis=1)
        past_max = jnp.maximum(past_max, sl * taper)
    energy_hyst = (past_max + future_max) / 2.0  # [B, T_out]

    cur = half[:, :T_out]
    last = jnp.concatenate(
        [jnp.zeros((B, 1, W), dtype), half[:, : T_out - 1]], axis=1
    )
    eps = jnp.asarray(C.EPS, dtype)
    sig_energy = jnp.sum(cur[:, :, 1:] ** 2, axis=-1)
    last_energy = jnp.sum(last[:, :, 1:] ** 2, axis=-1)
    normalized = cur / (jnp.sqrt(sig_energy)[..., None] + eps)
    normalized_last = last / (jnp.sqrt(last_energy)[..., None] + eps)
    bin_thresh = jnp.max(cur[:, :, 1:], axis=-1, keepdims=True) / 100.0
    mask = (cur[:, :, 1:] > bin_thresh) & (last[:, :, 1:] > bin_thresh)
    log_ratio = jnp.abs(
        jnp.log(
            (normalized[:, :, 1:] + eps) / (normalized_last[:, :, 1:] + eps)
        )
    )
    lsd_t = jnp.sum(jnp.where(mask, log_ratio, 0.0), axis=-1)

    skipped = (sig_energy <= cfg.low_energy_threshold) | (
        jnp.arange(T_out)[None, :] == 0
    )
    lsd = jnp.where(skipped, 0.0, lsd_t)
    ewld = lsd * energy_hyst
    ew_lpf = filters.first_order_lowpass(
        jnp.where(skipped, 0.0, ewld),
        cfg.lpf_alpha,
        C.MEAN_EMPHASIS_WEIGHTED_LOCAL_DIFFERENCE,
        axis=-1,
    )
    rsd = jnp.where(skipped, 0.0, ewld / (ew_lpf + 0.01 * C.MEAN_EMPHASIS_WEIGHTED_LPF))
    changes = jnp.where(skipped, 0.0, jnp.minimum(rsd, cfg.speech_changes_clamp))
    tension = C.TENSION_A * (energy_hyst - C.TENSION_M_E) + C.TENSION_B * (
        changes - C.TENSION_M_S
    )
    tension = c(tension, P("dp", None))
    return tension[:B0] if B0 != B else tension


def _plan_max_speed(global_speed: float, nonlinear_factor: float) -> float:
    """Planner ceiling on instantaneous speed (the analog of
    min_speed_bound): the grid engine clamps speeds to it.

    The law bounds the requested speed at 1.6*R_g - 0.6 for R_g > 1
    (tension >= -0.6) and at 1.0 for R_g <= 1; +1.0 covers the duration-
    feedback correction (fb*excess stays well under that for the
    reference's fb <= 0.4 on convergent inputs — pathological inputs hit
    the clamp, a documented planner contract, not an error). The shim's
    nonlinear interpolation final = req*nl + R_g*(1-nl) can EXCEED req
    when nl > 1, so the bound is mapped through it. Quantized to 0.5
    steps so sweeping rates reuses compiled programs."""
    rg = float(global_speed)
    nl = float(nonlinear_factor)
    req_max = 1.6 * rg - 0.6 + 1.0 if rg > 1.0 else 2.0
    final_max = max(req_max * nl + rg * (1.0 - nl), req_max, rg, 2.0)
    return float(np.ceil(final_max * 2.0) / 2.0)


def _run_grid_engine(
    xs: jnp.ndarray,
    lengths: jnp.ndarray,
    speeds: jnp.ndarray,
    minp: int,
    maxp: int,
    step: int,
    hop: int,
    gcap: int,
    K: int,
    max_speed_plan: Optional[float],
    mesh: Optional[Mesh],
    xs_channels: Optional[jnp.ndarray] = None,
    gain: Optional[jnp.ndarray] = None,
) -> wsola.WsolaResult:
    """Dispatch the grid WSOLA engine, sharded over the mesh's 'dp' axis.

    Under a mesh the engine runs inside `jax.shard_map`: every stage is
    batch-independent, so sharding the batch axis is mechanical — each
    device runs the identical program on its B/dp rows, with no
    collectives. Replicated over any other mesh axes ('tp').

    Batches not divisible by dp are zero-padded (padded rows have
    length 0 -> valid 0 -> all-zero output) and trimmed on return.
    """
    if mesh is None:
        return wsola_fast._wsola_grid_batch(
            xs, lengths, speeds, minp, maxp, step, hop, gcap, K,
            xs_channels=xs_channels, max_speed_plan=max_speed_plan,
            gain=gain,
        )
    dp = mesh.shape["dp"]
    B = xs.shape[0]
    pad = (-B) % dp
    if pad:
        xs = jnp.concatenate([xs, jnp.zeros((pad, xs.shape[1]), xs.dtype)])
        lengths = jnp.concatenate(
            [lengths, jnp.zeros((pad,), lengths.dtype)]
        )
        # Padded rows never emit output (valid=0); speed 1 keeps the time
        # map's 1/s finite.
        speeds = jnp.concatenate(
            [speeds, jnp.ones((pad, speeds.shape[1]), speeds.dtype)]
        )
        if xs_channels is not None:
            xs_channels = jnp.concatenate(
                [
                    xs_channels,
                    jnp.zeros((pad,) + xs_channels.shape[1:], xs_channels.dtype),
                ]
            )
    has_gain = gain is not None
    if has_gain and pad:
        gain = jnp.concatenate([gain, jnp.zeros((pad,), gain.dtype)])
    args = [xs, lengths, speeds]
    in_specs = [P("dp", None), P("dp"), P("dp", None)]
    if has_gain:
        args.append(gain)
        in_specs.append(P("dp"))
    if xs_channels is None:
        out_specs = wsola.WsolaResult(P("dp", None), P("dp"), P("dp"))
    else:
        args.append(xs_channels)
        in_specs.append(P("dp", None, None))
        out_specs = wsola.WsolaResult(P("dp", None, None), P("dp"), P("dp"))

    def body(x, l, s, *rest):
        rest = list(rest)
        g = rest.pop(0) if has_gain else None
        return wsola_fast._wsola_grid_batch(
            x, l, s, minp, maxp, step, hop, gcap, K,
            xs_channels=rest.pop(0) if rest else None,
            max_speed_plan=max_speed_plan,
            gain=g,
        )

    out = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=out_specs,
    )(*args)
    if pad:
        out = wsola.WsolaResult(
            out.output[:B], out.valid_length[:B], out.steps_used[:B]
        )
    return out


def _mask_speeds(speeds: jnp.ndarray, valid_tension: jnp.ndarray) -> jnp.ndarray:
    """Hold the last valid frame's speed through the padded tail, mirroring
    the shim's flush-at-last-speed (soniclib.c:538-551)."""
    t = speeds.shape[0]
    idx = jnp.arange(t)
    last = jnp.maximum(valid_tension - 1, 0)
    return jnp.where(idx < valid_tension, speeds, speeds[last])


def _speeds_for(
    tension: jnp.ndarray,
    lengths: jnp.ndarray,
    cfg: SpeedyConfig,
    global_speed: float,
    nonlinear_factor: float,
    duration_feedback_strength: float,
    min_speed_bound: float,
) -> jnp.ndarray:
    """tension[B, T_out] -> per-frame speeds[B, T_out'] for the grid and
    scan engines: the speed law, the shim's flush-at-last-speed tail,
    and the planner's min_speed_bound floor."""
    B = tension.shape[0]
    dtype = tension.dtype
    W, step, fut = cfg.window_size, cfg.frame_step_int, cfg.hysteresis_future
    with jax.named_scope("speed_law"):
        if tension.shape[1] == 0:
            # Entire batch shorter than the tension lookahead: every frame
            # drains at the requested speed (the shim's flush behavior).
            speeds = jnp.full((B, 1), global_speed, dtype)
        elif global_speed > 1.0:
            # Parallel fixed-point form (contraction only holds for rg > 1).
            speeds = speed_from_tension_parallel(
                tension, global_speed, duration_feedback_strength,
                nonlinear_factor,
            )
        else:
            speeds, _ = jax.vmap(
                lambda t: speed_from_tension(
                    t, global_speed, duration_feedback_strength,
                    nonlinear_factor,
                )
            )(tension)
        valid_frames = jnp.where(lengths >= W, (lengths - W) // step + 1, 0)
        valid_tension = jnp.minimum(
            jnp.maximum(valid_frames - fut, 0), speeds.shape[1]
        )
        speeds = jax.vmap(_mask_speeds)(speeds, valid_tension)
        # Utterances too short for any tension frame run at the global
        # speed.
        speeds = jnp.where(
            (valid_tension > 0)[:, None], speeds,
            jnp.asarray(global_speed, dtype),
        )
        # Honor the planner's contract: output capacity and trip count
        # are sized by min_speed_bound, so instantaneous speeds are
        # floored there (a no-op for global speedups, where the law
        # already guarantees >= 1; for slowdowns the reference-exact
        # unclamped law is available via the streaming/pipeline paths, or
        # by passing a smaller bound).
        return jnp.maximum(speeds, jnp.asarray(min_speed_bound, dtype))


def grid_output_capacity(
    cfg: SpeedyConfig,
    L: int,
    global_speed: float,
    capacity_factor: Optional[float] = None,
    min_speed_bound: Optional[float] = None,
) -> int:
    """The grid engine's output capacity for a length-L utterance — the
    exact value batched_nonlinear_speedup sizes its output buffer with
    (worst-case plan, or rate-derived when capacity_factor applies).
    Serving code uses it to preallocate and to check the truncation
    contract (valid_length == capacity) against a known bound."""
    if min_speed_bound is None:
        min_speed_bound = 1.0 if global_speed >= 1.0 else max(C.MIN_SPEED, 0.3 * global_speed)
    hop, gcap, _ = wsola_fast.plan_grid(cfg, L, min_speed_bound)
    if capacity_factor is not None and global_speed > 1.0:
        # Quantized to hop multiples, never above the worst-case plan,
        # floored at a few hops so degenerate factors stay runnable.
        tight = int(np.ceil(capacity_factor * L / global_speed / hop) + 2) * hop
        if tight < gcap:
            gcap = tight
    return gcap


def batched_nonlinear_speedup(
    xs: jnp.ndarray,
    lengths: jnp.ndarray,
    cfg: SpeedyConfig,
    global_speed: float,
    nonlinear_factor: float = 1.0,
    duration_feedback_strength: float = 0.1,
    min_speed_bound: Optional[float] = None,
    mesh: Optional[Mesh] = None,
    capacity: Optional[int] = None,
    num_steps: Optional[int] = None,
    engine: str = "grid",
    gain: Optional[jnp.ndarray] = None,
    capacity_factor: Optional[float] = None,
) -> BatchResult:
    """One device step: xs[B, L] float32 (±1), lengths[B] -> sped-up audio.

    Jit-compatible (close over the static args or use compile_batch_step).
    engine: "grid" (parallel WSOLA, the throughput path) or "scan"
    (sonic-exact sequential algebra).

    gain [B] (optional): per-utterance input scale (sonicSetVolume-style,
    classic sonic.c's volume control that the sonic2 shim dropped).
    Folded into the pipeline's first copies of xs (analysis windowing,
    WSOLA pad/pitch-grid builds) — same result as passing
    xs * gain[:, None] up to fp rounding.

    capacity_factor (optional, serving knob — grid engine, global_speed
    > 1 only): size the output capacity at factor * L / global_speed
    instead of the worst-case speed-1.0 plan. The duration feedback
    drives total output duration to ~L/global_speed on convergent audio
    (the +-14 ms length gates at every rate 1.1-6.3), so the worst-case
    plan leaves ~(1 - 1/rate) of the output buffer dead at speedups, and
    every K-proportional stage (time-map inversion, phase snap,
    synthesis, the final mask pass over [B, capacity]) pays for it.
    CONTRACT: output samples past capacity are dropped and valid_length
    clamps at capacity — tension-saturated inputs can legitimately run
    slower than the global rate (the law only bounds speed >=
    1 + MIN_SPEED with feedback on), so a truncated utterance reports
    valid_length == capacity exactly; callers sizing the factor for
    their corpus should treat that value as the retry-with-a-bigger-
    factor signal (1.5 holds with >20% margin on the speech/noise/chirp
    bench families at 3.5x). Ignored when `capacity` is given or
    global_speed <= 1. grid_output_capacity exposes the planned cap.
    """
    B, L = xs.shape
    step = cfg.frame_step_int
    T = cfg.num_frames(L, integer_step=True)
    if min_speed_bound is None:
        min_speed_bound = 1.0 if global_speed >= 1.0 else max(C.MIN_SPEED, 0.3 * global_speed)
    minp, maxp, cap, steps = wsola.plan(cfg, L, min_speed_bound)
    if capacity is not None:
        cap = capacity
    if num_steps is not None:
        steps = num_steps

    with jax.named_scope("analysis"):
        tension = batched_analysis(xs, cfg, T, mesh, gain=gain)
    speeds = _speeds_for(
        tension, lengths, cfg, global_speed, nonlinear_factor,
        duration_feedback_strength, min_speed_bound,
    )

    if engine == "grid":
        hop, gcap, K = wsola_fast.plan_grid(cfg, L, min_speed_bound)
        if capacity is not None:
            gcap, K = capacity, capacity // hop + 1
        elif capacity_factor is not None and global_speed > 1.0:
            # Rate-derived capacity (see docstring / grid_output_capacity).
            tight = grid_output_capacity(
                cfg, L, global_speed, capacity_factor, min_speed_bound
            )
            if tight < gcap:
                gcap, K = tight, tight // hop + 1
        max_speed_plan = _plan_max_speed(global_speed, nonlinear_factor)
        out = _run_grid_engine(
            xs, lengths.astype(jnp.int32), speeds, minp, maxp, step, hop,
            gcap, K, max_speed_plan, mesh, gain=gain,
        )
    else:
        if gain is not None:
            xs = xs * gain.astype(xs.dtype)[:, None]
        out = jax.vmap(
            lambda x, s, l: wsola._wsola_scan(
                x, l.astype(jnp.int32), s, minp, maxp, step, cap, steps
            )
        )(xs, speeds, lengths)
    return BatchResult(out.output, out.valid_length, tension, speeds)


@functools.lru_cache(maxsize=32)
def compile_batch_step(
    cfg: SpeedyConfig,
    batch: int,
    length: int,
    global_speed: float,
    nonlinear_factor: float = 1.0,
    duration_feedback_strength: float = 0.1,
    min_speed_bound: Optional[float] = None,
    use_mesh: bool = False,
    tp: int = 1,
    capacity_factor: Optional[float] = None,
):
    """Jit the batch step for a fixed (batch, length) bucket."""
    mesh = None
    if use_mesh:
        from .mesh import make_mesh

        mesh = make_mesh(tp=tp)

    def fn(xs, lengths):
        return batched_nonlinear_speedup(
            xs,
            lengths,
            cfg,
            global_speed,
            nonlinear_factor,
            duration_feedback_strength,
            min_speed_bound,
            mesh,
            capacity_factor=capacity_factor,
        )

    return jax.jit(fn)


@functools.lru_cache(maxsize=256)
def _device_zero_extend(n: int, target: int, dtype_name: str):
    """Tiny jitted zero-extend: flat[n] -> flat[target] on device. Keyed
    per (n, target) but compiles in seconds (vs minutes for the pipeline
    program), so the BIG packed step below can key on (B, L) only —
    every batch's exact-size wire transfer feeds one shared program."""
    assert target >= n

    def f(flat):
        return jnp.concatenate(
            [flat, jnp.zeros((target - n,), jnp.dtype(dtype_name))]
        )

    return jax.jit(f)


@functools.lru_cache(maxsize=256)
def _device_head_slice(n: int, head: int, dtype_name: str):
    """Tiny jitted head slice: flat[n] -> flat[head] on device — the
    down-wire twin of _device_zero_extend. The packed step leaves its
    compacted output on device; the host fetches ONLY the quantized
    occupied prefix through this seconds-to-compile program, so the
    down-wire ships ~sum(valid) samples instead of the full [B, cap]
    buffer (about twice the real output bytes on a 2-90 s corpus)."""
    assert 0 < head <= n

    def f(flat):
        return jax.lax.slice(flat, (0,), (head,))

    return jax.jit(f)


@functools.lru_cache(maxsize=64)
def compile_packed_batch_step(
    cfg: SpeedyConfig,
    batch: int,
    length: int,
    global_speed: float,
    nonlinear_factor: float = 1.0,
    duration_feedback_strength: float = 0.1,
    min_speed_bound: Optional[float] = None,
    use_mesh: bool = False,
    tp: int = 1,
    capacity_factor: Optional[float] = None,
    int16_wire: bool = False,
):
    """Packed-wire bucket step (CorpusEngine staging).

    The padded f32 [B, bucket_L] layout would ship bucket padding (2-2.5x
    the real samples at typical length spreads) at 4 bytes/sample across
    the host link. So the wire carries only the REAL samples, concatenated flat (int16 verbatim
    when the corpus is 16-bit PCM — lossless, the reference's
    sonicWriteShortToStream serving format, soniclib.c:496,516 — else
    float32, also lossless), and the padded [B, L] f32 layout is built
    ON DEVICE: one contiguous static-width dynamic_slice per row at its
    host-known offset, masked by the row's length (over-read beyond an
    utterance is masked off; flat is padded by one bucket so slices
    never clamp). Outputs return in the same wire dtype: int16 batches
    fetch clip(round(y*2^15)) — the shim's float->short rule, bit-equal
    to host-side quantization of the f32 path's output (gated in
    tests/test_parallel.py::test_corpus_packed_wire_bit_exact).
    The flat argument has the FIXED shape [(batch+1)*length]: the caller
    ships the exact wire bytes (a transfer, which never compiles) and
    zero-extends on device via _device_zero_extend, so this program is
    keyed on (B, L) alone — the extra
    bucket of zero tail also guarantees the per-row slices never
    clamp."""
    mesh = None
    if use_mesh:
        from .mesh import make_mesh

        mesh = make_mesh(tp=tp)

    def fn(flat, offsets, lengths):
        def row(off, n):
            r = jax.lax.dynamic_slice(flat, (off,), (length,))
            r = r.astype(jnp.float32)
            if int16_wire:
                r = r / 32768.0  # add_data_short (soniclib.c:496)
            return jnp.where(jnp.arange(length) < n, r, 0.0)

        xs = jax.vmap(row)(offsets, lengths)
        out = batched_nonlinear_speedup(
            xs,
            lengths,
            cfg,
            global_speed,
            nonlinear_factor,
            duration_feedback_strength,
            min_speed_bound,
            mesh,
            capacity_factor=capacity_factor,
        )
        y = out.output
        if int16_wire:
            y = jnp.clip(jnp.round(y * 32768.0), -32768, 32767).astype(jnp.int16)
        valid = out.valid_length.astype(jnp.int32)
        # DOWN-WIRE COMPACTION (the inverse of the row builder above):
        # each row's valid samples land at its exclusive-cumsum offset in
        # one flat buffer, so the host can fetch exactly the occupied
        # prefix (via _device_head_slice) instead of the padded [B, cap]
        # buffer. Rows are zero-masked beyond valid and written in
        # ascending order: row k's dead tail [off_k+valid_k, off_k+cap)
        # is fully covered by row k+1's window (off_{k+1} = off_k+valid_k
        # and valid_k <= cap), so after the last row every position below
        # sum(valid) holds real data. The buffer keeps the same
        # (B+1)*cap slack shape family as the input so the final row's
        # window never clamps. Mirrors the read-side contract of
        # soniclib.c:519-527 — reads return exactly the available
        # samples, nothing more.
        cap = y.shape[1]
        lanes = jnp.arange(cap, dtype=jnp.int32)
        yz = jnp.where(lanes[None, :] < valid[:, None], y, 0)
        offs = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(valid)[:-1]]
        )
        flat0 = jnp.zeros(((batch + 1) * cap,), y.dtype)

        def place(flat, row_off):
            row, off = row_off
            return jax.lax.dynamic_update_slice(flat, row, (off,)), None

        flat_out, _ = jax.lax.scan(place, flat0, (yz, offs))
        return flat_out, valid

    return jax.jit(fn)


def batched_nonlinear_speedup_multichannel(
    xs: jnp.ndarray,
    lengths: jnp.ndarray,
    cfg: SpeedyConfig,
    global_speed: float,
    nonlinear_factor: float = 1.0,
    duration_feedback_strength: float = 0.1,
    min_speed_bound: Optional[float] = None,
    mesh: Optional[Mesh] = None,
    gain: Optional[jnp.ndarray] = None,
    capacity_factor: Optional[float] = None,
) -> BatchResult:
    """Multichannel batch step: xs[B, L, C] -> output[B, C, capacity].

    Analysis runs on the channel mean (the shim's mixdown, soniclib.c:
    262-287); every channel is resynthesized with the mono-derived pitch
    and phase positions, so identical channels stay identical.
    gain [B] (optional): fused per-utterance input scale (see
    batched_nonlinear_speedup). capacity_factor: rate-derived output
    capacity, same contract as batched_nonlinear_speedup."""
    B, L, C = xs.shape
    mono = jnp.mean(xs, axis=2)
    T = cfg.num_frames(L, integer_step=True)
    if min_speed_bound is None:
        min_speed_bound = 1.0 if global_speed >= 1.0 else max(C_MIN, 0.3 * global_speed)
    minp, maxp, _, _ = wsola.plan(cfg, L, min_speed_bound)
    with jax.named_scope("analysis"):
        tension = batched_analysis(mono, cfg, T, mesh, gain=gain)
    speeds = _speeds_for(
        tension, lengths, cfg, global_speed, nonlinear_factor,
        duration_feedback_strength, min_speed_bound,
    )
    hop, gcap, K = wsola_fast.plan_grid(cfg, L, min_speed_bound)
    if capacity_factor is not None and global_speed > 1.0:
        tight = grid_output_capacity(
            cfg, L, global_speed, capacity_factor, min_speed_bound
        )
        if tight < gcap:
            gcap, K = tight, tight // hop + 1
    out = _run_grid_engine(
        mono,
        lengths.astype(jnp.int32),
        speeds,
        minp,
        maxp,
        cfg.frame_step_int,
        hop,
        gcap,
        K,
        _plan_max_speed(global_speed, nonlinear_factor),
        mesh,
        xs_channels=jnp.transpose(xs, (0, 2, 1)),
        gain=gain,
    )
    return BatchResult(out.output, out.valid_length, tension, speeds)


C_MIN = C.MIN_SPEED


class CorpusEngine:
    """Process a corpus of variable-length utterances at maximum throughput.

    Buckets utterances by padded length (powers-of-two quantization), runs
    one compiled sharded step per bucket batch, and reassembles results in
    input order. This is the rebuild's answer to the reference tests'
    serial file loops (sonic_classic_test.cc:529-534).

    Wire design: host<->device transfers carry only the REAL samples — each bucket batch ships one flat concat
    buffer + offsets (int16 verbatim for 16-bit PCM corpora, the
    reference's serving format; float32 otherwise — both lossless) and
    the padded [B, L] layout is built on device; outputs return in the
    same wire dtype (int16 corpora get int16 results via the shim's
    clip(round(y*2^15)) rule, bit-equal to quantizing the float path's
    output). int16_wire=False forces float32 both ways. See
    compile_packed_batch_step."""

    def __init__(
        self,
        cfg: SpeedyConfig,
        global_speed: float,
        nonlinear_factor: float = 1.0,
        duration_feedback_strength: float = 0.1,
        batch_size: int = 8,
        use_mesh: bool = False,
        tp: int = 1,
        capacity_factor: Optional[float] = None,
        long_utterance_samples: Optional[int] = 1 << 19,
        stream_batch: int = 8,
        stream_kw: Optional[dict] = None,
        int16_wire: bool = True,
        bucket_ratio: float = 2.0,
    ):
        self.cfg = cfg
        self.global_speed = float(global_speed)
        self.nonlinear_factor = float(nonlinear_factor)
        self.feedback = float(duration_feedback_strength)
        self.batch_size = batch_size
        self.use_mesh = use_mesh
        self.tp = tp
        # Rate-derived output capacity (see batched_nonlinear_speedup's
        # capacity_factor contract). Utterances that hit the cap report
        # valid_length == capacity; CorpusEngine retries those with the
        # worst-case plan so results are always complete.
        self.capacity_factor = capacity_factor
        # Utterances longer than this bypass the batch engine entirely
        # and run through the O(1)-state device streaming pipeline: the
        # batched engine's output clock is an f32 cumsum (drift ~sqrt(F)
        # ulps) and its time map is O(K*F), so minutes-long files belong
        # to streaming, not ever-doubling padded buckets. 2^19 samples =
        # ~33 s at 16 kHz. NOTE use_mesh/tp/capacity_factor do not apply
        # to streamed utterances and their samples differ from the batch
        # engine's at float rounding level (gated to max|d| < 5e-3 vs
        # batch). None disables rerouting (everything stays in padded
        # buckets).
        self.long_utterance_samples = (
            None if long_utterance_samples is None else int(long_utterance_samples)
        )
        # Long utterances stream CONCURRENTLY through a shared
        # MultiStreamPipeline (stream_batch lanes, shared fixed-shape
        # dispatches — per-lane outputs are bit-identical to the
        # single-stream pipeline, gated in tests/test_multistream.py).
        # stream_batch=1 restores the serial single-stream path.
        # stream_kw forwards chunk_frames/segment_frames overrides to
        # both streaming paths (testing/tuning knob).
        self.stream_batch = max(1, int(stream_batch))
        self.stream_kw = dict(stream_kw or {})
        # Packed-wire staging dtype policy (see compile_packed_batch_step):
        # batches whose every utterance is 1-D int16 ship int16 BOTH ways
        # (lossless; results for those utterances come back int16, the
        # reference's PCM serving contract). Float utterances always ship
        # and return float32 — quantizing floats would break the f32
        # quality gates. False
        # forces float32 wire and float32 results everywhere.
        self.int16_wire = bool(int16_wire)
        # Bucket ladder ratio: padded length quantization is geometric
        # from 4096 with this ratio (2.0 = the classic power-of-two
        # ladder). Finer ratios (1.25/1.5) cut device padding waste
        # multiplicatively (process() groups batches BY BUCKET, so
        # within-batch spread is bounded by the ratio) at the price of
        # more (B, L) program keys (one warm compile each, amortized by
        # enable_compile_cache) and more per-batch dispatches.
        assert bucket_ratio > 1.0
        self.bucket_ratio = float(bucket_ratio)
        self._ms: dict = {}  # wire dtype -> pipeline, reused across process()
        # Observability (reset per process() call): batches dispatched,
        # utterances that hit the rate-derived cap and were retried,
        # retry batches dispatched, utterances routed to streaming, and
        # the streamed path's dispatch/work counters (shared-dispatch
        # multiplexing shows as work >> dispatches).
        self.stats = {
            "batches": 0,
            "capacity_retries": 0,
            "retry_batches": 0,
            "streamed_long": 0,
            "stream_chunk_dispatches": 0,
            "stream_chunks": 0,
            "stream_segment_dispatches": 0,
            "stream_segments": 0,
            "wire_up_bytes": 0,
            "wire_down_bytes": 0,
        }

    def _bucket_length(self, n: int) -> int:
        """Smallest ladder value >= n: b_k = 4096 * ratio^k rounded up
        to a 1024 multiple (stable keys for the program cache)."""
        b, exact = 4096, 4096.0
        while b < n:
            exact *= self.bucket_ratio
            b = -(-int(np.ceil(exact)) // 1024) * 1024
        return b

    @staticmethod
    def _to_float(u: np.ndarray) -> np.ndarray:
        u = np.asarray(u)
        if u.dtype == np.int16:
            u = u.astype(np.float32) / 32768.0
        return u.astype(np.float32)

    def _process_streaming(self, u: np.ndarray) -> np.ndarray:
        from ..streaming_device import DeviceStreamingPipeline

        pipe = DeviceStreamingPipeline(
            self.cfg,
            self.global_speed,
            self.nonlinear_factor,
            self.feedback,
            **self.stream_kw,
        )
        head = pipe.feed(self._to_float(u))
        tail = pipe.flush()
        return np.concatenate([head, tail])

    def _get_multistream(self, int16: bool = False):
        if self._ms.get(int16) is None:
            from ..multistream import MultiStreamPipeline

            self._ms[int16] = MultiStreamPipeline(
                self.cfg,
                self.global_speed,
                n_streams=self.stream_batch,
                nonlinear_factor=self.nonlinear_factor,
                duration_feedback_strength=self.feedback,
                wire_dtype="int16" if int16 else "float32",
                **self.stream_kw,
            )
        return self._ms[int16]

    def _process_streaming_many(self, items) -> dict:
        """Stream several long utterances CONCURRENTLY: a slot-recycling
        work queue over the shared MultiStreamPipeline — every lane's
        chunks/segments ride the same fixed-shape dispatches, so M long
        files cost ~M/stream_batch of the serial path's dispatch floor.
        items: [(result index, raw utterance)]; returns {index: output}.
        Per-utterance outputs are bit-identical to the single-stream
        path (the multistream equality gate)."""
        from collections import deque

        # int16 corpora ride the multistream pipeline's int16 PCM wire
        # (feeds verbatim, outputs device-quantized) — the same lossless
        # wire rule as the bucket path.
        i16 = self.int16_wire and all(
            np.asarray(u).ndim == 1 and np.asarray(u).dtype == np.int16
            for _, u in items
        )
        ms = self._get_multistream(i16)
        snap = dict(ms.stats)
        feed = ms.Fseg * ms.step  # one segment's samples per round
        queue = deque(items)
        active = {}  # sid -> [result index, wire-dtype audio, position, outs]
        results: dict = {}
        while queue or active:
            while queue and ms.n_active < ms.n_slots:
                j, u = queue.popleft()
                active[ms.open()] = [
                    j, np.asarray(u) if i16 else self._to_float(u), 0, []
                ]
            pairs = []
            for sid, st in active.items():
                chunk = st[1][st[2] : st[2] + feed]
                self.stats["wire_up_bytes"] += chunk.nbytes
                pairs.append((sid, chunk))
                st[2] += feed
            drains = ms.feed_many(pairs)
            self.stats["wire_down_bytes"] += sum(d.nbytes for d in drains.values())
            done = []
            for sid, st in active.items():
                st[3].append(drains[sid])
                if st[2] >= len(st[1]):
                    st[3].append(ms.flush(sid))
                    results[st[0]] = np.concatenate(st[3])
                    done.append(sid)
            for sid in done:
                del active[sid]
        for k_ms, k_st in (
            ("chunk_dispatches", "stream_chunk_dispatches"),
            ("chunks_processed", "stream_chunks"),
            ("segment_dispatches", "stream_segment_dispatches"),
            ("segments_processed", "stream_segments"),
        ):
            self.stats[k_st] += ms.stats[k_ms] - snap[k_ms]
        return results

    def _run_bucket_packed(self, batch, capacity_factor):
        """Dispatch one bucket batch through the packed-wire step: only
        the REAL samples cross the host link in BOTH directions (flat concat
        up, int16 when the whole batch is 16-bit PCM; device-compacted
        valid-prefix down via _device_head_slice), the padded layout is
        built on device, and outputs return in wire dtype. Returns
        (rows, valid, cap): per-utterance output arrays (views into the
        fetched flat buffer), the valid-length vector, and the device
        capacity (valid[k] >= cap means the rate-derived plan truncated
        row k — the caller's retry contract)."""
        i16 = self.int16_wire and all(
            np.asarray(u).ndim == 1 and np.asarray(u).dtype == np.int16
            for u in batch
        )
        dt = np.int16 if i16 else np.float32
        lengths = np.asarray([len(u) for u in batch], np.int32)
        L = self._bucket_length(int(lengths.max()))
        total = int(lengths.sum())
        # The wire carries the EXACT bytes (transfers never compile);
        # the device zero-extends to the step's fixed (B+1)*L flat shape
        # via a seconds-to-compile tiny program, so the pipeline program
        # compiles once per (B, L) bucket regardless of batch fill. A
        # small host-side quantum keeps even the tiny-program key count
        # low (<= 128 KB of zero padding on the wire).
        q = min(65536, L)
        flat_len = -(-total // q) * q
        flat = np.zeros((flat_len,), dt)
        offsets = np.zeros((len(batch),), np.int32)
        pos = 0
        for k, u in enumerate(batch):
            u = np.asarray(u) if i16 else self._to_float(u)
            offsets[k] = pos
            flat[pos : pos + len(u)] = u
            pos += len(u)
        target = (len(batch) + 1) * L
        assert flat_len <= target  # q <= L guarantees it
        flat_d = _device_zero_extend(flat_len, target, dt.__name__)(
            jnp.asarray(flat)
        )
        step_fn = compile_packed_batch_step(
            self.cfg,
            len(batch),
            L,
            self.global_speed,
            self.nonlinear_factor,
            self.feedback,
            None,
            self.use_mesh,
            self.tp,
            capacity_factor,
            i16,
        )
        flat_out_d, valid_d = step_fn(
            flat_d, jnp.asarray(offsets), jnp.asarray(lengths)
        )
        # Two-fetch down-wire: the tiny valid vector first (its size
        # tells the host the exact occupied prefix), then ONLY that
        # prefix (host-quantized so the head-slice program cache stays
        # small) — ~sum(valid) samples instead of the full [B, cap]
        # buffer, for one extra dispatch and fetch per batch.
        valid = np.asarray(valid_d)
        flat_shape = int(flat_out_d.shape[0])
        cap = flat_shape // (len(batch) + 1)
        total = int(valid.sum())
        if total > 0:
            tq = min(-(-total // q) * q, flat_shape)
            head = _device_head_slice(flat_shape, tq, dt.__name__)(flat_out_d)
            flat_out = np.asarray(head)
        else:
            flat_out = np.zeros((0,), dt)
        self.stats["wire_up_bytes"] += flat.nbytes + offsets.nbytes + lengths.nbytes
        self.stats["wire_down_bytes"] += flat_out.nbytes + valid.nbytes
        ends = np.cumsum(valid)
        starts = ends - valid
        rows = [flat_out[s:e] for s, e in zip(starts, ends)]
        return rows, valid, cap

    def process(self, utterances: Sequence[np.ndarray]) -> List[np.ndarray]:
        for k in self.stats:
            self.stats[k] = 0
        results: List[Optional[np.ndarray]] = [None] * len(utterances)

        # Very long utterances -> streaming pipeline (bounded memory, no
        # padded power-of-two bucket, exact-seam continuation engine).
        # Several of them stream CONCURRENTLY in shared dispatches via
        # MultiStreamPipeline (multichannel long files take the
        # single-stream path — the shared multistream plan is mono here).
        batched_idx = []
        long_mono = []
        for j, u in enumerate(utterances):
            if (
                self.long_utterance_samples is not None
                and len(u) > self.long_utterance_samples
            ):
                self.stats["streamed_long"] += 1
                if self.stream_batch > 1 and np.asarray(u).ndim == 1:
                    long_mono.append((j, u))
                else:
                    results[j] = self._process_streaming(u)
            else:
                batched_idx.append(j)
        if len(long_mono) == 1:
            j, u = long_mono[0]
            results[j] = self._process_streaming(u)
        elif long_mono:
            for j, y in self._process_streaming_many(long_mono).items():
                results[j] = y

        # Batches are grouped BY BUCKET (not just sorted): within-batch
        # padding spread is then bounded by the ladder ratio, so a finer
        # bucket_ratio cuts device padding waste directly. Sorting inside
        # each bucket keeps lengths adjacent for the capacity plan.
        order = sorted(batched_idx, key=lambda j: len(utterances[j]))
        by_bucket: dict = {}
        for j in order:
            by_bucket.setdefault(
                self._bucket_length(len(utterances[j])), []
            ).append(j)
        # (bucket_L) -> list of result indices: inputs whose rate-derived
        # capacity truncated, re-run BATCHED under the worst-case plan
        # after the main sweep (round-2 retried at B=1 per utterance — a
        # tension-saturated corpus degraded quietly).
        retry: dict = {}
        batch_groups = [
            grp[i : i + self.batch_size]
            for _, grp in sorted(by_bucket.items())
            for i in range(0, len(grp), self.batch_size)
        ]
        for idxs in batch_groups:
            batch = [utterances[j] for j in idxs]
            L = self._bucket_length(max(len(u) for u in batch))
            rows, valid, cap = self._run_bucket_packed(batch, self.capacity_factor)
            self.stats["batches"] += 1
            for k, j in enumerate(idxs):
                if self.capacity_factor is not None and valid[k] >= cap:
                    retry.setdefault(L, []).append(j)
                else:
                    results[j] = rows[k]

        if retry:
            n_retry = sum(len(v) for v in retry.values())
            self.stats["capacity_retries"] = n_retry
            warnings.warn(
                f"CorpusEngine: {n_retry} utterance(s) hit the rate-derived "
                f"output cap (capacity_factor={self.capacity_factor}) and were "
                "re-run under the worst-case plan; raise capacity_factor if "
                "this is common in your corpus",
                RuntimeWarning,
                stacklevel=2,
            )
        for L, items in retry.items():
            for i in range(0, len(items), self.batch_size):
                chunk = items[i : i + self.batch_size]
                rows, valid, cap = self._run_bucket_packed(
                    [utterances[j] for j in chunk], None
                )
                self.stats["retry_batches"] += 1
                for k, j in enumerate(chunk):
                    results[j] = rows[k]

        # Per-utterance dtype contract: int16 in -> int16 out whenever
        # int16_wire is on, regardless of which path (mixed bucket batch,
        # serial streaming fallback) produced a float result — host
        # quantization uses the identical clip(round(y*2^15)) rule on the
        # identical f32 values, so this matches the device-quantized
        # paths bit-for-bit.
        if self.int16_wire:
            for j, u in enumerate(utterances):
                y = results[j]
                if (
                    y is not None
                    and y.dtype != np.int16
                    and np.asarray(u).ndim == 1
                    and np.asarray(u).dtype == np.int16
                ):
                    results[j] = np.clip(
                        np.round(y * 32768.0), -32768, 32767
                    ).astype(np.int16)
        return results  # type: ignore
