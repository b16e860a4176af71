"""WSOLA time-scale modification: the JAX rebuild of libsonic's
pitch-synchronous resynthesis engine (component C19 in SURVEY.md).

The reference consumes the external libsonic through the sonicInt* ABI
(soniclib.c:94-369). That engine is sample-serial C with data-dependent
control flow; here it becomes a fixed-trip-count `lax.scan` over synthesis
steps with masked emission into a fixed-capacity output buffer, so the
whole resynthesis jits, vmaps over utterances, and shards over chips.

Per-step algebra mirrors sonic's speed-change quanta (each step's
input/output ratio equals the instantaneous speed s exactly, up to integer
rounding):
  s > 1 ("skip a pitch period"):
      n = P/(s-1) if s >= 2 else P; emit OLA(x[p:p+n] down, x[p+P:p+P+n] up),
      consume P + n; if s < 2, additionally pass through P(2-s)/(s-1)
      samples unchanged.
  s < 1 ("insert a pitch period"):
      n = P·s/(1-s) if s <= 0.5 else P; emit x[p:p+P] then
      OLA(x[p+P:p+P+n] down, x[p:p+n] up); consume n; if s > 0.5,
      additionally pass through P(2s-1)/(1-s) samples unchanged.
  s ≈ 1: plain copy.

Pitch period P is the AMDF argmin over [fs/400, fs/65] (sonic's
SONIC_MIN/MAX_PITCH contract), computed at full rate (the reference's
engine decimates to 4 kHz for cost; we keep full accuracy — the search is
a dense masked reduction that vectorizes on the VPU).

Speed may vary per analysis frame (the sonic2 shim sets a new speed before
writing each 1/frameRate buffer, soniclib.c:354-370): `speeds` is indexed
by in_pos // frame_step, clamped to the last frame for the flush tail
(soniclib.c:538-551 drains pending frames at the last speed).

Output-length bookkeeping: the per-step ideal output is consumed/s; we
accumulate that for the *real* (unpadded) consumed samples and trim the
emitted stream to its rounded total, mirroring libsonic's expected-output
trimming on flush. Per-step integer rounding drift is O(sqrt(steps))
samples, well inside the reference's ±14 ms / ±1.5% contracts.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SpeedyConfig


class WsolaResult(NamedTuple):
    output: jnp.ndarray        # [capacity] (zero beyond valid_length)
    valid_length: jnp.ndarray  # scalar int32
    steps_used: jnp.ndarray    # scalar int32 (diagnostics)


def _pitch_period(window: jnp.ndarray, min_period: int, max_period: int) -> jnp.ndarray:
    """AMDF pitch search on window[2*max_period] starting at the cursor.

    diff(L) = (1/L)·sum_{i<L} |w[i] - w[i+L]|, argmin over L in
    [min_period, max_period] (ties -> smallest L, like sonic's strict '<').
    """
    dtype = window.dtype
    lags = jnp.arange(min_period, max_period + 1, dtype=jnp.int32)
    i = jnp.arange(max_period, dtype=jnp.int32)
    idx = i[:, None] + lags[None, :]
    diffs = jnp.sum(
        jnp.where(
            i[:, None] < lags[None, :],
            jnp.abs(window[i][:, None] - window[idx]),
            0.0,
        ),
        axis=0,
    )
    amdf = diffs / lags.astype(dtype)
    return min_period + jnp.argmin(amdf).astype(jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=(
        "min_period",
        "max_period",
        "frame_step",
        "capacity",
        "num_steps",
        "unroll",
    ),
)
def _wsola_scan(
    x: jnp.ndarray,
    input_length: jnp.ndarray,
    speeds: jnp.ndarray,
    min_period: int,
    max_period: int,
    frame_step: int,
    capacity: int,
    num_steps: int,
    unroll: int = 1,
) -> WsolaResult:
    """See module docstring. Layout notes:
      * Writing into a carried output buffer at the data-dependent out_pos
        lowers to a scatter per step (batched offsets defeat in-place
        aliasing). Instead, variable-size emissions accumulate in a small
        carried residue vector and flush as fixed-size rows into the
        scan's stacked outputs; the waveform is then assembled with one
        contiguous row gather.
      * All per-step memory access is contiguous dynamic slices, never a
        data-dependent element gather."""
    dtype = x.dtype
    maxp = max_period
    chunk = maxp             # passthrough quantum per step
    emit_width = 2 * maxp    # max emission of any step (insert: P + n <= 2P)
    # Front padding lets the insert branch read x[p + lane - period] as a
    # contiguous dynamic_slice (base never underflows); all per-step memory
    # access is contiguous slices.
    x_pad = jnp.concatenate(
        [jnp.zeros(maxp, dtype), x, jnp.zeros(2 * maxp + chunk, dtype)]
    )
    n_frames = speeds.shape[0]
    lane = jnp.arange(emit_width, dtype=jnp.int32)

    res_cap = 2 * emit_width  # residue capacity: < E before + <= E appended
    res_lane = jnp.arange(res_cap, dtype=jnp.int32)

    def step(carry, _):
        in_pos, out_pos, rem_copy, target, done, residue, res_len = carry
        frame = jnp.clip(in_pos // frame_step, 0, n_frames - 1)
        s = speeds[frame]

        # One HBM slice per step covering every view the step needs
        # ([p-maxp, p+3maxp)); head/tail/prev are cheap re-slices of it.
        big = jax.lax.dynamic_slice(x_pad, (in_pos,), (4 * maxp,))
        head = jax.lax.slice_in_dim(big, maxp, maxp + emit_width)  # x[p+i]
        period = _pitch_period(head, min_period, maxp)
        pf = period.astype(dtype)

        speeding = s > 1.00001
        slowing = s < 0.99999
        copying = rem_copy > 0

        # Branch quantities (all computed, selected by masks).
        n_skip = jnp.where(
            s >= 2.0, jnp.maximum((pf / (s - 1.0)).astype(jnp.int32), 1), period
        )
        rem_skip = jnp.where(
            s >= 2.0,
            0,
            jnp.maximum(
                (pf * (2.0 - s) / jnp.maximum(s - 1.0, 1e-6)).astype(jnp.int32), 0
            ),
        )
        n_ins = jnp.where(
            s <= 0.5,
            jnp.maximum((pf * s / jnp.maximum(1.0 - s, 1e-6)).astype(jnp.int32), 1),
            period,
        )
        rem_ins = jnp.where(
            s <= 0.5,
            0,
            jnp.maximum(
                (pf * (2.0 * s - 1.0) / jnp.maximum(1.0 - s, 1e-6)).astype(jnp.int32), 0
            ),
        )
        n_copy = jnp.minimum(rem_copy, chunk)

        consumed = jnp.where(
            copying,
            n_copy,
            jnp.where(speeding, period + n_skip, jnp.where(slowing, n_ins, chunk)),
        )
        emitted = jnp.where(
            copying,
            n_copy,
            jnp.where(speeding, n_skip, jnp.where(slowing, period + n_ins, chunk)),
        )
        new_rem = jnp.where(
            copying,
            rem_copy - n_copy,
            jnp.where(speeding, rem_skip, jnp.where(slowing, rem_ins, 0)),
        )

        # Emission buffers — contiguous slices only (see x_pad note above).
        tail = jax.lax.dynamic_slice(
            big, (maxp + period,), (emit_width,)
        )  # x[p+P+i]
        prev = jax.lax.dynamic_slice(
            big, (maxp - period,), (emit_width,)
        )  # x[p+i-P]
        up_skip = lane.astype(dtype) / jnp.maximum(n_skip.astype(dtype), 1.0)
        skip_buf = head * (1.0 - up_skip) + tail * up_skip
        # Insert emission at output lane i: for i < P it is x[p+i]; for
        # i = P + j it is x[p+P+j]*(1-r) + x[p+j]*r = head[i]*(1-r) +
        # prev[i]*r with r = (i-P)/n — the gathered tail[j]/head[j] forms
        # collapse to shifted contiguous views.
        j = jnp.clip(lane - period, 0, emit_width - 1)
        up_ins = j.astype(dtype) / jnp.maximum(n_ins.astype(dtype), 1.0)
        ins_buf = jnp.where(
            lane < period, head, head * (1.0 - up_ins) + prev * up_ins
        )
        buf = jnp.where(
            copying, head, jnp.where(speeding, skip_buf, jnp.where(slowing, ins_buf, head))
        )

        active = jnp.logical_not(done)
        emitted = jnp.where(active, emitted, 0)

        c_real = jnp.clip(input_length - in_pos, 0, consumed).astype(dtype)
        target = target + jnp.where(active, c_real / s, 0.0)
        in_pos = in_pos + jnp.where(active, consumed, 0)
        new_out_pos = out_pos + emitted
        rem_copy = jnp.where(active, new_rem, 0)
        done = done | (in_pos >= input_length)

        # Append buf[:emitted] into the residue at res_len via a dynamic
        # roll (double-buffer slice — contiguous, no scatter).
        padded = jnp.concatenate([buf, jnp.zeros(emit_width, dtype)])
        dbl = jnp.concatenate([padded, padded])
        rolled = jax.lax.dynamic_slice(dbl, (res_cap - res_len,), (res_cap,))
        residue = jnp.where(
            (res_lane >= res_len) & (res_lane < res_len + emitted), rolled, residue
        )
        res_len = res_len + emitted
        # Flush one fixed-size row when full (res_len < 2E always holds:
        # it was < E before the append and emitted <= E).
        flush = res_len >= emit_width
        row = residue[:emit_width]
        residue = jnp.where(
            flush,
            jnp.concatenate([residue[emit_width:], jnp.zeros(emit_width, dtype)]),
            residue,
        )
        res_len = jnp.where(flush, res_len - emit_width, res_len)
        return (
            (in_pos, new_out_pos, rem_copy, target, done, residue, res_len),
            (row, flush, active),
        )

    init = (
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0.0, dtype),
        jnp.asarray(False),
        jnp.zeros(res_cap, dtype),
        jnp.asarray(0, jnp.int32),
    )
    (
        (_, out_pos, _, target, _, residue, res_len),
        (rows, flushes, actives),
    ) = jax.lax.scan(step, init, None, length=num_steps, unroll=unroll)

    valid = jnp.minimum(jnp.round(target).astype(jnp.int32), capacity)
    valid = jnp.minimum(valid, out_pos)

    # Assemble: r-th flushed row is rows[k_r] with k_r = first step where
    # cumsum(flushes) == r+1 — a contiguous row gather, then the residue
    # tail is placed with a single dynamic_update_slice.
    n_rows = capacity // emit_width + 1
    flush_cum = jnp.cumsum(flushes.astype(jnp.int32))
    row_steps = jnp.searchsorted(
        flush_cum, jnp.arange(1, n_rows + 1, dtype=jnp.int32), side="left"
    )
    gathered = rows[jnp.clip(row_steps, 0, num_steps - 1)]  # [n_rows, E]
    out_full = gathered.reshape(-1)  # [n_rows * E] >= capacity
    rows_end = flush_cum[-1] * emit_width
    out_full = jax.lax.dynamic_update_slice(
        jnp.concatenate([out_full, jnp.zeros(res_cap, dtype)]),
        residue,
        (rows_end,),
    )
    idx = jnp.arange(capacity, dtype=jnp.int32)
    out = jnp.where(idx < valid, out_full[:capacity], 0.0)
    return WsolaResult(out, valid, jnp.sum(actives.astype(jnp.int32)))


def plan(cfg: SpeedyConfig, input_len: int, min_speed_bound: float):
    """Static capacity / trip-count planning for a given input length.

    `min_speed_bound` must lower-bound every speed the scan will see; it
    sizes the fixed output buffer and the scan trip count.
    """
    minp, maxp = cfg.wsola_min_period, cfg.wsola_max_period
    capacity = int(np.ceil(input_len / max(min_speed_bound, 0.01))) + 4 * maxp
    if min_speed_bound >= 1.0:
        min_consumed = minp + 1
    else:
        s = min(min_speed_bound, 0.5)
        min_consumed = max(1, int(minp * s / (1.0 - s)))
        min_consumed = min(min_consumed, minp + 1)
    num_steps = int(np.ceil(input_len / min_consumed)) + 8
    # Bucket the static sizes so nearby inputs share one compiled program.
    capacity = -(-capacity // 8192) * 8192
    num_steps = -(-num_steps // 512) * 512
    return minp, maxp, capacity, num_steps


def time_scale(
    x: jnp.ndarray,
    speeds: jnp.ndarray,
    cfg: SpeedyConfig,
    input_length=None,
    min_speed_bound: float = 0.25,
    capacity: Optional[int] = None,
    num_steps: Optional[int] = None,
) -> WsolaResult:
    """Time-scale mono waveform x[L] by per-frame `speeds` [n_frames].

    For constant-speed (pure-sonic "linear") use, pass speeds of shape [1].
    `input_length` may be a traced scalar < len(x) for padded batching.
    """
    x = jnp.asarray(x)
    if input_length is None:
        input_length = x.shape[-1]
    minp, maxp, cap, steps = plan(cfg, x.shape[-1], min_speed_bound)
    if capacity is not None:
        cap = capacity
    if num_steps is not None:
        steps = num_steps
    return _wsola_scan(
        x,
        jnp.asarray(input_length, jnp.int32),
        jnp.asarray(speeds, x.dtype),
        minp,
        maxp,
        cfg.frame_step_int,
        cap,
        steps,
    )
