"""Unbounded-length device streaming: analysis as a chunked `lax.scan`
carrying O(1) state (SURVEY.md §5.7).

The reference streams arbitrarily long audio through fixed-size state — a
21-frame spectrogram ring, a 42-slot hysteresis ring, and scalar filter
states (/root/reference/speedy.c:95,97,137-151). The batched device path
(parallel/batch.py) instead materializes all [T, W] frames per length
bucket: ideal for corpus throughput, but device memory grows with
utterance length. This module is the device-side answer for unbounded
utterances: a `lax.scan` over CHUNKS of frames whose carry is exactly the
reference's ring state,

  * raw-audio tail        [W + 2*step]   (frame overlap + preemph state)
  * energy-LPF state      scalar         (speedy.c:287-292)
  * spectral-diff LPF     scalar         (speedy.c:264-265)
  * energy_compressed ring [past+fut]    (the 42-slot hysteresis ring)
  * spectrogram ring      [fut+2, W]     (the 21-slot history ring slice
                                          tension actually reads: frames
                                          t-1..t+fut relative to emission)

so peak device state is ~4 KB regardless of utterance length; per-chunk
compute is the same fused tensor math as the batched engine (DFT matmuls,
shifted-slice hysteresis).

Frame pipelining: a frame's window spans W = 1.5*step samples, so the
last frame of a chunk's sample range needs the NEXT chunk's first
samples; the scan therefore computes frames lagged by 2 chunks' worth of
alignment (chunk k emits analysis frames [k*Ch-2, (k+1)*Ch-2) and
tension frames [k*Ch-2-fut, (k+1)*Ch-2-fut)), with invalid leading slots
masked off at the end.

Equivalence contract: identical math to ops.analysis.analyze
(integer-step mode) except that the two 1-pole LPFs run as per-chunk
associative scans seeded with the carried state instead of one length-T
associative scan. Float reassociation across different scan trees moves
results by ulps (measured max tension delta ~1e-7 on 10-minute speech;
gated at 2e-5 by tests/test_chunked.py) — bit-exactness across different
reduction trees is not a meaningful target in f32, and NEITHER tree is
the reference's serial order; all three agree to the golden-data SNR
gates.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import config as C
from ..config import SpeedyConfig
from . import dft


class _Carry(NamedTuple):
    tail: jnp.ndarray      # [W + 2*step] last raw samples seen
    energy_lpf: jnp.ndarray    # scalar
    ew_lpf: jnp.ndarray        # scalar
    ec_ring: jnp.ndarray   # [past + fut] energy_compressed history
    sp_ring: jnp.ndarray   # [fut + 2, W] half-spectrogram history


def _lpf_chunk(x: jnp.ndarray, alpha, carry, valid=None):
    """First-order LPF over one chunk seeded with the carried state:
    the per-chunk form of ops.filters.first_order_lowpass. Entries with
    valid=False take an IDENTITY step (a=1, b=0) — the filter state
    passes through untouched, exactly as if the frame never happened
    (used for the lag slots before global frame 0)."""
    a = jnp.broadcast_to(jnp.asarray(alpha, x.dtype), x.shape)
    b = (1.0 - a) * x
    if valid is not None:
        a = jnp.where(valid, a, 1.0)
        b = jnp.where(valid, b, 0.0)

    def combine(left, right):
        a1, b1 = left
        a2, b2 = right
        return a1 * a2, a2 * b1 + b2

    a_cum, b_cum = jax.lax.associative_scan(combine, (a, b))
    y = a_cum * carry + b_cum
    return y, y[-1]


@functools.partial(
    jax.jit, static_argnames=("cfg", "chunk_frames", "num_frames")
)
def chunked_tension(
    x: jnp.ndarray,
    cfg: SpeedyConfig,
    chunk_frames: int = 256,
    num_frames: int | None = None,
) -> jnp.ndarray:
    """Tension for one utterance x[L] via the O(1)-state chunked scan.

    Returns tension [T_out] identical (to float-reassociation ulps) to
    `analyze(x, cfg, integer_step=True).tension`. Device state per scan
    step is independent of L. vmap over a batch axis composes.
    """
    dtype = x.dtype
    step = cfg.frame_step_int
    Ch = chunk_frames
    T = cfg.num_frames(x.shape[-1], integer_step=True) if num_frames is None else num_frames
    T_out = cfg.num_tension_frames(T)
    if T_out <= 0:
        return jnp.zeros((0,), dtype)

    n_chunks = -(-(T + 2) // Ch)
    need = n_chunks * Ch * step
    x_pad = (
        jnp.concatenate([x, jnp.zeros((need - x.shape[-1],), dtype)])
        if need > x.shape[-1]
        else x[:need]
    )
    xs_scan = x_pad.reshape(n_chunks, Ch * step)

    carry0, body = make_chunk_step(cfg, Ch, np.dtype(dtype).name)
    _, tension_chunks = jax.lax.scan(
        body, carry0, (jnp.arange(n_chunks), xs_scan)
    )
    flat = tension_chunks.reshape(-1)  # flat[t + 2 + fut] = tension[t]
    fut = cfg.hysteresis_future
    return jax.lax.slice_in_dim(flat, 2 + fut, 2 + fut + T_out)


def make_chunk_step(cfg: SpeedyConfig, chunk_frames: int, dtype: str = "float32"):
    """The O(1)-state analysis step: returns (carry0, step_fn) with
    step_fn(carry, (k, samples[Ch*step])) -> (carry, tension[Ch]), the
    lax.scan body of chunked_tension. Exposed so a host-driven streaming
    loop (streaming_device.py) can jit ONE step and pump arbitrarily long
    audio through it segment by segment. Chunk k's tension slots cover
    frames [k*Ch - 2 - fut, (k+1)*Ch - 2 - fut); slots with negative
    frame index are garbage the caller drops."""
    dtype = np.dtype(dtype).type(0).dtype
    step = cfg.frame_step_int
    W = cfg.window_size
    fut = cfg.hysteresis_future
    past = cfg.hysteresis_past
    Ch = chunk_frames
    tail_len = W + 2 * step
    win = jnp.asarray(dft.hamming_window(W, dtype.name))
    cos_m, sin_m = (
        jnp.asarray(m) for m in dft.dft_matrices(W, dtype.name)
    )
    alpha = cfg.lpf_alpha
    eps = jnp.asarray(C.EPS, dtype)
    low_thresh = jnp.asarray(cfg.low_energy_threshold, dtype)

    def body(carry: _Carry, inp):
        k, samples = inp
        buf = jnp.concatenate([carry.tail, samples])  # [(Ch+3.5)*step]
        # Frames this chunk: local i = 0..Ch-1 <-> global t = k*Ch - 2 + i,
        # window at buf offset i*step + W. Slice off step/2 so offsets are
        # step-aligned, then frames are views of a strided reshape (the
        # same gather-free framing as parallel/batch.py).
        buf2 = jax.lax.slice_in_dim(buf, step // 2, buf.shape[0])
        cells = buf2.reshape(Ch + 3, step)
        frames = jnp.concatenate(
            [cells[1 : 1 + Ch], cells[2 : 2 + Ch]], axis=-1
        )[:, :W]  # [Ch, W]
        t_glob = k * Ch - 2 + jnp.arange(Ch)  # analysis-frame indices
        # Preemphasis state = previous frame's last input sample
        # (state-as-gather, framing.py): buf2 offset i*step + W - 1.
        state = jax.lax.slice(buf2, (W - 1,), (W - 1 + Ch * step,), (step,))
        state = jnp.where(t_glob == 0, 0.0, state)  # no frame before t=0
        prev = jnp.concatenate([state[:, None], frames[:, :-1]], axis=1)
        pre = frames - jnp.asarray(C.PREEMPHASIS_COEF, dtype) * prev

        fw = pre * win[None, :]
        hi = dft.ANALYSIS_PRECISION
        re = jnp.dot(fw, cos_m, precision=hi)
        im = jnp.dot(fw, sin_m, precision=hi)
        half = jnp.sqrt(re * re + im * im)[:, :W]  # bins 0..fft/2-1
        # Chunk 0's two lag slots are pre-time frames (global t < 0):
        # they must behave as the reference's rings do for negative times
        # — zeros everywhere, with NO filter-state update.
        valid_frame = t_glob >= 0
        half = jnp.where(valid_frame[:, None], half, 0.0)

        energy = jnp.sum(half[:, 1:] ** 2, axis=-1)
        energy_lp, e_state = _lpf_chunk(
            energy, alpha, carry.energy_lpf, valid_frame
        )
        ec = jnp.where(
            valid_frame, jnp.sqrt(jnp.minimum(energy / energy_lp, 2.0)), 0.0
        )

        # Hysteresis over the carried ring + this chunk's values. Tension
        # frames this chunk: j = 0..Ch-1 <-> t = k*Ch - 2 - fut + j; in
        # ec_all coordinates frame t sits at index j + past.
        ec_all = jnp.concatenate([carry.ec_ring, ec])  # [past+fut+Ch]
        future_max = jnp.zeros((Ch,), dtype)
        for i in range(fut + 1):
            taper = (fut - i) / float(fut)
            sl = jax.lax.slice_in_dim(ec_all, past + i, past + i + Ch)
            future_max = jnp.maximum(future_max, sl * taper)
        past_max = jnp.zeros((Ch,), dtype)
        for i in range(past + 1):
            taper = (past - i) / float(past)
            sl = jax.lax.slice_in_dim(ec_all, past - i, past - i + Ch)
            past_max = jnp.maximum(past_max, sl * taper)
        energy_hyst = (past_max + future_max) / 2.0

        # Spectral difference: frames t and t-1 from the carried spectro-
        # gram ring (frame t sits at index j + 2 of sp_all).
        sp_all = jnp.concatenate([carry.sp_ring, half])  # [fut+2+Ch, W]
        cur = jax.lax.slice_in_dim(sp_all, 2, 2 + Ch, axis=0)
        last = jax.lax.slice_in_dim(sp_all, 1, 1 + Ch, axis=0)
        sig_energy = jnp.sum(cur[:, 1:] ** 2, axis=-1)
        last_energy = jnp.sum(last[:, 1:] ** 2, axis=-1)
        normalized = cur / (jnp.sqrt(sig_energy)[:, None] + eps)
        normalized_last = last / (jnp.sqrt(last_energy)[:, None] + eps)
        tt = t_glob - fut  # tension-frame indices
        skipped = (sig_energy <= low_thresh) | (tt == 0)
        bin_thresh = jnp.max(cur[:, 1:], axis=-1, keepdims=True) / 100.0
        mask = (cur[:, 1:] > bin_thresh) & (last[:, 1:] > bin_thresh)
        log_ratio = jnp.abs(
            jnp.log((normalized[:, 1:] + eps) / (normalized_last[:, 1:] + eps))
        )
        lsd = jnp.sum(jnp.where(mask, log_ratio, 0.0), axis=-1)
        lsd = jnp.where(skipped, 0.0, lsd)
        ewld = lsd * energy_hyst
        ew_lpf, ew_state = _lpf_chunk(
            jnp.where(skipped, 0.0, ewld), alpha, carry.ew_lpf, tt >= 0
        )
        rsd = jnp.where(
            skipped, 0.0, ewld / (ew_lpf + 0.01 * C.MEAN_EMPHASIS_WEIGHTED_LPF)
        )
        changes = jnp.where(
            skipped, 0.0, jnp.minimum(rsd, cfg.speech_changes_clamp)
        )
        tension = C.TENSION_A * (energy_hyst - C.TENSION_M_E) + C.TENSION_B * (
            changes - C.TENSION_M_S
        )

        new_carry = _Carry(
            tail=buf[-tail_len:],
            energy_lpf=e_state,
            ew_lpf=ew_state,
            ec_ring=ec_all[-(past + fut):],
            sp_ring=sp_all[-(fut + 2):],
        )
        return new_carry, tension

    carry0 = _Carry(
        tail=jnp.zeros((tail_len,), dtype),
        energy_lpf=jnp.asarray(C.MEAN_SPECTROGRAM_ENERGY, dtype),
        ew_lpf=jnp.asarray(C.MEAN_EMPHASIS_WEIGHTED_LOCAL_DIFFERENCE, dtype),
        ec_ring=jnp.zeros((past + fut,), dtype),
        sp_ring=jnp.zeros((fut + 2, W), dtype),
    )
    return carry0, body


def chunked_speeds(
    tension: jnp.ndarray,
    global_speed: float,
    duration_feedback_strength: float = 0.1,
    nonlinear_factor: float = 1.0,
):
    """Speed law over a chunked-analysis tension stream. The duration-
    feedback integrator (speedy.c:768-788) is already O(1) state — the
    existing scan implementation IS the streaming form; re-exported here
    so the unbounded pipeline reads as one module."""
    from .speed import speed_from_tension

    return speed_from_tension(
        tension, global_speed, duration_feedback_strength, nonlinear_factor
    )
