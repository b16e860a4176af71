"""Framing and preemphasis, recast frame-parallel.

The reference processes frames serially, carrying preemphasis state across
50%-overlapped frames (speedy.c:416-425,540-551: the state entering frame t
is the *raw* last sample of frame t-1). Because that carried state is itself
just a gather from the input waveform, the whole stage is data-parallel over
frames here — no scan needed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PREEMPHASIS_COEF, SpeedyConfig


def frame_starts(cfg: SpeedyConfig, num_frames: int, integer_step: bool = False) -> np.ndarray:
    """Start index of each analysis frame.

    Float-step mode replicates `(int)std::round(t * stepSize)` from the
    reference harness (speedy_test.cc:558,912) — round half away from zero.
    Integer-step mode replicates the sonic2 shim's contiguous 1/frameRate
    buffers (soniclib.c:195,265-287: frame k covers [k*step, k*step+window)).
    """
    t = np.arange(num_frames, dtype=np.float64)
    if integer_step:
        return (t.astype(np.int64) * cfg.frame_step_int).astype(np.int32)
    return np.floor(t * cfg.frame_step_float + 0.5).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("window_size",))
def extract_frames(x: jnp.ndarray, starts: jnp.ndarray, window_size: int) -> jnp.ndarray:
    """Gather overlapping frames: x[L] -> frames[T, W]."""
    idx = starts[:, None] + jnp.arange(window_size, dtype=jnp.int32)[None, :]
    return jnp.take(x, idx, axis=0, mode="clip")


@functools.partial(jax.jit, static_argnames=("window_size",))
def preemphasis_state(x: jnp.ndarray, starts: jnp.ndarray, window_size: int) -> jnp.ndarray:
    """Raw sample carried into each frame's preemphasis (0 for frame 0).

    Frame t's first filtered sample subtracts the *last raw sample of frame
    t-1* (speedy.c:422-423: preemph_state persists across AddData calls),
    which for overlapped frames is x[start[t-1] + W - 1], not x[start[t]-1].
    """
    prev_last_idx = starts[:-1] + (window_size - 1)
    prev = jnp.take(x, prev_last_idx, axis=0, mode="clip")
    return jnp.concatenate([jnp.zeros((1,), x.dtype), prev])


@jax.jit
def preemphasize(frames: jnp.ndarray, state: jnp.ndarray) -> jnp.ndarray:
    """y[i] = x[i] - 0.97 * x[i-1] within each frame, with carried state.

    Matches filter([1 -0.97], 1, x) semantics of speedy.c:416-425.
    frames: [T, W], state: [T] -> [T, W].
    """
    prev = jnp.concatenate([state[:, None], frames[:, :-1]], axis=1)
    return frames - jnp.asarray(PREEMPHASIS_COEF, frames.dtype) * prev
