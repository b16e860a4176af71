"""Tension -> speed control law with duration feedback (components C11/C16).

speedyComputeSpeedFromTension (speedy.c:768-788) integrates consumed vs
desired duration frame by frame, so it is sequential by definition — but it
only consumes the (already computed) tension sequence and scalar state, so
it runs as a cheap lax.scan *after* the parallel front-end rather than
serializing the pipeline (SURVEY.md §7 hard-part #4).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import config as C


def speed_law_step(cur, des, t, rg, fb, nl, min_speed, frame_duration):
    """One frame of speedyComputeSpeedFromTension (speedy.c:768-788) plus
    the shim's nonlinear interpolation (soniclib.c:342-345).

    The SINGLE implementation of the control law's inner step — shared by
    `speed_from_tension` below and the multistream masked law
    (`multistream._law_factory`), so the multiplexed path's bit-equality
    contract cannot drift from a fix applied to only one copy. Scalars
    (`rg`, `fb`, `nl`, `min_speed`, `frame_duration`) may be Python
    floats or traced values; callers pass exactly the types they always
    did, preserving bitwise outputs.

    Returns (cur', des', final_speed)."""
    fast = jnp.maximum(1.0, rg + (1.0 - rg) * t)
    slow = jnp.maximum(min_speed, jnp.minimum(1.0, rg - (1.0 - rg) * t))
    requested = jnp.where(rg > 1.0, fast, slow)
    excess = cur - des
    requested = jnp.where(
        fb > 0.0, requested + jnp.maximum(min_speed, fb * excess), requested
    )
    cur = cur + frame_duration / requested
    des = des + frame_duration / rg
    final = requested * nl + rg * (1.0 - nl)
    return cur, des, final


@jax.jit
def speed_from_tension(
    tension: jnp.ndarray,
    global_rate,
    duration_feedback_strength=0.0,
    nonlinear_factor=1.0,
    initial_durations: Tuple[float, float] = (0.0, 0.0),
):
    """Map a tension sequence [T] to per-frame speeds [T].

    Implements speedy.c:768-788 exactly, including:
      * the piecewise law around R_g (>1: max(1, R_g+(1-R_g)·t); <=1:
        clamp(R_g-(1-R_g)·t, kMinimumSpeed, 1)),
      * duration feedback `speed += max(kMinimumSpeed, k·excess)` (note the
        reference adds at least kMinimumSpeed whenever feedback is on),
      * duration integration at 1/kFrameRateHz per frame using the
        *feedback-adjusted but pre-interpolation* speed,
    plus the shim's nonlinear interpolation `rate·f + R_g·(1-f)`
    (soniclib.c:342-345), applied after integration as in the C call order.

    Returns (speeds, (current_duration, desired_duration)).
    """
    dtype = tension.dtype
    rg = jnp.asarray(global_rate, dtype)
    fb = jnp.asarray(duration_feedback_strength, dtype)
    nl = jnp.asarray(nonlinear_factor, dtype)
    frame_duration = jnp.asarray(1.0 / C.FRAME_RATE_HZ, dtype)
    min_speed = jnp.asarray(C.MIN_SPEED, dtype)

    def step(carry, t):
        cur, des = carry
        cur, des, final = speed_law_step(
            cur, des, t, rg, fb, nl, min_speed, frame_duration
        )
        return (cur, des), final

    init = (
        jnp.asarray(initial_durations[0], dtype),
        jnp.asarray(initial_durations[1], dtype),
    )
    carry, speeds = jax.lax.scan(step, init, tension, unroll=16)
    return speeds, carry


@functools.partial(jax.jit, static_argnames=("num_iters",))
def speed_from_tension_parallel(
    tension: jnp.ndarray,
    global_rate,
    duration_feedback_strength=0.0,
    nonlinear_factor=1.0,
    num_iters: int = 8,
):
    """Parallel fixed-point solver for the speed law (batched [..., T]).

    The duration-feedback recurrence is a contraction: the sensitivity of
    the excess-duration sequence to itself is ~ sum(fd*fb/req^2) ~ 0.1 for
    typical settings, so Jacobi iteration — evaluate all requested speeds
    from the previous iterate's excess durations (elementwise), then
    recompute the durations with prefix sums — converges geometrically.
    num_iters=8 agrees with the exact sequential scan to float32 round-off
    (tested); the scan's O(T) dependency chain becomes a few parallel
    passes.

    VALID ONLY FOR global_rate > 1: at sub-unity rates the kMinimumSpeed
    clamp makes fb/req^2 exceed 1 and the iteration is not a contraction —
    callers must use the exact scan there (the batch engine does).
    """
    dtype = tension.dtype
    rg = jnp.asarray(global_rate, dtype)
    fb = jnp.asarray(duration_feedback_strength, dtype)
    nl = jnp.asarray(nonlinear_factor, dtype)
    fd = jnp.asarray(1.0 / C.FRAME_RATE_HZ, dtype)
    min_speed = jnp.asarray(C.MIN_SPEED, dtype)

    fast = jnp.maximum(1.0, rg + (1.0 - rg) * tension)
    slow = jnp.maximum(min_speed, jnp.minimum(1.0, rg - (1.0 - rg) * tension))
    base = jnp.where(rg > 1.0, fast, slow)

    # Strictly-lower-triangular matmul computes the exclusive prefix sum
    # (float32, HIGHEST). Built from iotas ON DEVICE: a materialized
    # [T, T] numpy constant would ship inside the serialized program
    # (324 MB at T=9000).
    T = tension.shape[-1]
    tri = (
        jnp.arange(T, dtype=jnp.int32)[:, None]
        < jnp.arange(T, dtype=jnp.int32)[None, :]
    ).astype(dtype)  # tri[j, k] = 1 for j < k

    def refine(_, excess_prev):
        req = jnp.where(
            fb > 0.0, base + jnp.maximum(min_speed, fb * excess_prev), base
        )
        # excess entering frame k = sum_{j<k} (fd/req_j - fd/rg)
        delta = fd / req - fd / rg
        return jnp.dot(delta, tri, precision=jax.lax.Precision.HIGHEST)

    excess = jax.lax.fori_loop(
        0, num_iters, refine, jnp.zeros_like(tension)
    )
    req = jnp.where(fb > 0.0, base + jnp.maximum(min_speed, fb * excess), base)
    return req * nl + rg * (1.0 - nl)
