"""First-order IIR lowpass as an associative scan (component C1).

The reference iterates state = (1-α)·x + α·state sample-serially
(speedy.c:50-88). A first-order linear recurrence composes associatively
((a,b) pairs with (a2,b2)∘(a1,b1) = (a1·a2, a2·b1 + b2)), so we run
it as jax.lax.associative_scan — O(log T) depth instead of O(T).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("alpha", "initial_state", "axis"))
def first_order_lowpass(
    x: jnp.ndarray, alpha: float, initial_state: float, axis: int = -1
) -> jnp.ndarray:
    """y[t] = α·y[t-1] + (1-α)·x[t], with y[-1] = initial_state.

    Matches IterateFirstOrderFilter (speedy.c:73-76) seeded via
    SetFirstOrderFilterState (speedy.c:82-84,287-292).
    """
    alpha = jnp.asarray(alpha, x.dtype)
    a = jnp.broadcast_to(alpha, x.shape)
    b = (1.0 - alpha) * x

    def combine(left, right):
        a1, b1 = left
        a2, b2 = right
        return a1 * a2, a2 * b1 + b2

    a_cum, b_cum = jax.lax.associative_scan(combine, (a, b), axis=axis)
    return a_cum * jnp.asarray(initial_state, x.dtype) + b_cum
