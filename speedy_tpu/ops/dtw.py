"""Dynamic time warping (component C21), recast for batched devices.

The reference (dynamic_time_warping.cc) fills an O(M·N) cost matrix with a
pairwise distance, accumulates the classic {(1,0),(0,1),(1,1)}-move DP, and
backtracks the optimal path with diagonal preferred on ties
(dynamic_time_warping.cc:67-74).

Recast:
  * cost matrix = one matmul (|a-b|^2 = |a|^2 + |b|^2 - 2ab);
  * the DP's within-row dependency acc[i,j] = c[i,j] + min(m[j], acc[i,j-1])
    (m[j] = min(acc[i-1,j], acc[i-1,j-1])) is a min-plus recurrence that
    factors through prefix sums:
        acc[i,j] = S[j] + min_{k<=j} (m[k] - S[k-1]),  S = cumsum(c[i,:])
    so each row is a cummin (associative scan) and rows run under one
    lax.scan — O(M) sequential depth instead of O(M·N).
  * path backtracking is host-side (test/verification only), with the
    reference's exact tie rule.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def euclidean_cost_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Pairwise Euclidean distances: a[M,D], b[N,D] -> [M,N] (one matmul)."""
    a2 = jnp.sum(a * a, axis=-1)[:, None]
    b2 = jnp.sum(b * b, axis=-1)[None, :]
    ab = jnp.dot(a, b.T, precision=jax.lax.Precision.HIGHEST)
    return jnp.sqrt(jnp.maximum(a2 + b2 - 2.0 * ab, 0.0))


@jax.jit
def accumulate(cost: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """DP-accumulate a cost matrix.

    Returns (total_cost, acc_matrix). Matches ComputeFromCostMatrix
    (dynamic_time_warping.cc:76-100): first row/col are cumulative sums;
    interior cells add min(up, left, upleft).
    """
    dtype = cost.dtype
    n = cost.shape[1]
    inf = jnp.asarray(jnp.finfo(dtype).max, dtype)

    first_row = jnp.cumsum(cost[0])

    def row_step(prev_row, cost_row):
        s = jnp.cumsum(cost_row)
        up = prev_row
        upleft = jnp.concatenate([jnp.full((1,), inf, dtype), prev_row[:-1]])
        m = jnp.minimum(up, upleft)
        # acc[j] = S[j] + cummin_k<=j (m[k] - S[k-1]); S[-1] = 0.
        s_prev = jnp.concatenate([jnp.zeros((1,), dtype), s[:-1]])
        acc = s + jax.lax.associative_scan(jnp.minimum, m - s_prev)
        return acc, acc

    last_row, acc_rest = jax.lax.scan(row_step, first_row, cost[1:])
    acc = jnp.concatenate([first_row[None, :], acc_rest], axis=0)
    return acc[-1, -1], acc


@jax.jit
def directions(cost: jnp.ndarray, acc: jnp.ndarray) -> jnp.ndarray:
    """Reference best_directions matrix from the accumulated DP.

    -1 = came from up, 0 = diagonal, 1 = left; ties prefer diagonal
    (ArgMin, dynamic_time_warping.cc:67-74). First row = 1, first col = -1,
    corner (0,0) = 0 (value irrelevant: backtrack stops there).
    """
    m, n = cost.shape
    dtype = cost.dtype
    inf = jnp.asarray(jnp.finfo(dtype).max, dtype)
    up = jnp.concatenate([jnp.full((1, n), inf, dtype), acc[:-1, :]], axis=0)
    left = jnp.concatenate([jnp.full((m, 1), inf, dtype), acc[:, :-1]], axis=1)
    upleft = jnp.concatenate(
        [jnp.full((m, 1), inf, dtype),
         jnp.concatenate([jnp.full((1, n - 1), inf, dtype), acc[:-1, :-1]], axis=0)],
        axis=1,
    )
    d = jnp.where(
        (up < upleft) & (up < left),
        -1,
        jnp.where((left < up) & (left < upleft), 1, 0),
    ).astype(jnp.int8)
    row_idx = jnp.arange(m)[:, None]
    col_idx = jnp.arange(n)[None, :]
    d = jnp.where(row_idx == 0, jnp.int8(1), d)
    d = jnp.where(col_idx == 0, jnp.int8(-1), d)
    d = jnp.where((row_idx == 0) & (col_idx == 0), jnp.int8(0), d)
    return d


def best_path(dirs: np.ndarray) -> Tuple[List[int], List[int]]:
    """Backtrack the optimal path (BestPathSequence,
    dynamic_time_warping.cc:102-132). Host-side."""
    dirs = np.asarray(dirs)
    i, j = dirs.shape[0] - 1, dirs.shape[1] - 1
    p1, p2 = [], []
    while i >= 0 and j >= 0:
        d = dirs[i, j]
        if d == -1:
            p1.append(i)
            p2.append(j)
            i -= 1
        elif d == 0:
            p1.append(i)
            p2.append(j)
            i -= 1
            j -= 1
        else:
            p1.append(i)
            p2.append(j)
            j -= 1
    p1.reverse()
    p2.reverse()
    return p1, p2


class DynamicTimeWarping:
    """API-parity wrapper mirroring the reference class
    (dynamic_time_warping.h:28-119). `distance` defaults to Euclidean
    (which runs fully on device); a custom Python distance falls back to a
    host loop, like the reference's std::function."""

    def __init__(self, dimension: int, distance: Optional[Callable] = None):
        self.dimension = dimension
        self.distance = distance
        self._dirs = None
        self._cost = None

    def compute(self, sequence1, sequence2) -> float:
        a = np.asarray(sequence1, np.float32)
        b = np.asarray(sequence2, np.float32)
        assert a.shape[1] == self.dimension and b.shape[1] == self.dimension
        if self.distance is None:
            cost = euclidean_cost_matrix(jnp.asarray(a), jnp.asarray(b))
        else:
            cost = jnp.asarray(
                [[self.distance(ra, rb) for rb in b] for ra in a], jnp.float32
            )
        total, acc = accumulate(cost)
        self._dirs = np.asarray(directions(cost, acc))
        self._cost = np.asarray(cost)
        return float(total)

    def best_path_sequence(self, sequence1=None, sequence2=None):
        assert self._dirs is not None, "call compute() first"
        return best_path(self._dirs)

    def display_debug_information(self, sequence1=None, sequence2=None, file=None):
        """Print the cost and direction matrices, mirroring the reference's
        DisplayDebugInformation (dynamic_time_warping.cc:134-154): one
        width-3 column per cell, row-major. The sequence arguments are
        accepted for signature parity but unused (like the reference,
        which only reads the stored matrices)."""
        import sys

        out = file if file is not None else sys.stdout
        assert self._dirs is not None, "call compute() first"
        print("Cost matrix:", file=out)
        for row in self._cost:
            print("".join(f"{v:3g} " for v in row), file=out)
        print("Directions matrix:", file=out)
        for row in self._dirs:
            print("".join(f"{int(v):3d} " for v in row), file=out)

    # C-style aliases for parity with the reference naming.
    Compute = compute
    BestPathSequence = best_path_sequence
    DisplayDebugInformation = display_debug_information
