"""High-level pipelines: waveform in -> time-compressed waveform out.

This is the functional equivalent of the reference's sonic2 shim data path
(soniclib.c:240-373): analysis frames feed Speedy, tension becomes speed,
and each frame's audio is resynthesized at its frame's speed — but batched:
the whole utterance's tension/speed sequence is computed in one fused
device program, then the WSOLA scan consumes it.

Frame/speed alignment matches the shim exactly: frame k (samples
[k·step, (k+1)·step)) is written to the resynthesis engine at the speed
derived from tension(k); the trailing lookahead frames are flushed at the
last computed speed (soniclib.c:529-552).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from . import config as C
from .config import SpeedyConfig
from .ops import wsola, wsola_fast
from .ops.analysis import analyze_jit
from .ops.speed import speed_from_tension


class SpeedupResult(NamedTuple):
    output: np.ndarray       # int16 or float32 waveform (trimmed to length)
    tension: np.ndarray      # [T_out]
    speeds: np.ndarray       # [T_out] per-frame speeds sent to WSOLA
    achieved_rate: float     # input_len / output_len


def nonlinear_speedup(
    x,
    cfg: SpeedyConfig,
    global_speed: float,
    nonlinear_factor: float = 1.0,
    duration_feedback_strength: float = 0.1,
    min_speed_bound: Optional[float] = None,
    engine: str = "scan",
) -> SpeedupResult:
    """Speedy nonlinear speedup of one mono utterance.

    `x` may be int16 (scaled by 2^15 like speedyAddDataShort) or float32 in
    ±1. Default duration_feedback_strength mirrors the shim's default
    (soniclib.c:122). nonlinear_factor=0 short-circuits to pure linear
    WSOLA (soniclib.c:397-399). engine: "scan" (sonic-exact sequential
    algebra) or "grid" (parallel WSOLA, the throughput path).
    """
    x = np.asarray(x)
    if x.dtype == np.int16:
        xf = x.astype(np.float32) / 32768.0
    else:
        xf = x.astype(np.float32)

    if nonlinear_factor == 0.0:
        return linear_time_scale(x, cfg, global_speed, engine=engine)

    res = analyze_jit(xf, cfg, integer_step=True)
    tension = res.tension
    if tension.shape[0] == 0:
        speeds = jnp.asarray([global_speed], jnp.float32)
    else:
        speeds, _ = speed_from_tension(
            tension, global_speed, duration_feedback_strength, nonlinear_factor
        )

    if min_speed_bound is None:
        # Speeds are already concrete on host; plan buffers from the truth.
        min_speed_bound = max(C.MIN_SPEED, float(jnp.min(speeds)) * 0.999)
    scale = wsola_fast.time_scale_grid if engine == "grid" else wsola.time_scale
    out = scale(xf, speeds, cfg, min_speed_bound=min_speed_bound)
    n = int(out.valid_length)
    y = np.asarray(out.output[:n])
    if x.dtype == np.int16:
        y = np.clip(np.round(y * 32768.0), -32768, 32767).astype(np.int16)
    return SpeedupResult(
        y,
        np.asarray(tension),
        np.asarray(speeds),
        float(len(x)) / max(n, 1),
    )


def linear_time_scale(
    x, cfg: SpeedyConfig, speed: float, engine: str = "scan"
) -> SpeedupResult:
    """Pure WSOLA at constant speed (original-libsonic behavior)."""
    x = np.asarray(x)
    if x.dtype == np.int16:
        xf = x.astype(np.float32) / 32768.0
    else:
        xf = x.astype(np.float32)
    speeds = jnp.asarray([speed], jnp.float32)
    scale = wsola_fast.time_scale_grid if engine == "grid" else wsola.time_scale
    out = scale(xf, speeds, cfg, min_speed_bound=max(C.MIN_SPEED, speed * 0.999))
    n = int(out.valid_length)
    y = np.asarray(out.output[:n])
    if x.dtype == np.int16:
        y = np.clip(np.round(y * 32768.0), -32768, 32767).astype(np.int16)
    return SpeedupResult(
        y, np.zeros(0, np.float32), np.asarray(speeds), float(len(x)) / max(n, 1)
    )
