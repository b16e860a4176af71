"""The Speedy analysis front-end: waveform -> per-frame tension + features.

This is the batched, frame-parallel recast of the reference's AddData /
ComputeTension pipeline (speedy.c:529-766). The only sequential pieces of
the algorithm are two 1-pole lowpass filters, which run as associative
scans; everything else (framing, preemphasis, DFT spectrogram, energy,
hysteresis, normalization, spectral difference) is data-parallel across
frames and vectorizes over utterances with vmap.

Key equivalences proven against the C code:
  * The preemphasis cross-frame state is a gather (see framing.py).
  * skip_frame_count (speedy.c:685-703) never survives a frame: it is set
    to 1 when a frame is low-energy and consumed by the post-decrement in
    the same call, so `skipped(t) = low_energy(t) or (t == 0)` exactly
    (t == 0 from the initialization at speedy.c:293).
  * The reference's ring buffers read zeros for out-of-range times (see
    hysteresis.py); spectrogram_history likewise gives zeros for frame -1
    (speedy.c:242-248, slot not yet overwritten when tension(0) runs).
  * Feature timestamps: the features vector snapshotted when tension(t) is
    returned mixes AddData-time values from frame t+future (energy_lp,
    energy_local, energy_compressed — speedy.c:106-109) with tension-time
    values for frame t — reproduced by shifting those three columns.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import config as C
from ..config import SpeedyConfig
from . import dft, filters, framing, hysteresis


class AnalysisResult(NamedTuple):
    """Batched analysis outputs.

    With T input frames and T_out = T - hysteresis_future tension frames:
      spectrogram:  [T, W+1]  magnitude bins 0..fft/2 per AddData frame
      normalized:   [T_out, W] energy-normalized spectrogram at tension time
      features:     [T_out, 15] the reference's feature vector per tension
                    frame (layout speedy.c:106-124)
      tension:      [T_out]
    """

    spectrogram: jnp.ndarray
    normalized: jnp.ndarray
    features: jnp.ndarray
    tension: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("eps",))
def normalize_by_energy(spectrogram: jnp.ndarray, eps: float = C.EPS):
    """speedyNormalizeByEnergy (speedy.c:628-647) over the last axis.

    Energy skips the DC bin; the normalization scales every bin (incl. DC).
    Returns (normalized, signal_energy).
    """
    energy = jnp.sum(spectrogram[..., 1:] ** 2, axis=-1)
    inv = 1.0 / (jnp.sqrt(energy) + jnp.asarray(eps, spectrogram.dtype))
    return spectrogram * inv[..., None], energy


def analyze(
    x: jnp.ndarray,
    cfg: SpeedyConfig,
    num_frames: Optional[int] = None,
    integer_step: bool = False,
    precision=None,  # None -> dft.ANALYSIS_PRECISION
    constrain_frames=None,
    constrain_spectrogram=None,
) -> AnalysisResult:
    """Full analysis of one utterance x[L] (float, nominal range ±1).

    `num_frames` defaults to the reference harness's count for len(x); pass
    it explicitly under jit/vmap when x is padded so the frame count stays
    static and padding frames are simply computed (their outputs are valid
    garbage to be masked by the caller — all ops are padding-safe).

    `constrain_frames` / `constrain_spectrogram` are optional hooks applied
    to the framed input [T, W] and the magnitude spectrogram [T, W+1]; the
    parallel engine injects jax.lax.with_sharding_constraint here to pin
    sequence-parallel (frame-axis) and tensor-parallel (bin-axis) layouts
    on a device mesh (see parallel/batch.py).
    """
    dtype = x.dtype
    W = cfg.window_size
    fut = cfg.hysteresis_future
    if num_frames is None:
        num_frames = cfg.num_frames(x.shape[-1], integer_step)
    T = num_frames
    T_out = cfg.num_tension_frames(T)
    if T == 0:
        # Input shorter than one analysis window: no frames, no tension —
        # the reference simply never returns data (speedy.c:752-765).
        return AnalysisResult(
            spectrogram=jnp.zeros((0, W + 1), dtype),
            normalized=jnp.zeros((0, W), dtype),
            features=jnp.zeros((0, C.FEATURE_COUNT), dtype),
            tension=jnp.zeros((0,), dtype),
        )

    starts = jnp.asarray(framing.frame_starts(cfg, T, integer_step))
    frames = framing.extract_frames(x, starts, W)
    state = framing.preemphasis_state(x, starts, W)
    pre = framing.preemphasize(frames, state)
    if constrain_frames is not None:
        pre = constrain_frames(pre)

    # --- AddData-time chain (speedy.c:540-551) ---
    spec = dft.magnitude_spectrogram(pre, cfg, precision=precision)  # [T, W+1]
    if constrain_spectrogram is not None:
        spec = constrain_spectrogram(spec)
    half = spec[:, :W]  # bins 0..fft/2-1, all any consumer reads
    # Local energy over bins 1..fft/2-1 (speedy.c:513-516).
    energy = jnp.sum(half[:, 1:] ** 2, axis=-1)  # [T]
    energy_lp = filters.first_order_lowpass(
        energy, cfg.lpf_alpha, C.MEAN_SPECTROGRAM_ENERGY
    )
    energy_local = energy / energy_lp
    energy_compressed = jnp.sqrt(jnp.minimum(energy_local, 2.0))  # speedy.c:520

    # --- ComputeTension-time chain for t = 0..T_out-1 (speedy.c:649-766) ---
    energy_hyst = hysteresis.tapered_max_hysteresis(
        energy_compressed, fut, cfg.hysteresis_past, T_out
    )

    cur = half[:T_out]  # frame t
    last = jnp.concatenate([jnp.zeros((1, W), dtype), half[: T_out - 1]])  # t-1
    normalized, sig_energy = normalize_by_energy(cur)
    normalized_last, _ = normalize_by_energy(last)

    low_thresh = jnp.asarray(cfg.low_energy_threshold, dtype)
    low_energy = sig_energy <= low_thresh
    first = jnp.arange(T_out) == 0
    skipped = low_energy | first  # see module docstring

    # 40 dB bin mask (speedy.c:705-719); DC excluded from both max and sum.
    bin_thresh = jnp.max(cur[:, 1:], axis=-1, keepdims=True) / 100.0
    mask = (cur[:, 1:] > bin_thresh) & (last[:, 1:] > bin_thresh)
    eps = jnp.asarray(C.EPS, dtype)
    log_ratio = jnp.abs(
        jnp.log((normalized[:, 1:] + eps) / (normalized_last[:, 1:] + eps))
    )
    lsd = jnp.sum(jnp.where(mask, log_ratio, 0.0), axis=-1)
    lsd = jnp.where(skipped, 0.0, lsd)
    ewld = lsd * energy_hyst  # zero when skipped since lsd is zeroed
    ew_lpf = filters.first_order_lowpass(
        jnp.where(skipped, 0.0, ewld), cfg.lpf_alpha, C.MEAN_EMPHASIS_WEIGHTED_LOCAL_DIFFERENCE
    )
    rsd = ewld / (ew_lpf + 0.01 * C.MEAN_EMPHASIS_WEIGHTED_LPF)
    rsd = jnp.where(skipped, 0.0, rsd)
    changes = jnp.where(
        skipped, 0.0, jnp.minimum(rsd, jnp.asarray(cfg.speech_changes_clamp, dtype))
    )

    tension = C.TENSION_A * (energy_hyst - C.TENSION_M_E) + C.TENSION_B * (
        changes - C.TENSION_M_S
    )

    # --- Feature vector (layout speedy.c:106-124; timing per docstring) ---
    t_idx = jnp.arange(T_out, dtype=dtype)
    feats = jnp.stack(
        [
            sig_energy,                           # 0 spectrogram_energy (t)
            energy_lp[fut : fut + T_out],         # 1 energy_lp (t+future)
            energy_local[fut : fut + T_out],      # 2 energy_local (t+future)
            energy_compressed[fut : fut + T_out], # 3 energy_compressed (t+future)
            energy_hyst,                          # 4
            skipped.astype(dtype),                # 5 low_energy_frame
            lsd,                                  # 6
            ewld,                                 # 7
            ew_lpf,                               # 8
            rsd,                                  # 9
            changes,                              # 10
            tension,                              # 11
            t_idx + fut,                          # 12 time_energy
            t_idx,                                # 13 time_spectral
            jnp.broadcast_to(low_thresh, (T_out,)),  # 14
        ],
        axis=-1,
    )
    return AnalysisResult(spec, normalized, feats, tension)


def analyze_batch(
    x: jnp.ndarray, cfg: SpeedyConfig, num_frames: int, integer_step: bool = False
) -> AnalysisResult:
    """vmap of `analyze` over a batch of equal-padded utterances [B, L]."""
    return jax.vmap(lambda u: analyze(u, cfg, num_frames, integer_step))(x)


@functools.lru_cache(maxsize=64)
def _compiled_analyze(cfg: SpeedyConfig, num_frames: int, integer_step: bool):
    return jax.jit(
        lambda u: analyze(u, cfg, num_frames=num_frames, integer_step=integer_step)
    )


def analyze_jit(x, cfg: SpeedyConfig, integer_step: bool = False) -> AnalysisResult:
    """Compiled entry point for one utterance (compile cached per shape)."""
    x = jnp.asarray(x)
    T = cfg.num_frames(x.shape[-1], integer_step)
    return _compiled_analyze(cfg, T, integer_step)(x)
