"""Spectrogram via DFT-as-matmul: the replacement for KissFFT/FFTW.

The reference zero-pads a Hamming-windowed frame of W samples to 2W and runs
a complex FFT (speedy.c:438-474). 2W is never a power of two (660 at
22.05 kHz); because the input is real and only W+1 unique magnitude bins
exist, the transform is exactly two [T, W] @ [W, W+1] matmuls, which fuse
with the window multiply. This is the hot op of the front-end.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SpeedyConfig


# Matmul precision of the analysis DFTs: full float32. On an H100, XLA
# hands both DEFAULT and HIGH float32 dots to cuBLAS in TF32 (max
# relative error 2.9e-4 on a [4096, 240] @ [240, 241] product, against
# 6.2e-7 at HIGHEST), which moved tension by up to 0.059 (mean 2.6e-4)
# at 16 kHz and 0.15 at 22.05 kHz against this chain at HIGHEST
# (tools/card_probe.py; PERF.md).
ANALYSIS_PRECISION = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=16)
def hamming_window(window_size: int, dtype: str = "float32") -> np.ndarray:
    """Hamming window as designed in speedyCreateStream (speedy.c:256-258)."""
    i = np.arange(window_size, dtype=np.float64)
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * i / (window_size - 1.0))
    return w.astype(dtype)


@functools.lru_cache(maxsize=16)
def dft_matrices(window_size: int, dtype: str = "float32"):
    """Real/imag DFT basis for a real input zero-padded from W to N=2W.

    Returns (cos_mat, sin_mat), each [W, W+1]: bin k of frame f is
    sum_n f[n]·exp(-2πi·k·n/N). Bins 0..W cover DC..Nyquist; the upper half
    of the reference's full 2W-point magnitude array is the mirror of bins
    1..W-1 (real input), reconstructed by `full_magnitude` when needed.
    """
    n = np.arange(window_size, dtype=np.float64)[:, None]
    k = np.arange(window_size + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / (2.0 * window_size)
    return np.cos(ang).astype(dtype), (-np.sin(ang)).astype(dtype)


@functools.partial(jax.jit, static_argnames=("cfg", "precision"))
def magnitude_spectrogram(
    frames: jnp.ndarray, cfg: SpeedyConfig, precision=None
) -> jnp.ndarray:
    """|DFT| of Hamming-windowed, zero-padded frames: [T, W] -> [T, W+1].

    Matches speedySpectrogram (speedy.c:438-454) bins 0..fft_size/2.
    """
    if precision is None:
        precision = ANALYSIS_PRECISION
    dtype = frames.dtype
    win = jnp.asarray(hamming_window(cfg.window_size, np.dtype(dtype).name))
    cos_m, sin_m = dft_matrices(cfg.window_size, np.dtype(dtype).name)
    fw = frames * win[None, :]
    re = jnp.dot(fw, jnp.asarray(cos_m), precision=precision)
    im = jnp.dot(fw, jnp.asarray(sin_m), precision=precision)
    return jnp.sqrt(re * re + im * im)


@functools.partial(jax.jit, static_argnames=("cfg",))
def full_magnitude(half: jnp.ndarray, cfg: SpeedyConfig) -> jnp.ndarray:
    """Expand bins [.., W+1] to the reference's full fft_size array
    (speedy.c:450-452 stores all 2W bins; upper half mirrors 1..W-1)."""
    return jnp.concatenate([half[..., : cfg.window_size + 1],
                            half[..., 1 : cfg.window_size][..., ::-1]], axis=-1)
