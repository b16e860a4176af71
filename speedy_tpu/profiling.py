"""Tracing / profiling utilities (SURVEY.md §5.1).

The reference's only observability is per-frame monitoring callbacks and
CLI dump files. The rebuild exposes:
  * the 15-feature matrix as a first-class batched output
    (ops.analysis.AnalysisResult.features) — the feature-tap API;
  * device-level tracing via jax.profiler (`trace` context manager);
  * simple wall/throughput counters for pipeline stages.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator


# Compile-cache directory when JAX_COMPILATION_CACHE_DIR is not set: a
# fixed path inside the checkout (listed in .gitignore). The path is part
# of the cache key, so it must not move between runs.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache for this process and
    return its directory. When JAX_COMPILATION_CACHE_DIR is set, JAX
    already uses it and nothing is changed; otherwise the cache goes to
    DEFAULT_CACHE_DIR. Called by the entry points (CLI, bench.py,
    chip_smoke.py, the examples), never by library code."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace viewable in TensorBoard/XProf."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Wall-clock + audio-throughput accounting per pipeline stage."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.audio_seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, audio_seconds: float = 0.0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self.audio_seconds[name] = (
                self.audio_seconds.get(name, 0.0) + audio_seconds
            )

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            rt = ""
            if self.audio_seconds.get(name):
                rt = f"  {self.audio_seconds[name] / total:,.0f}x realtime"
            lines.append(
                f"{name:24s} {total * 1000:9.1f} ms  x{self.counts[name]:<5d}{rt}"
            )
        return "\n".join(lines)


def feature_names() -> list:
    """Labels for the 15-feature vector (speedy.c:369-384 legend)."""
    return [
        "spectrogram_energy",
        "energy_lp",
        "energy_local",
        "energy_compressed",
        "energy_hysteresis",
        "low_energy_frame",
        "local_spectral_difference",
        "emphasis_weighted_local_difference",
        "emphasis_weighted_lpf",
        "relative_spectral_difference",
        "speech_changes",
        "audio_tension",
        "time_energy",
        "time_spectral",
        "low_energy_threshold",
    ]
