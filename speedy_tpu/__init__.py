"""speedy_tpu: a JAX/XLA rebuild of google/speedy.

Nonlinear ("Mach1") speech speedup: a batched spectral front-end computes a
per-frame tension, a control law maps tension to instantaneous speed, and a
WSOLA resynthesis engine time-compresses the waveform at that varying speed.
See SURVEY.md at the repo root for the full blueprint.
"""

from .config import SpeedyConfig
from .ops.analysis import AnalysisResult, analyze, analyze_batch, analyze_jit
from .ops.chunked import chunked_tension
from .ops.speed import speed_from_tension

__all__ = [
    "SpeedyConfig",
    "AnalysisResult",
    "analyze",
    "analyze_batch",
    "analyze_jit",
    "chunked_tension",
    "speed_from_tension",
    "DeviceStreamingPipeline",
]


def __getattr__(name):
    # Lazy: streaming_device pulls in the batch engine; keep base import light.
    if name == "DeviceStreamingPipeline":
        from .streaming_device import DeviceStreamingPipeline

        return DeviceStreamingPipeline
    raise AttributeError(name)

__version__ = "0.1.0"
