"""Example: corpus-scale nonlinear speedup with profiling and checkpointing.

Generates a small synthetic speech-like corpus, processes it with the
batched sharded CorpusEngine, reports throughput per stage, and
demonstrates streaming checkpoint/resume. Run:

    python examples/corpus_speedup.py [--speed 3.0] [--n 16]
"""

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from speedy_tpu.config import SpeedyConfig
from speedy_tpu.parallel.batch import CorpusEngine
from speedy_tpu.profiling import StageTimer


def synth_utterance(rng, sr, seconds):
    n = int(sr * seconds)
    t = np.arange(n) / sr
    f0 = rng.uniform(90, 220) * (1 + 0.1 * np.sin(2 * np.pi * 0.8 * t))
    phase = np.cumsum(2 * np.pi * f0 / sr)
    voiced = sum(np.sin(k * phase) / k for k in range(1, 5))
    envelope = np.clip(np.sin(2 * np.pi * rng.uniform(2, 4) * t), 0, None)
    return (voiced * envelope * 0.25).astype(np.float32)


def main():
    # Persistent XLA cache: repeat runs (e.g. the smoke tests) skip
    # recompilation entirely.
    from speedy_tpu.profiling import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--speed", type=float, default=3.0)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--sr", type=int, default=16000)
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    corpus = [
        synth_utterance(rng, args.sr, rng.uniform(2.0, 8.0)) for _ in range(args.n)
    ]
    total_audio = sum(len(u) for u in corpus) / args.sr

    cfg = SpeedyConfig(args.sr)
    engine = CorpusEngine(cfg, global_speed=args.speed, batch_size=8)
    timer = StageTimer()
    with timer.stage("warmup (compile)"):
        engine.process(corpus[:1])
    with timer.stage("corpus", audio_seconds=total_audio):
        outputs = engine.process(corpus)
    print(timer.report())
    achieved = total_audio / (sum(len(o) for o in outputs) / args.sr)
    print(f"{len(corpus)} utterances, {total_audio:.1f} audio-s, "
          f"achieved {achieved:.2f}x (requested {args.speed}x)")

    # Streaming checkpoint/resume demo.
    from speedy_tpu.checkpoint import restore_stream, snapshot_stream
    from speedy_tpu.streaming import SonicStream

    x16 = np.clip(corpus[0] * 32768, -32768, 32767).astype(np.int16)
    st = SonicStream(args.sr, 1)
    st.set_speed(args.speed)
    st.enable_nonlinear_speedup(1.0)
    st.write_short(x16[: len(x16) // 2])
    st2 = restore_stream(snapshot_stream(st))  # e.g. after a process restart
    st2.write_short(x16[len(x16) // 2 :])
    st2.flush()
    out = st2.read_short(10 * len(x16))
    print(f"streaming resume demo: {len(x16)} -> {len(out)} samples")


if __name__ == "__main__":
    main()
