"""Example: unbounded wav -> wav speedup through the device streaming
pipeline (speedy_tpu/streaming_device.py).

Feeds audio in small chunks — the pattern of a long-file/serving loop —
through feed()/flush(): analysis runs as an O(1)-state chunked scan,
WSOLA as segment-continued device calls sharing one global output clock,
so host and device memory stay bounded no matter how long the input is.
Demonstrates a mid-stream set_speed() change. Run:

    python examples/device_streaming.py [--wav in.wav] [--speed 3.0] \
        [--seconds 20] [--set-speed-at 0.5:4.0]
"""

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from speedy_tpu import DeviceStreamingPipeline, SpeedyConfig  # noqa: E402
from speedy_tpu.io import read_wave, write_wave  # noqa: E402


def synth(sr, seconds):
    t = np.arange(int(sr * seconds)) / sr
    f0 = 120 * (1 + 0.15 * np.sin(2 * np.pi * 0.7 * t))
    phase = np.cumsum(2 * np.pi * f0 / sr)
    voiced = sum(np.sin(k * phase) / k for k in range(1, 5))
    env = np.clip(np.sin(2 * np.pi * 2.5 * t), 0, None)
    return (voiced * env * 0.25).astype(np.float32)


def main():
    # Persistent XLA cache: repeat runs (e.g. the smoke tests) skip
    # recompilation entirely.
    from speedy_tpu.profiling import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--wav")
    ap.add_argument("--out", default="/tmp/device_streamed.wav")
    ap.add_argument("--speed", type=float, default=3.0)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument(
        "--set-speed-at",
        default="",
        help="FRACTION:SPEED — change the rate mid-stream, e.g. 0.5:4.0",
    )
    args = ap.parse_args()

    if args.wav:
        x, sr = read_wave(args.wav)
        if x.dtype == np.int16:
            x = x.astype(np.float32) / 32768.0
    else:
        sr = 16000
        x = synth(sr, args.seconds)

    change_at, new_speed = None, None
    if args.set_speed_at:
        frac, spd = args.set_speed_at.split(":")
        change_at = int(float(frac) * len(x))
        new_speed = float(spd)

    pipe = DeviceStreamingPipeline(SpeedyConfig(sr), args.speed)
    t0 = time.perf_counter()
    outs, fed = [], 0
    for i in range(0, len(x), args.chunk):
        if change_at is not None and fed <= change_at < fed + args.chunk:
            pipe.set_speed(new_speed)
            print(f"set_speed({new_speed}) at sample {fed}")
        outs.append(pipe.feed(x[i : i + args.chunk]))
        fed += min(args.chunk, len(x) - i)
    outs.append(pipe.flush())
    y = np.concatenate(outs)
    dt = time.perf_counter() - t0

    in_s = len(x) / sr
    print(
        f"streamed {in_s:.1f}s -> {len(y) / sr:.1f}s "
        f"(achieved {in_s / (len(y) / sr):.2f}x) in {dt:.1f}s wall "
        f"({in_s / dt:.0f}x real-time on {__import__('jax').default_backend()}); "
        f"host ring buffer peak ~{pipe.L_seg} samples"
    )
    write_wave(args.out, np.clip(y * 32768, -32768, 32767).astype(np.int16), sr)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
