"""Example: real-time-style streaming speedup with the sonic2-API shim.

Feeds a WAV (or a synthetic utterance) through the streaming runtime in
small chunks — the pattern a live playback pipeline uses — while tapping
the per-frame monitoring callbacks (tension, speed), and reports the
end-to-end latency contract (output lags input by the 8-frame tension
lookahead, like the reference shim). Run:

    python examples/streaming_realtime.py [--wav in.wav] [--speed 3.0] \
        [--chunk 1024] [--native]

--native uses the C++ runtime (csrc/libspeedy_tpu_native.so, built on
demand) through the identical API.
"""

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from speedy_tpu.config import SpeedyConfig  # noqa: E402


def synth(sr, seconds=4.0):
    n = int(sr * seconds)
    t = np.arange(n) / sr
    f0 = 120 * (1 + 0.15 * np.sin(2 * np.pi * 0.7 * t))
    phase = np.cumsum(2 * np.pi * f0 / sr)
    voiced = sum(np.sin(k * phase) / k for k in range(1, 5))
    env = np.clip(np.sin(2 * np.pi * 2.5 * t), 0, None)
    return (voiced * env * 0.25 * 32767).astype(np.int16)


def main():
    # Persistent XLA cache: repeat runs (e.g. the smoke tests) skip
    # recompilation entirely.
    from speedy_tpu.profiling import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--wav")
    ap.add_argument("--out", default="/tmp/streamed_out.wav")
    ap.add_argument("--speed", type=float, default=3.0)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--native", action="store_true")
    args = ap.parse_args()

    if args.wav:
        from speedy_tpu.io import read_wave

        samples, sr = read_wave(args.wav)
        if samples.ndim > 1:
            samples = samples[:, 0]
    else:
        sr = 16000
        samples = synth(sr)
    samples = samples.astype(np.int16)

    if args.native:
        from speedy_tpu.native import NativeSonicStream as Stream
    else:
        from speedy_tpu.streaming import SonicStream as Stream

    st = Stream(sr, 1)
    st.set_speed(args.speed)
    st.enable_nonlinear_speedup(1.0)

    tensions, speeds = [], []
    tension_cb = lambda s, t, v: tensions.append((t, v))
    speed_cb = lambda s, t, v: speeds.append((t, v))
    if hasattr(st, "set_on_tension"):  # native runtime
        st.set_on_tension(tension_cb)
        st.set_on_speed(speed_cb)
    else:
        st.on_tension = tension_cb
        st.on_speed = speed_cb

    out = []
    first_out_at = None
    fed = 0
    for i in range(0, len(samples), args.chunk):
        st.write_short(samples[i : i + args.chunk])
        fed = i + args.chunk
        got = st.read_short(8 * args.chunk)
        if len(got) and first_out_at is None:
            first_out_at = fed
        out.append(got)
    st.flush()
    while True:
        got = st.read_short(8 * args.chunk)
        if not len(got):
            break
        out.append(got)
    y = np.concatenate(out)

    cfg = SpeedyConfig(sr)
    print(f"in {len(samples)} samples @ {sr} Hz -> out {len(y)} "
          f"(ratio {len(samples)/max(len(y),1):.2f}, requested {args.speed})")
    if first_out_at is not None:
        frames = first_out_at / cfg.frame_step_int
        print(f"first audio after feeding ~{frames:.1f} frames "
              f"(analysis lookahead is {cfg.hysteresis_future} frames + "
              f"buffering)")
    if tensions:
        tv = np.array([v for _, v in tensions])
        sv = np.array([v for _, v in speeds])
        print(f"tension mean {tv.mean():.3f}; speed mean {sv.mean():.2f}")

    from speedy_tpu.io import write_wave

    write_wave(args.out, y, sr)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
