"""speedy_wave-equivalent CLI (component C22, speedy_wave.cc).

Usage:
  python -m speedy_tpu.cli --input sound.wav --output fast.wav --speed 3.0
      [--nonlinear 1.0 | --linear] [--match_nonlinear] [--length SECONDS]
      [--duration_feedback_strength 0.1] [--rate 1.0]
      [--tension_file F] [--speed_file F] [--features_file F]
      [--spectrogram_file F] [--normalized_spectrogram_file F]
      [--engine stream|scan|grid|device-stream]

Flag set mirrors speedy_wave.cc:257-277, including:
  --match_nonlinear : run speedy once to measure the achieved rate, then
    compress at that measured overall speed (speedy_wave.cc:424-427);
  --length          : two-pass targeting of a total output duration
    (speedy_wave.cc:428-462).
Extras over the reference: --engine picks the streaming shim (exact
reference data flow, default) or the batched device pipelines; --rate adds
varispeed resampling (sonicSetRate).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .config import SpeedyConfig
from .io.wave import read_wave, write_wave


def compress_sound(
    input_file: str,
    speed: float,
    nonlinear: float,
    feedback: float,
    output_file: str = "",
    rate: float = 1.0,
    engine: str = "stream",
    dump_files: dict | None = None,
) -> float:
    """Read a WAV, speed it up, optionally write the result; return the
    achieved compression ratio (input frames / output frames) like
    speedy_wave.cc's compress_sound (speedy_wave.cc:154-242)."""
    samples, sr = read_wave(input_file)
    num_channels = 1 if samples.ndim == 1 else samples.shape[1]
    dump_files = dump_files or {}

    needs_stream = (
        bool(dump_files)
        or rate != 1.0
        or (num_channels > 1 and engine not in ("stream", "device-stream"))
    )
    if engine != "stream" and needs_stream:
        print(
            f"note: --engine {engine} does not support dump files, --rate, or "
            "multichannel input; using the streaming engine."
        )
    if engine == "stream" or needs_stream:
        out = _compress_streaming(
            samples, sr, num_channels, speed, nonlinear, feedback, rate, dump_files
        )
    elif engine == "device-stream":
        # Unbounded-length device pipeline (streaming_device.py): bounded
        # memory regardless of file length — the long-file serving path.
        from .streaming_device import DeviceStreamingPipeline

        is_int = samples.dtype == np.int16
        xf = samples.astype(np.float32) / 32768.0 if is_int else samples
        y = DeviceStreamingPipeline(
            SpeedyConfig(sr), speed, nonlinear, feedback
        ).process(xf)
        out = (
            np.clip(np.round(y * 32768.0), -32768, 32767).astype(np.int16)
            if is_int
            else y
        )
    else:
        from .pipeline import nonlinear_speedup

        out = nonlinear_speedup(
            samples, SpeedyConfig(sr), speed, nonlinear, feedback,
            engine=("grid" if engine == "grid" else "scan"),
        ).output

    if output_file:
        write_wave(output_file, out, sr)
    n_in = len(samples) if samples.ndim == 1 else samples.shape[0]
    n_out = len(out) if np.ndim(out) == 1 else np.shape(out)[0]
    return n_in / max(n_out, 1)


def _compress_streaming(
    samples, sr, num_channels, speed, nonlinear, feedback, rate, dump_files
):
    from .streaming import SonicStream

    st = SonicStream(sr, num_channels)
    st.set_speed(speed)
    if rate != 1.0:
        st.set_rate(rate)
    st.enable_nonlinear_speedup(nonlinear)
    st.set_duration_feedback_strength(feedback)

    writers = {}
    for key, path in dump_files.items():
        if path:
            writers[key] = open(path, "w")

    def dump(key, values):
        f = writers.get(key)
        if f is not None:
            f.write(" ".join(f"{v:g}" for v in np.atleast_1d(values)) + "\n")

    if "tension" in writers:
        st.on_tension = lambda s, t, v: dump("tension", v)
    if "speed" in writers:
        st.on_speed = lambda s, t, v: dump("speed", v)
    if "features" in writers:
        st.on_features = lambda s, t, v: dump("features", v)
    if "spectrogram" in writers:
        st.on_spectrogram = lambda s, t, v: dump("spectrogram", v)
    if "normalized_spectrogram" in writers:
        st.on_normalized_spectrogram = lambda s, t, v: dump(
            "normalized_spectrogram", v
        )

    flat = samples.reshape(-1)
    chunk = 1000 * num_channels
    outs = []
    for i in range(0, len(flat), chunk):
        st.write_short(flat[i : i + chunk])
        outs.append(st.read_short(4096))
    st.flush()
    while True:
        r = st.read_short(4096)
        if len(r) == 0:
            break
        outs.append(r)
    for f in writers.values():
        f.close()
    out = np.concatenate(outs) if outs else np.zeros(0, np.int16)
    if num_channels > 1:
        out = out.reshape(-1, num_channels)
    return out


def main(argv=None) -> int:
    from .profiling import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(
        prog="speedy_wave",
        description="Nonlinear (Mach1/Speedy) speech speedup of a WAV file.",
    )
    ap.add_argument("--input", "-i", required=True)
    ap.add_argument("--output", "-o", required=True)
    ap.add_argument("--speed", "-s", type=float, default=3.0)
    ap.add_argument("--nonlinear", "-n", type=float, default=1.0,
                    help="0 = linear; 1 = full speedy nonlinear speedup")
    ap.add_argument("--linear", "-l", action="store_true",
                    help="force linear speedup (nonlinear = 0)")
    ap.add_argument("--match_nonlinear", action="store_true",
                    help="measure the nonlinear achieved rate, then compress "
                         "at that overall speed")
    ap.add_argument("--length", "-e", type=float, default=0.0,
                    help="desired output length in seconds (two-pass)")
    ap.add_argument("--duration_feedback_strength", "-d", type=float, default=0.1)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="varispeed playback rate (sonicSetRate)")
    ap.add_argument("--tension_file", "-t", default="")
    ap.add_argument("--speed_file", "-p", default="")
    ap.add_argument("--features_file", "-f", default="")
    ap.add_argument("--spectrogram_file", "-S", default="")
    ap.add_argument("--normalized_spectrogram_file", "-N", default="")
    ap.add_argument("--engine", choices=("stream", "scan", "grid", "device-stream"),
                    default="stream")
    args = ap.parse_args(argv)

    speed = args.speed
    nonlinear = 0.0 if args.linear else args.nonlinear
    fb = args.duration_feedback_strength
    dumps = {
        "tension": args.tension_file,
        "speed": args.speed_file,
        "features": args.features_file,
        "spectrogram": args.spectrogram_file,
        "normalized_spectrogram": args.normalized_spectrogram_file,
    }

    if args.match_nonlinear:
        # speedy_wave.cc:424-427: measure the nonlinear achieved rate.
        speed = compress_sound(args.input, speed, 1.0, fb, "", engine=args.engine)
        print(f"Nonlinear run achieved {speed:.4f}x; matching it.")
    elif args.length > 0:
        # speedy_wave.cc:428-462: two-pass length targeting.
        samples, sr = read_wave(args.input)
        n = len(samples) if samples.ndim == 1 else samples.shape[0]
        desired_speed = (n / sr) / args.length
        achieved = compress_sound(
            args.input, desired_speed, 1.0, fb, "", engine=args.engine
        )
        speed = desired_speed * (desired_speed / achieved)
        print(
            f"Targeting {args.length}s: first pass at {desired_speed:.4f}x "
            f"achieved {achieved:.4f}x; using {speed:.4f}x."
        )

    kind = "non-linearly" if nonlinear > 0 else "linearly"
    print(f"Reading {args.input}, speeding up {kind} by {speed}x into {args.output}.")
    achieved = compress_sound(
        args.input, speed, nonlinear, fb, args.output, args.rate, args.engine, dumps
    )
    print(f"Achieved overall compression: {achieved:.4f}x.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
