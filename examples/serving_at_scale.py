"""Example: concurrent serving at scale with MultiStreamPipeline.

N live callers stream int16 PCM through ONE pipeline: every caller's
feed rides shared fixed-shape device dispatches (the reference serves
one sonicStream per caller — N callers pay N serial C loops;
soniclib.c:427-450), audio stays device-resident in per-slot sliding
windows, and the wire speaks the reference's int16 PCM format both ways
(sonicWriteShortToStream / sonicReadShortFromStream semantics on
device). Pipelines wider than 32 streams automatically serve through
dispatch GROUPS of <=32 slots (per-stream outputs stay equal to an
ungrouped pipeline's).

Also demonstrates mid-stream checkpoint/resume: one caller's lane is
snapshotted, the slot is reused by someone else, and the caller later
resumes on a fresh slot bit-identically (SURVEY.md §5.4).

Run:  python examples/serving_at_scale.py [--streams 8] [--speed 3.0] \
          [--seconds 4] [--feed-ms 500]
"""

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from speedy_tpu.config import SpeedyConfig  # noqa: E402


def caller_audio(sr, seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    f0 = rng.uniform(100, 230) * (1 + 0.12 * np.sin(2 * np.pi * 0.8 * t))
    phase = np.cumsum(2 * np.pi * f0 / sr)
    voiced = sum(np.sin(k * phase) / k for k in range(1, 5))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(1.8, 3.2) * t), 0, None)
    x = voiced * env * 0.25 + 0.002 * rng.standard_normal(n)
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def main():
    from speedy_tpu.profiling import enable_compile_cache

    enable_compile_cache()
    from speedy_tpu.multistream import MultiStreamPipeline

    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--speed", type=float, default=3.0)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--feed-ms", type=int, default=500)
    ap.add_argument("--chunk-frames", type=int, default=64)
    ap.add_argument("--segment-frames", type=int, default=128)
    args = ap.parse_args()

    sr = 16000
    cfg = SpeedyConfig(sr)
    ms = MultiStreamPipeline(
        cfg,
        args.speed,
        n_streams=args.streams,
        wire_dtype="int16",
        chunk_frames=args.chunk_frames,
        segment_frames=args.segment_frames,
    )
    feed = int(sr * args.feed_ms / 1000)
    callers = [caller_audio(sr, args.seconds, 100 + i) for i in range(args.streams)]
    sids = [ms.open() for _ in callers]
    outs = {s: [] for s in sids}
    pos = 0
    t0 = time.perf_counter()
    rounds = 0
    while pos < len(callers[0]):
        pairs = [(s, callers[i][pos : pos + feed]) for i, s in enumerate(sids)]
        for s, y in ms.feed_many(pairs).items():
            outs[s].append(y)
        pos += feed
        rounds += 1

    # Failover demo (§5.4): checkpoint caller 0's lane mid-stream and
    # resume it on a fresh lane of a SECOND pipeline (another server) —
    # continuation is bit-identical (gated by
    # test_multistream_lane_checkpoint_resume). The abandoned lane is
    # drained to free its slot.
    snapshot = ms.state_dict(sids[0])
    ms.flush(sids[0])  # first server drops the caller (tail discarded)
    ms2 = MultiStreamPipeline(
        cfg,
        args.speed,
        n_streams=2,
        wire_dtype="int16",
        chunk_frames=args.chunk_frames,
        segment_frames=args.segment_frames,
    )
    resumed = ms2.open()
    ms2.load_state_dict(resumed, snapshot)
    outs[sids[0]].append(ms2.flush(resumed))  # caller's tail, server 2

    for s in sids[1:]:
        outs[s].append(ms.flush(s))
    dt = time.perf_counter() - t0

    total_in = args.streams * args.seconds
    st = ms.stats
    print(
        f"{args.streams} streams x {args.seconds:g}s at {args.speed}x: "
        f"{total_in / dt:.1f} audio-s/s aggregate "
        f"({rounds} rounds, {st['chunk_dispatches']} chunk + "
        f"{st['segment_dispatches']} segment dispatches, "
        f"{st['chunks_processed'] / max(st['chunk_dispatches'], 1):.1f} "
        "chunks per dispatch)"
    )
    for i, s in enumerate(sids):
        y = np.concatenate(outs[s])
        print(
            f"  caller {i}: {len(callers[i]) / sr:.2f}s in -> "
            f"{len(y) / sr:.2f}s out (rate {len(callers[i]) / max(len(y), 1):.2f})"
            + ("  [checkpoint/resumed mid-stream]" if i == 0 else "")
        )


if __name__ == "__main__":
    main()
