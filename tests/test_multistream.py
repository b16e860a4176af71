"""Gates for concurrent multi-stream serving (speedy_tpu/multistream.py):
per-stream outputs BIT-IDENTICAL to a standalone DeviceStreamingPipeline,
work genuinely multiplexed into shared fixed-shape dispatches, slot
lifecycle, per-stream rates, and multichannel lanes.

The bit-equality gate is the load-bearing one: every contract the
single-stream pipeline carries (seam exactness, Teager glitch gates,
flush semantics, batch-engine equivalence — tests/test_streaming_device.py)
transfers to every lane for free once outputs are bitwise equal."""

import numpy as np
import pytest

from speedy_tpu.config import SpeedyConfig
from speedy_tpu.multistream import MultiStreamPipeline
from speedy_tpu.streaming_device import DeviceStreamingPipeline

CFG16 = SpeedyConfig(16000)
KW = dict(chunk_frames=64, segment_frames=128)


def speechlike(seconds=6.0, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 130.0 + 35.0 * np.sin(2 * np.pi * 0.5 * t)
    phase = np.cumsum(2 * np.pi * f0 / sr)
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = np.clip(np.sin(2 * np.pi * 2.7 * t), 0, None)
    return (voiced * env * 0.3 + 0.002 * rng.standard_normal(t.size)).astype(
        np.float32
    )


def single_stream_ref(x, speed, feed_chunk=17000, **kw):
    pipe = DeviceStreamingPipeline(CFG16, speed, **kw)
    return pipe.process(np.asarray(x), feed_chunk=feed_chunk)


def test_multistream_bitwise_matches_single_stream():
    """Four staggered streams of different lengths/content through shared
    dispatches: each stream's output must be BIT-IDENTICAL to its own
    standalone DeviceStreamingPipeline run — and the dispatch counters
    must show real multiplexing (chunks per dispatch well above 1)."""
    xs = [speechlike(4.0 + i, seed=i) for i in range(4)]
    refs = [single_stream_ref(x, 3.0, **KW) for x in xs]

    ms = MultiStreamPipeline(CFG16, 3.0, n_streams=4, **KW)
    sids = [ms.open() for _ in xs]
    outs = {s: [] for s in sids}
    pos = [0] * 4
    chunk = 17000
    while any(pos[i] < len(xs[i]) for i in range(4)):
        pairs = []
        for i in range(4):
            if pos[i] < len(xs[i]):
                pairs.append((sids[i], xs[i][pos[i] : pos[i] + chunk]))
                pos[i] += chunk
        for s, y in ms.feed_many(pairs).items():
            outs[s].append(y)
    for s in sids:
        outs[s].append(ms.flush(s))

    for i, s in enumerate(sids):
        y = np.concatenate(outs[s])
        np.testing.assert_array_equal(y, refs[i], err_msg=f"stream {i}")

    # Multiplexing actually happened: while all four streams were live,
    # each chunk dispatch carried ~4 chunks (the tail/flush rounds carry
    # fewer as shorter streams drain — require a clear aggregate ratio).
    ratio = ms.stats["chunks_processed"] / ms.stats["chunk_dispatches"]
    assert ratio > 2.0, ms.stats
    assert ms.stats["segments_processed"] > ms.stats["segment_dispatches"], ms.stats
    assert ms.n_active == 0


def test_multistream_per_stream_rates_and_set_speed():
    """Streams at different rates share dispatches; a mid-stream
    set_speed on one lane matches the single-stream pipeline exactly."""
    x = speechlike(6.0, seed=11)
    rates = [2.0, 3.0, 4.0]
    # Plan bounds must cover every rate (the shared-plan contract).
    from speedy_tpu.parallel.batch import _plan_max_speed

    max_sb = max(_plan_max_speed(r, 1.0) for r in rates)
    mk = dict(KW, max_speed_bound=max_sb)

    refs = []
    for r in rates:
        p = DeviceStreamingPipeline(CFG16, r, min_speed_bound=1.0, **mk)
        a = p.feed(x[:48000])
        p.set_speed(r + 0.5)
        b = p.feed(x[48000:])
        c = p.flush()
        refs.append(np.concatenate([a, b, c]))

    ms = MultiStreamPipeline(
        CFG16, 3.0, n_streams=3, min_speed_bound=1.0, **mk
    )
    sids = [ms.open(r) for r in rates]
    outs = {s: [ms.feed(s, x[:48000])] for s in sids}
    for s, r in zip(sids, rates):
        ms.set_speed(s, r + 0.5)
    for s in sids:
        outs[s].append(ms.feed(s, x[48000:]))
    for s in sids:
        outs[s].append(ms.flush(s))
    for i, s in enumerate(sids):
        np.testing.assert_array_equal(
            np.concatenate(outs[s]), refs[i], err_msg=f"rate {rates[i]}"
        )


def test_multistream_slot_lifecycle():
    """Slot exhaustion raises; flushed slots are reusable and the reused
    slot's output is untainted by its previous occupant (the k==0 fresh-
    carry rule); out-of-plan rates are rejected."""
    x = speechlike(3.0, seed=5)
    ref = single_stream_ref(x, 3.0, **KW)

    ms = MultiStreamPipeline(CFG16, 3.0, n_streams=2, **KW)
    a = ms.open()
    b = ms.open()
    with pytest.raises(RuntimeError, match="busy"):
        ms.open()
    with pytest.raises(ValueError, match="plan bounds"):
        ms.open(9.0)
    with pytest.raises(KeyError):
        ms.feed(7, x)

    # Occupy slot a with different audio, flush, reopen, run x.
    ya = np.concatenate([ms.feed(a, speechlike(2.0, seed=99)), ms.flush(a)])
    assert len(ya) > 0
    a2 = ms.open()
    assert a2 == a  # the freed slot is reused
    y = np.concatenate([ms.feed(a2, x), ms.flush(a2)])
    np.testing.assert_array_equal(y, ref)
    # Lane b was live throughout; it still finishes correctly.
    yb = np.concatenate([ms.feed(b, x), ms.flush(b)])
    np.testing.assert_array_equal(yb, ref)


def test_multistream_early_flush_interleaved():
    """One lane flushes while another keeps streaming: the survivor's
    output is unaffected (flush runs masked single-lane dispatches
    against the same shared state)."""
    x_long = speechlike(7.0, seed=2)
    x_short = speechlike(2.0, seed=3)
    ref_long = single_stream_ref(x_long, 3.0, **KW)
    ref_short = single_stream_ref(x_short, 3.0, **KW)

    ms = MultiStreamPipeline(CFG16, 3.0, n_streams=2, **KW)
    sl = ms.open()
    ss = ms.open()
    out_l = [ms.feed(sl, x_long[:40000])]
    out_s = [ms.feed(ss, x_short)]
    out_s.append(ms.flush(ss))  # short stream ends mid-long-stream
    out_l.append(ms.feed(sl, x_long[40000:]))
    out_l.append(ms.flush(sl))
    np.testing.assert_array_equal(np.concatenate(out_s), ref_short)
    np.testing.assert_array_equal(np.concatenate(out_l), ref_long)


def test_multistream_stereo():
    """Multichannel lanes: a stereo pipeline's per-stream output matches
    the standalone stereo pipeline bit-for-bit."""
    x = speechlike(4.0, seed=7)
    stereo = np.stack([x, 0.7 * np.roll(x, 23)], axis=1)
    p = DeviceStreamingPipeline(CFG16, 3.0, **KW)
    ref = p.process(stereo, feed_chunk=20000)

    ms = MultiStreamPipeline(CFG16, 3.0, n_streams=2, channels=2, **KW)
    s0 = ms.open()
    s1 = ms.open()
    outs0 = [ms.feed(s0, stereo[:20000]), ms.feed(s0, stereo[20000:])]
    outs1 = [ms.feed(s1, stereo)]
    outs0.append(ms.flush(s0))
    outs1.append(ms.flush(s1))
    y0 = np.concatenate(outs0)
    y1 = np.concatenate(outs1)
    np.testing.assert_array_equal(y0, ref)
    np.testing.assert_array_equal(y1, ref)


def test_multistream_int16_wire():
    """The PCM serving wire (round 4): int16 feeds converted on device by
    the add_data_short rule x/2^15, int16 outputs via the read_short rule
    clip(round(x*2^15)) — bit-identical to a single-stream pipeline fed
    the dequantized floats with the same conversions applied on host."""
    x = speechlike(5.0, seed=21)
    xi = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    ref_f = single_stream_ref(xi.astype(np.float32) / 32768.0, 3.0, **KW)
    ref_i = np.clip(np.round(ref_f * 32768.0), -32768, 32767).astype(np.int16)

    ms = MultiStreamPipeline(CFG16, 3.0, n_streams=2, wire_dtype="int16", **KW)
    s = ms.open()
    s2 = ms.open()  # concurrent lane perturbs scheduling
    outs = [ms.feed(s, xi[:30000])]
    ms.feed(s2, np.ascontiguousarray(xi[::-1]))
    outs.append(ms.feed(s, xi[30000:]))
    outs.append(ms.flush(s))
    y = np.concatenate(outs)
    assert y.dtype == np.int16
    np.testing.assert_array_equal(y, ref_i)
    assert ms.flush(s2).dtype == np.int16
    # Float feeds must be rejected loudly on the int16 wire.
    ms2 = MultiStreamPipeline(CFG16, 3.0, n_streams=1, wire_dtype="int16", **KW)
    sid = ms2.open()
    with pytest.raises(TypeError, match="int16"):
        ms2.feed(sid, x[:1000])


def test_multistream_feed_validation_and_bounded_wire():
    """Owner-level feed contracts (round-4 review fixes): a channels=1
    pipeline REJECTS multichannel feeds (never silently downmixes),
    [n, 1] feeds are mono on both wires, feed_many validates like
    feed, int16 PCM history is not retained when no device ring
    consumes it, and flush-path rounds ship zero upload bytes."""
    x = speechlike(3.0, seed=33)
    xi = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)

    ms = MultiStreamPipeline(CFG16, 3.0, n_streams=2, **KW)
    sid = ms.open()
    with pytest.raises(ValueError, match="channels=1"):
        ms.feed(sid, np.stack([x[:2000], x[:2000]], axis=1))
    with pytest.raises(ValueError, match="channels=1"):
        ms.feed_many([(sid, np.stack([x[:2000], x[:2000]], axis=1))])
    # feed_many validation is ATOMIC: an invalid pair mid-list must not
    # leave earlier pairs half-ingested (no partial application).
    fed_before = ms._lane(sid)._fed
    with pytest.raises(ValueError, match="channels=1"):
        ms.feed_many(
            [
                (sid, x[:2000]),  # valid — must NOT be ingested
                (sid, np.stack([x[:2000], x[:2000]], axis=1)),  # invalid
            ]
        )
    assert ms._lane(sid)._fed == fed_before
    # [n, 1] is mono: bit-equal to the 1-D feed.
    y_col = np.concatenate([ms.feed(sid, x[:, None]), ms.flush(sid)])
    sid2 = ms.open()
    y_1d = np.concatenate([ms.feed(sid2, x), ms.flush(sid2)])
    np.testing.assert_array_equal(y_col, y_1d)

    # int16 wire + device_ring=False: nothing consumes the wire staging,
    # so PCM history must NOT accumulate (bounded-memory contract).
    ms2 = MultiStreamPipeline(
        CFG16, 3.0, n_streams=1, wire_dtype="int16", device_ring=False, **KW
    )
    s2 = ms2.open()
    lane = ms2._lane(s2)
    ms2.feed(s2, xi[:, None])  # [n, 1] int16 accepted as mono
    ms2.feed(s2, xi)
    assert lane._wire_pending == []
    out = np.concatenate([ms2.feed(s2, xi), ms2.flush(s2)])
    assert out.dtype == np.int16 and out.size > 0

    # Flush-path force_one rounds have nothing pending: the U=0 bucket
    # ships zero upload bytes (was a 32768-wide zero bucket per chunk).
    ms3 = MultiStreamPipeline(CFG16, 3.0, n_streams=1, **KW)
    s3 = ms3.open()
    ms3.feed(s3, x)
    up_before = ms3.stats["bytes_up"]
    ms3.flush(s3)
    assert ms3.stats["bytes_up"] == up_before


def test_multistream_ring_wraparound_and_split_writes():
    """A stream several times longer than the device ring (forced small
    via max_feed_samples) wraps it repeatedly, and feeds larger than the
    upload bucket split across write rounds — output stays bit-identical
    to the single-stream pipeline."""
    x = speechlike(8.0, seed=31)
    ref = single_stream_ref(x, 3.0, **KW)
    ms = MultiStreamPipeline(
        CFG16, 3.0, n_streams=2, max_feed_samples=20480, **KW
    )
    assert ms.R < len(x), "test premise: the stream must wrap the ring"
    s = ms.open()
    outs = []
    for pos in range(0, len(x), 50000):  # 50k feeds > 20480 bucket cap
        outs.append(ms.feed(s, x[pos : pos + 50000]))
    outs.append(ms.flush(s))
    np.testing.assert_array_equal(np.concatenate(outs), ref)
    # The deliberately tiny ring may age out under a 50k burst — the
    # host fallback covers that (bit-equality above is the gate). The
    # ring path itself must still have served most segments.
    ring_segs = ms.stats["segment_dispatches"] - ms.stats["ring_fallbacks"]
    assert ring_segs >= ms.stats["ring_fallbacks"], ms.stats


def test_multistream_device_ring_off_matches():
    """device_ring=False restores the host-upload dispatches (the
    multichannel/fallback path) — same outputs, by the same gate."""
    x = speechlike(4.0, seed=41)
    ref = single_stream_ref(x, 3.0, **KW)
    ms = MultiStreamPipeline(CFG16, 3.0, n_streams=2, device_ring=False, **KW)
    s = ms.open()
    y = np.concatenate([ms.feed(s, x), ms.flush(s)])
    np.testing.assert_array_equal(y, ref)


def test_multistream_slow_lane_capacity_fallback():
    """A lane near the plan's min speed needs more output than the
    rate-derived trim ships; the dispatch must route to the full-capacity
    program (correctness never depends on the trim)."""
    x = speechlike(4.0, seed=51)
    p = DeviceStreamingPipeline(CFG16, 1.2, min_speed_bound=1.0, **KW)
    ref = p.process(x, feed_chunk=17000)

    from speedy_tpu.parallel.batch import _plan_max_speed

    ms = MultiStreamPipeline(
        CFG16,
        3.0,
        n_streams=2,
        min_speed_bound=1.0,
        max_speed_bound=_plan_max_speed(3.0, 1.0),
        **KW,
    )
    slow = ms.open(1.2)
    # out_need at rate 1.2 exceeds the rg=3.0-derived trim.
    assert ms.Fseg * ms.step / 1.2 > ms.out_cap
    outs = []
    for pos in range(0, len(x), 17000):
        outs.append(ms.feed(slow, x[pos : pos + 17000]))
    outs.append(ms.flush(slow))
    np.testing.assert_array_equal(np.concatenate(outs), ref)


def test_multistream_lane_checkpoint_resume():
    """§5.4 across runtimes: a lane snapshotted mid-stream restores into
    (a) a standalone DeviceStreamingPipeline and (b) a fresh lane of
    another MultiStreamPipeline, both continuing bit-identically — the
    live carries live stacked in the owner, so this gates the slot-row
    extraction/injection."""
    x = speechlike(6.0, seed=71)
    ref = single_stream_ref(x, 3.0, **KW)

    ms = MultiStreamPipeline(CFG16, 3.0, n_streams=2, **KW)
    s = ms.open()
    noise = ms.open()  # concurrent lane keeps the stacked state non-trivial
    head = [ms.feed(s, x[:50000])]
    ms.feed(noise, speechlike(2.0, seed=72))
    snap = ms.state_dict(s)  # public §5.4 surface

    # (a) standalone pipeline resumes the lane.
    p = DeviceStreamingPipeline(CFG16, 3.0, **KW)
    p.load_state_dict(snap)
    tail_a = [p.feed(x[50000:]), p.flush()]
    np.testing.assert_array_equal(
        np.concatenate(head + tail_a), ref, err_msg="standalone resume"
    )

    # (b) a fresh lane of a different MultiStreamPipeline resumes it.
    ms2 = MultiStreamPipeline(CFG16, 3.0, n_streams=2, **KW)
    s2 = ms2.open()
    ms2.load_state_dict(s2, snap)  # public §5.4 surface
    tail_b = [ms2.feed(s2, x[50000:]), ms2.flush(s2)]
    np.testing.assert_array_equal(
        np.concatenate(head + tail_b), ref, err_msg="lane resume"
    )
    ms.flush(noise)


def test_corpus_engine_long_utterances_batched():
    """Verdict item: CorpusEngine's long-utterance path streams MANY
    long files in shared dispatches (not serially at B=1). Eight long
    utterances must come out bit-identical to the serial single-stream
    path, with the dispatch counters proving real multiplexing."""
    from speedy_tpu.parallel.batch import CorpusEngine

    skw = dict(chunk_frames=64, segment_frames=128)
    # 2.2-3.6 s utterances; threshold 2^15 samples (~2 s) marks them all
    # "long" so the test stays fast while exercising the real route.
    utts = [speechlike(2.2 + 0.2 * i, seed=40 + i) for i in range(8)]
    common = dict(
        long_utterance_samples=1 << 15,
        stream_kw=skw,
    )
    serial = CorpusEngine(CFG16, 3.0, stream_batch=1, **common)
    ref = serial.process(utts)
    assert serial.stats["streamed_long"] == 8
    assert serial.stats["stream_chunk_dispatches"] == 0  # serial path

    eng = CorpusEngine(CFG16, 3.0, stream_batch=4, **common)
    got = eng.process(utts)
    assert eng.stats["streamed_long"] == 8
    for i in range(8):
        np.testing.assert_array_equal(got[i], ref[i], err_msg=f"utt {i}")
    # Shared dispatches: with 4 lanes live, each chunk dispatch carries
    # multiple chunks.
    assert eng.stats["stream_chunks"] > 2 * eng.stats["stream_chunk_dispatches"], eng.stats
    assert eng.stats["stream_segments"] > eng.stats["stream_segment_dispatches"], eng.stats

    # The mixed corpus still reassembles in input order: short utterances
    # ride the padded-bucket batch engine alongside the streamed longs.
    mixed = [utts[0], speechlike(0.9, seed=60), utts[1], speechlike(1.1, seed=61)]
    eng2 = CorpusEngine(CFG16, 3.0, stream_batch=4, batch_size=2, **common)
    got2 = eng2.process(mixed)
    assert eng2.stats["streamed_long"] == 2 and eng2.stats["batches"] >= 1
    np.testing.assert_array_equal(got2[0], ref[0])
    np.testing.assert_array_equal(got2[2], ref[1])
    assert len(got2[1]) > 0 and len(got2[3]) > 0


def test_corpus_engine_long_int16_wire():
    """An int16 PCM corpus's long utterances ride the multistream int16
    wire (feeds verbatim, outputs device-quantized) and come out
    bit-identical to the serial float path's host-quantized results —
    the same int16-in -> int16-out contract as the bucket path."""
    from speedy_tpu.parallel.batch import CorpusEngine

    utts_f = [speechlike(2.2 + 0.2 * i, seed=70 + i) for i in range(4)]
    utts_i = [
        np.clip(np.round(u * 32768.0), -32768, 32767).astype(np.int16)
        for u in utts_f
    ]
    common = dict(long_utterance_samples=1 << 15,
                  stream_kw=dict(chunk_frames=64, segment_frames=128))
    serial = CorpusEngine(CFG16, 3.0, stream_batch=1, **common)
    ref = serial.process(utts_i)
    assert serial.stats["streamed_long"] == 4
    assert all(r.dtype == np.int16 for r in ref)

    eng = CorpusEngine(CFG16, 3.0, stream_batch=4, **common)
    got = eng.process(utts_i)
    assert all(r.dtype == np.int16 for r in got)
    # int16 feeds crossed the wire at 2 bytes/sample.
    assert eng.stats["wire_up_bytes"] <= 2 * sum(u.nbytes for u in utts_i)
    for i in range(4):
        np.testing.assert_array_equal(got[i], ref[i], err_msg=f"utt {i}")


def test_multistream_feed_chunking_invariance():
    """Like the single-stream gate: output is bit-identical regardless of
    how feeds are chunked or interleaved across lanes."""
    x = speechlike(5.0, seed=13)
    runs = []
    for chunks in ((9000, 31000, len(x) - 40000), (len(x),)):
        ms = MultiStreamPipeline(CFG16, 3.0, n_streams=2, **KW)
        s = ms.open()
        # A second lane streams noise concurrently to perturb scheduling.
        s2 = ms.open()
        rng = np.random.default_rng(0)
        outs = []
        pos = 0
        for c in chunks:
            outs.append(ms.feed(s, x[pos : pos + c]))
            ms.feed(s2, (0.01 * rng.standard_normal(12345)).astype(np.float32))
            pos += c
        outs.append(ms.flush(s))
        ms.flush(s2)
        runs.append(np.concatenate(outs))
    np.testing.assert_array_equal(runs[0], runs[1])
