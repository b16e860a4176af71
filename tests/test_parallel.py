"""Batch engine and multi-chip sharding tests (8 virtual CPU devices via
conftest's xla_force_host_platform_device_count)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import testutil
from speedy_tpu.config import SpeedyConfig
from speedy_tpu.ops.analysis import analyze
from speedy_tpu.parallel.batch import (
    CorpusEngine,
    batched_analysis,
    batched_nonlinear_speedup,
)
from speedy_tpu.parallel.mesh import make_mesh

CFG16 = SpeedyConfig(16000)


def make_batch(B=4, L=8000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / 16000.0
    xs = np.stack(
        [
            (0.3 * np.sin(2 * np.pi * (150 + 40 * b) * t) * np.clip(np.sin(2 * np.pi * 3 * t), 0, None)).astype(np.float32)
            for b in range(B)
        ]
    )
    xs += rng.normal(size=xs.shape).astype(np.float32) * 0.001
    return xs


def test_batched_analysis_matches_vmap():
    """The fused batched front-end must be bit-compatible with the
    per-utterance analyze() under vmap: both run the identical XLA
    formulation, so the gate is tight."""
    xs = make_batch()
    T = CFG16.num_frames(xs.shape[1], integer_step=True)
    got = np.asarray(batched_analysis(jnp.asarray(xs), CFG16, T))
    ref = np.asarray(
        jax.vmap(lambda x: analyze(x, CFG16, num_frames=T, integer_step=True).tension)(
            jnp.asarray(xs)
        )
    )
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_batched_speedup_shapes_and_rates():
    xs = make_batch()
    lengths = jnp.asarray([8000, 8000, 6000, 4000], jnp.int32)
    out = batched_nonlinear_speedup(jnp.asarray(xs), lengths, CFG16, 3.0)
    valid = np.asarray(out.valid_length)
    for b, l in enumerate([8000, 8000, 6000, 4000]):
        achieved = l / valid[b]
        assert 2.0 < achieved < 4.5, (b, achieved)
    # Output is zero beyond valid.
    y = np.asarray(out.output)
    for b in range(4):
        assert not y[b, valid[b] :].any()


def test_padding_invariance():
    """An utterance's output must not depend on how much padding follows it
    in the batch bucket."""
    xs = make_batch(B=1, L=6000)
    lengths = jnp.asarray([6000], jnp.int32)
    out1 = batched_nonlinear_speedup(jnp.asarray(xs), lengths, CFG16, 2.5)
    xs_pad = np.zeros((1, 8192), np.float32)
    xs_pad[0, :6000] = xs[0]
    cap = out1.output.shape[1]
    steps = None
    out2 = batched_nonlinear_speedup(
        jnp.asarray(xs_pad), lengths, CFG16, 2.5, capacity=cap
    )
    v1, v2 = int(out1.valid_length[0]), int(out2.valid_length[0])
    assert abs(v1 - v2) <= 2
    n = min(v1, v2)
    np.testing.assert_allclose(
        np.asarray(out1.output[0, :n]), np.asarray(out2.output[0, :n]), atol=1e-4
    )


def test_mesh_sharded_matches_unsharded():
    """dp x tp mesh execution must be numerically equivalent to single-
    device execution (collectives change layout, not values) — INCLUDING
    the resynthesized output waveform, not just tension/valid_length (the
    WSOLA stage runs inside shard_map; a partitioning regression there
    must fail this gate)."""
    if jax.device_count() < 4:
        pytest.skip("needs >= 4 devices")
    mesh = make_mesh(dp=jax.device_count() // 2, tp=2)
    xs = make_batch(B=8)
    lengths = jnp.asarray([8000] * 8, jnp.int32)
    ref = batched_nonlinear_speedup(jnp.asarray(xs), lengths, CFG16, 3.0)
    got = jax.jit(
        lambda x, l: batched_nonlinear_speedup(x, l, CFG16, 3.0, mesh=mesh)
    )(jnp.asarray(xs), lengths)
    np.testing.assert_allclose(
        np.asarray(got.tension), np.asarray(ref.tension), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(got.valid_length), np.asarray(ref.valid_length)
    )
    # Output-waveform equality. tp-partitioned DFT matmuls reorder float
    # reductions, so tension (and thus speeds) differ at the few-ulp
    # level; the audio must still agree tightly sample-by-sample.
    np.testing.assert_allclose(
        np.asarray(got.output), np.asarray(ref.output), atol=2e-3
    )
    err = np.abs(np.asarray(got.output) - np.asarray(ref.output))
    assert err.mean() < 1e-5, err.mean()


def test_wsola_shard_map_matches_unsharded():
    """The shard_map'd grid engine must produce the same audio as the
    unsharded engine when fed identical speeds. Every row's computation is
    device-local, but XLA's einsum rounding is batch-shape dependent
    (B/dp-row shards vs the full batch), so the pitch parabola moves by
    ulps and interpolated samples shift at the ~1e-4 level; anything
    beyond that (silent replication, wrong rows, a broken collective)
    fails this gate."""
    if jax.device_count() < 4:
        pytest.skip("needs >= 4 devices")
    from speedy_tpu.ops import wsola_fast
    from speedy_tpu.parallel.batch import _run_grid_engine

    mesh = make_mesh(dp=4, tp=jax.device_count() // 4)
    cfg = CFG16
    B, L = 8, 8000
    xs = jnp.asarray(make_batch(B=B, L=L))
    lengths = jnp.asarray([L, L, 6000, 4000, L, 7000, L, 5000], jnp.int32)
    F = L // cfg.frame_step_int
    rng = np.random.default_rng(3)
    speeds = jnp.asarray(
        rng.uniform(1.2, 3.4, size=(B, F)).astype(np.float32)
    )
    minp, maxp = cfg.wsola_min_period, cfg.wsola_max_period
    hop, gcap, K = wsola_fast.plan_grid(cfg, L, 1.0)
    args = (xs, lengths, speeds, minp, maxp, cfg.frame_step_int, hop, gcap, K, 4.0)
    ref = _run_grid_engine(*args, None)
    got = jax.jit(lambda x, l, s: _run_grid_engine(
        x, l, s, *args[3:], mesh))(xs, lengths, speeds)
    np.testing.assert_array_equal(
        np.asarray(got.valid_length), np.asarray(ref.valid_length)
    )
    err = np.abs(np.asarray(got.output) - np.asarray(ref.output))
    assert err.max() < 1e-3 and err.mean() < 1e-5, (err.max(), err.mean())


def test_wsola_shard_map_pads_ragged_batch():
    """B not divisible by dp: the shard_map wrapper zero-pads and trims;
    real rows must be untouched."""
    if jax.device_count() < 4:
        pytest.skip("needs >= 4 devices")
    from speedy_tpu.ops import wsola_fast
    from speedy_tpu.parallel.batch import _run_grid_engine

    mesh = make_mesh(dp=4, tp=jax.device_count() // 4)
    cfg = CFG16
    B, L = 6, 6000  # 6 % 4 != 0
    xs = jnp.asarray(make_batch(B=B, L=L))
    lengths = jnp.asarray([L] * B, jnp.int32)
    F = L // cfg.frame_step_int
    speeds = jnp.full((B, F), 2.5, jnp.float32)
    minp, maxp = cfg.wsola_min_period, cfg.wsola_max_period
    hop, gcap, K = wsola_fast.plan_grid(cfg, L, 1.0)
    args = (xs, lengths, speeds, minp, maxp, cfg.frame_step_int, hop, gcap, K, 4.0)
    ref = _run_grid_engine(*args, None)
    got = _run_grid_engine(*args, mesh)
    assert got.output.shape == ref.output.shape
    np.testing.assert_array_equal(
        np.asarray(got.valid_length), np.asarray(ref.valid_length)
    )
    err = np.abs(np.asarray(got.output) - np.asarray(ref.output))
    assert err.max() < 1e-3 and err.mean() < 1e-5, (err.max(), err.mean())


def test_corpus_engine_end_to_end():
    cfg = SpeedyConfig(22050)
    utts = [
        (np.sin(np.arange(n) * 2 * np.pi * 237 / 22050) * 20000).astype(np.int16)
        for n in (22050, 15000, 30000, 8000, 11025)
    ]
    engine = CorpusEngine(cfg, global_speed=3.0, nonlinear_factor=1e-5, batch_size=3)
    results = engine.process(utts)
    assert len(results) == len(utts)
    for u, r in zip(utts, results):
        expected = len(u) / 3.0
        assert abs(len(r) - expected) < 0.04 * expected + 60, (len(u), len(r))


def test_corpus_packed_wire_bit_exact():
    """Packed-wire staging gate: (a) an int16 PCM corpus rides the int16
    wire and its results equal the float32-wire results quantized with
    the shim's clip(round(y*2^15)) rule BIT-FOR-BIT (the device builds
    the identical f32 xs from the int16 flat buffer, so the pipeline and
    the quantization see identical values); (b) a float32 corpus through
    the packed wire equals direct host-padded batched_nonlinear_speedup
    exactly; (c) wire-byte counters account the shipped bytes."""
    cfg = SpeedyConfig(16000)
    rng = np.random.default_rng(11)
    utts_f = [
        (np.sin(np.arange(n) * 2 * np.pi * 219 / 16000) * 0.6
         + 0.01 * rng.standard_normal(n)).astype(np.float32)
        for n in (16000, 9000, 12000, 5000)
    ]
    utts_i = [
        np.clip(np.round(u * 32768.0), -32768, 32767).astype(np.int16)
        for u in utts_f
    ]

    eng_i16 = CorpusEngine(cfg, 3.0, batch_size=4)
    res_i16 = eng_i16.process(utts_i)
    assert all(r.dtype == np.int16 for r in res_i16)
    assert eng_i16.stats["wire_up_bytes"] < 3 * sum(u.nbytes for u in utts_i)
    # Packed DOWN-wire (round-5): the fetch is the device-compacted
    # valid prefix — real output bytes + one host quantum (65536
    # samples) per batch + the valid vector, NOT the [B, cap] buffer.
    real_down = sum(r.nbytes for r in res_i16)
    assert eng_i16.stats["wire_down_bytes"] <= real_down + 2 * 65536 + 64, (
        eng_i16.stats["wire_down_bytes"],
        real_down,
    )

    eng_f32 = CorpusEngine(cfg, 3.0, batch_size=4, int16_wire=False)
    res_f32 = eng_f32.process(utts_i)  # same int16 corpus, float wire
    assert all(r.dtype == np.float32 for r in res_f32)
    for a, b in zip(res_i16, res_f32):
        q = np.clip(np.round(b * 32768.0), -32768, 32767).astype(np.int16)
        np.testing.assert_array_equal(a, q)

    # Float corpus: packed wire == direct host-padded batch step, exactly.
    res_pf = CorpusEngine(cfg, 3.0, batch_size=4).process(utts_f)
    assert all(r.dtype == np.float32 for r in res_pf)
    order = sorted(range(4), key=lambda j: len(utts_f[j]))
    L = 16384
    xs = np.zeros((4, L), np.float32)
    lens = np.zeros((4,), np.int32)
    for k, j in enumerate(order):
        xs[k, : len(utts_f[j])] = utts_f[j]
        lens[k] = len(utts_f[j])
    out = batched_nonlinear_speedup(jnp.asarray(xs), jnp.asarray(lens), cfg, 3.0)
    y, valid = np.asarray(out.output), np.asarray(out.valid_length)
    for k, j in enumerate(order):
        np.testing.assert_array_equal(res_pf[j], y[k, : valid[k]])


@pytest.mark.slow  # ~3 min; the driver itself runs dryrun_multichip every round
def test_dryrun_multichip_entry():
    """The driver's multi-chip dry run must compile and execute."""
    import sys, pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import __graft_entry__ as ge

    n = jax.device_count()
    ge.dryrun_multichip(n)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.tree_util.tree_map(lambda a: a.block_until_ready(), out)


def test_batched_slowdown_capacity_contract():
    """Regression: at sub-unity global speeds the speed law can clamp to
    kMinimumSpeed, far below the planner's default bound; speeds are now
    floored at the planned bound so output is never silently truncated."""
    xs = make_batch(B=2, L=8000, seed=7) * 5.0  # hot signal -> high tension
    lengths = jnp.asarray([8000, 8000], jnp.int32)
    out = batched_nonlinear_speedup(jnp.asarray(xs), lengths, CFG16, 0.5)
    valid = np.asarray(out.valid_length)
    # Output fits the planned capacity and is a genuine slowdown.
    assert np.all(valid <= out.output.shape[1])
    assert np.all(valid > 8000)
    y = np.asarray(out.output)
    for b in range(2):
        assert np.any(y[b, valid[b] - 400 : valid[b]] != 0)  # not truncated


def test_corpus_engine_with_mesh():
    """CorpusEngine in sharded mode on the virtual device mesh."""
    if jax.device_count() < 2:
        pytest.skip("needs >= 2 devices")
    cfg = SpeedyConfig(16000)
    utts = [make_batch(B=1, L=8000, seed=s)[0] for s in range(8)]
    plain = CorpusEngine(cfg, 3.0, batch_size=8).process(utts)
    meshed = CorpusEngine(cfg, 3.0, batch_size=8, use_mesh=True).process(utts)
    for a, b in zip(plain, meshed):
        assert abs(len(a) - len(b)) <= 2


def test_batched_multichannel():
    """Stereo batch: identical channels stay identical; distinct channels
    both resynthesize with the mono-derived positions."""
    from speedy_tpu.parallel.batch import batched_nonlinear_speedup_multichannel

    xs_mono = make_batch(B=2, L=8000)
    stereo_same = np.stack([xs_mono[:2], xs_mono[:2]], axis=-1)  # [B, L, 2]
    lengths = jnp.asarray([8000, 8000], jnp.int32)
    out = batched_nonlinear_speedup_multichannel(
        jnp.asarray(stereo_same), lengths, CFG16, 3.0
    )
    y = np.asarray(out.output)
    assert y.shape[1] == 2
    np.testing.assert_array_equal(y[:, 0], y[:, 1])
    # Matches the mono path exactly (mixdown of identical channels == mono).
    ref = batched_nonlinear_speedup(jnp.asarray(xs_mono[:2]), lengths, CFG16, 3.0)
    np.testing.assert_allclose(y[:, 0], np.asarray(ref.output), atol=1e-5)
    # Distinct channels: finite, same valid length.
    stereo_diff = np.stack([xs_mono[:2], np.roll(xs_mono[:2], 17, axis=1)], axis=-1)
    out2 = batched_nonlinear_speedup_multichannel(
        jnp.asarray(stereo_diff), lengths, CFG16, 3.0
    )
    assert np.all(np.isfinite(np.asarray(out2.output)))
    # Distinct channels change the mixdown (and thus the tension/speeds),
    # so lengths may differ from the identical-channel case — but both
    # channels of one utterance share the same valid region.
    v2 = np.asarray(out2.valid_length)
    y2 = np.asarray(out2.output)
    for b in range(2):
        assert 1500 < v2[b] < 4000
        assert not y2[b, :, v2[b] :].any()


def test_fused_input_gain_matches_prescaled():
    """gain=g must equal processing xs * g[:, None] (the multiply is
    folded into the pipeline's first copies; linearity of framing/
    preemphasis/DFT makes it exact up to fp rounding) — on both the
    grid and scan engines, and under a mesh."""
    xs = make_batch(B=8)
    lengths = jnp.asarray([8000] * 8, jnp.int32)
    g = jnp.asarray(np.linspace(0.4, 1.1, 8), jnp.float32)
    scaled = jnp.asarray(xs) * g[:, None]
    for engine in ("grid", "scan"):
        ref = batched_nonlinear_speedup(
            scaled, lengths, CFG16, 3.0, engine=engine
        )
        got = batched_nonlinear_speedup(
            jnp.asarray(xs), lengths, CFG16, 3.0, engine=engine, gain=g
        )
        np.testing.assert_array_equal(
            np.asarray(got.valid_length), np.asarray(ref.valid_length)
        )
        np.testing.assert_allclose(
            np.asarray(got.output), np.asarray(ref.output), atol=2e-4
        )
    if jax.device_count() >= 4:
        mesh = make_mesh(dp=jax.device_count() // 2, tp=2)
        got_m = jax.jit(
            lambda x, l, gg: batched_nonlinear_speedup(
                x, l, CFG16, 3.0, mesh=mesh, gain=gg
            )
        )(jnp.asarray(xs), lengths, g)
        ref_m = batched_nonlinear_speedup(scaled, lengths, CFG16, 3.0)
        np.testing.assert_allclose(
            np.asarray(got_m.output), np.asarray(ref_m.output), atol=2e-3
        )


def test_fused_input_gain_multichannel():
    """Multichannel gain path == prescaled multichannel input."""
    from speedy_tpu.parallel.batch import batched_nonlinear_speedup_multichannel

    xs = make_batch(B=2, L=8000)
    st = np.stack([xs, 0.5 * xs], axis=2)  # [B, L, 2]
    lengths = jnp.asarray([8000, 8000], jnp.int32)
    g = jnp.asarray([0.6, 1.2], jnp.float32)
    ref = batched_nonlinear_speedup_multichannel(
        jnp.asarray(st) * g[:, None, None], lengths, CFG16, 3.0
    )
    got = batched_nonlinear_speedup_multichannel(
        jnp.asarray(st), lengths, CFG16, 3.0, gain=g
    )
    np.testing.assert_array_equal(
        np.asarray(got.valid_length), np.asarray(ref.valid_length)
    )
    np.testing.assert_allclose(
        np.asarray(got.output), np.asarray(ref.output), atol=2e-4
    )


def test_mesh_analysis_xla_pads_ragged_batch():
    """batched_analysis on the XLA (non-kernel) path with a mesh and a
    non-dp-divisible batch: the up-front zero-pad must make the sharding
    constraints legal and leave real rows' tension unchanged (this
    combination raised a divisibility ValueError before the pad)."""
    if jax.device_count() < 8:
        pytest.skip("needs >= 8 devices")
    mesh = make_mesh(dp=4, tp=2)
    xs = make_batch(B=6)
    T = CFG16.num_frames(xs.shape[1], integer_step=True)
    ref = np.asarray(batched_analysis(jnp.asarray(xs), CFG16, T))
    got = np.asarray(batched_analysis(jnp.asarray(xs), CFG16, T, mesh=mesh))
    assert got.shape == ref.shape
    # tp-partitioned DFT-bin reductions reorder float sums (few-ulp).
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_capacity_factor_matches_default_plan():
    """Rate-derived capacity (the serving knob behind the bench's +25%)
    must be a pure buffer-size change: identical samples and
    valid_length vs the worst-case speed-1.0 plan whenever the output
    fits the tightened cap."""
    xs = make_batch()
    lengths = jnp.asarray([8000, 8000, 6000, 4000], jnp.int32)
    ref = batched_nonlinear_speedup(jnp.asarray(xs), lengths, CFG16, 3.0)
    got = batched_nonlinear_speedup(
        jnp.asarray(xs), lengths, CFG16, 3.0, capacity_factor=1.5
    )
    cap = got.output.shape[1]
    assert cap < ref.output.shape[1]  # the plan actually tightened
    np.testing.assert_array_equal(
        np.asarray(got.valid_length), np.asarray(ref.valid_length)
    )
    assert int(np.max(np.asarray(got.valid_length))) < cap  # no clamp hit
    np.testing.assert_array_equal(
        np.asarray(got.output), np.asarray(ref.output)[:, :cap]
    )


def test_grid_output_capacity_matches_buffer():
    """grid_output_capacity (the public sizing helper the bench's
    truncation guard checks against) must return the exact buffer width
    batched_nonlinear_speedup allocates — worst-case and rate-derived."""
    from speedy_tpu.parallel.batch import grid_output_capacity

    xs = make_batch()
    lengths = jnp.asarray([8000] * 4, jnp.int32)
    for factor in (None, 0.3, 1.5):
        out = batched_nonlinear_speedup(
            jnp.asarray(xs), lengths, CFG16, 3.0, capacity_factor=factor
        )
        assert out.output.shape[1] == grid_output_capacity(
            CFG16, xs.shape[1], 3.0, factor
        ), factor
    # Multichannel plans with the same helper (output is [B, C, cap]).
    from speedy_tpu.parallel.batch import batched_nonlinear_speedup_multichannel

    st = jnp.stack([jnp.asarray(xs), jnp.asarray(xs) * 0.5], axis=2)
    for factor in (None, 1.5):
        out = batched_nonlinear_speedup_multichannel(
            st, lengths, CFG16, 3.0, capacity_factor=factor
        )
        assert out.output.shape[2] == grid_output_capacity(
            CFG16, xs.shape[1], 3.0, factor
        ), factor


def test_capacity_factor_truncation_is_loud():
    """When an utterance's true output exceeds the rate-derived cap, the
    documented contract holds: valid_length == capacity exactly (the
    caller's retry signal — CorpusEngine acts on it) and the output
    buffer is fully populated, not silently zero-tailed."""
    xs = make_batch()
    lengths = jnp.asarray([8000] * 4, jnp.int32)
    out = batched_nonlinear_speedup(
        jnp.asarray(xs), lengths, CFG16, 3.0, capacity_factor=0.3
    )
    cap = out.output.shape[1]
    valid = np.asarray(out.valid_length)
    assert np.all(valid == cap)
    y = np.asarray(out.output)
    assert np.all(np.any(y[:, cap - 400 :] != 0, axis=1))


def test_corpus_engine_capacity_factor_retry():
    """CorpusEngine with a deliberately too-small capacity_factor must
    transparently redo truncated utterances under the worst-case plan —
    BATCHED (one retry dispatch per bucket, not B=1 per utterance), with
    the retry counted in stats and surfaced as a RuntimeWarning."""
    import warnings as _w

    utts = [make_batch(B=1, L=8000, seed=s)[0] for s in range(3)]
    plain = CorpusEngine(CFG16, 3.0, batch_size=3).process(utts)
    eng = CorpusEngine(CFG16, 3.0, batch_size=3, capacity_factor=0.3)
    with _w.catch_warnings(record=True) as rec:
        _w.simplefilter("always")
        tight = eng.process(utts)
    assert any("rate-derived output cap" in str(r.message) for r in rec)
    assert eng.stats["capacity_retries"] == 3
    assert eng.stats["retry_batches"] == 1  # batched, not per-utterance
    assert eng.stats["batches"] == 1
    for a, b in zip(plain, tight):
        assert len(a) == len(b)
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_corpus_engine_routes_long_utterances_to_streaming():
    """Utterances beyond long_utterance_samples bypass the padded-bucket
    batch engine and run through the device streaming pipeline (the
    batched engine's f32 output clock drifts on minutes-long files and
    its buckets double unboundedly). Output must agree with the batch
    engine at this still-batchable length, and short utterances in the
    same corpus stay on the batch path."""
    long_u = make_batch(B=1, L=24000, seed=7)[0]
    short_u = make_batch(B=1, L=8000, seed=8)[0]
    eng = CorpusEngine(
        CFG16, 3.0, batch_size=2, long_utterance_samples=16000
    )
    got = eng.process([long_u, short_u])
    assert eng.stats["streamed_long"] == 1
    assert eng.stats["batches"] == 1
    ref = CorpusEngine(CFG16, 3.0, batch_size=2).process([long_u, short_u])
    np.testing.assert_allclose(got[1], ref[1], atol=1e-6)
    n = min(len(got[0]), len(ref[0]))
    assert abs(len(got[0]) - len(ref[0])) <= 2
    d = np.abs(got[0][:n] - ref[0][:n])
    assert d.max() < 5e-3 and d.mean() < 1e-4, (d.max(), d.mean())


def test_corpus_bucket_ratio_invariance():
    """Outputs must be invariant to the bucket ladder (round-5 knob):
    a finer geometric ratio changes padded lengths, batch grouping, and
    dispatch count, but every utterance's audio must stay IDENTICAL up
    to the padding-invariance contract (same capacity plan per bucket —
    compare lengths exactly and samples to the padding-invariance
    tolerance)."""
    cfg = SpeedyConfig(16000)
    rng = np.random.default_rng(23)
    utts = []
    for n in (5000, 9000, 13000, 21000):
        t = np.arange(n) / 16000.0
        x = (0.4 * np.sin(2 * np.pi * 180 * t) * np.clip(np.sin(2 * np.pi * 2.2 * t), 0, None)
             + 0.005 * rng.standard_normal(n)).astype(np.float32)
        utts.append(np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16))
    res_a = CorpusEngine(cfg, 3.0, batch_size=3).process(utts)
    res_b = CorpusEngine(cfg, 3.0, batch_size=3, bucket_ratio=1.25).process(utts)
    for k, (a, b) in enumerate(zip(res_a, res_b)):
        assert abs(len(a) - len(b)) <= 2, (k, len(a), len(b))
        n = min(len(a), len(b))
        d = np.abs(a[:n].astype(np.int32) - b[:n].astype(np.int32))
        assert d.max() <= 2, (k, d.max())  # int16 LSBs of the f32 tolerance
