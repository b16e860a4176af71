"""tools/stage_trace.py's reduction: HLO scope map and per-stage sums."""

import jax
import jax.numpy as jnp

from tools import stage_trace


def test_scope_map_finds_every_stage_in_the_compiled_step():
    from speedy_tpu.config import SpeedyConfig
    from speedy_tpu.parallel.batch import batched_nonlinear_speedup

    cfg = SpeedyConfig(16000)
    xs = jnp.zeros((2, 16000))
    lengths = jnp.full((2,), 16000, jnp.int32)
    hlo = (
        jax.jit(lambda x, l: batched_nonlinear_speedup(x, l, cfg, 3.5).output)
        .lower(xs, lengths)
        .compile()
        .as_text()
    )
    stages = set(stage_trace.scope_map(hlo).values())
    assert {"analysis", "speed_law", "time_map", "pitch", "synthesis"} <= stages


def test_reduce_events_sums_stages_and_busy_share():
    inst = {"fusion.1": "pitch", "fusion_2": "analysis"}
    events = [  # (name, hlo_op, start_ns, dur_ns, stats)
        ("k1", "fusion.1", 0, 100, {}),
        ("fusion_2", "", 50, 100, {}),  # overlaps k1; matched by name
        ("k3", "", 300, 50, {"name": "jit(step)/synthesis/add"}),
        ("k4", "", 400, 50, {}),
    ]
    res = stage_trace.reduce_events(events, inst, steps=2)
    assert res["stage_ms_per_step"] == {
        "analysis": 50e-6, "other": 25e-6, "pitch": 50e-6, "synthesis": 25e-6,
    }
    assert res["device_ms_per_step"] == 150e-6
    # busy = [0, 150) + [300, 350) + [400, 450) = 250 of a 450 ns window
    assert abs(res["busy_share_of_window"] - 250 / 450) < 1e-12
