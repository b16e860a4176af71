"""tools/divergence_witness.py at tiny sizes on the CPU backend, where
both pairs it explains agree (bit for bit for the stream pair)."""

from tools import divergence_witness as witness


def test_stream_witness_rebuilds_every_emitted_chunk():
    res = witness.run_stream(
        [0.2, 0.5, 0.9, 2.6, 0.4, 3.1], long_samples=1 << 15,
        stream_kw=dict(chunk_frames=64, segment_frames=128),
    )
    assert res["output_diff"]["identical"]
    assert res["chunks"] == res["output_diff"]["slots"]
    assert res["speeds_diff"]["max"] == 0.0 and res["dc"]["max"] == 0.0
    assert res["period_cells"]["flips"] == 0 and res["period_cells"]["cells"] > 0
    assert res["m_max"] > 100  # the snap count grows along the utterance
    assert res["slots"]["bad_slots"] == 0


def test_seqpar_witness_on_virtual_devices():
    res = witness.run_seqpar(3.0, n_utt=4)
    assert res["devices"] >= 2
    assert res["tension_diff"]["max"] < 1e-4
    assert res["dc_from_speeds"]["max"] < 0.01
    assert res["control_same_speeds_output_diff"]["slots_over_2e-3"] == 0
    assert res["period_cells_read"]["flips_are_ties"] is True
    assert res["control_slots"]["bad_slots"] == 0
    assert res["slots"]["bad_slots"] == 0


def test_time_map_matches_the_engine_formula():
    import numpy as np

    sp = np.array([2.0, 4.0, 1.0])
    # Output clock bounds 0, 80, 120, 280 for step 160.
    c = witness.time_map(sp, 160, np.array([0.0, 40.0, 100.0, 200.0, 400.0]))
    np.testing.assert_allclose(c, [0.0, 80.0, 240.0, 400.0, 600.0])
