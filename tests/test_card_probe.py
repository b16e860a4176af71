"""tools/card_probe.py's CPU-checkable parts: the span gather it times
against the production per-row gather returns the same rows, and its
precision override restores the production precision."""

import numpy as np
import pytest

from tools import card_probe


@pytest.mark.parametrize("K,width", [(300, 321), (128, 441)])
def test_span_gather_matches_per_row(K, width):
    import jax.numpy as jnp

    from speedy_tpu.ops import wsola_fast

    rng = np.random.default_rng(3)
    B, L = 2, 200000
    x = jnp.asarray(rng.standard_normal((B, L)).astype(np.float32))
    steps = rng.uniform(40.0, 900.0, (B, K))
    starts = np.minimum(np.cumsum(steps, axis=1), L - width - 1).astype(np.int32)
    starts = jnp.asarray(starts)
    np.testing.assert_array_equal(
        np.asarray(card_probe.gather_rows_spans(x, starts, width)),
        np.asarray(wsola_fast._gather_rows(x, starts, width)),
    )


def test_analysis_precision_override_restores():
    import jax

    from speedy_tpu.ops import dft

    with card_probe.analysis_precision(jax.lax.Precision.HIGH):
        assert dft.ANALYSIS_PRECISION == jax.lax.Precision.HIGH
    assert dft.ANALYSIS_PRECISION == jax.lax.Precision.HIGHEST


def test_main_refuses_cpu(capsys):
    assert card_probe.main([]) == 2
    assert "no GPU" in capsys.readouterr().err
