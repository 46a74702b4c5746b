"""PyTorch port: the one prefix-sum compaction of ExpandA / ExpandS against
the JAX compaction forms whose budget rules it reproduces (their outputs
recorded in `tests/jax_reference.py`)."""

import math

import numpy as np
import pytest
import torch

from dilithium_tpu_torch.ops import sampling
from jax_reference import assert_matches_jax, jax_ref

P_ACCEPT = [15 / 16, 9 / 16]


def _synthetic_masks(rng, rows, n_cand, reject_rates):
    """Accept masks with reject rates around and beyond the budgets."""
    return np.stack([rng.random(n_cand) >= rate for rate in reject_rates for _ in range(rows)])


def _sparse_inputs():
    """-> (cand uint32 [160, 280], accept bool [160, 280])."""
    rng = np.random.default_rng(40)
    accept = _synthetic_masks(rng, 40, 280, [0.001, 0.02, 0.04, 0.08])
    return rng.integers(0, 1 << 23, size=accept.shape).astype(np.uint32), accept


def test_compaction_budget_rule_matches_sparse_form():
    """ExpandA's rule (`_rank_compact_sparse`): ok iff the 256th accept lies
    at candidate <= 255 + max_skips; values equal wherever ok."""
    cand, accept = _sparse_inputs()
    ref = jax_ref("compaction_sparse")
    for max_skips in (8, 12):
        out, ok = sampling._compact(torch.from_numpy(cand.astype(np.int64)), torch.from_numpy(accept),
                                    256, 256 + max_skips)
        assert_matches_jax(ok, ref[f"ok {max_skips}"], "ok")
        assert 0 < int(ok.sum()) < len(ok)  # both outcomes exercised
        assert_matches_jax(out[ok], ref[f"out {max_skips}"], "values where ok")


def _logshift_inputs(p_accept):
    """-> (cand int32 [120, n_cand], accept bool [120, n_cand], the window
    t), reject rates that put the 256th accept just inside and just beyond
    t."""
    rng = np.random.default_rng(41)
    n_cand = 544 if p_accept > 0.9 else 816
    t = int(math.ceil(256 / p_accept + 8 * math.sqrt(256 * (1 - p_accept)) / p_accept)) + 2
    rates = [1 - 256 / (t - d) for d in (-6, 0, 6, 14)]
    accept = _synthetic_masks(rng, 30, n_cand, rates)
    return rng.integers(0, 16, size=accept.shape).astype(np.int32), accept, t


@pytest.mark.parametrize("p_accept", P_ACCEPT)
def test_compaction_budget_rule_matches_logshift_form(p_accept):
    """ExpandS's rule (`_rank_compact_logshift_packed` with its 8-sigma
    window): ok iff 256 accepts lie within the window."""
    cand, accept, t = _logshift_inputs(p_accept)
    out, ok = sampling._compact(torch.from_numpy(cand.astype(np.int64)), torch.from_numpy(accept), 256, t)
    ref = jax_ref("compaction_logshift")
    assert_matches_jax(ok, ref[f"ok {p_accept}"], "ok")
    assert 0 < int(ok.sum()) < len(ok)
    assert_matches_jax(out[ok], ref[f"out {p_accept}"], "values where ok")
