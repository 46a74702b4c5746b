"""PyTorch port: the one prefix-sum compaction of ExpandA / ExpandS against
the JAX compaction forms whose budget rules it reproduces."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dilithium_tpu.ops import sampling as jsampling
from dilithium_tpu_torch.ops import sampling


def _eq(got, exp):
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(exp).astype(np.int64))


def _synthetic_masks(rng, rows, n_cand, reject_rates):
    """Accept masks with reject rates around and beyond the budgets."""
    return np.stack([rng.random(n_cand) >= rate for rate in reject_rates for _ in range(rows)])


def test_compaction_budget_rule_matches_sparse_form():
    """ExpandA's rule (`_rank_compact_sparse`): ok iff the 256th accept lies
    at candidate <= 255 + max_skips; values equal wherever ok."""
    rng = np.random.default_rng(40)
    accept = _synthetic_masks(rng, 40, 280, [0.001, 0.02, 0.04, 0.08])
    cand = rng.integers(0, 1 << 23, size=accept.shape).astype(np.uint32)
    for max_skips in (8, 12):
        out, ok = sampling._compact(torch.from_numpy(cand.astype(np.int64)), torch.from_numpy(accept),
                                    256, 256 + max_skips)
        out_j, ok_j = jsampling._rank_compact_sparse(jnp.asarray(cand), jnp.asarray(accept), 256, max_skips)
        _eq(ok, ok_j)
        assert 0 < int(ok.sum()) < len(ok)  # both outcomes exercised
        _eq(out[ok], np.asarray(out_j)[ok.numpy()])


@pytest.mark.parametrize("p_accept", [15 / 16, 9 / 16])
def test_compaction_budget_rule_matches_logshift_form(p_accept):
    """ExpandS's rule (`_rank_compact_logshift_packed` with its 8-sigma
    window): ok iff 256 accepts lie within the window."""
    import math

    rng = np.random.default_rng(41)
    n_cand = 544 if p_accept > 0.9 else 816
    t = int(math.ceil(256 / p_accept + 8 * math.sqrt(256 * (1 - p_accept)) / p_accept)) + 2
    # reject rates that put the 256th accept just inside and just beyond t
    rates = [1 - 256 / (t - d) for d in (-6, 0, 6, 14)]
    accept = _synthetic_masks(rng, 30, n_cand, rates)
    cand = rng.integers(0, 16, size=accept.shape).astype(np.int32)
    out, ok = sampling._compact(torch.from_numpy(cand.astype(np.int64)), torch.from_numpy(accept), 256, t)
    out_j, ok_j = jsampling._rank_compact_logshift_packed(
        jnp.asarray(cand), jnp.asarray(accept), 256, val_bits=4, p_accept=p_accept)
    _eq(ok, ok_j)
    assert 0 < int(ok.sum()) < len(ok)
    _eq(out[ok], np.asarray(out_j)[ok.numpy()])
