"""PyTorch port: ExpandMask, its int8 limb form (the mask kernel's layout)
and SampleInBall vs the JAX package, byte-equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dilithium_tpu.ops import sampling as jsampling
from dilithium_tpu_torch import params
from dilithium_tpu_torch.ops import sampling

LEVELS = [2, 3, 5]


def _u8(rng, shape):
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def _eq(got, exp):
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(exp).astype(np.int64))


@pytest.mark.parametrize("level", LEVELS)
def test_expand_mask_and_limbs_match_jax(level):
    p = params.get_params(level)
    rng = np.random.default_rng(20 + level)
    W = 5
    rp = _u8(rng, (W, 64))
    kappa = (rng.integers(0, 20000, size=W) * p.L).astype(np.uint32)
    kappa[0] = 65535  # nonces wrap at 16 bits
    y = sampling.expand_mask(torch.from_numpy(rp), torch.from_numpy(kappa.astype(np.int32)), p)
    _eq(y, jsampling.expand_mask(jnp.asarray(rp), jnp.asarray(kappa), p))
    limbs = sampling.expand_mask_limbs(torch.from_numpy(rp), torch.from_numpy(kappa.astype(np.int32)), p)
    assert limbs.dtype == torch.int8 and limbs.shape == (3, W, p.L * 256)
    limbs_j = np.asarray(jsampling.expand_mask_limbs(jnp.asarray(rp), jnp.asarray(kappa), p))  # [3, 256, L, W]
    _eq(limbs, limbs_j.transpose(0, 3, 2, 1).reshape(3, W, p.L * 256))


@pytest.mark.parametrize("level", LEVELS)
def test_sample_in_ball_matches_jax(level):
    p = params.get_params(level)
    c_tilde = _u8(np.random.default_rng(30 + level), (6, 32))
    c, ok = sampling.sample_in_ball(torch.from_numpy(c_tilde), p)
    c_j, ok_j = jsampling.sample_in_ball(jnp.asarray(c_tilde), p)
    _eq(c, c_j)
    _eq(ok, ok_j)
    assert int((c != 0).sum(dim=-1).min()) == p.tau


def test_ball_short_stream_fills_with_position_zero():
    """A stream with too few takes: ok False, the missing swaps use j = 0
    (as the JAX paths' zero-filled position buffers do)."""
    tau = 49
    stream = torch.full((2, 272), 255, dtype=torch.uint8)
    stream[:, :8] = torch.tensor([0b10110, 0, 0, 0, 0, 0, 0, 1], dtype=torch.uint8)
    stream[1, 8:12] = torch.tensor([3, 255, 7, 0], dtype=torch.uint8)
    c, ok = sampling.sample_in_ball_plain(stream, tau)
    assert not bool(ok.any())
    ref = np.zeros((2, 256), dtype=np.int64)
    signs = int.from_bytes(bytes(stream[0, :8].tolist()), "little")
    for r, js in ((0, []), (1, [3, 7, 0])):
        for t in range(tau):
            j = js[t] if t < len(js) else 0
            ref[r, 256 - tau + t] = ref[r, j]
            ref[r, j] = -1 if (signs >> t) & 1 else 1
    _eq(c, ref % params.Q)
