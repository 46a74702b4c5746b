"""PyTorch port: the A/B rigs of the kernel bench (`dilithium_tpu_torch.tools`)
vs the JAX package, byte-equal.

- `xof_exp.planes_for` against the JAX rig's prologue
  (`tools/xof_exp.py::_planes_for`, plain jnp), and `xof_exp.xof_bm`
  (kernel K6's plain version) against JAX `keccak.shake_words` and hashlib;
- `ball_exp.sample_in_ball_v1_plain` (kernel K7's plain version, bit
  planes) against JAX `sampling.sample_in_ball` on the rows it accepts, and
  against K3's plain version on every row, rows without a take included.
"""

import hashlib
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dilithium_tpu.ops import keccak as jkeccak
from dilithium_tpu.ops import sampling as jsampling
from dilithium_tpu_torch import params
from dilithium_tpu_torch.ops import keccak, sampling
from dilithium_tpu_torch.tools import ball_exp, xof_exp

_spec = importlib.util.spec_from_file_location(
    "jax_xof_exp", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "xof_exp.py"))
jxof = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jxof)

HASHLIB = {168: hashlib.shake_128, 136: hashlib.shake_256}


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def test_planes_for_matches_jax_prologue():
    for msg_len, rate in ((66, 136), (34, 168), (200, 136)):
        data = _u8(msg_len, (130, msg_len))  # 130 rows: the JAX fold pads to 256
        got = xof_exp.planes_for(torch.from_numpy(data), rate)
        planes, _, b = jxof._planes_for(jnp.asarray(data), rate)
        exp = np.asarray(planes).reshape(planes.shape[0], -1)[:, :b]
        assert got.dtype == torch.int32 and got.shape == exp.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32), exp)


@pytest.mark.parametrize("msg_len,out_words,rate", [(66, 160, 136), (34, 252, 168)],
                         ids=["shake256_66B_160w", "shake128_34B_252w"])
def test_xof_bm_matches_jax_and_hashlib(msg_len, out_words, rate):
    data = _u8(msg_len + out_words, (2, 3, msg_len))
    got = xof_exp.xof_bm(torch.from_numpy(data), out_words, rate)
    assert got.dtype == torch.int64 and got.shape == (2, 3, out_words)
    exp = np.asarray(jkeccak.shake_words(jnp.asarray(data), out_words, rate))
    np.testing.assert_array_equal(got.numpy(), exp.astype(np.int64))
    for row, words in zip(data.reshape(6, msg_len), got.reshape(6, out_words).numpy()):
        ref = np.frombuffer(HASHLIB[rate](row.tobytes()).digest(4 * out_words), dtype="<u4")
        np.testing.assert_array_equal(words, ref.astype(np.int64))


@pytest.mark.parametrize("level", [2, 3, 5])
def test_ball_v1_matches_jax_and_k3(level):
    p = params.get_params(level)
    c_tilde = _u8(40 + level, (10, 32))
    stream = keccak.shake256(torch.from_numpy(c_tilde), p.ball_blocks * 136)
    stream[:2, 8:] = 255  # rows 0 and 1 take nothing: ok is False, steps use j = 0
    c, ok = ball_exp.sample_in_ball_v1(stream, p.tau)
    assert c.dtype == torch.int32 and c.shape == (10, 256)
    c_k3, ok_k3 = sampling.sample_in_ball_plain(stream, p.tau)
    assert torch.equal(c, c_k3) and torch.equal(ok, ok_k3)
    assert ok.tolist() == [False, False] + [True] * 8
    c_j, ok_j = jsampling.sample_in_ball(jnp.asarray(c_tilde), p)
    assert np.asarray(ok_j)[2:].all()
    np.testing.assert_array_equal(c.numpy()[2:].astype(np.int64), np.asarray(c_j)[2:].astype(np.int64))
    assert set(np.unique(c.numpy())) <= {0, 1, params.Q - 1}
