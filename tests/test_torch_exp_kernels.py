"""PyTorch port: the A/B rigs of the kernel bench (`dilithium_tpu_torch.tools`)
vs the JAX package, byte-equal.

- `xof_exp.planes_for` against the JAX rig's prologue
  (`tools/xof_exp.py::_planes_for`, plain jnp), and `xof_exp.xof_bm`
  (kernel K6's plain version) against JAX `keccak.shake_words` and hashlib;
- `ball_exp.sample_in_ball_v1_plain` (kernel K7's plain version, bit
  planes) against JAX `sampling.sample_in_ball` on the rows it accepts, and
  against K3's plain version on every row, rows without a take included.

The JAX package's outputs are recorded in `tests/jax_reference.py`.
"""

import hashlib

import numpy as np
import pytest
import torch

from dilithium_tpu_torch import params
from dilithium_tpu_torch.ops import keccak, sampling
from dilithium_tpu_torch.tools import ball_exp, xof_exp
from jax_reference import assert_matches_jax, jax_ref

HASHLIB = {168: hashlib.shake_128, 136: hashlib.shake_256}
PLANES_FOR = [(66, 136), (34, 168), (200, 136)]  # msg_len, rate
XOF_BM = [(66, 160, 136), (34, 252, 168)]  # msg_len, out_words, rate


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def test_planes_for_matches_jax_prologue():
    for msg_len, rate in PLANES_FOR:
        data = _u8(msg_len, (130, msg_len))  # 130 rows: the JAX fold pads to 256
        got = xof_exp.planes_for(torch.from_numpy(data), rate)
        exp = jax_ref("exp_kernels_planes_for")[f"{msg_len} {rate}"]  # planes [words, b], uint32
        assert got.dtype == torch.int32 and got.shape == exp.shape
        assert_matches_jax(got.numpy().view(np.uint32), exp, f"{msg_len} bytes, rate {rate}")


@pytest.mark.parametrize("msg_len,out_words,rate", XOF_BM, ids=["shake256_66B_160w", "shake128_34B_252w"])
def test_xof_bm_matches_jax_and_hashlib(msg_len, out_words, rate):
    data = _u8(msg_len + out_words, (2, 3, msg_len))
    got = xof_exp.xof_bm(torch.from_numpy(data), out_words, rate)
    assert got.dtype == torch.int64 and got.shape == (2, 3, out_words)
    assert_matches_jax(got, jax_ref("exp_kernels_xof_bm")[f"{msg_len} {out_words} {rate}"], "xof_bm")
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
    ref = jax_ref("exp_kernels_ball_v1")
    c_j, ok_j = ref[f"c {level}"], ref[f"ok {level}"]
    assert ok_j[2:].all()
    assert_matches_jax(c[2:], c_j[2:], "c")
    assert set(np.unique(c.numpy())) <= {0, 1, params.Q - 1}
