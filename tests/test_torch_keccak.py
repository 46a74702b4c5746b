"""PyTorch port: SHAKE / SHA3 sponges vs hashlib and the JAX package.

The shapes are every sponge call of the Dilithium-3 one-key signing path,
plus ExpandMask's (which the signer runs inside the mask kernel). The JAX
package's outputs are recorded in `tests/jax_reference.py`.
"""

import hashlib

import numpy as np
import pytest
import torch

from dilithium_tpu_torch import params
from dilithium_tpu_torch.ops import keccak
from jax_reference import assert_matches_jax, jax_ref

P3 = params.get_params(3)

# name, msg_len, out_bytes, rate
PATH_SHAPES = [
    ("seedbuf", 32, 128, 136),
    ("expand_a", 34, 840, 168),
    ("expand_s", 66, P3.eta_blocks * 136, 136),
    ("tr", P3.pk_bytes, 32, 136),
    ("rhoprime", 96, 64, 136),
    ("c_tilde", 64 + P3.K * P3.polyw1_packedbytes, 32, 136),
    ("ball_stream", 32, 272, 136),
    ("expand_mask", 66, 640, 136),
]
HASHLIB = {168: hashlib.shake_128, 136: hashlib.shake_256}


@pytest.mark.parametrize("name,msg_len,out_bytes,rate", PATH_SHAPES, ids=[s[0] for s in PATH_SHAPES])
def test_path_shapes_match_hashlib_and_jax(name, msg_len, out_bytes, rate):
    rng = np.random.default_rng(msg_len * 1000 + out_bytes)
    data = rng.integers(0, 256, size=(3, msg_len), dtype=np.uint8)
    got = keccak.shake(torch.from_numpy(data), out_bytes, rate).numpy()
    for i in range(3):
        assert got[i].tobytes() == HASHLIB[rate](data[i].tobytes()).digest(out_bytes), i
    words = keccak.shake_words(torch.from_numpy(data), out_bytes // 4, rate)
    assert words.dtype == torch.int64 and int(words.min()) >= 0
    assert_matches_jax(words, jax_ref("keccak_path_shapes")[name], name)


def test_batch_shape_and_word_forms():
    data = np.random.default_rng(5).integers(0, 256, size=(2, 3, 40), dtype=np.uint8)
    t = torch.from_numpy(data)
    ref = jax_ref("keccak_batch_forms")
    out = keccak.shake256(t, 48)
    assert out.shape == (2, 3, 48) and out.dtype == torch.uint8
    assert_matches_jax(out, ref["shake256"], "shake256")
    w = keccak.shake128_words(t, 6).numpy()
    np.testing.assert_array_equal(w, keccak.shake128(t, 24).numpy().view("<u4").astype(np.int64))
    assert_matches_jax(keccak.shake256_words(t, 6), ref["shake256_words"], "shake256_words")


def test_permutation_matches_jax():
    st = np.random.default_rng(7).integers(0, 1 << 32, size=(4, 25, 2), dtype=np.int64).astype(np.uint32)
    exp = jax_ref("keccak_permutation")["f1600"].astype(np.uint64)
    lanes = (st[..., 0].astype(np.uint64) | (st[..., 1].astype(np.uint64) << np.uint64(32))).view(np.int64)
    got = keccak.keccak_f1600_plain(torch.from_numpy(lanes.copy())).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, exp[..., 0] | (exp[..., 1] << np.uint64(32)))


def test_cpu_tensor_takes_the_plain_path(monkeypatch):
    from dilithium_tpu_torch import _kernels

    def no_kernel(*args):
        raise AssertionError("a CPU tensor reached the kernel launcher")

    monkeypatch.setattr(_kernels, "launch", no_kernel)
    keccak.shake256(torch.zeros((2, 10), dtype=torch.uint8), 16)
    with pytest.raises(ValueError):
        keccak.sponge(torch.zeros((2, 10), dtype=torch.int32), 16, 136, 0x1F)
