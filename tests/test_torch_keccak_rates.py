"""PyTorch port: SHAKE128/256 and SHA3-256/512 at the rate boundaries vs
hashlib."""

import hashlib

import numpy as np
import pytest
import torch

from dilithium_tpu_torch.ops import keccak


@pytest.mark.parametrize("msg_len", [0, 1, 135, 136, 137, 167, 168, 300])
def test_rate_boundaries_match_hashlib(msg_len):
    rng = np.random.default_rng(msg_len)
    data = rng.integers(0, 256, size=(2, msg_len), dtype=np.uint8)
    t = torch.from_numpy(data)
    for i in range(2):
        m = data[i].tobytes()
        assert keccak.shake128(t, 200)[i].numpy().tobytes() == hashlib.shake_128(m).digest(200)
        assert keccak.shake256(t, 150)[i].numpy().tobytes() == hashlib.shake_256(m).digest(150)
        assert keccak.sha3_256(t)[i].numpy().tobytes() == hashlib.sha3_256(m).digest()
        assert keccak.sha3_512(t)[i].numpy().tobytes() == hashlib.sha3_512(m).digest()
