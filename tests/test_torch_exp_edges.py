"""The plain versions that `chip_smoke.py` phase 6 holds kernels K6 and K7
to, at the shapes where their designs branch, against hashlib and the
port's own SampleInBall (no JAX):

- `xof_exp.xof_bm` (K6's plain version behind the `planes_for`
  prologue): a 7-block absorb (c_tilde's 832 bytes) -> 8 words, SHAKE128's
  21 lanes (34 bytes -> 210 words, ExpandA's 840 bytes), 1 and 37 output
  words, and a batch of one;
- `ball_exp.sample_in_ball_v1_plain` (K7's plain version, bit planes) on
  the stress rows of `tools/ball_edges.py` (no-take rows, rows that run out
  on the last byte, takes at the limit) at levels 2, 3 and 5, against
  `sampling.sample_in_ball_plain`, c and ok.

Two tests, so that xdist's loadfile order hands the file out late, to an
idle worker (`ROADMAP.md` §3)."""

import hashlib

import numpy as np
import torch

from dilithium_tpu_torch import params
from dilithium_tpu_torch.ops import sampling
from dilithium_tpu_torch.tools import ball_exp, xof_exp
from dilithium_tpu_torch.tools.ball_edges import edge_streams

HASHLIB = {168: hashlib.shake_128, 136: hashlib.shake_256}


def test_xof_bm_edges_match_hashlib():
    rng = np.random.default_rng(9)
    for batch, msg_len, out_words, rate in ((3, 832, 8, 136), (2, 34, 210, 168), (3, 66, 1, 136),
                                            (2, 66, 37, 136), (1, 66, 160, 136)):
        data = rng.integers(0, 256, (batch, msg_len), dtype=np.uint8)
        got = xof_exp.xof_bm(torch.from_numpy(data), out_words, rate)
        assert got.dtype == torch.int64 and got.shape == (batch, out_words)
        for row, words in zip(data, got.numpy()):
            ref = np.frombuffer(HASHLIB[rate](row.tobytes()).digest(4 * out_words), dtype="<u4")
            np.testing.assert_array_equal(words, ref.astype(np.int64))


def test_ball_v1_plain_on_edge_streams_matches_sampling():
    for level in (2, 3, 5):
        p = params.get_params(level)
        stream = torch.from_numpy(edge_streams(p.tau, p.ball_blocks * 136, seed=level))
        c, ok = ball_exp.sample_in_ball_v1_plain(stream, p.tau)
        c_ref, ok_ref = sampling.sample_in_ball_plain(stream, p.tau)
        assert torch.equal(c, c_ref) and torch.equal(ok, ok_ref)
        assert not ok.all() and ok.any()  # the no-take rows fail, the rest pass
        assert ((c != 0).sum(dim=1) == p.tau).all()
