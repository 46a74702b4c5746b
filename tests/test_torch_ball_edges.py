"""SampleInBall on the streams that stress K3's take logic
(`dilithium_tpu_torch/tools/ball_edges.py`): the port's plain version,
K3's yardstick on the card, against the JAX package's jnp path (its
outputs recorded in `tests/jax_reference.py`), byte-equal, at levels 2, 3
and 5, on the 272-byte rows and the short 136-byte rows that
`chip_smoke.py` phase 3 sends through K3.

The file holds two tests, so that xdist's loadfile order (files by test
count, then by name) hands it out after the JAX package's slow two-test
files and it runs on a worker that is otherwise idle (`ROADMAP.md` §3)."""

import numpy as np
import torch

from dilithium_tpu_torch import params
from dilithium_tpu_torch.ops import sampling
from dilithium_tpu_torch.tools.ball_edges import edge_streams
from jax_reference import assert_matches_jax, jax_ref

LEVELS = [2, 3, 5]


def _walk(row: np.ndarray, tau: int):
    """Sequential walk of one stream: (take flags, band flags) per
    candidate byte; a byte rejected before the walk ends lies in the band
    (256 - tau + cnt, 255]."""
    cnt, takes, band = 0, [], []
    for j in row[8:].tolist():
        take = cnt < tau and j <= 256 - tau + cnt
        takes.append(take)
        band.append(cnt < tau and not take)
        cnt += take
    return np.array(takes), np.array(band)


def test_edge_streams_match_jax():
    """The JAX package's SampleInBall hashes c_tilde into the stream; with
    its SHAKE256 replaced by the identity it walks the given stream."""
    ref = jax_ref("ball_edges_streams")
    for level in LEVELS:
        p = params.get_params(level)
        for nbytes in (272, 136):
            streams = edge_streams(p.tau, nbytes, seed=level)
            c, ok = sampling.sample_in_ball_plain(torch.from_numpy(streams), p.tau)
            what = f"level {level}, {nbytes}-byte streams"
            assert_matches_jax(c, ref[f"c {level} {nbytes}"], what)
            assert_matches_jax(ok, ref[f"ok {level} {nbytes}"], what)


def test_edge_streams_stress_the_take_logic():
    """Every level's rows hold band rejects inside chunks that also take,
    takes on both sides of a 32-byte chunk edge, ok and failed rows, rows
    with no take at all, and a row whose tau-th take is its last byte."""
    for level in LEVELS:
        tau = params.get_params(level).tau
        streams = edge_streams(tau, 272, seed=level)
        walks = [_walk(row, tau) for row in streams]
        ok = np.array([takes.sum() >= tau for takes, _ in walks])
        assert ok.any() and not ok.all()
        assert sum(not takes.any() for takes, _ in walks) >= 2
        assert any(takes.sum() == tau and takes[-1] for takes, _ in walks)
        mixed = straddle = 0
        for takes, band in walks:
            chunks_t = takes[:256].reshape(8, 32)
            chunks_b = band[:256].reshape(8, 32)
            mixed += int((chunks_t.any(1) & chunks_b.any(1)).sum())
            straddle += int((chunks_t[:-1, -1] & chunks_t[1:, 0]).sum())
        assert mixed >= 2 * len(streams) and straddle >= 4, (level, mixed, straddle)
