"""SampleInBall streams that stress the walk's take logic.

K3 (`csrc/ball.cu`) decides the takes of 32 candidate bytes at once, and
a byte in the band (256 - tau + cnt, 255] is taken or not depending on
the takes before it in its chunk. `edge_streams` builds rows, from a
numpy seed, whose bytes fall in that band often, that take exactly at the
limit, that take every byte, that take nothing or that run out on the
last byte. `chip_smoke.py` phase 3 sends them through K3 and its plain
version on the card, and `tests/test_torch_ball_edges.py` through the
plain version and the JAX package on the CPU.
"""

from __future__ import annotations

import numpy as np

N = 256


def edge_streams(tau: int, nbytes: int = 272, seed: int = 0) -> np.ndarray:
    """uint8 [R, nbytes] streams (8 sign bytes, then candidates). At
    nbytes = 272 three rows end with ok False (two take nothing, one runs
    out one take short); at 136 bytes the band-heavy rows often do too."""
    rng = np.random.default_rng(seed)
    body = nbytes - 8
    rows = []
    # band-heavy: candidates just below and inside the band
    for _ in range(16):
        rows.append(rng.integers(N - tau - 8, N, body))
    # bands of other widths
    for width in rng.integers(0, 64, 8):
        rows.append(rng.integers(max(N - tau - int(width), 0), N, body))
    # takes exactly at the limit, each after a reject one above it with
    # probability 1/2 (the reject is in the band)
    for _ in range(4):
        seq = []
        for cnt in range(tau):
            lim = N - tau + cnt
            if lim + 1 < N and rng.random() < 0.5:
                seq.append(lim + 1)
            seq.append(lim)
        seq += list(rng.integers(0, N, body))
        rows.append(np.array(seq[:body]))
    rows.append(np.zeros(body, dtype=np.int64))  # every candidate taken
    rows.append(np.full(body, N - 1))  # nothing taken
    rows.append(np.full(body, N - 1))
    for takes in (tau, tau - 1):  # the tau-th take on the last byte, or one short
        row = np.full(body, N - 1)
        row[body - takes:] = 0
        rows.append(row)
    for _ in range(4):  # plain random candidates
        rows.append(rng.integers(0, N, body))
    out = np.empty((len(rows), nbytes), dtype=np.uint8)
    out[:, :8] = rng.integers(0, 256, (len(rows), 8))
    out[:, 8:] = np.stack(rows)
    return out
