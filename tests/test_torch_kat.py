"""The port's KAT loader and replay on a corpus written from the C++
oracle: two vectors a level in the corpus's format (one hex line a
vector and component; the message lines carry bytes past mlen, which
the loader trims). The port's `utils.kat.load_kat` must return the JAX
package's dicts, and `tools.kat_replay.replay` must accept the corpus on
the CPU."""

import numpy as np
import torch

from dilithium_tpu.utils import kat as jkat
from dilithium_tpu_torch import oracle, params
from dilithium_tpu_torch.tools import kat_replay
from dilithium_tpu_torch.utils import kat

LEVELS = (2, 3, 5)
N_VECTORS = 2


def _write_corpus(path, level: int, rng) -> None:
    p = params.get_params(level)
    seeds = rng.integers(0, 256, (N_VECTORS, 32), dtype=np.uint8)
    pk, sk = oracle.keygen(level, seeds)
    msgs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in (33, 0)]
    tr = sk[:, 64:96]
    mus = np.stack([kat.to_u8(kat.crh(t.tobytes(), m)) for t, m in zip(tr, msgs)])
    sig, _ = oracle.sign(level, sk, mus)
    s2_at = 96 + p.L * p.polyeta_packedbytes  # sk = rho | K | tr | s1 | s2 | t0
    t0_at = s2_at + p.K * p.polyeta_packedbytes
    nz = 32 + p.L * p.polyz_packedbytes  # sig = c | z | h
    cols = {
        "z": seeds, "rho": sk[:, :32], "k": sk[:, 32:64], "tr": tr,
        "s1": sk[:, 96:s2_at], "s2": sk[:, s2_at:t0_at], "t0": sk[:, t0_at:],
        "t1": pk[:, 32:], "zs": sig[:, 32:nz], "h": sig[:, nz:], "c": sig[:, :32],
    }
    lines = {name: [r.tobytes().hex().upper() for r in rows] for name, rows in cols.items()}
    lines["m"] = [(m + b"\x5a" * 7).hex().upper() for m in msgs]
    lines["mlen"] = [f"{len(m):X}" for m in msgs]
    for name, rows in lines.items():
        (path / f"{name}_{level}.txt").write_text("\n".join(rows) + "\n")


def test_load_kat_and_replay_on_an_oracle_corpus(tmp_path, monkeypatch):
    rng = np.random.default_rng(4242)
    for level in LEVELS:
        _write_corpus(tmp_path, level, rng)
    monkeypatch.setattr(kat, "KAT_DIR", str(tmp_path))
    monkeypatch.setattr(jkat, "KAT_DIR", str(tmp_path))
    for level in LEVELS:
        got = kat.load_kat(level)
        assert got == jkat.load_kat(level)
        assert got["mlen"] == [33, 0] and [len(m) for m in got["m"]] == [33, 0]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = kat_replay.replay(levels=LEVELS, count=N_VECTORS, stream_q=4, device="cpu")
        assert out["kat"] == "ok", out["failed"]
        assert out["checks"] == 17 * len(LEVELS)
        # a flipped byte in KAT signature 0's z is seen by every check that reads it
        zs = (tmp_path / "zs_2.txt").read_text().splitlines()
        zs[0] = ("%02X" % (int(zs[0][:2], 16) ^ 1)) + zs[0][2:]
        (tmp_path / "zs_2.txt").write_text("\n".join(zs) + "\n")
        bad = kat_replay.replay(levels=(2,), count=N_VECTORS, stream_q=4, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert bad["kat"] == "FAIL"
    assert [f.split(" ")[0] for f in bad["failed"]] == [
        "L2.sign.z", "L2.stream_mxu.sig", "L2.stream_keys.sig", "L2.verify.accept"]
