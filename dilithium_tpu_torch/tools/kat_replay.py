"""Byte-exact replay of the KAT corpus through the port.

The port's counterpart of `tools/tpu_kat.py`: keygen, both signer
families and verify run on the given device (the card by default) and
every output is compared byte for byte with the corpus in
`utils.kat.KAT_DIR` (DILITHIUM_KAT_DIR). Per level:
  * `scheme.keygen` on the vectors' seeds: rho, K and tr, and the packed
    s1, s2, t0 and t1;
  * the lockstep `scheme.sign` over the vectors' messages: c~, z and h;
  * `mxu.sign_stream_mxu` under KAT key 0 on a queue of `stream_q`
    copies of its message: every row equals KAT signature 0;
  * `scheme.sign_stream_keys` over the first 4 KAT keys, each signing its
    own message in one window;
  * `scheme.verify` accepts the KAT signatures and rejects them with a
    byte flipped.

    python -m dilithium_tpu_torch.tools.kat_replay [--count 25] [--stream-q 128] [--device cuda]

prints one JSON line ({"kat": "ok" | "FAIL", ...}) and exits 0 iff every
check passed. `replay` is the same run as a function (`chip_smoke.py`
phase 8a and the tests call it).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from dilithium_tpu_torch import mxu, scheme
from dilithium_tpu_torch.ops import pack
from dilithium_tpu_torch.params import get_params
from dilithium_tpu_torch.utils import kat


def replay(levels=(2, 3, 5), count: int = 25, stream_q: int = 128, device="cuda") -> dict:
    """Replay `count` vectors a level of the corpus on `device` -> {"kat":
    "ok" | "FAIL", "checks": n, "failed": [name (detail), ...], ...}."""
    checks = []
    failed = []

    def check(name, got, exp):
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        exp = np.asarray(exp)
        checks.append(name)
        if got.shape != exp.shape:
            failed.append(f"{name} (shape {got.shape} != {exp.shape})")
        elif not np.array_equal(got, exp):
            failed.append(f"{name} ({int((got != exp).sum())} values differ)")

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    for level in levels:
        p = get_params(level)
        k = kat.load_kat(level, count=count)
        n = len(k["z"])

        kp = scheme.keygen(t(kat.stack_u8(k["z"])), p)
        check(f"L{level}.keygen.rho", kp.rho, kat.stack_u8(k["rho"]))
        check(f"L{level}.keygen.key", kp.key, kat.stack_u8(k["k"]))
        check(f"L{level}.keygen.tr", kp.tr, kat.stack_u8(k["tr"]))
        check(f"L{level}.keygen.s1", pack.pack_eta(kp.s1, p).reshape(n, -1), kat.stack_u8(k["s1"]))
        check(f"L{level}.keygen.s2", pack.pack_eta(kp.s2, p).reshape(n, -1), kat.stack_u8(k["s2"]))
        check(f"L{level}.keygen.t0", pack.pack_t0(kp.t0).reshape(n, -1), kat.stack_u8(k["t0"]))
        check(f"L{level}.keygen.t1", pack.pack_t1(kp.t1).reshape(n, -1), kat.stack_u8(k["t1"]))

        mus = t(np.stack([kat.to_u8(kat.crh(tr, m)) for tr, m in zip(k["tr"], k["m"])]))
        sigs = np.concatenate([kat.stack_u8(k["c"]), kat.stack_u8(k["zs"]), kat.stack_u8(k["h"])], axis=1)
        res = scheme.sign(kp.sk, mus, p)
        check(f"L{level}.sign.ok", res.ok, np.ones(n, dtype=bool))
        nz = 32 + p.L * p.polyz_packedbytes
        check(f"L{level}.sign.c", res.sig[:, :32], sigs[:, :32])
        check(f"L{level}.sign.z", res.sig[:, 32:nz], sigs[:, 32:nz])
        check(f"L{level}.sign.h", res.sig[:, nz:], sigs[:, nz:])

        ops = mxu.build_operators(kp.sk[0], p)
        sres = mxu.sign_stream_mxu(ops, mus[0].expand(stream_q, -1), p, window=min(768, stream_q),
                                   max_rounds=4096)
        check(f"L{level}.stream_mxu.ok", sres.ok, np.ones(stream_q, dtype=bool))
        check(f"L{level}.stream_mxu.sig", sres.sig, np.broadcast_to(sigs[0], (stream_q, sigs.shape[1])))

        nk = min(4, n)
        kres = scheme.sign_stream_keys(scheme.expand_sk(kp.sk[:nk], p), t(np.arange(nk)), mus[:nk], p,
                                       window=nk, max_rounds=4096)
        check(f"L{level}.stream_keys.ok", kres.ok, np.ones(nk, dtype=bool))
        check(f"L{level}.stream_keys.sig", kres.sig, sigs[:nk])

        check(f"L{level}.verify.accept", scheme.verify(kp.pk, t(sigs), mus, p), np.ones(n, dtype=bool))
        bad = sigs.copy()
        bad[:, 40] ^= 1
        check(f"L{level}.verify.reject_corrupted", scheme.verify(kp.pk, t(bad), mus, p), np.zeros(n, dtype=bool))

    return {"kat": "FAIL" if failed else "ok", "device": str(torch.device(device)), "levels": list(levels),
            "vectors_per_level": count, "stream_queue": stream_q, "checks": len(checks), "failed": failed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dilithium_tpu_torch.tools.kat_replay", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--count", type=int, default=25, help="vectors a level")
    ap.add_argument("--stream-q", type=int, default=128, help="queue rows of the stream signer's check")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu: the plain versions)")
    args = ap.parse_args(argv)
    out = replay(count=args.count, stream_q=args.stream_q, device=args.device)
    print(json.dumps(out))
    return 0 if out["kat"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
