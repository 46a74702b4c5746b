"""Command-line front end: `python -m dilithium_tpu_torch <keygen|sign|verify>`.

Keys, messages and signatures are raw byte files; the security level is a
flag. Many message files sign or verify as one batch. Runs on the card
unless `--device cpu` is given.

    python -m dilithium_tpu_torch --level 3 keygen --pk key.pk --sk key.sk
    python -m dilithium_tpu_torch --level 3 sign --sk key.sk msg1 msg2
    python -m dilithium_tpu_torch --level 3 verify --pk key.pk msg1 msg2

Exit codes: 0 success (verify: every signature valid), 1 a verification
failure, 2 a usage error.
"""

from __future__ import annotations

import argparse
import sys


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dilithium_tpu_torch",
        description="CRYSTALS-Dilithium (round 3) keygen/sign/verify in PyTorch, on a CUDA card or the CPU.",
    )
    ap.add_argument("--level", type=int, default=3, choices=(2, 3, 5),
                    help="security level (default 3)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the plain versions)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    kg = sub.add_parser("keygen", help="generate a keypair")
    kg.add_argument("--seed", help="32-byte seed file (random if omitted)")
    kg.add_argument("--pk", required=True, help="output public-key file")
    kg.add_argument("--sk", required=True, help="output secret-key file")

    sg = sub.add_parser("sign", help="sign one or more message files")
    sg.add_argument("--sk", required=True, help="secret-key file")
    sg.add_argument("--out-suffix", default=".sig",
                    help="signature written to <message><suffix> (default .sig)")
    sg.add_argument("--randomized", action="store_true",
                    help="randomized signing (uniform rhoprime; fault-attack "
                         "countermeasure) instead of the deterministic default")
    sg.add_argument("messages", nargs="+", help="message files")

    vy = sub.add_parser("verify", help="verify signatures over message files")
    vy.add_argument("--pk", required=True, help="public-key file")
    vy.add_argument("--sig-suffix", default=".sig",
                    help="signature path = <message><suffix> (default .sig)")
    vy.add_argument("messages", nargs="+", help="message files")

    args = ap.parse_args(argv)

    from dilithium_tpu_torch import api

    if args.cmd == "keygen":
        if args.seed:
            seed = _read(args.seed)
            if len(seed) != 32:
                print(f"seed must be 32 bytes, got {len(seed)}", file=sys.stderr)
                return 2
        else:
            import secrets
            seed = secrets.token_bytes(32)
        pks, sks = api.keygen(args.level, [seed], device=args.device)
        _write(args.pk, pks[0])
        _write(args.sk, sks[0])
        print(f"wrote {args.pk} ({len(pks[0])} B), {args.sk} ({len(sks[0])} B)")
        return 0

    if args.cmd == "sign":
        msgs = [_read(m) for m in args.messages]
        sigs = api.sign(args.level, _read(args.sk), msgs, randomized=args.randomized,
                        device=args.device)
        for m, s in zip(args.messages, sigs):
            _write(m + args.out_suffix, s)
        print(f"signed {len(sigs)} message(s)")
        return 0

    msgs = [_read(m) for m in args.messages]
    pairs = [(m, _read(path + args.sig_suffix)) for m, path in zip(msgs, args.messages)]
    oks = api.verify(args.level, _read(args.pk), pairs, device=args.device)
    for path, ok in zip(args.messages, oks):
        print(f"{path}: {'OK' if ok else 'FAIL'}")
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main())
