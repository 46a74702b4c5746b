"""The port's measurement entry points on the CPU, held against the C++
oracle (the test budget forbids jitting a JAX scheme graph here; the
oracle is what the JAX package's own tests hold it to).

Two tests: every mode of `dilithium_tpu_torch.bench.build` at level 2, its
inputs equal to the root `bench.py`'s `default_rng(0)` draws in their
order, its signatures equal to `oracle.sign` in bytes and attempts, verify's
answers equal to `oracle.verify` on a corpus with corrupted rows, the gate
passing them and failing one flipped ok (and, in verify mode, an
always-accepting verifier); then `bench.main`'s JSON line, its exit 1 on a
flipped ok, without a card and on a knob the port lacks. And `bench_round`,
`bench_components`, `tools.profile_sign`, `tools.profile_verify` and
`bench_scaling` (a world of one gloo rank, in a process of its own) end to
end, each with its JSON line."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dilithium_tpu_torch import bench, bench_components, bench_round, oracle
from dilithium_tpu_torch.params import SEEDBYTES, TRBYTES, get_params
from dilithium_tpu_torch.tools import profile_sign, profile_verify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL, B, W, NKEYS, MSGLEN = 2, 8, 4, 2, 40

# the root bench_components.py's rows, by name
COMPONENT_ROWS = [
    "keccak_f1600 x30B", "shake128 expandA-shape", "ntt fwd xBL", "invntt xBL", "matvec", "expand_mask",
    "sample_in_ball", "expand_a", "decompose", "pack_z", "sign_attempt", "sign_attempt_mxu", "keygen",
    "verify_expanded", "verify_mxu", "verify_fresh_keys",
] + [f"latency {op} B={b}" for b in (1, 64) for op in ("keygen", "sign", "verify")]


@pytest.fixture
def one_thread():
    # the shapes are tiny, and the test workers share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draws(mode: str) -> dict:
    """The root bench.py's draws up to the first call's mu, in its order."""
    rng = np.random.default_rng(0)
    shape = {"batch": (B, 32), "keys": (NKEYS, 32)}.get(mode, (32,))
    d = {"seed": rng.integers(0, 256, size=shape, dtype=np.uint8)}
    if mode == "serve":
        d["msgs"] = rng.integers(0, 256, size=(B, MSGLEN), dtype=np.uint8)
    if mode == "keys":
        d["key_idx"] = rng.integers(0, NKEYS, size=(B,)).astype(np.int32)
    if mode == "verify":
        d["mu"] = rng.integers(0, 256, size=(B, 64), dtype=np.uint8)
    d["mu0"] = rng.integers(0, 256, size=(B, 64), dtype=np.uint8)
    return d


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_modes_match_the_oracle(monkeypatch, capsys, one_thread):
    for mode in bench.MODES:
        run, inputs = bench.build(mode, LEVEL, B, W, nkeys=NKEYS, msg_len=MSGLEN, device="cpu")
        want = _draws(mode)
        for key in ("seed", "msgs", "key_idx", "mu"):
            if key in want:
                np.testing.assert_array_equal(inputs[key], want[key], err_msg=f"{mode} {key}")
        np.testing.assert_array_equal(inputs["rng"].integers(0, 256, size=(B, 64), dtype=np.uint8), want["mu0"])
        pk_o, sk_o = oracle.keygen(LEVEL, want["seed"].reshape(-1, 32))
        np.testing.assert_array_equal(inputs["pk"], pk_o)

        out = run(torch.from_numpy(want["mu0"]))
        sig, ok, att = (x.numpy() for x in out)
        if mode == "verify":
            corpus_o, _ = oracle.sign(LEVEL, np.repeat(sk_o, B, axis=0), want["mu"])
            bad = bench.corrupt(corpus_o, get_params(LEVEL))
            np.testing.assert_array_equal(inputs["corrupted"], bad)
            np.testing.assert_array_equal(inputs["sig"], corpus_o)
            expect = oracle.verify(LEVEL, np.repeat(pk_o, B, axis=0), want["mu"], corpus_o)
            assert len(bad) >= 3 and not expect[bad].any() and np.delete(expect, bad).all()
            np.testing.assert_array_equal(ok, expect)
            mu = want["mu"]
            yes = torch.ones_like(out[1])
            with pytest.raises(bench.GateError):
                bench.gate(mode, LEVEL, (yes, yes, yes), mu, inputs)
        else:
            mu = want["mu0"]
            if mode == "serve":
                tr = sk_o[0, 2 * SEEDBYTES:2 * SEEDBYTES + TRBYTES].tobytes()
                mu = np.stack([np.frombuffer(hashlib.shake_256(tr + m.tobytes()).digest(64), dtype=np.uint8)
                               for m in want["msgs"]])
                np.testing.assert_array_equal(inputs["mu"], mu)
            keys = {"keys": want.get("key_idx"), "batch": np.arange(B)}.get(mode, np.zeros(B, dtype=np.int64))
            sig_o, att_o = oracle.sign(LEVEL, sk_o[keys], mu)
            np.testing.assert_array_equal(sig, sig_o, err_msg=mode)
            np.testing.assert_array_equal(att, att_o, err_msg=mode)
        assert mode == "verify" or ok.all(), mode
        bench.gate(mode, LEVEL, out, mu, inputs)
        flipped = out[1].clone()
        flipped[3] = ~flipped[3]
        with pytest.raises(bench.GateError):
            bench.gate(mode, LEVEL, (out[0], flipped, out[2]), mu, inputs)

    for k, v in {"LEVEL": LEVEL, "BATCH": B, "WINDOW": W, "ITERS": 3, "DEVICE": "cpu", "MODE": "verify"}.items():
        monkeypatch.setenv(f"DILITHIUM_BENCH_{k}", str(v))
    assert bench.main() == 0
    line = _last_json(capsys)
    assert line["metric"] == "dilithium2_verify_throughput" and line["unit"] == "verifies/sec"
    assert len(line["blocks"]) >= 3 and line["value"] == round(sorted(line["blocks"])[-2], 1) > 0
    assert min(line["blocks"]) <= line["window_value"] <= max(line["blocks"])
    assert (line["device"], line["power_limit_w"]) == ("cpu", None)

    real_build = bench.build

    def flipping_build(*args, **kwargs):
        run, inputs = real_build(*args, **kwargs)

        def flipped_run(mu):
            sig, ok, att = run(mu)
            ok = ok.clone()
            ok[3] = ~ok[3]
            return sig, ok, att
        return flipped_run, inputs

    monkeypatch.setenv("DILITHIUM_BENCH_MODE", "mxu")
    monkeypatch.setattr(bench, "build", flipping_build)
    assert bench.main() == 1
    line = _last_json(capsys)
    assert line["value"] is None and line["error"] == "gate" and "not ok" in line["detail"]

    monkeypatch.setenv("DILITHIUM_BENCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 1
    line = _last_json(capsys)
    assert line["value"] is None and line["error"] == "device_unavailable"
    monkeypatch.setenv("DILITHIUM_BENCH_KEYS_SORT", "1")
    assert bench.main() == 1
    assert _last_json(capsys)["error"] == "unported_knob"


def test_entry_points_end_to_end(monkeypatch, capsys, one_thread):
    monkeypatch.setenv("DILITHIUM_BENCH_DEVICE", "cpu")

    assert bench_round.main([str(W)]) == 0
    line = _last_json(capsys)
    assert (line["window"], line["device"]) == (W, "cpu") and line["stream_signs_per_sec"] > 0
    assert 0 < line["attempt_ms"] and 0 < line["attempt_pack_ms"] and 0 < line["round_ms"]

    assert bench_components.main([str(B), "--latency-calls", "1"]) == 0
    line = _last_json(capsys)
    assert (line["batch"], line["device"]) == (B, "cpu")
    assert list(line["per_unit_us"]) == COMPONENT_ROWS and all(v > 0 for v in line["per_unit_us"].values())

    assert profile_sign.main([str(W), str(LEVEL)]) == 0
    line = _last_json(capsys)
    assert (line["window"], line["level"]) == (W, LEVEL) and len(line["us_per_round"]) == 8
    assert all(v > 0 for v in line["us_per_round"].values())

    assert profile_verify.main([str(B)]) == 0
    line = _last_json(capsys)
    assert line["batch"] == B and len(line["ms"]) == 11 and all(v > 0 for v in line["ms"].values())

    # in a process of its own, so that no process group lives in this one
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               **{f"DILITHIUM_BENCH_{k}": str(v) for k, v in {"LEVEL": LEVEL, "BATCH": B, "WINDOW": W, "ITERS": 1}.items()})
    proc = subprocess.run([sys.executable, "-m", "dilithium_tpu_torch.bench_scaling"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == "dilithium2_sign_scaling_efficiency" and line["unit"] == "fraction_of_linear_x1"
    assert (line["n"], line["device"]) == (1, "cpu") and line["value"] > 0
