"""The port's data-parallel services and multi-process launcher on the
CPU over gloo, held against the C++ oracle (the JAX package's services
jit whole scheme graphs; the oracle matches the JAX binding byte for
byte, `test_torch_isolation.py`).

Two tests: every service of `dilithium_tpu_torch.parallel` in a world of
one gloo rank in this process, both modes of each flag, with the mesh's
checks (and `local_batch_to_global` across two spawned ranks whose shards
differ in size); and `python -m dilithium_tpu_torch.tools.run_multihost`
in two gloo processes, like `tests/test_multihost.py` for the JAX
launcher."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dilithium_tpu_torch import mxu, oracle, params, scheme
from dilithium_tpu_torch.parallel import (
    initialize, local_batch_to_global, make_mesh, sharded_keygen, sharded_sign,
    sharded_sign_stream, sharded_sign_stream_keys, sharded_verify, sharded_verify_stream,
    throughput_counters,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL = 2
B = 8
N_KEYS = 3


def _env() -> dict:
    # one intra-op thread a process: the shapes are tiny, and the test
    # workers share the cores
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def _check(res, sig, att):
    np.testing.assert_array_equal(res.sig.numpy(), sig)
    np.testing.assert_array_equal(res.attempts.numpy(), att)
    assert bool(res.ok.all())
    assert int(res.total_signed) == B and int(res.total_attempts) == int(att.sum())


_UNEQUAL = r"""
import sys, numpy as np
from dilithium_tpu_torch.parallel import initialize, local_batch_to_global, make_mesh
import torch.distributed as dist
rank = int(sys.argv[1])
initialize(coordinator=sys.argv[2], num_processes=2, process_id=rank, device="cpu")
mesh = make_mesh()
assert local_batch_to_global(mesh, np.zeros((2, 64), np.uint8)).shape == (2, 64)
try:
    local_batch_to_global(mesh, np.zeros((2 + rank, 64), np.uint8))
except ValueError as e:
    print("raised:", e)
dist.destroy_process_group()
"""


def test_services_in_a_world_of_one(tmp_path):
    p = params.get_params(LEVEL)
    rng = np.random.default_rng(77)
    seeds = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    mus = rng.integers(0, 256, (B, 64), dtype=np.uint8)
    key_idx = (np.arange(B) % N_KEYS).astype(np.int32)
    pk_o, sk_o = oracle.keygen(LEVEL, seeds)
    sig1, att1 = oracle.sign(LEVEL, np.repeat(sk_o[:1], B, axis=0), mus)  # one key
    sig_l, att_l = oracle.sign(LEVEL, sk_o, mus)  # a key a lane
    sig_k, att_k = oracle.sign(LEVEL, sk_o[key_idx], mus)  # N_KEYS keys mixed

    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh()
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    initialize(coordinator=f"file://{tmp_path / 'store'}", num_processes=1, process_id=0, device="cpu")
    try:
        with pytest.raises(ValueError, match="does not serve"):
            make_mesh("cuda:0")
        mesh = make_mesh()
        assert (mesh.rank, mesh.world_size, mesh.device) == (0, 1, torch.device("cpu"))
        seed, mu = local_batch_to_global(mesh, seeds), local_batch_to_global(mesh, mus)

        pk, sk, ok = sharded_keygen(mesh, p)(seed)
        np.testing.assert_array_equal(pk.numpy(), pk_o)
        np.testing.assert_array_equal(sk.numpy(), sk_o)
        assert bool(ok.all())

        res = sharded_sign(mesh, p, attempts_per_round=2)(sk, mu)
        _check(res, sig_l, att_l)
        counters = throughput_counters(res)
        assert counters == {"signed": B, "attempts": int(att_l.sum()), "mean_attempts": att_l.sum() / B}
        _check(sharded_sign(mesh, p, attempts_per_round=2, replicate_key=True)(sk[0], mu), sig1, att1)
        with pytest.raises(ValueError, match="replicate_key"):
            sharded_sign(mesh, p, replicate_key=True)(sk, mu)
        for use_mxu, km in ((True, mxu.build_operators(sk[0], p)), (False, scheme.expand_sk(sk[0], p))):
            _check(sharded_sign_stream(mesh, p, window=4, use_mxu=use_mxu)(km, mu), sig1, att1)
        eks = scheme.expand_sk(sk[:N_KEYS], p)
        _check(sharded_sign_stream_keys(mesh, p, window=4)(eks, local_batch_to_global(mesh, key_idx), mu),
               sig_k, att_k)

        # two corrupted rows a batch: a flipped signature byte, another message
        for sig_o, pk_rows in ((sig1, pk_o[[0] * B]), (sig_k, pk_o[key_idx])):
            bad_sig, bad_mu = sig_o.copy(), mus.copy()
            bad_sig[1, 50] ^= 1
            bad_mu[6, 3] ^= 1
            expect = oracle.verify(LEVEL, pk_rows, bad_mu, bad_sig)
            assert expect.sum() == B - 2 and not (expect[1] or expect[6])
            sig_t, mu_t = local_batch_to_global(mesh, bad_sig), local_batch_to_global(mesh, bad_mu)
            if sig_o is sig1:
                runs = [sharded_verify(mesh, p, replicate_key=True)(pk[0], sig_t, mu_t),
                        sharded_verify_stream(mesh, p, use_mxu=True)(
                            mxu.build_verify_operators(pk[0], p), sig_t, mu_t),
                        sharded_verify_stream(mesh, p, use_mxu=False)(scheme.expand_pk(pk[0], p), sig_t, mu_t)]
            else:
                runs = [sharded_verify(mesh, p)(torch.from_numpy(pk_rows), sig_t, mu_t)]
            for ok, total in runs:
                np.testing.assert_array_equal(ok.numpy(), expect)
                assert int(total) == B - 2
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(n_threads)

    # shards of unequal size across two ranks: every rank raises
    procs = [subprocess.Popen([sys.executable, "-c", _UNEQUAL, str(rank), f"file://{tmp_path / 'store2'}"],
                              cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        assert "raised: local shards differ in size across ranks (2 to 3 rows" in out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_launcher(tmp_path):
    """--signer stream (W = 4) and --signer keys --nkeys 1 --verify
    (W = 2), each in two gloo processes, both pairs at once. One key from
    the launcher's derivation signs every row in both modes (with one
    key, every key_idx is 0), so both equal the same oracle signatures."""
    runs = {"stream": ["--signer=stream", "--window=4"],
            "keys": ["--signer=keys", "--nkeys=1", "--verify", "--window=2"]}
    procs = {}
    for name, flags in runs.items():
        port = _free_port()
        procs[name] = [(subprocess.Popen(
            [sys.executable, "-m", "dilithium_tpu_torch.tools.run_multihost", "--device=cpu",
             f"--coordinator=127.0.0.1:{port}", "--num-processes=2", f"--process-id={pid}",
             f"--level={LEVEL}", f"--global-batch={B}", "--max-rounds=1024", *flags,
             f"--out={tmp_path / f'{name}_{pid}.npy'}"],
            cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ), tmp_path / f"{name}_{pid}.npy") for pid in range(2)]

    rng = np.random.default_rng(0)  # the launcher's derivation at --seed 0
    seed = rng.integers(0, 256, (1, 32), dtype=np.uint8)
    mus = rng.integers(0, 256, (B, 64), dtype=np.uint8)
    _, sk_o = oracle.keygen(LEVEL, seed)
    sig_o, att_o = oracle.sign(LEVEL, np.repeat(sk_o, B, axis=0), mus)

    for name, pair in procs.items():
        reports = []
        for proc, _ in pair:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"{name}: launcher rc={proc.returncode}\n{out}\n{err[-3000:]}"
            reports.append(json.loads(out.strip().splitlines()[-1]))
        for pid, r in enumerate(reports):
            assert (r["process_id"], r["num_processes"], r["local_batch"], r["global_batch"]) == (pid, 2, B // 2, B)
            assert r["signed"] == B and r["attempts"] == int(att_o.sum())
            assert r["verified"] == (B if name == "keys" else None)
        got = np.concatenate([np.load(path) for _, path in pair])
        np.testing.assert_array_equal(got, sig_o)
