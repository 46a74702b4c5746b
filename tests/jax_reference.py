"""The JAX package's outputs that the port's tests hold the port to, recorded.

The JAX package is the port's reference, and its outputs for the tests'
fixed inputs never change. Computing them on every run means compiling
JAX graphs and interpreting Pallas kernels on the CPU, which costs far more
than the port's own work. So each case below runs the JAX package once, at
a test's own seeds and shapes, and `python tests/jax_reference.py` writes
what it returns to `tests/data/jax_reference.npz`; the tests read it with
`jax_ref(case)` and compare with `assert_matches_jax`.

- An array of up to `WHOLE_BYTES` is stored whole. A larger one is stored
  as its dtype, shape and the SHA-256 of its bytes (a `Digest`).
- A case takes its inputs from the helpers of its test module, or restates
  the test's one-line seeds; inputs that drift apart fail the comparison.
- `python -m pytest tests/test_jax_reference.py -m slow` recomputes every
  case and compares it with the file.

A new port test that needs JAX's bytes adds a case here, re-records, and
runs the slow test.
"""

import hashlib
import os
import sys
from functools import lru_cache
from typing import Dict, NamedTuple, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data", "jax_reference.npz")
WHOLE_BYTES = 64 * 1024


class Digest(NamedTuple):
    """An array too large to store, by its dtype, shape and SHA-256."""
    dtype: str
    shape: Tuple[int, ...]
    sha256: str


def digest(a: np.ndarray) -> Digest:
    a = np.ascontiguousarray(a)
    return Digest(a.dtype.str, a.shape, hashlib.sha256(a.tobytes()).hexdigest())


def stored(a) -> object:
    """What the file holds for an array: the array, or its `Digest`."""
    a = np.asarray(a)
    return a if a.nbytes <= WHOLE_BYTES else digest(a)


def _encode(v) -> np.ndarray:
    if isinstance(v, Digest):
        return np.array(f"sha256 {v.dtype} {'x'.join(map(str, v.shape))} {v.sha256}")
    return v


def _decode(a: np.ndarray):
    if a.dtype.kind == "U":
        _, dtype, shape, sha = str(a).split(" ")
        return Digest(dtype, tuple(int(n) for n in shape.split("x") if n), sha)
    return a


@lru_cache(maxsize=None)
def _load() -> Dict[str, Dict[str, object]]:
    out: Dict[str, Dict[str, object]] = {}
    with np.load(DATA) as f:
        for key in f.files:
            case, name = key.split("/", 1)
            out.setdefault(case, {})[name] = _decode(f[key])
    return out


def jax_ref(case: str) -> Dict[str, object]:
    """The recorded outputs of one case: {name: numpy array or Digest}."""
    return _load()[case]


def assert_matches_jax(got, ref, what: str) -> None:
    """got (torch tensor or numpy array) has JAX's values: equal to a stored
    array as integers, or, against a `Digest`, the same shape and, cast to
    JAX's dtype without loss, the same bytes."""
    g = np.asarray(got.numpy() if hasattr(got, "numpy") else got)
    if isinstance(ref, Digest):
        assert g.shape == ref.shape, f"{what}: shape {g.shape}, JAX's {ref.shape}"
        cast = g.astype(ref.dtype)
        assert np.array_equal(cast, g), f"{what}: values outside JAX's dtype {ref.dtype}"
        assert digest(cast).sha256 == ref.sha256, f"{what}: bytes differ from JAX's (SHA-256)"
    else:
        np.testing.assert_array_equal(g.astype(np.int64), ref.astype(np.int64), err_msg=what)


# --------------------------------------------------------------------------
# The cases: one a test function, named after its file and test. Each runs
# the JAX package eagerly or under its own jit, as the test once did.

def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def ntt_forward():
    import jax.numpy as jnp
    from dilithium_tpu.ops import ntt as jntt
    from test_torch_ntt import SHAPES, _rand
    return {str(s): jntt.ntt(jnp.asarray(_rand(1, s))) for s in SHAPES}


def ntt_inverse():
    import jax.numpy as jnp
    from dilithium_tpu.ops import ntt as jntt
    from test_torch_ntt import _rand
    x = jnp.asarray(_rand(2, (6,)))
    return {str(fp): jntt.invntt(x, from_product=fp) for fp in (True, False)}


def ntt_pallas_interpreted():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from dilithium_tpu.ops import ntt_pallas
    from test_torch_ntt import _rand
    x = jnp.asarray(_rand(3, (4,)))
    with pltpu.force_tpu_interpret_mode():
        return {"ntt": ntt_pallas.ntt(x), "invntt": ntt_pallas.invntt(x, from_product=True)}


def ntt_matvec():
    import jax.numpy as jnp
    from dilithium_tpu import params as jparams
    from dilithium_tpu.ops import ntt as jntt
    from test_torch_ntt import _rand
    out = {}
    for level in (2, 3, 5):
        p = jparams.get_params(level)
        out[str(level)] = jntt.matvec(jnp.asarray(_rand(10 + level, (2, p.K, p.L))),
                                      jnp.asarray(_rand(20 + level, (2, p.L))))
    return out


def slice_level2():
    import jax.numpy as jnp
    from dilithium_tpu import mxu as jmxu
    from dilithium_tpu import params as jparams
    from dilithium_tpu import scheme as jscheme
    from test_torch_slice import _level2_inputs
    p = jparams.get_params(2)
    seed, mus = _level2_inputs()
    kp = jscheme.keygen(jnp.asarray(seed), p)
    ops = jmxu.build_operators(kp.sk, p)
    res = jmxu.sign_stream_mxu(ops, jnp.asarray(mus), p, window=4, max_rounds=512)
    return {**{f"kp.{n}": v for n, v in zip(kp._fields, kp)},
            **{f"ops.{n}": v for n, v in zip(ops._fields, ops)},
            **{f"res.{n}": v for n, v in zip(("sig", "attempts", "ok"), res)}}


def sign_generic_attempt():
    import jax.numpy as jnp
    from dilithium_tpu import params as jparams
    from dilithium_tpu import scheme as jscheme
    from test_torch_sign_generic import _attempt_inputs
    jp = jparams.get_params(2)
    _, sk, mus, kappa, rhoprime, _ = _attempt_inputs()
    ek = jscheme.expand_sk(jnp.asarray(sk), jp)
    out = jscheme._sign_attempt(ek.a_hat, ek.s1_hat, ek.s2_hat, ek.t0_hat, jnp.asarray(mus),
                                jnp.asarray(rhoprime), jnp.asarray(kappa), jp)
    return {**{f"ek.{n}": v for n, v in zip(ek._fields, ek)},
            **{f"attempt.{n}": v for n, v in zip(("c_tilde", "z", "h", "accept"), out)}}


def verify_level2():
    import jax.numpy as jnp
    from dilithium_tpu import mxu as jmxu
    from dilithium_tpu import params as jparams
    from test_torch_verify import RNG_SEED, _batch
    jp = jparams.get_params(2)
    pk, _, sig, mu, _ = _batch(2, RNG_SEED)
    vops = jmxu.build_verify_operators(jnp.asarray(pk), jp)
    ok = jmxu.verify_mxu(vops, jnp.asarray(sig), jnp.asarray(mu), jp)
    return {**{f"vops.{n}": v for n, v in zip(vops._fields, vops)}, "ok": ok}


def keccak_path_shapes():
    import jax.numpy as jnp
    from dilithium_tpu.ops import keccak as jkeccak
    from test_torch_keccak import PATH_SHAPES
    return {name: jkeccak.shake_words(jnp.asarray(_u8(msg_len * 1000 + out_bytes, (3, msg_len))),
                                      out_bytes // 4, rate)
            for name, msg_len, out_bytes, rate in PATH_SHAPES}


def keccak_batch_forms():
    import jax.numpy as jnp
    from dilithium_tpu.ops import keccak as jkeccak
    data = jnp.asarray(_u8(5, (2, 3, 40)))
    return {"shake256": jkeccak.shake256(data, 48), "shake256_words": jkeccak.shake256_words(data, 6)}


def keccak_permutation():
    import jax.numpy as jnp
    from dilithium_tpu.ops import keccak as jkeccak
    st = np.random.default_rng(7).integers(0, 1 << 32, size=(4, 25, 2), dtype=np.int64).astype(np.uint32)
    return {"f1600": jkeccak.keccak_f1600(jnp.asarray(st))}


def mask_ball_expand_mask():
    import jax.numpy as jnp
    from dilithium_tpu import params as jparams
    from dilithium_tpu.ops import sampling as jsampling
    from test_torch_mask_ball import W, _mask_inputs
    out = {}
    for level in (2, 3, 5):
        p = jparams.get_params(level)
        rp, kappa = (jnp.asarray(x) for x in _mask_inputs(level))
        out[f"y {level}"] = jsampling.expand_mask(rp, kappa, p)
        limbs = np.asarray(jsampling.expand_mask_limbs(rp, kappa, p))  # [3, 256, L, W]
        out[f"limbs {level}"] = limbs.transpose(0, 3, 2, 1).reshape(3, W, p.L * 256)
    return out


def _ball(seed, rows):
    """SampleInBall of c_tilde rows made from seed + level, at 2, 3, 5."""
    import jax.numpy as jnp
    from dilithium_tpu import params as jparams
    from dilithium_tpu.ops import sampling as jsampling
    out = {}
    for level in (2, 3, 5):
        c, ok = jsampling.sample_in_ball(jnp.asarray(_u8(seed + level, (rows, 32))), jparams.get_params(level))
        out[f"c {level}"], out[f"ok {level}"] = c, ok
    return out


def mask_ball_sample_in_ball():
    return _ball(30, 6)


def sampling_expand_a():
    import jax.numpy as jnp
    from dilithium_tpu import params as jparams
    from dilithium_tpu.ops import sampling as jsampling
    out = {}
    for level in (2, 3, 5):
        for max_skips in (8, 12):
            a, ok = jsampling.expand_a(jnp.asarray(_u8(level, (2, 32))), jparams.get_params(level),
                                       max_skips=max_skips)
            out[f"a {level} {max_skips}"], out[f"ok {level} {max_skips}"] = a, ok
    return out


def sampling_expand_s():
    import jax.numpy as jnp
    from dilithium_tpu import params as jparams
    from dilithium_tpu.ops import sampling as jsampling
    out = {}
    for level in (2, 3, 5):
        p = jparams.get_params(level)
        s, ok = jsampling.expand_s(jnp.asarray(_u8(10 + level, (2, 64))), 0, p.L + p.K, p)
        out[f"s {level}"], out[f"ok {level}"] = s, ok
    return out


def exp_kernels_planes_for():
    """The JAX rig's prologue (`tools/xof_exp.py::_planes_for`, plain jnp),
    as [words, b]."""
    import importlib.util
    import jax.numpy as jnp
    from test_torch_exp_kernels import PLANES_FOR
    spec = importlib.util.spec_from_file_location("jax_xof_exp",
                                                  os.path.join(os.path.dirname(HERE), "tools", "xof_exp.py"))
    jxof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jxof)
    out = {}
    for msg_len, rate in PLANES_FOR:
        planes, _, b = jxof._planes_for(jnp.asarray(_u8(msg_len, (130, msg_len))), rate)
        out[f"{msg_len} {rate}"] = np.asarray(planes).reshape(planes.shape[0], -1)[:, :b]
    return out


def exp_kernels_xof_bm():
    import jax.numpy as jnp
    from dilithium_tpu.ops import keccak as jkeccak
    from test_torch_exp_kernels import XOF_BM
    return {f"{m} {w} {r}": jkeccak.shake_words(jnp.asarray(_u8(m + w, (2, 3, m))), w, r) for m, w, r in XOF_BM}


def exp_kernels_ball_v1():
    return _ball(40, 10)


def pack_rounding_codecs():
    import jax.numpy as jnp
    from dilithium_tpu import params as jparams
    from dilithium_tpu.ops import pack as jpack
    from test_torch_pack_rounding import _codec_inputs
    out = {}
    for level in (2, 3, 5):
        p = jparams.get_params(level)
        x = {k: jnp.asarray(v) for k, v in _codec_inputs(level).items()}
        out.update({f"eta {level}": jpack.pack_eta(x["s_canon"], p), f"t1 {level}": jpack.pack_t1(x["t1"]),
                    f"t0 {level}": jpack.pack_t0(x["t0"]), f"z {level}": jpack.pack_z(x["z"], p),
                    f"w1 {level}": jpack.pack_w1(x["w1"], p), f"hints {level}": jpack.pack_hints(x["h"], p)})
    return out


def pack_rounding_containers():
    import jax.numpy as jnp
    from dilithium_tpu import params as jparams
    from dilithium_tpu.ops import pack as jpack
    from test_torch_pack_rounding import _container_inputs
    out = {}
    for level in (2, 3, 5):
        p = jparams.get_params(level)
        x = {k: jnp.asarray(v) for k, v in _container_inputs(level).items()}
        out[f"pk {level}"] = jpack.pack_pk(x["rho"], x["t1"], p)
        sk = jpack.pack_sk(*(x[k] for k in ("rho", "key", "tr", "s1", "s2", "t0")), p)
        out[f"sk {level}"] = sk
        for i, part in enumerate(jpack.unpack_sk(sk, p)):
            out[f"unpack_sk {level} {i}"] = part
        out[f"sig {level}"] = jpack.pack_sig(x["c_tilde"], x["z"], x["h"], p)
    return out


def pack_rounding_rounding():
    import jax.numpy as jnp
    from dilithium_tpu import params as jparams
    from dilithium_tpu.ops import rounding as jrounding
    from test_torch_pack_rounding import _rounding_case
    out = {}
    for level in (2, 3, 5):
        p = jparams.get_params(level)
        bound = p.gamma2 - p.beta
        a, a0, cent, canon = (jnp.asarray(v) for v in _rounding_case(level))
        r1, r0 = jrounding.power2round(a)
        w1, w0 = jrounding.decompose(a, p)
        out.update({f"power2round {level} 0": r1, f"power2round {level} 1": r0,
                    f"decompose {level} 0": w1, f"decompose {level} 1": w0,
                    f"make_hint {level}": jrounding.make_hint(a0, w1, p),
                    f"norm {level}": jrounding.norm_exceeds(cent, bound),
                    f"norm2 {level}": jrounding.norm_exceeds(cent, bound, axis=(-2, -1)),
                    f"norm_canon {level}": jrounding.norm_exceeds(canon, bound, axis=(-2, -1))})
    return out


def verify_codecs_unpackers():
    import jax.numpy as jnp
    from dilithium_tpu import params as jparams
    from dilithium_tpu.ops import pack as jpack
    from test_torch_verify_codecs import _unpack_inputs
    out = {}
    for level in (2, 3, 5):
        p = jparams.get_params(level)
        x = {k: jnp.asarray(v) for k, v in _unpack_inputs(level).items()}
        out[f"t1 {level}"] = jpack.unpack_t1(x["t1b"])
        out[f"pk rho {level}"], out[f"pk t1 {level}"] = jpack.unpack_pk(x["pks"], p)
        out[f"z {level}"] = jpack.unpack_z(x["zb"], p)
        out[f"hints bitmap {level}"], out[f"hints ok {level}"] = jpack.unpack_hints(x["hints"], p)
        for name, v in zip(("c_tilde", "z", "h", "ok"), jpack.unpack_sig(x["sigs"], p)):
            out[f"sig {name} {level}"] = v
    return out


def verify_codecs_rounding():
    import jax.numpy as jnp
    from dilithium_tpu import params as jparams
    from dilithium_tpu.ops import rounding as jrounding
    from test_torch_verify_codecs import _use_hint_inputs
    out = {}
    for level in (2, 3, 5):
        p = jparams.get_params(level)
        a2, h = _use_hint_inputs(level)
        aj = jnp.asarray(a2.astype(np.uint32))
        out[f"highbits {level}"] = jrounding.highbits(aj, p)
        out[f"lowbits {level}"] = jrounding.lowbits(aj, p)
        out[f"use_hint {level}"] = jrounding.use_hint(jnp.asarray(h.astype(np.uint32)), aj, p)
    return out


def ball_edges_streams():
    """JAX's SampleInBall hashes c_tilde into its stream; with its SHAKE256
    replaced by the identity it walks the given stream."""
    import jax.numpy as jnp
    from dilithium_tpu import params as jparams
    from dilithium_tpu.ops import keccak as jkeccak
    from dilithium_tpu.ops import sampling as jsampling
    from dilithium_tpu_torch.tools.ball_edges import edge_streams
    shake256, out = jkeccak.shake256, {}
    jkeccak.shake256 = lambda data, nbytes: data
    try:
        for level in (2, 3, 5):
            p = jparams.get_params(level)
            for nbytes in (272, 136):
                c, ok = jsampling.sample_in_ball(jnp.asarray(edge_streams(p.tau, nbytes, seed=level)), p)
                out[f"c {level} {nbytes}"], out[f"ok {level} {nbytes}"] = c, ok
    finally:
        jkeccak.shake256 = shake256
    return out


def permute_f1600():
    """JAX's permutation and the body of its Pallas kernel (`_f1600_soa`,
    on lane-half planes), both as uint32 [b, 25, 2]."""
    import jax.numpy as jnp
    from dilithium_tpu.ops import keccak as jkeccak
    from test_torch_permute import BATCHES, _states
    out = {}
    for b in BATCHES:
        st = _states(b, 100 + b)
        out[f"f1600 {b}"] = jkeccak.keccak_f1600(jnp.asarray(st))
        lo, hi = jkeccak._f1600_soa([jnp.asarray(st[:, k, 0]) for k in range(25)],
                                    [jnp.asarray(st[:, k, 1]) for k in range(25)])
        out[f"soa {b}"] = np.stack([np.stack([np.asarray(lo[k]), np.asarray(hi[k])], axis=-1)
                                    for k in range(25)], axis=1)
    return out


def compaction_sparse():
    """`_rank_compact_sparse`: ok, and the values of the rows it keeps."""
    import jax.numpy as jnp
    from dilithium_tpu.ops import sampling as jsampling
    from test_torch_compaction import _sparse_inputs
    cand, accept = _sparse_inputs()
    out = {}
    for max_skips in (8, 12):
        vals, ok = jsampling._rank_compact_sparse(jnp.asarray(cand), jnp.asarray(accept), 256, max_skips)
        ok = np.asarray(ok)
        out[f"ok {max_skips}"], out[f"out {max_skips}"] = ok, np.asarray(vals)[ok]
    return out


def compaction_logshift():
    """`_rank_compact_logshift_packed`: ok, and the values of the rows it keeps."""
    import jax.numpy as jnp
    from dilithium_tpu.ops import sampling as jsampling
    from test_torch_compaction import P_ACCEPT, _logshift_inputs
    out = {}
    for p_accept in P_ACCEPT:
        cand, accept, _ = _logshift_inputs(p_accept)
        vals, ok = jsampling._rank_compact_logshift_packed(jnp.asarray(cand), jnp.asarray(accept), 256,
                                                           val_bits=4, p_accept=p_accept)
        ok = np.asarray(ok)
        out[f"ok {p_accept}"], out[f"out {p_accept}"] = ok, np.asarray(vals)[ok]
    return out


CASES = {f.__name__: f for f in (
    ntt_forward, ntt_inverse, ntt_pallas_interpreted, ntt_matvec, slice_level2, sign_generic_attempt,
    verify_level2, keccak_path_shapes, keccak_batch_forms, keccak_permutation, mask_ball_expand_mask,
    mask_ball_sample_in_ball, sampling_expand_a, sampling_expand_s, exp_kernels_planes_for,
    exp_kernels_xof_bm, exp_kernels_ball_v1, pack_rounding_codecs, pack_rounding_containers,
    pack_rounding_rounding, verify_codecs_unpackers, verify_codecs_rounding, ball_edges_streams,
    permute_f1600, compaction_sparse, compaction_logshift)}


def record(case: str) -> Dict[str, object]:
    """Run one case -> {name: numpy array or Digest}, as the file holds it."""
    return {name: stored(v) for name, v in CASES[case]().items()}


def main() -> int:
    recorded = {}
    for case in CASES:
        recorded[case] = record(case)
        print(case, len(recorded[case]), "arrays", flush=True)
    os.makedirs(os.path.dirname(DATA), exist_ok=True)
    np.savez_compressed(DATA, **{f"{case}/{name}": _encode(v)
                                 for case, arrays in recorded.items() for name, v in sorted(arrays.items())})
    print(DATA, os.path.getsize(DATA), "bytes")
    return 0


if __name__ == "__main__":
    # The environment of tests/conftest.py: the repo on the path, JAX on the CPU.
    sys.path.insert(0, os.path.dirname(HERE))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.exit(main())
