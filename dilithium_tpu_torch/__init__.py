"""dilithium_tpu_torch — Dilithium keygen, sign and verify in PyTorch.

A port of the JAX package `dilithium_tpu` to PyTorch, with a hand-written
CUDA kernel (sm_90a) in place of every Pallas kernel:

  - keygen (`scheme.keygen`); signing with one key over dense int8
    operators (`mxu.build_operators` -> `mxu.sign_stream_mxu`, or the
    `mxu.MxuSigner` module); signing in the NTT form (`scheme.expand_sk`,
    the lockstep `scheme.sign` / `sign_expanded`, the elastic
    `scheme.sign_stream` and `sign_stream_keys`); verify per lane, under
    one expanded public key, or over dense operators (`mxu.MxuVerifier`);
  - the bytes API (`api`: `keygen`, `sign`, `verify`, `Signer`,
    `MultiSigner`, `Verifier`) and the CLI (`python -m
    dilithium_tpu_torch`), on the card unless given device="cpu";
  - the data-parallel services on `torch.distributed` (`parallel`: one
    process per card, NCCL; gloo on the CPU) and their launcher
    (`python -m dilithium_tpu_torch.tools.run_multihost`); the KAT
    loader (`utils.kat`) and replay (`tools.kat_replay`);
  - the kernels of the JAX package's micro-bench and its A/B rigs
    (`bench_kernels`, `tools/`).

Tensors on the CPU run each kernel's plain PyTorch version; tensors on a
CUDA device run the kernels from `csrc/`, built with nvcc at first use
(`_kernels.py`). Importing the package imports neither JAX nor Triton and
builds nothing.

Conventions: bytes are uint8; polynomial coefficients are int32, canonical
in [0, q) or centered in (-q/2, q/2] as each function states; 32-bit XOF
words are int64 in [0, 2^32).
"""

from dilithium_tpu_torch.params import DilithiumParams, LEVELS, get_params

__all__ = ["DilithiumParams", "LEVELS", "get_params"]
