"""dilithium_tpu_torch — the Dilithium one-key signing path in PyTorch.

A port of the JAX package `dilithium_tpu` to PyTorch, with a hand-written
CUDA kernel (sm_90a) in place of every Pallas kernel on the path:

  keygen (`scheme.keygen`) -> dense per-key operators
  (`mxu.build_operators`) -> elastic stream signer over int8 GEMMs
  (`mxu.sign_stream_mxu`, or the `mxu.MxuSigner` module),

and for the kernels of the JAX package's micro-bench and its A/B rigs
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
