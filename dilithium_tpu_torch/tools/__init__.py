"""A/B rigs of the kernel micro-bench: the counterparts of the JAX
package's `tools/xof_exp.py` (K6, a sponge over plane-major words) and
`tools/ball_exp.py` (K7, SampleInBall on bit planes). Each holds a
kernel, its plain PyTorch version and the wrapper that picks between them
by the tensor's device; `dilithium_tpu_torch.bench_kernels` times them
against K1 and K3. Two measuring tools hold no kernel: `kernel_ab` times
this checkout's K1 and K2 against other checkouts' on one card, and
`round_profile` gives the signing path's device time per round by kernel
group."""
