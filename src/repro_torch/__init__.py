"""PyTorch/CUDA port of the multi-bit TFHE engine (`repro`, in JAX).

Layout mirrors `repro`: `core/` holds the scheme (torus, decompose, fft,
lwe, glwe, ggsw, pbs, batch, engine) in plain PyTorch, `kernels/` the
hand-written CUDA kernels for Hopper with their wrappers and the fused
PBS path.  The package imports `torch`, never JAX or `repro`.  Its entry
points run on the card unless the caller passes `device="cpu"`.
"""
