"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel.

  keyswitch         — the LPU key-switch MAC, mod 2^64, as an int8
                      tensor-core GEMM over the KSK's byte limbs; int32
                      digits (`keyswitch_mac_int32`) as five int8 digit
                      rows each, stacked along the batch, one launch.
  fourstep_fft      — the four-step negacyclic FFT, one launch per
                      transform on a thread-block cluster: `fft_forward`
                      and `fft_inverse` in f64 or f32 (`dtype=`), the
                      digit and torus entry points (f64) carrying a CMux
                      step's glue.
  external_product  — the BRU transform-domain MAC with batch BSK reuse,
                      f64 or f32 planes.
  fused_pbs         — the kernels wired into the batched PBS hot path with
                      resident key operands (`kernel_backend="fused"`).
  ops               — the reference's public wrappers with its defaults
                      (f32 planes, int32 keyswitch digits, tiling hints).

Sources live in `csrc/` and build with `nvcc` at first use (`_build`).
Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version only for CPU tensors; `launch_counts()` reads how often
each kernel was launched (a replayed CUDA graph's kernels included).
"""
from repro_torch.kernels._build import launch_counts, reset_launch_counts  # noqa: F401
