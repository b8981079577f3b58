"""Four-step negacyclic FFT, f64, natural spectrum order.

    forward:  real coeffs (B, N) -> spectrum planes (B, 2, M), M = N/2,
              spectrum[m] = FFT_M(fold+twist(x))[m]   (as `core.fft.forward`)
    inverse:  spectrum planes (B, 2, M) -> real coeffs (B, N)

Replaces the Pallas TPU kernels `repro/kernels/fourstep_fft.py::fft_forward`
and `::fft_inverse` with `csrc/fft.cu`.  A row at N = 32,768 and the
TPU's 128 x 128 DFT matrix each outgrow a Hopper block's shared memory,
so the split M = R * C (`factor_m`) runs as two passes — R-point column
FFTs with fold/twist and twiddle, then C-point row FFTs with the
transposed store — with radix-2 FFTs in shared memory in place of the
TPU's DFT matrix products.  Only f64 is ported: an f32 transform puts
about 2^60 of error into the 64-bit torus.

Bound on the card: bytes (a 24-row forward call at gpt2 reads and writes
12.6 MB; its twist and root tables stay in L2 across a round's calls).
The wrappers launch the kernels for CUDA tensors and run the plain
`torch.fft` versions only for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fft as core_fft
from repro_torch.kernels import _build

_ROOTS: dict = {}


def factor_m(M: int) -> tuple[int, int]:
    """Pick R*C = M mirroring the paper's 256x128 for M = 2^15."""
    assert M & (M - 1) == 0 and M >= 4
    lg = M.bit_length() - 1
    r = min(256, 1 << ((lg + 1) // 2))
    return r, M // r


def _roots(M: int, device) -> torch.Tensor:
    """exp(-2 pi i k / M), k < M, complex128 on `device` (cached)."""
    key = (M, str(device))
    w = _ROOTS.get(key)
    if w is None:
        w = _ROOTS[key] = torch.as_tensor(
            np.exp(-2j * np.pi * np.arange(M) / M), dtype=torch.complex128,
            device=device)
    return w


def fft_forward_plain(x: torch.Tensor) -> torch.Tensor:
    """real (B, N) -> (B, 2, N/2) f64 stacked re/im (the kernel's layout)."""
    spec = core_fft.forward(x)
    return torch.stack([spec.real, spec.imag], dim=1)


def fft_inverse_plain(spec: torch.Tensor) -> torch.Tensor:
    """(B, 2, M) -> real (B, 2M) f64."""
    return core_fft.inverse(torch.complex(spec[:, 0], spec[:, 1]))


def _launch(name: str, inp: torch.Tensor, out: torch.Tensor, N: int) -> None:
    M = N // 2
    R, C = factor_m(M)
    scratch = torch.empty((inp.shape[0], M), dtype=torch.complex128,
                          device=inp.device)
    twist, roots = core_fft.twist(N, inp.device), _roots(M, inp.device)
    fn = _build.function("fft", f"{name}_launch", 5, 4)
    _build.launch(name, fn, inp.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                  twist.data_ptr(), roots.data_ptr(), inp.shape[0], M, R, C,
                  device=inp.device)


def _check(name: str, t: torch.Tensor, dims: int) -> None:
    _build.require(name, t.device.type == "cuda", f"needs a CUDA tensor, got {t.device}")
    _build.require(name, t.dtype == torch.float64, f"needs float64, got {t.dtype}")
    _build.require(name, t.dim() == dims and t.is_contiguous(),
                   f"needs a contiguous {dims}-d tensor, got {tuple(t.shape)}")


def fft_forward(x: torch.Tensor) -> torch.Tensor:
    """Negacyclic forward transform: real (B, N) -> (B, 2, N/2) planes."""
    if x.device.type == "cpu":
        return fft_forward_plain(x)
    _check("fft_forward", x, 2)
    B, N = x.shape
    out = torch.empty((B, 2, N // 2), dtype=torch.float64, device=x.device)
    _launch("fft_forward", x, out, N)
    return out


def fft_inverse(spec: torch.Tensor) -> torch.Tensor:
    """Inverse: (B, 2, M) planes -> real coeffs (B, 2M)."""
    if spec.device.type == "cpu":
        return fft_inverse_plain(spec)
    _check("fft_inverse", spec, 3)
    _build.require("fft_inverse", spec.shape[1] == 2,
                   f"needs (B, 2, M) planes, got {tuple(spec.shape)}")
    B, _, M = spec.shape
    out = torch.empty((B, 2 * M), dtype=torch.float64, device=spec.device)
    _launch("fft_inverse", spec, out, 2 * M)
    return out
