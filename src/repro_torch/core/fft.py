"""Negacyclic polynomial multiplication via the double-real ("twisted") FFT.

    forward :  N real coeffs  ->  N/2 complex values
               u_j = a_j + i * a_{j+N/2}
               v_j = u_j * exp(i*pi*j/N)            (the "twist")
               A   = FFT_{N/2}(v)                   (natural order)
    pointwise multiply in the transform domain == negacyclic convolution
    inverse :  untwist + split real/imag.

This is the complex128 `torch.fft` reference path, in the same natural
spectrum order as `repro.core.fft`: the plain path of the engine's
`"reference"` backend and the oracle of `repro_torch.kernels.fourstep_fft`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import torus

_TWIST: dict = {}


def twist(N: int, device) -> torch.Tensor:
    """exp(i*pi*j/N), j < N/2, complex128 on `device` (cached per device)."""
    key = (N, str(device))
    t = _TWIST.get(key)
    if t is None:
        j = np.arange(N // 2)
        t = _TWIST[key] = torch.as_tensor(np.exp(1j * np.pi * j / N),
                                          dtype=torch.complex128, device=device)
    return t


_COMPLEX = {torch.float64: torch.complex128, torch.float32: torch.complex64}


def forward(poly: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Real (..., N) -> complex (..., N/2) negacyclic transform, on
    `dtype` planes (complex128 for float64, complex64 for float32).

    Integer coefficients are taken as SIGNED representatives (the int64
    view of torus values), as the reference does."""
    N = poly.shape[-1]
    poly = poly.to(dtype)
    u = torch.complex(poly[..., : N // 2], poly[..., N // 2:])
    return torch.fft.fft(u * twist(N, poly.device).to(_COMPLEX[dtype]), dim=-1)


def inverse(spec: torch.Tensor) -> torch.Tensor:
    """Complex (..., N/2) -> real (..., N) coefficients, of the spectrum's
    precision."""
    N = spec.shape[-1] * 2
    u = torch.fft.ifft(spec, dim=-1) * torch.conj(twist(N, spec.device)).to(spec.dtype)
    return torch.cat([u.real, u.imag], dim=-1)


def inverse_torus(spec: torch.Tensor) -> torch.Tensor:
    """Inverse transform folded back onto the torus (int64 mod 2^64)."""
    return torus.float_to_torus(inverse(spec))
