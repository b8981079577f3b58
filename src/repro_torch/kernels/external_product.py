"""BRU transform-domain MAC against one BSK slice shared by the batch.

    out[b, k, f] = sum_j dig[b, j, f] * bsk[j, k, f]        (complex)

Layouts are stacked re/im planes: dig (B, 2, J, F), bsk (2, J, K, F),
out (B, 2, K, F), J = (k+1) * pbs_level.

Replaces the Pallas TPU kernel
`repro/kernels/external_product.py::external_product_mac` with the CUDA
kernel in `csrc/external_product.cu`.  Bound on the card: bytes (13.6 MB
per call at gpt2, B = 12; 303 MB at 288 rows; 8 B J K F flops).  So the
design keeps bytes in flight: a grid over (F tile, group of 2 rows),
each thread one f with its J x K complex BSK values in registers and
both rows' loads issued before the first store; the BSK slice is read
once per row group, from L2 after the first (the paper's key reuse).
The block shape is the best of `kernels/mac_sweep.py` on the card, which
builds variants of the kernel's source with other shapes.

Planes are f64 on the engine's path; `dtype=torch.float32`, the
reference's default plane type (reached through `kernels.ops`), runs the
kernel's f32 instantiation, counted under the same name.
`external_product_mac` launches the kernel for CUDA tensors and runs
`external_product_mac_plain` (a complex einsum) only for CPU tensors.  A
launch puts ceil(B / 2) row groups on grid y, at most 65,535, so a call
of more than `MAX_ROWS` rows runs one launch per slice of the batch
(a call that fits takes one launch on the whole tensors).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fourstep_fft import MAX_GRID_Y, _at, plane_type, row_slices

ROWS_PER_BLOCK = 2                      # `kRows` in csrc/external_product.cu
MAX_ROWS = ROWS_PER_BLOCK * MAX_GRID_Y  # batch rows one launch takes


def external_product_mac_plain(dig: torch.Tensor, bsk: torch.Tensor,
                               dtype=torch.float64) -> torch.Tensor:
    """dig (B,2,J,F), bsk (2,J,K,F) -> (B,2,K,F): a complex einsum in
    `dtype`'s complex type (complex128, or complex64 for f32)."""
    dig, bsk = dig.to(dtype), bsk.to(dtype)
    d = torch.complex(dig[:, 0], dig[:, 1])
    w = torch.complex(bsk[0], bsk[1])
    out = torch.einsum("bjf,jkf->bkf", d, w)
    return torch.stack([out.real, out.imag], dim=1)


def external_product_mac(dig: torch.Tensor, bsk: torch.Tensor,
                         dtype=torch.float64) -> torch.Tensor:
    """dig (B,2,J,F), bsk (2,J,K,F) -> (B,2,K,F) planes of `dtype` (the
    operands are cast to it, as the reference casts)."""
    name = "external_product_mac"
    plane_type(name, dtype)
    if dig.dtype != dtype:
        dig = dig.to(dtype)
    if bsk.dtype != dtype:
        bsk = bsk.to(dtype)
    if dig.device.type == "cpu":
        return external_product_mac_plain(dig, bsk, dtype)
    _build.require(name, dig.device.type == "cuda" and bsk.device == dig.device,
                   f"needs CUDA tensors on one device, got {dig.device} and "
                   f"{bsk.device}")
    _build.require(name, dig.dtype == dtype and bsk.dtype == dtype,
                   f"needs {dtype} planes, got {dig.dtype} and {bsk.dtype}")
    _build.require(name, dig.dim() == 4 and bsk.dim() == 4 and dig.shape[1] == 2
                   and bsk.shape[0] == 2 and dig.shape[2] == bsk.shape[1]
                   and dig.shape[3] == bsk.shape[3],
                   f"shapes {tuple(dig.shape)} x {tuple(bsk.shape)}")
    _build.require(name, dig.is_contiguous() and bsk.is_contiguous(),
                   "needs contiguous tensors")
    B, _, J, F = dig.shape
    K = bsk.shape[2]
    out = torch.empty((B, 2, K, F), dtype=dtype, device=dig.device)
    fn = _build.function("external_product", "external_product_mac_launch"
                         if dtype == torch.float64 else "external_product_mac_f32_launch", 3, 4)
    if B <= MAX_ROWS:
        _build.launch(name, fn, dig.data_ptr(), bsk.data_ptr(), out.data_ptr(),
                      B, J, K, F, device=dig.device)
        return out
    for b0, b1 in row_slices(B, 1, MAX_ROWS):
        _build.launch(name, fn, _at(dig, b0), bsk.data_ptr(), _at(out, b0),
                      b1 - b0, J, K, F, device=dig.device)
    return out
