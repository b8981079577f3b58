"""Four-step negacyclic FFT, natural spectrum order, and the CMux step's
glue folded into it.

    fft_forward:         real coeffs (B, N) -> spectrum planes (B, 2, M),
                         M = N/2, spectrum = `core.fft.forward`; f64 or f32
    fft_inverse:         spectrum planes (B, 2, M) -> real coeffs (B, N);
                         f64 or f32
    fft_forward_digits:  int64 (B, K, N) [+ shifts (B,)] -> (B, 2, J, M)
                         planes of the gadget digits of X^shift * src - src
                         (or of src), J = K * level, row j = u * level + l:
                         the external-product MAC's dig layout
    fft_inverse_torus:   the MAC's (B, 2, K, M) output -> int64 (B, K, N)
                         on the torus [+ acc]

Replaces the Pallas TPU kernels
`repro/kernels/fourstep_fft.py::fft_forward` and `::fft_inverse` with
`csrc/fft.cu`.  All four entry points run one kernel launch each: a
thread-block cluster per row (8 blocks for M >= 4096, 16 at M = 32,768)
splits M = R * C as `factor_m` does, does the R-point column FFTs in
shared memory, exchanges through distributed shared memory and does the
C-point row FFTs, with radix-16 Stockham passes in registers, so no
intermediate touches device memory.  The digit and torus entry points
fold a blind-rotation step's rotate, subtract, decompose, cast,
`float_to_torus` and accumulator add into the same launch: a CMux step
is forward, MAC, inverse.  Their launches count under `fft_forward` and
`fft_inverse`.  A launch puts its rows on grid y, at most 65,535 of
them, so a larger call runs one launch per slice of the batch
(`row_slices`), each counted; a call that fits takes one launch on the
whole tensors, with no per-slice address arithmetic on the CMux step's
host path.  The engine's path is f64 (an f32 transform puts about 2^60
of error into the 64-bit torus), so the digit and torus entry points
exist only in f64.  `fft_forward` and `fft_inverse` take `dtype=`, the
reference's plane type: f64 by default here, f32 (the TPU kernel's
default, reached through `kernels.ops`) as a second instantiation of the
same CUDA kernel, counted under the same name.

Bound on the card: bytes (a 24-row forward call at gpt2 reads and writes
12.6 MB; `fft_inverse_torus` with `acc` moves 18.9 MB).  The wrappers
launch the kernel for CUDA tensors and run the plain versions (composed of
`torch.fft` and the core ops) only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import batch as batch_mod, decompose as dec, fft as core_fft, torus
from repro_torch.kernels import _build

MAX_GRID_Y = 65535      # CUDA's limit on gridDim.y, where a launch puts its rows


def row_slices(B: int, rows_per_item: int, limit: int = MAX_GRID_Y) -> list:
    """[(b0, b1), ...]: the batch cut into slices of at most
    `limit // rows_per_item` items, so that each slice's launch has at most
    `limit` rows on its grid.  One launch per slice."""
    if rows_per_item < 1 or rows_per_item > limit:
        raise ValueError(f"{rows_per_item} rows per item cannot fit {limit} rows")
    step = limit // rows_per_item
    return [(b0, min(B, b0 + step)) for b0 in range(0, B, step)]


def _at(t: torch.Tensor, b0: int) -> int:
    """The address of item b0 of a contiguous tensor (no view is made: the
    wrappers run on every CMux step)."""
    return t.data_ptr() + b0 * t.stride(0) * t.element_size()


def factor_m(M: int) -> tuple[int, int]:
    """The split R*C = M the kernel uses, mirroring the paper's 256x128 for
    M = 2^15."""
    assert M & (M - 1) == 0 and M >= 4
    lg = M.bit_length() - 1
    r = min(256, 1 << ((lg + 1) // 2))
    return r, M // r


PLANE_TYPES = (torch.float64, torch.float32)


def plane_type(name: str, dtype) -> torch.dtype:
    """`dtype` if a kernel has an instantiation for it, else raise: an f32
    request never runs f64, nor the other way round."""
    if dtype not in PLANE_TYPES:
        raise ValueError(f"{name}: planes are float64 or float32, got {dtype}")
    return dtype


# --- plain versions ------------------------------------------------------------

def fft_forward_plain(x: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """real (B, N) -> (B, 2, N/2) stacked re/im (the kernel's layout) of
    `dtype`: `core.fft.forward` (complex128 `torch.fft` in f64, complex64
    in f32)."""
    spec = core_fft.forward(x, dtype)
    return torch.stack([spec.real, spec.imag], dim=1)


def fft_inverse_plain(spec: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """(B, 2, M) -> real (B, 2M) of `dtype`: `core.fft.inverse`."""
    spec = spec.to(dtype)
    return core_fft.inverse(torch.complex(spec[:, 0], spec[:, 1]))


def fft_forward_digits_plain(src: torch.Tensor, shifts: torch.Tensor | None,
                             base_log: int, level: int) -> torch.Tensor:
    """int64 (B, K, N), shifts (B,) or None -> (B, 2, K*level, N/2) f64."""
    B, K, N = src.shape
    v = src if shifts is None else batch_mod.rotate_batch(src, shifts, N) - src
    digs = dec.decompose(v, base_log, level).movedim(-1, -2).reshape(B * K * level, N)
    spec = fft_forward_plain(digs.to(torch.float64))
    return spec.reshape(B, K * level, 2, N // 2).transpose(1, 2).contiguous()


def fft_inverse_torus_plain(planes: torch.Tensor,
                            acc: torch.Tensor | None) -> torch.Tensor:
    """(B, 2, K, M) f64, acc (B, K, 2M) int64 or None -> int64 (B, K, 2M)."""
    B, _, K, M = planes.shape
    coeffs = fft_inverse_plain(planes.transpose(1, 2).reshape(B * K, 2, M))
    out = torus.float_to_torus(coeffs).reshape(B, K, 2 * M)
    return out if acc is None else acc + out


# --- kernel wrappers -----------------------------------------------------------

def residency(N: int) -> dict:
    """{entry point: {"clusters": .., "blocks_per_sm": ..}} of the CMux
    step's two launches at N on the current card: the clusters (rows) that
    fit on it at once (`cudaOccupancyMaxActiveClusters`) and the blocks an
    SM holds.  Needs CUDA."""
    _check_n("residency", N)
    _build.require("residency", torch.cuda.is_available(), "needs a CUDA device")
    fn = _build.build_all()["fft"].fft_residency
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = {}
    for name, mode in (("fft_forward_digits", 1), ("fft_inverse_torus", 3)):
        clusters, blocks = ctypes.c_int(), ctypes.c_int()
        rc = fn(N, mode, ctypes.byref(clusters), ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"residency: CUDA error {rc} for {name} at N = {N}")
        out[name] = {"clusters": clusters.value, "blocks_per_sm": blocks.value}
    return out


def _check(name: str, t: torch.Tensor, dims: int, dtype: torch.dtype) -> None:
    _build.require(name, t.device.type == "cuda", f"needs a CUDA tensor, got {t.device}")
    _build.require(name, t.dtype == dtype, f"needs {dtype}, got {t.dtype}")
    _build.require(name, t.dim() == dims and t.is_contiguous(),
                   f"needs a contiguous {dims}-d tensor, got {tuple(t.shape)}")


def _check_n(name: str, N: int) -> None:
    _build.require(name, 8 <= N <= 65536 and N & (N - 1) == 0,
                   f"needs N a power of two in [8, 65536], got {N}")


def _check_aux(name: str, aux: torch.Tensor, like: torch.Tensor, shape: tuple) -> None:
    _build.require(name, aux.device == like.device and aux.dtype == torch.int64
                   and tuple(aux.shape) == shape and aux.is_contiguous(),
                   f"needs a contiguous int64 {shape} tensor on {like.device}, got "
                   f"{aux.dtype} {tuple(aux.shape)} on {aux.device}")


def fft_forward(x: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Negacyclic forward transform: real (B, N) -> (B, 2, N/2) planes of
    `dtype` (x is cast to it, as the reference casts)."""
    plane_type("fft_forward", dtype)
    if x.dtype != dtype:
        x = x.to(dtype)
    if x.device.type == "cpu":
        return fft_forward_plain(x, dtype)
    _check("fft_forward", x, 2, dtype)
    B, N = x.shape
    _check_n("fft_forward", N)
    out = torch.empty((B, 2, N // 2), dtype=dtype, device=x.device)
    fn = _build.function("fft", "fft_forward_launch" if dtype == torch.float64
                         else "fft_forward_f32_launch", 2, 2)
    if B <= MAX_GRID_Y:
        _build.launch("fft_forward", fn, x.data_ptr(), out.data_ptr(), B, N, device=x.device)
        return out
    for b0, b1 in row_slices(B, 1):
        _build.launch("fft_forward", fn, _at(x, b0), _at(out, b0), b1 - b0, N,
                      device=x.device)
    return out


def fft_inverse(spec: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Inverse: (B, 2, M) planes -> real coeffs (B, 2M) of `dtype` (the
    planes are cast to it)."""
    plane_type("fft_inverse", dtype)
    if spec.dtype != dtype:
        spec = spec.to(dtype)
    if spec.device.type == "cpu":
        return fft_inverse_plain(spec, dtype)
    _check("fft_inverse", spec, 3, dtype)
    _build.require("fft_inverse", spec.shape[1] == 2,
                   f"needs (B, 2, M) planes, got {tuple(spec.shape)}")
    B, _, M = spec.shape
    _check_n("fft_inverse", 2 * M)
    out = torch.empty((B, 2 * M), dtype=dtype, device=spec.device)
    fn = _build.function("fft", "fft_inverse_launch" if dtype == torch.float64
                         else "fft_inverse_f32_launch", 2, 2)
    if B <= MAX_GRID_Y:
        _build.launch("fft_inverse", fn, spec.data_ptr(), out.data_ptr(), B, 2 * M,
                      device=spec.device)
        return out
    for b0, b1 in row_slices(B, 1):
        _build.launch("fft_inverse", fn, _at(spec, b0), _at(out, b0), b1 - b0, 2 * M,
                      device=spec.device)
    return out


def fft_forward_digits(src: torch.Tensor, shifts: torch.Tensor | None,
                       base_log: int, level: int) -> torch.Tensor:
    """A CMux step's prologue and forward transform in one launch.

    src (B, K, N) int64 torus polys, shifts (B,) int64 in [0, 2N) or None
    -> (B, 2, K*level, N/2) f64 planes of the signed gadget digits of
    X^shifts[b] * src[b] - src[b] (of src[b] when shifts is None), digit
    row j = u*level + l, level l = 0 the most significant."""
    if src.device.type == "cpu":
        return fft_forward_digits_plain(src, shifts, base_log, level)
    name = "fft_forward_digits"
    _check(name, src, 3, torch.int64)
    B, K, N = src.shape
    _check_n(name, N)
    _build.require(name, 0 < base_log <= 32 and level > 0 and base_log * level <= 64,
                   f"needs 0 < base_log <= 32 and base_log * level <= 64, got "
                   f"{base_log} x {level}")
    if shifts is not None:
        _check_aux(name, shifts, src, (B,))
    out = torch.empty((B, 2, K * level, N // 2), dtype=torch.float64, device=src.device)
    fn = _build.function("fft", "fft_forward_digits_launch", 3, 5)
    if B * K * level <= MAX_GRID_Y:
        _build.launch("fft_forward", fn, src.data_ptr(),
                      None if shifts is None else shifts.data_ptr(), out.data_ptr(),
                      B, K, N, base_log, level, device=src.device)
        return out
    for b0, b1 in row_slices(B, K * level):
        _build.launch("fft_forward", fn, _at(src, b0),
                      None if shifts is None else _at(shifts, b0), _at(out, b0),
                      b1 - b0, K, N, base_log, level, device=src.device)
    return out


def fft_inverse_torus(planes: torch.Tensor, acc: torch.Tensor | None) -> torch.Tensor:
    """A CMux step's inverse transform and epilogue in one launch.

    planes (B, 2, K, M) f64, acc (B, K, 2M) int64 or None -> a new int64
    (B, K, 2M) tensor: the inverse transform rounded onto the torus as
    `torus.float_to_torus`, plus acc (wrapping) when given."""
    if planes.device.type == "cpu":
        return fft_inverse_torus_plain(planes, acc)
    name = "fft_inverse_torus"
    _check(name, planes, 4, torch.float64)
    B, two, K, M = planes.shape
    _build.require(name, two == 2, f"needs (B, 2, K, M) planes, got {tuple(planes.shape)}")
    _check_n(name, 2 * M)
    if acc is not None:
        _check_aux(name, acc, planes, (B, K, 2 * M))
    out = torch.empty((B, K, 2 * M), dtype=torch.int64, device=planes.device)
    fn = _build.function("fft", "fft_inverse_torus_launch", 3, 3)
    if B * K <= MAX_GRID_Y:
        _build.launch("fft_inverse", fn, planes.data_ptr(),
                      None if acc is None else acc.data_ptr(), out.data_ptr(),
                      B, K, 2 * M, device=planes.device)
        return out
    for b0, b1 in row_slices(B, K):
        _build.launch("fft_inverse", fn, _at(planes, b0),
                      None if acc is None else _at(acc, b0), _at(out, b0),
                      b1 - b0, K, 2 * M, device=planes.device)
    return out
