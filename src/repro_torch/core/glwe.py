"""GLWE ciphertexts: the LUT carriers of programmable bootstrapping.

Layout: (..., k+1, N) int64 = [A_1 .. A_k, B]; each row a polynomial in
Z_q[X]/(X^N+1), with the bits of the reference's uint64 coefficients.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.core import torus, fft
from repro_torch.core.params import TFHEParams

I64 = torch.int64


def keygen(generator: torch.Generator, k: int, N: int, device=None) -> torch.Tensor:
    """Binary GLWE secret key: (k, N) int64 in {0,1}."""
    return torch.randint(0, 2, (k, N), dtype=I64, generator=generator,
                         device=device)


def flatten_key(glwe_key: torch.Tensor) -> torch.Tensor:
    """The 'big' LWE key sample-extract produces ciphertexts under."""
    return glwe_key.reshape(-1)


def encrypt(generator: torch.Generator, sk: torch.Tensor,
            msg_poly: torch.Tensor, std: float) -> torch.Tensor:
    """Encrypt torus polynomial(s) (..., N) -> (..., k+1, N)."""
    k, N = sk.shape
    shape = tuple(msg_poly.shape[:-1])
    a = torus.random_torus(generator, shape + (k, N), device=sk.device)
    e = torus.gaussian_noise(generator, shape + (N,), std, device=sk.device)
    # b = sum_i a_i * s_i + m + e  (negacyclic products)
    prod = fft.inverse_torus((fft.forward(a) * fft.forward(sk)).sum(dim=-2))
    b = prod + msg_poly + e
    return torch.cat([a, b[..., None, :]], dim=-2)


def decrypt_phase(sk: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    prod = fft.inverse_torus((fft.forward(ct[..., :-1, :])
                              * fft.forward(sk)).sum(dim=-2))
    return ct[..., -1, :] - prod


def trivial(msg_poly: torch.Tensor, k: int) -> torch.Tensor:
    """Noiseless GLWE (A=0, B=m): how LUT accumulators start life."""
    z = torch.zeros(tuple(msg_poly.shape[:-1]) + (k, msg_poly.shape[-1]),
                    dtype=I64, device=msg_poly.device)
    return torch.cat([z, msg_poly[..., None, :].to(I64)], dim=-2)


def rotation_index(r: torch.Tensor, N: int):
    """Source index and sign mask of X^r * p for shifts r in [0, 2N)."""
    j = torch.arange(N, dtype=I64, device=r.device)
    src = (j - r[..., None]) % (2 * N)   # exponent index in [0, 2N)
    neg = src >= N                       # the second copy carries a minus sign
    return torch.where(neg, src - N, src), neg


def rotate(ct: torch.Tensor, r, N: int) -> torch.Tensor:
    """Multiply every polynomial by the monomial X^r, r in [0, 2N).

    Negacyclic: X^N = -1.  Works on any (..., N) trailing-axis layout;
    `r` is one shift (a Python int or a 0-d tensor)."""
    r = torch.as_tensor(r, dtype=I64, device=ct.device)
    idx, neg = rotation_index(r, N)
    vals = ct[..., idx]
    return torch.where(neg, -vals, vals)


def sample_extract(ct: torch.Tensor) -> torch.Tensor:
    """Extract the constant coefficient as an LWE ciphertext (paper step D).

    (..., k+1, N) -> (..., k*N+1) under the flattened GLWE key.
    """
    *lead, kp1, N = ct.shape
    a_polys, b_poly = ct[..., :-1, :], ct[..., -1, :]
    # a'_{i*N + j} = A_i[0] if j == 0 else -A_i[N - j]
    rev = -a_polys.flip(-1)
    a = torch.cat([a_polys[..., :1], rev[..., : N - 1]], dim=-1)
    a = a.reshape(*lead, (kp1 - 1) * N)
    return torch.cat([a, b_poly[..., :1]], dim=-1)


def make_lut_poly(table, params: TFHEParams, device=None) -> torch.Tensor:
    """Encode a plaintext LUT f: [0, 2^width) -> [0, 2^width) as the test
    polynomial V (torus coefficients), pre-rotated by half a slot so the
    rounding window is centred (standard Concrete construction).

    table: (2^width,) integer outputs.
    """
    N, width = params.N, params.width
    reps = N // (1 << width)
    vals = torus.encode(table, params.delta, device=device)
    v = torch.repeat_interleave(vals, reps)                # (N,)
    # multiply by X^{-reps/2}: rotate by 2N - reps//2
    return rotate(v, 2 * N - reps // 2, N)


def make_lut_polys(tables, params: TFHEParams, device=None) -> torch.Tensor:
    """Batched `make_lut_poly`: (B, 2^width) integer tables -> (B, N)."""
    tables = torch.as_tensor(tables, dtype=I64, device=device)
    return torch.stack([make_lut_poly(t, params) for t in tables])


# Process-wide test-polynomial cache, one entry per UNIQUE table row per
# parameter set and device.  A PBS round's (B, 2^width) table stack is
# almost always a tile of 2-3 distinct rows, and concurrent requests
# re-derive the same rows, so each distinct row is encoded once and the
# stack is gathered.  Bounded FIFO, because table rows arrive from client
# programs; lookups and eviction hold a lock, the encode itself does not
# (a race at worst re-encodes a row).
_ROW_POLY_CACHE: dict = {}
_ROW_POLY_CACHE_MAX = 4096
_ROW_POLY_LOCK = threading.Lock()
_ROW_POLY_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def row_poly_cache_stats() -> dict:
    """Snapshot of the process-wide LUT-poly cache counters."""
    with _ROW_POLY_LOCK:
        return dict(_ROW_POLY_STATS)


def clear_row_poly_cache() -> None:
    """Drop every cached row and reset the counters (test isolation)."""
    with _ROW_POLY_LOCK:
        _ROW_POLY_CACHE.clear()
        _ROW_POLY_STATS.update(hits=0, misses=0, evictions=0)


def _cache_put(key, poly) -> None:
    with _ROW_POLY_LOCK:
        while len(_ROW_POLY_CACHE) >= _ROW_POLY_CACHE_MAX:
            _ROW_POLY_CACHE.pop(next(iter(_ROW_POLY_CACHE)), None)
            _ROW_POLY_STATS["evictions"] += 1
        _ROW_POLY_CACHE[key] = poly


def make_lut_polys_cached(tables, params: TFHEParams,
                          device=None) -> torch.Tensor:
    """`make_lut_polys` through the process-wide per-row cache: only rows
    never seen under (`params`, `device`) are encoded; the stack is
    gathered from cached (N,) polynomials."""
    if isinstance(tables, torch.Tensor):
        device = tables.device if device is None else device
        tables = tables.cpu().numpy()
    device = torch.device("cpu" if device is None else device)
    tables = np.ascontiguousarray(np.asarray(tables, dtype=np.int64))
    row_keys = [(params, str(device), r.tobytes()) for r in tables]
    order: dict = {}
    for i, k in enumerate(row_keys):
        order.setdefault(k, i)
    with _ROW_POLY_LOCK:
        local = {k: _ROW_POLY_CACHE[k] for k in order if k in _ROW_POLY_CACHE}
        _ROW_POLY_STATS["hits"] += len(local)
        _ROW_POLY_STATS["misses"] += len(order) - len(local)
    missing = [k for k in order if k not in local]
    if missing:
        polys = make_lut_polys(np.stack([tables[order[k]] for k in missing]),
                               params, device=device)
        for j, k in enumerate(missing):
            local[k] = polys[j]
            _cache_put(k, polys[j])
    uniq = torch.stack([local[k] for k in order])
    slot = {k: j for j, k in enumerate(order)}
    return uniq[torch.tensor([slot[k] for k in row_keys], device=device)]
