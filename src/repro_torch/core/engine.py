"""TaurusEngine: the batched KS-first PBS engine on one CUDA device.

The engine is the execution backend later layers (integers, compiler,
serving) call.  Kernel backends: `kernel_backend="fused"` (the default)
runs `repro_torch.kernels.fused_pbs` — the FFT / external-product /
keyswitch stages as hand-written CUDA kernels against a `FusedPbsPack`
of resident transform-domain key operands, built lazily on first use
and reused across every round (the paper's key-reuse strategy).
`"reference"` runs the plain PyTorch pipeline in `repro_torch.core.batch`.
Both are decrypt-identical; the keyswitch stage is bit-identical.

The engine runs on the card unless the caller names another device; on
the CPU the fused backend runs each kernel's plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import batch as batch_mod, glwe
from repro_torch.core.params import TFHEParams
from repro_torch.device import resolve_device

I64 = torch.int64
KERNEL_BACKENDS = ("fused", "reference")


def validate_lut_tables(cts: torch.Tensor, tables, params: TFHEParams) -> torch.Tensor:
    """Normalize/validate per-ciphertext integer LUT tables against a
    batch: broadcast a single (2^width,) table across the batch, reject
    any other count mismatch.  Returns an int64 (B, 2^width) CPU tensor."""
    if isinstance(tables, torch.Tensor):
        tables = tables.cpu()
    tables = torch.as_tensor(tables, dtype=I64)
    mod = params.plaintext_modulus
    if tables.dim() == 1:
        tables = tables.expand((cts.shape[0],) + tuple(tables.shape))
    if tables.dim() != 2 or tables.shape[-1] != mod:
        raise ValueError(
            f"lut_batch_tables: tables must be (B, {mod}) or ({mod},), "
            f"got {tuple(tables.shape)}")
    if tables.shape[0] != cts.shape[0]:
        raise ValueError(
            f"lut_batch_tables: {cts.shape[0]} ciphertexts but "
            f"{tables.shape[0]} tables — pass one table per ciphertext "
            f"or a single shared table")
    return tables


@dataclasses.dataclass
class TaurusEngine:
    params: TFHEParams
    bsk_f: torch.Tensor
    ksk: torch.Tensor
    # optional telemetry (duck-typed: span/counter/histogram); None keeps
    # the hot path untouched
    telemetry: Optional[object] = None
    kernel_backend: str = "fused"
    # None = the current CUDA device (raises without one)
    device: Optional[object] = None

    def __post_init__(self):
        if self.kernel_backend not in KERNEL_BACKENDS:
            raise ValueError(
                f"kernel_backend must be one of {KERNEL_BACKENDS}, "
                f"got {self.kernel_backend!r}")
        self.device = resolve_device(self.device)
        self.bsk_f = self.bsk_f.to(self.device)
        self.ksk = self.ksk.to(self.device)

    # -- derived -----------------------------------------------------------
    @property
    def key_bytes(self) -> tuple:
        """(bsk_bytes, ksk_bytes) of the evaluation keys as streamed per
        PBS round — the quantity the bandwidth ledger accounts."""
        return (self.bsk_f.numel() * self.bsk_f.element_size(),
                self.ksk.numel() * self.ksk.element_size())

    @property
    def fused_pack(self):
        """The resident `FusedPbsPack` for the fused backend, built on
        first use and cached."""
        pack = getattr(self, "_fused_pack", None)
        if pack is None:
            from repro_torch.kernels.fused_pbs import FusedPbsPack
            pack = self._fused_pack = FusedPbsPack.build(
                self.bsk_f, self.ksk, self.params)
        return pack

    # -- PBS ------------------------------------------------------------------
    def _observe(self, name: str, rows: int, run):
        tel = self.telemetry
        if tel is None:
            return run()
        with tel.span(name, cat="engine", rows=rows):
            out = run()
        tel.counter(f"engine.lut_batches_{self.kernel_backend}").inc()
        tel.counter("engine.lut_batches").inc()
        tel.counter("engine.pbs_rows").inc(rows)
        tel.histogram("engine.lut_batch_rows").observe(rows)
        return out

    def lut_batch(self, cts: torch.Tensor, lut_polys: torch.Tensor) -> torch.Tensor:
        """Apply per-ciphertext LUTs with noise refresh.

        cts: (B, k*N+1); lut_polys: (B, N) torus polys
        (`glwe.make_lut_poly` encodes integer tables).
        """
        B = cts.shape[0]
        if lut_polys.shape[0] != B:
            raise ValueError(
                f"lut_batch: {B} ciphertexts but {lut_polys.shape[0]} LUT "
                f"polynomials — counts must match per batch row")
        cts, lut_polys = cts.to(self.device), lut_polys.to(self.device)
        if self.kernel_backend == "fused":
            run = lambda: self.fused_pack.pbs_batch(cts, lut_polys)
        else:
            run = lambda: batch_mod.pbs_batch(cts, lut_polys, self.bsk_f,
                                              self.ksk, self.params)
        return self._observe("lut_batch", B, run)

    # -- the split PBS entries (KS-level partial dedup) -----------------------
    def keyswitch(self, big_cts: torch.Tensor) -> torch.Tensor:
        """The keyswitch stage alone: (B, k*N+1) big-key cts -> (B, n+1)
        small-key cts, bit-identical to the first stage of `lut_batch`."""
        big_cts = big_cts.to(self.device)
        if self.kernel_backend == "fused":
            return self.fused_pack.keyswitch(big_cts)
        return batch_mod.keyswitch_batch(big_cts, self.ksk, self.params)

    def lut_batch_small(self, small_cts: torch.Tensor,
                        lut_polys: torch.Tensor) -> torch.Tensor:
        """`lut_batch` minus the keyswitch: (B, n+1) small-key cts +
        (B, N) LUT polys -> (B, k*N+1).  `keyswitch` then
        `lut_batch_small` computes exactly what `lut_batch` computes."""
        B = small_cts.shape[0]
        if lut_polys.shape[0] != B:
            raise ValueError(
                f"lut_batch_small: {B} ciphertexts but {lut_polys.shape[0]} "
                f"LUT polynomials — counts must match per batch row")
        small_cts, lut_polys = small_cts.to(self.device), lut_polys.to(self.device)
        if self.kernel_backend == "fused":
            run = lambda: self.fused_pack.pbs_from_small(small_cts, lut_polys)
        else:
            run = lambda: batch_mod.pbs_batch_small(small_cts, lut_polys,
                                                    self.bsk_f, self.params)
        return self._observe("lut_batch_small", B, run)

    def lut_batch_tables(self, cts: torch.Tensor, tables) -> torch.Tensor:
        """lut_batch from per-ciphertext INTEGER tables (B, 2^width); a
        single (2^width,) table broadcasts across the batch."""
        tables = validate_lut_tables(cts, tables, self.params)
        return self.lut_batch(cts, glwe.make_lut_polys_cached(
            tables, self.params, device=self.device))

    @classmethod
    def from_context(cls, ctx, **kw) -> "TaurusEngine":
        return cls(ctx.params, ctx.bsk_f, ctx.ksk, **kw)
