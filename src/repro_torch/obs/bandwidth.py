"""Bandwidth ledger: bytes of key material streamed per fused PBS round
vs. the unfused counterfactual.  The port's own copy of
`repro.obs.bandwidth`; `engine_key_bytes` reads the port's tensors.

Taurus's central claim is that multi-bit FHE throughput is a memory-
bandwidth problem: a fused round streams the decomposed bootstrapping
key (and the key-switching key) ONCE for every participating request,
where a per-request server would stream it once per request (paper
§III-B / Fig. 13; MATCHA and HEAX make the same argument).  This ledger
makes that saving a measured quantity: `FusedLutScheduler` accounts
every dispatched group here.

Accounting model (per fused round over one engine group):

  streamed        = bsk_bytes + ksk_bytes          (one stream, everyone)
  counterfactual  = participants * (bsk_bytes + ksk_bytes)
                    (each of the `participants` blocked requests
                    dispatching its own lut_batch)
  saved           = counterfactual - streamed

Dedup savings are tracked separately as rows (`rows_logical` vs
`rows_dispatched`): dedup removes blind-rotation *work*, not key
streams, so it must not be conflated with the key-reuse column.
"""
from __future__ import annotations

import threading


def engine_key_bytes(engine) -> tuple:
    """(bsk_bytes, ksk_bytes) of the key operands an engine's rounds
    stream: the resident pack's (BSK planes, KSK limb operand) once a
    fused engine holds one, else its Fourier BSK and int64 KSK."""
    pack = getattr(engine, "_fused_pack", None)
    if pack is not None:
        return pack.resident_key_bytes
    bsk, ksk = engine.bsk_f, engine.ksk
    return (bsk.numel() * bsk.element_size(), ksk.numel() * ksk.element_size())


class BandwidthLedger:
    """Thread-safe accumulator for per-round key-traffic accounting."""

    def __init__(self):
        self._lock = threading.Lock()
        self.fused_rounds = 0
        self.participants = 0             # sum of round participant counts
        self.rows_logical = 0
        self.rows_dispatched = 0
        self.rows_padded = 0
        self.bsk_bytes_streamed = 0
        self.ksk_bytes_streamed = 0
        self.bsk_bytes_unfused = 0
        self.ksk_bytes_unfused = 0

    def account_round(self, *, participants: int, rows_logical: int,
                      rows_dispatched: int, rows_padded: int,
                      bsk_bytes: int, ksk_bytes: int) -> None:
        """Record one dispatched engine group of a fused round."""
        with self._lock:
            self.fused_rounds += 1
            self.participants += participants
            self.rows_logical += rows_logical
            self.rows_dispatched += rows_dispatched
            self.rows_padded += rows_padded
            self.bsk_bytes_streamed += bsk_bytes
            self.ksk_bytes_streamed += ksk_bytes
            self.bsk_bytes_unfused += participants * bsk_bytes
            self.ksk_bytes_unfused += participants * ksk_bytes

    @property
    def bsk_bytes_saved(self) -> int:
        return self.bsk_bytes_unfused - self.bsk_bytes_streamed

    @property
    def ksk_bytes_saved(self) -> int:
        return self.ksk_bytes_unfused - self.ksk_bytes_streamed

    @property
    def rows_deduped(self) -> int:
        return self.rows_logical - self.rows_dispatched

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "fused_rounds": self.fused_rounds,
                "participants": self.participants,
                "rows_logical": self.rows_logical,
                "rows_dispatched": self.rows_dispatched,
                "rows_padded": self.rows_padded,
                "rows_deduped": self.rows_logical - self.rows_dispatched,
                "bsk_bytes_streamed": self.bsk_bytes_streamed,
                "ksk_bytes_streamed": self.ksk_bytes_streamed,
                "bsk_bytes_unfused": self.bsk_bytes_unfused,
                "ksk_bytes_unfused": self.ksk_bytes_unfused,
                "bsk_bytes_saved":
                    self.bsk_bytes_unfused - self.bsk_bytes_streamed,
                "ksk_bytes_saved":
                    self.ksk_bytes_unfused - self.ksk_bytes_streamed,
            }


class NullLedger:
    """No-op twin for fully disabled telemetry."""

    fused_rounds = 0
    participants = 0
    rows_logical = 0
    rows_dispatched = 0
    rows_padded = 0
    bsk_bytes_streamed = 0
    ksk_bytes_streamed = 0
    bsk_bytes_unfused = 0
    ksk_bytes_unfused = 0
    bsk_bytes_saved = 0
    ksk_bytes_saved = 0
    rows_deduped = 0

    def account_round(self, **kw) -> None:
        pass

    def snapshot(self) -> dict:
        return {}


NULL_LEDGER = NullLedger()
