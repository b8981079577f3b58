"""Batch scheduler with BRU/LPU overlap (paper §IV-B, Fig. 9).

The port's copy of `repro.compiler.schedule` (pure Python).

Taurus schedules at batch granularity: 48 ciphertexts per batch (12
round-robin x 4 clusters), full synchronization across clusters
(Observation 5).  The compiler groups blind rotations into batches by
dependency level; LPU work (key-switch, sample-extract, linear ops) of
batch i+1 overlaps the BRU time of batch i when the levels allow it —
dependent consecutive batches serialize (Fig. 9, batches 4/5).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from repro_torch.compiler.passes import PhysOp


@dataclasses.dataclass
class Batch:
    level: int
    n_br: int = 0               # blind rotations in this batch
    n_ks: int = 0
    n_se: int = 0
    lin_macs: int = 0
    dependent: bool = False     # depends on the previous batch's output


@dataclasses.dataclass
class Schedule:
    batches: list
    batch_size: int

    @property
    def total_pbs(self) -> int:
        return sum(b.n_br for b in self.batches)

    def runtime(self, t_br_batch, t_lpu_batch) -> tuple:
        """Pipelined runtime given per-batch cost callables.

        t_br_batch(b) / t_lpu_batch(b): seconds for the BRU / LPU portion
        of one batch.  Independent batches overlap LPU(i+1) with BRU(i);
        dependent ones serialize (Fig. 9).  Returns (seconds, utilization).
        """
        t = 0.0
        busy_br = 0.0
        prev_br_end = 0.0
        for b in self.batches:
            lpu = t_lpu_batch(b)
            br = t_br_batch(b)
            if b.dependent:
                start = prev_br_end + lpu          # must wait, then KS
            else:
                start = max(prev_br_end, t + lpu)  # LPU overlapped
            prev_br_end = start + br
            t = start
            busy_br += br
        total = prev_br_end
        util = busy_br / total if total else 0.0
        return total, util


def build_schedule(ops: list, batch_size: int = 48) -> Schedule:
    """Group physical ops into level-synchronous batches of <= batch_size
    blind rotations (plus their KS/SE and the level's linear work)."""
    by_level: dict = defaultdict(lambda: {"br": 0, "ks": 0, "se": 0, "macs": 0})
    for op in ops:
        s = by_level[op.level]
        if op.kind == "BR":
            s["br"] += op.count
        elif op.kind == "KS":
            s["ks"] += op.count
        elif op.kind == "SE":
            s["se"] += op.count
        else:
            s["macs"] += op.macs

    batches: list = []
    for level in sorted(by_level):
        s = by_level[level]
        n = max(s["br"], 1)
        n_batches = -(-s["br"] // batch_size) if s["br"] else (1 if s["macs"] else 0)
        for i in range(max(n_batches, 1) if (s["br"] or s["macs"]) else 0):
            frac = min(batch_size, s["br"] - i * batch_size) / n if s["br"] else 0
            batches.append(Batch(
                level=level,
                n_br=min(batch_size, max(s["br"] - i * batch_size, 0)),
                n_ks=int(s["ks"] * frac),
                n_se=int(s["se"] * frac),
                lin_macs=s["macs"] // max(n_batches, 1),
                # first batch of a level depends on the previous level
                dependent=(i == 0),
            ))
    return Schedule(batches, batch_size)
