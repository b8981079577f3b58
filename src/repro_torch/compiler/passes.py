"""Lowering + the paper's two deduplication passes (§V, Observation 6).

The port's copy of `repro.compiler.passes` (numpy only).

Physical op stream (what the scheduler/cost model consume):

    KS   one key-switch of one ciphertext  (LPU)
    BR   one blind rotation               (BRU)  — carries its LUT table id
    SE   one sample extraction            (LPU)
    LIN  bulk linear work                 (LPU)  — MAC count attached

KS-dedup: Taurus runs PBS key-switching-FIRST, so when several `lut`
nodes consume the SAME tensor (fanout), the key-switched small-LWE
ciphertexts are computed once and broadcast to every blind rotation
(paper: up to 47.12% fewer key-switches).

ACC-dedup: `lut` nodes applying the same table to many tensor elements
share one GLWE test-polynomial accumulator image in DRAM instead of one
per element (paper: −91.54% GLWE storage).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.compiler.ir import (Graph, Node, RADIX_OPS, radix_round_plan,
                                     radix_vectors)


@dataclasses.dataclass
class PhysOp:
    kind: str                # KS | BR | SE | LIN
    node: int                # producing IR node
    count: int               # ciphertext elements covered
    level: int               # dependency level (scheduling)
    macs: int = 0            # for LIN: plaintext-ct MACs
    table_id: int = 0        # for BR: which accumulator image


@dataclasses.dataclass
class DedupStats:
    ks_before: int = 0
    ks_after: int = 0
    acc_before: int = 0
    acc_after: int = 0

    @property
    def ks_saved_frac(self) -> float:
        return 1.0 - self.ks_after / self.ks_before if self.ks_before else 0.0

    @property
    def acc_saved_frac(self) -> float:
        return 1.0 - self.acc_after / self.acc_before if self.acc_before else 0.0


def _levels(g: Graph) -> dict:
    """Dependency depth per node.  A radix op spans as many levels as it
    has batched-PBS rounds, so chained radix ops serialize correctly in
    the schedule."""
    lvl = {}
    for n in g.nodes:
        depth = (len(radix_round_plan(n.op, n.attrs["n_digits"],
                                      n.attrs.get("msg_bits"),
                                      term_maxes=n.attrs.get("term_maxes"),
                                      max_val=n.attrs.get("max_val")))
                 if n.op in RADIX_OPS else 1)
        lvl[n.id] = depth + max((lvl[i] for i in n.inputs), default=-1)
    return lvl


def _table_key(t: np.ndarray) -> bytes:
    return np.ascontiguousarray(t).tobytes()


def fused_round_dedup(pair_keys) -> tuple:
    """Online (serving-time) extension of the KS/ACC dedup passes.

    The static passes above dedup within ONE compiled graph.  When a
    serving scheduler fuses the ready PBS rounds of many concurrent
    requests into a single engine batch, the same observation applies
    across requests: two batch rows with an identical
    (ciphertext-digest, table-digest) pair are the SAME bootstrap —
    key-switch, blind rotation and sample extraction included — so the
    round dispatches it once and fans the refreshed ciphertext back out
    (retried/replayed requests dedup to zero marginal PBS work).

    pair_keys: one hashable (ct_key, table_key) per fused batch row.
    Returns (unique_idx, inverse, hits): the row indices to dispatch,
    the scatter map (inverse[i] indexes the dispatched results to rebuild
    row i), and how many rows were deduplicated away.
    """
    first: dict = {}
    unique_idx: list = []
    inverse: list = []
    for i, key in enumerate(pair_keys):
        if key not in first:
            first[key] = len(unique_idx)
            unique_idx.append(i)
        inverse.append(first[key])
    return unique_idx, inverse, len(inverse) - len(unique_idx)


def lower_to_physical(g: Graph, *, ks_dedup: bool = True,
                      acc_dedup: bool = True):
    """Graph -> (list[PhysOp], DedupStats).

    Key-switch placement: with the KS-first order, the key-switch belongs
    to the PBS *input* tensor.  Without dedup every `lut` node key-switches
    its own copy; with dedup all luts sharing an input share one KS.
    """
    lvl = _levels(g)
    ops: list = []
    stats = DedupStats()
    ks_done: set = set()          # input node ids already key-switched
    tables: dict = {}             # table bytes -> id

    for n in g.nodes:
        if n.op == "lut":
            src = n.inputs[0]
            stats.ks_before += n.n_elements
            if (src not in ks_done) or not ks_dedup:
                ops.append(PhysOp("KS", n.id, n.n_elements, lvl[src] + 1))
                stats.ks_after += n.n_elements
                ks_done.add(src)
            # accumulator image(s)
            stats.acc_before += n.n_elements
            key = _table_key(n.attrs["table"])
            if acc_dedup:
                if key not in tables:
                    tables[key] = len(tables)
                    stats.acc_after += 1
                tid = tables[key]
            else:
                stats.acc_after += n.n_elements
                tid = len(tables)
                tables[_table_key(n.attrs["table"]) + bytes([tid % 251])] = tid
            ops.append(PhysOp("BR", n.id, n.n_elements, lvl[n.id],
                              table_id=tid))
            ops.append(PhysOp("SE", n.id, n.n_elements, lvl[n.id]))
        elif n.op in ("radix_addc", "radix_mulc"):
            # LPU-only const ops: one MAC per digit, zero PBS rounds
            ops.append(PhysOp("LIN", n.id, n.n_elements, lvl[n.id],
                              macs=n.n_elements))
        elif n.op in RADIX_OPS:
            # one KS/BR/SE wave per batched round (see ir.radix_round_plan).
            # Within a round the (msg, carry)-style LUT fanout reads the
            # SAME digit ciphertexts, so KS-dedup collapses `luts` key-
            # switches down to `sources` — the digit-batch analogue of the
            # tensor-fanout dedup above.
            vecs = radix_vectors(n)
            plan = radix_round_plan(n.op, n.attrs["n_digits"],
                                    n.attrs.get("msg_bits"),
                                    term_maxes=n.attrs.get("term_maxes"),
                                    max_val=n.attrs.get("max_val"))
            base_lvl = lvl[n.id] - len(plan) + 1
            if n.op == "radix_linear":
                # the LPU weight combine that precedes the rounds: one
                # D-digit scalar-mul/add per nonzero weight
                macs = int(np.count_nonzero(n.attrs["W"])) \
                    * n.attrs["n_digits"]
                ops.append(PhysOp("LIN", n.id, macs, max(base_lvl - 1, 0),
                                  macs=macs))
            for r, rd in enumerate(plan):
                luts = rd["luts"] * vecs
                srcs = rd["sources"] * vecs
                stats.ks_before += luts
                ks_n = srcs if ks_dedup else luts
                stats.ks_after += ks_n
                ops.append(PhysOp("KS", n.id, ks_n, base_lvl + r))
                stats.acc_before += luts
                tid = 0
                if acc_dedup:
                    for tkey in rd["tables"]:
                        key = tkey.encode()
                        if key not in tables:
                            tables[key] = len(tables)
                            stats.acc_after += 1
                        tid = tables[key]
                else:
                    stats.acc_after += luts
                    tid = len(tables)
                    tables[rd["tables"][0].encode() + bytes([tid % 251])] = tid
                ops.append(PhysOp("BR", n.id, luts, base_lvl + r,
                                  table_id=tid))
                ops.append(PhysOp("SE", n.id, luts, base_lvl + r))
                if rd.get("macs"):
                    ops.append(PhysOp("LIN", n.id, rd["macs"] * vecs,
                                      base_lvl + r, macs=rd["macs"] * vecs))
        elif n.op == "linear":
            W = n.attrs["W"]
            macs = n.n_elements * W.shape[0]
            ops.append(PhysOp("LIN", n.id, n.n_elements, lvl[n.id], macs=macs))
        elif n.op in ("add", "sub", "addc", "mulc"):
            ops.append(PhysOp("LIN", n.id, n.n_elements, lvl[n.id],
                              macs=n.n_elements))
        # input/reshape/concat: free
    return ops, stats
