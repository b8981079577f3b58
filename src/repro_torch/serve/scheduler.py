"""Cross-request PBS round scheduler — the paper's key-reuse batching,
applied ONLINE across concurrent clients.  The port of
`repro.serve.scheduler`.

Each in-flight request executes its compiled IR program on its own worker
thread; every nonlinear step blocks in `FusedLutScheduler.submit` instead
of dispatching its own `engine.lut_batch`.  The LAST active request to
block becomes the round leader (a barrier, no dispatcher thread): it
groups all pending rounds by engine — i.e. by parameter set and
bootstrapping key, so each fused `lut_batch` streams the BSK once for the
whole group — deduplicates identical (ciphertext, LUT) rows
(`repro_torch.compiler.passes.fused_round_dedup`), pads the fused batch to
one of the quantized row counts (`integer._pad_batch`), dispatches ONE
batched PBS per group, and scatters the refreshed ciphertexts back to
every waiting request.

On the card the leader launches the kernels of the fused round (one
keyswitch, then n forward FFTs, MACs and inverse FFTs) for everyone; the
workers run their requests' linear (LPU) ops and compute their rows'
dedup keys, which copies the rows to the host.

Spans (with a tracing `Telemetry`): a worker's `row_keys` (its `d2h`
child holds the two copies to the host and any wait for the device they
make) and `pbs_round`, both carrying the request's id; the leader's
`fused_round`, from the gather of the round's rows to the inverse
gather of its results, enclosing the engine's spans.  On a card each
`fused_round` also gets its device time from two CUDA events
(`device_ms`, and `device_gap_ms` since the engine's previous round
ended; `TraceRecorder.device_interval`).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional

import torch

from repro_torch.compiler.passes import fused_round_dedup
from repro_torch.core import glwe
from repro_torch.core.engine import TaurusEngine, validate_lut_tables
from repro_torch.core.integer import _pad_batch
from repro_torch.obs import (NOOP_RECORDER, StatsView, Telemetry,
                             engine_key_bytes)


@dataclasses.dataclass
class _Pending:
    """One request's blocked PBS round."""
    engine: object
    cts: torch.Tensor       # (B, k*N+1)
    polys: torch.Tensor     # (B, N)
    keys: Optional[list] = None     # per-row (ct, poly) dedup keys
    result: Optional[torch.Tensor] = None
    error: Optional[BaseException] = None
    round_id: Optional[int] = None  # fused batch id, set by the leader


def _row_keys(cts: torch.Tensor, polys: torch.Tensor,
              recorder=NOOP_RECORDER) -> list:
    """Per-row (ciphertext, LUT-poly) dedup keys: the rows' exact bytes
    (a lossy hash could merge distinct rows).  Computed on the
    REQUEST's own thread before it blocks at the barrier, so the round
    leader's critical path is a dict scan instead of a device-to-host
    copy of the whole fused batch.  The copies run under `recorder`'s
    `d2h` span."""
    with recorder.span("d2h", cat="sched"):
        ct_rows, poly_rows = cts.cpu().numpy(), polys.cpu().numpy()
    return [(ct_rows[i].tobytes(), poly_rows[i].tobytes())
            for i in range(ct_rows.shape[0])]


class FusedEngineProxy:
    """Engine facade handed to per-request interpreters.

    Linear ops run locally (LPU work needs no cross-request fusion);
    every `lut_batch` routes through the shared scheduler so concurrent
    requests' rounds fuse into one BSK-streaming batch.  `request` (the
    serving request's id) goes on its `row_keys` and `pbs_round`
    spans."""

    fused = True

    def __init__(self, scheduler: "FusedLutScheduler", engine: TaurusEngine,
                 request: Optional[int] = None):
        self._scheduler = scheduler
        self._engine = engine
        self.request = request

    @property
    def params(self):
        return self._engine.params

    @property
    def batch_size(self):
        return self._engine.batch_size

    @property
    def device(self):
        return self._engine.device

    def lut_batch(self, cts: torch.Tensor, lut_polys: torch.Tensor) -> torch.Tensor:
        if lut_polys.shape[0] != cts.shape[0]:
            raise ValueError(
                f"lut_batch: {cts.shape[0]} ciphertexts but "
                f"{lut_polys.shape[0]} LUT polynomials")
        sched = self._scheduler
        # keys for full-row dedup AND the KS-level partial dedup — both
        # consume them on the leader's dict-scan path
        keys = None
        if sched.dedup or sched.ks_dedup:
            rec = sched.telemetry.recorder
            with rec.span("row_keys", cat="sched", rows=int(cts.shape[0]),
                          request=self.request):
                keys = _row_keys(cts, lut_polys, rec)
        return sched.submit(self._engine, cts, lut_polys, keys,
                            request=self.request)

    def lut_batch_tables(self, cts: torch.Tensor, tables) -> torch.Tensor:
        tables = validate_lut_tables(cts, tables, self.params)
        return self.lut_batch(cts, glwe.make_lut_polys_cached(
            tables, self.params, device=self.device))

    # -- linear ops delegate straight to the engine -------------------------
    def add(self, a, b):
        return self._engine.add(a, b)

    def sub(self, a, b):
        return self._engine.sub(a, b)

    def scalar_mul(self, a, c):
        return self._engine.scalar_mul(a, c)

    def add_plain(self, a, msg):
        return self._engine.add_plain(a, msg)

    def trivial(self, msg):
        return self._engine.trivial(msg)


class FusedLutScheduler:
    """Barrier-style round scheduler over any number of engines.

    `register()`/`unregister()` bracket each active request; `submit()`
    blocks a request's round until every active request is blocked (or
    `max_wait_s` elapses — stragglers stuck in long linear stretches
    can't stall the fleet forever), then the leader dispatches the fused
    round.  Used through `proxy(engine)`, which returns the engine facade
    request interpreters consume.

    Example (what `ServeRuntime` does per worker)::

        sched = FusedLutScheduler(dedup=True)
        eng = sched.proxy(engine)          # hand to an IrInterpreter
        sched.register()                   # request becomes barrier-width
        ...                                # eng.lut_batch calls now fuse
        sched.unregister()
        print(sched.dedup_hit_rate, sched.mean_occupancy)
    """

    def __init__(self, *, dedup: bool = True, ks_dedup: bool = True,
                 pad_batches: bool = True,
                 max_wait_s: float = 10.0,
                 telemetry: Optional[Telemetry] = None,
                 shard_ns: Optional[str] = None):
        self.dedup = dedup
        # KS-level partial dedup: rows sharing a CIPHERTEXT but not a
        # table key-switch once and fan the small-key result out across
        # their tables (engines exposing keyswitch/lut_batch_small only)
        self.ks_dedup = ks_dedup
        self.pad_batches = pad_batches
        self.max_wait_s = max_wait_s
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        # per-shard metric namespace (e.g. "serve.shard.0"): every round
        # counter below lands in the shared sched.* aggregate AND, when
        # set, in this shard's own serve.shard.<i>.* counters
        self.shard_ns = shard_ns
        self._cv = threading.Condition()
        self._active = 0
        self._pending: list = []
        self._round_seq = 0
        tel = self.telemetry
        names = ("fused_rounds", "logical_luts", "dispatched_luts",
                 "padded_luts", "dedup_hits", "ks_dedup_hits")
        self._c = {k: tel.counter(f"sched.{k}") for k in names}
        self._shard_c = ({k: tel.counter(f"{shard_ns}.{k}") for k in names}
                         if shard_ns else None)
        self._occ_hist = tel.histogram("sched.occupancy")
        # this scheduler's own occupancy (the histogram above is shared by
        # every shard of a telemetry): its sum and count, and the last few
        # rounds' for the elastic controller
        self._occ_sum = 0.0
        self._occ_rounds = 0
        self._recent_occ: collections.deque = collections.deque(maxlen=8)
        # per-engine (bsk, ksk) byte sizes, resolved once per engine
        self._key_bytes: dict = {}

    @property
    def stats(self) -> StatsView:
        """Stats mapping, read live off the metrics registry counters.

        fused_rounds      engine-group dispatches
        logical_luts      rows requested by interpreters
        dispatched_luts   rows after dedup, before padding
        padded_luts       rows entering engine.lut_batch
        dedup_hits        rows removed by online (ct, LUT) dedup
        ks_dedup_hits     rows whose keyswitch was shared (same ct,
                          different table — KS-level partial dedup)
        """
        return StatsView(dict(self._c))

    def _inc(self, key: str, n: int = 1) -> None:
        """Bump one round counter in the shared sched.* aggregate and,
        for a shard-owned scheduler, in its serve.shard.<i>.* mirror."""
        self._c[key].inc(n)
        if self._shard_c is not None:
            self._shard_c[key].inc(n)

    # -- lifecycle -----------------------------------------------------------
    def proxy(self, engine: TaurusEngine,
              request: Optional[int] = None) -> FusedEngineProxy:
        return FusedEngineProxy(self, engine, request)

    def register(self) -> None:
        """Mark one request as actively executing (fusion barrier width)."""
        with self._cv:
            self._active += 1

    def unregister(self) -> None:
        with self._cv:
            self._active -= 1
            # a finishing request may complete the barrier for the rest
            self._cv.notify_all()

    # -- metrics -------------------------------------------------------------
    @property
    def dedup_hit_rate(self) -> float:
        n = self._c["logical_luts"].value
        return self._c["dedup_hits"].value / n if n else 0.0

    @property
    def mean_occupancy(self) -> float:
        n = self._occ_rounds
        return self._occ_sum / n if n else 0.0

    # -- the blocking round entry -------------------------------------------
    def submit(self, engine: TaurusEngine, cts: torch.Tensor,
               polys: torch.Tensor, keys: Optional[list] = None,
               request: Optional[int] = None) -> torch.Tensor:
        entry = _Pending(engine, cts, polys,
                         keys if self.dedup else None)
        deadline = time.monotonic() + self.max_wait_s
        with self.telemetry.span("pbs_round", cat="sched",
                                 rows=int(cts.shape[0]),
                                 request=request) as sp:
            with self._cv:
                self._pending.append(entry)
                while entry.result is None and entry.error is None:
                    if self._pending and len(self._pending) >= self._active:
                        self._dispatch_locked()     # barrier complete: lead
                        continue
                    if time.monotonic() >= deadline:
                        if entry in self._pending:
                            # straggler timeout: flush a partial round rather
                            # than stall the fleet forever
                            self._dispatch_locked()
                            continue
                        # our entry is owned by an in-flight dispatch (lock
                        # released by its leader) — don't flush OTHER
                        # requests' fresh entries solo or spin; just wait
                        deadline = time.monotonic() + self.max_wait_s
                    # leaders/unregister notify promptly; the timeout only
                    # bounds how late a deadline-triggered partial dispatch
                    # can fire
                    self._cv.wait(timeout=0.25)
            # the fused batch id this round landed in (the leader stamps it)
            sp.set(round=entry.round_id)
        if entry.error is not None:
            raise RuntimeError("fused PBS round failed") from entry.error
        return entry.result

    # -- leader dispatch (called with the lock held) ------------------------
    def _dispatch_locked(self) -> None:
        pending, self._pending = self._pending, []
        if not pending:
            return
        occupancy = len(pending) / max(self._active, len(pending))
        self._occ_sum += occupancy
        self._occ_rounds += 1
        self._recent_occ.append(occupancy)
        self._occ_hist.observe(occupancy)
        groups: dict = {}
        for e in pending:
            groups.setdefault(id(e.engine), []).append(e)
        # assign fused batch ids while the lock is still held (the seq
        # counter is lock-protected state) so blocked requests see them
        # the moment their result lands
        rounds: list = []
        for entries in groups.values():
            rid = self._round_seq
            self._round_seq += 1
            for e in entries:
                e.round_id = rid
            rounds.append((rid, entries))
        # the heavy part (the kernel launches) runs with the lock RELEASED
        # so new requests can register/enqueue for the next round
        # meanwhile; the popped entries are owned by this leader alone,
        # and the metric counters take their own locks (a
        # straggler-timeout leader can run concurrently)
        self._cv.release()
        try:
            for rid, entries in rounds:
                try:
                    self._dispatch_group(entries[0].engine, entries, rid,
                                         occupancy)
                except BaseException as err:  # noqa: BLE001 — fan it out
                    for e in entries:
                        e.error = err
        finally:
            self._cv.acquire()
        self._cv.notify_all()

    def _engine_key_bytes(self, engine: TaurusEngine) -> tuple:
        kb = self._key_bytes.get(id(engine))
        if kb is None:
            kb = self._key_bytes[id(engine)] = engine_key_bytes(engine)
        return kb

    def _dispatch_group(self, engine: TaurusEngine, entries: list,
                        round_id: int, occupancy: float) -> None:
        """One fused lut_batch for every round sharing this engine's BSK;
        publishes round composition metrics and the bandwidth ledger row."""
        tel = self.telemetry
        rec = tel.recorder
        dev = engine.device
        # device time from two CUDA events: before the round's first
        # device operation (the gather) and after its last (the inverse
        # gather); no event is made with tracing off
        timed = rec.enabled and getattr(dev, "type", None) == "cuda"
        hits = 0
        with rec.span("fused_round", cat="sched", round=round_id,
                      participants=len(entries),
                      occupancy=occupancy) as sp:
            start = rec.cuda_event(dev) if timed else None
            cts = torch.cat([e.cts.to(dev) for e in entries], dim=0)
            polys = torch.cat([e.polys.to(dev) for e in entries], dim=0)
            n = int(cts.shape[0])
            sp.set(rows=n)
            all_keys: Optional[list] = None
            if self.dedup or self.ks_dedup:
                all_keys = []
                for e in entries:  # workers pre-key; direct submits fall back
                    all_keys.extend(e.keys if e.keys is not None
                                    else _row_keys(e.cts, e.polys))
            inverse = None
            sel = None
            if self.dedup:
                unique_idx, inverse, hits = fused_round_dedup(all_keys)
                if hits:
                    sel = unique_idx
                    idx = torch.as_tensor(sel, device=dev)
                    cts, polys = cts[idx], polys[idx]
                else:
                    inverse = None
            nb = int(cts.shape[0])
            # KS-level partial dedup: among the dispatched rows, those
            # sharing a CIPHERTEXT but not a table (the radix carry
            # rounds' msg/carry table pairs are the canonical case)
            # key-switch once; the small-key result fans out across their
            # tables and the round resumes through lut_batch_small.
            # Decrypt-identical: keyswitch then lut_batch_small IS
            # lut_batch.
            ks_hits = 0
            ks_plan = None
            if (self.ks_dedup and nb > 1
                    and getattr(engine, "supports_ks_split", False)):
                rows = sel if sel is not None else range(n)
                ct_keys = [all_keys[j][0] for j in rows]
                uq, ct_inv, ks_hits = fused_round_dedup(ct_keys)
                if ks_hits:
                    ks_plan = (torch.as_tensor(uq, device=dev),
                               torch.as_tensor(ct_inv, device=dev))
            if ks_plan is not None:
                uq_idx, ct_inv = ks_plan
                u = int(uq_idx.shape[0])
                ucts = cts[uq_idx]
                if self.pad_batches:        # quantize the KS batch shape too
                    pu = _pad_batch(u)
                    if pu > u:
                        ucts = ucts.repeat(-(-pu // u), 1)[:pu]
                body = engine.keyswitch(ucts)[:u][ct_inv]
            else:
                body = cts
            if self.pad_batches:
                p = _pad_batch(nb)
                if p > nb:                      # repeat real rows up to a
                    reps = -(-p // nb)          # quantized batch shape
                    body = body.repeat(reps, 1)[:p]
                    polys = polys.repeat(reps, 1)[:p]
            padded = int(body.shape[0])
            sp.set(dedup_hits=hits, ks_dedup_hits=ks_hits,
                   dispatched=nb, padded=padded)
            if ks_plan is not None:
                out = engine.lut_batch_small(body, polys)[:nb]
            else:
                out = engine.lut_batch(body, polys)[:nb]
            if inverse is not None:
                out = out[torch.as_tensor(inverse, device=dev)]
            if timed:
                rec.device_interval(sp, start, rec.cuda_event(dev), id(engine))
        self._inc("fused_rounds")
        self._inc("logical_luts", n)
        self._inc("dedup_hits", hits)
        self._inc("ks_dedup_hits", ks_hits)
        self._inc("dispatched_luts", nb)
        self._inc("padded_luts", padded)
        bsk_b, ksk_b = self._engine_key_bytes(engine)
        tel.bandwidth.account_round(
            participants=len(entries), rows_logical=n, rows_dispatched=nb,
            rows_padded=padded, bsk_bytes=bsk_b, ksk_bytes=ksk_b)
        if self.shard_ns is not None:
            # the bandwidth ledger aggregates across shards; the per-shard
            # key-stream traffic lands in this shard's own namespace
            tel.counter(f"{self.shard_ns}.bsk_bytes_streamed").inc(bsk_b)
            tel.counter(f"{self.shard_ns}.ksk_bytes_streamed").inc(ksk_b)
        ofs = 0
        for e in entries:
            b = int(e.cts.shape[0])
            e.result = out[ofs:ofs + b]
            ofs += b
