"""Engine shards: the execution workers behind the `ServeRuntime` router.
The port of `repro.serve.shard`.

The runtime is a front-door ROUTER (admission, per-client fairness,
placement — `ServeRuntime`) over N `EngineShard` workers.  Each shard
owns

  * its own `TaurusEngine` — a private engine object, so the scheduler's
    engine-id grouping keeps one shard's rounds from ever mixing into
    another's batches.  Shards built from one context read ONE resident
    `FusedPbsPack` (`TaurusEngine.fused_pack` takes it from
    `FusedPbsPack.shared`), so a second shard on one card costs no second
    copy of the 2.6 GB key operands;
  * its own `FusedLutScheduler` barrier — the fusion width of a shard
    is the requests the router placed on it, so shards dispatch rounds
    independently (no global barrier across the fleet);
  * its own concurrency limit — static, or an `ElasticAdmission`
    controller (`repro_torch.runtime.elastic`) resizing `max_inflight`
    from queue depth and recent fused-wave occupancy.

Device routing (`repro_torch.launch.mesh.shard_devices`, over the
context's device): on one card, or on the CPU, every shard gets that
device.  A shard given several devices (`device_sets`) gets a mesh
engine over them with the reference backend, and a one-device engine on
the first with the fused backend, as in the reference.

Observability: every shard mirrors its round counters into a
`serve.shard.<i>.*` namespace (admitted/completed/failed/inflight/
max_inflight here; fused_rounds/dedup_hits/ks_dedup_hits/
bsk_bytes_streamed via its scheduler's `shard_ns`), and the router
stamps `shard=<i>` on each request span.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.engine import ConfigError, TaurusEngine
from repro_torch.launch.mesh import shard_devices, shard_mesh
from repro_torch.obs import Telemetry
from repro_torch.runtime.elastic import ElasticAdmission, ElasticPolicy
from repro_torch.serve.scheduler import FusedLutScheduler


class EngineShard:
    """One serving shard: engine + scheduler + concurrency limit.

    The router mutates `inflight` under ITS lock (`acquire`/`release`
    are called with the `ServeRuntime` admission lock held), so the
    shard itself needs no locking; the scheduler has its own barrier
    condition variable.
    """

    def __init__(self, index: int, ctx, engine: TaurusEngine, *,
                 fused: bool = True, dedup: bool = True,
                 ks_dedup: bool = True, max_inflight: int = 8,
                 elastic: Optional[ElasticAdmission] = None,
                 telemetry: Optional[Telemetry] = None,
                 devices: Sequence = ()):
        self.index = index
        self.ctx = ctx
        self.engine = engine
        self.devices = tuple(devices)
        self.fused = fused
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        ns = f"serve.shard.{index}"
        self.metrics_ns = ns
        self.scheduler = (FusedLutScheduler(dedup=dedup, ks_dedup=ks_dedup,
                                            telemetry=self.telemetry,
                                            shard_ns=ns)
                          if fused else None)
        self.elastic = elastic
        self._static_limit = max_inflight
        self.inflight = 0
        tel = self.telemetry
        self._c_admitted = tel.counter(f"{ns}.admitted")
        self._c_completed = tel.counter(f"{ns}.completed")
        self._c_failed = tel.counter(f"{ns}.failed")
        self._g_inflight = tel.gauge(f"{ns}.inflight")
        self._g_limit = tel.gauge(f"{ns}.max_inflight")
        self._g_limit.set(self.limit)

    # -- placement interface (read under the router lock) --------------------
    @property
    def limit(self) -> int:
        """Current concurrency limit: the elastic controller's grant, or
        the static `max_inflight`."""
        return (self.elastic.limit if self.elastic is not None
                else self._static_limit)

    @property
    def capacity(self) -> int:
        return self.limit - self.inflight

    def accepts(self, params) -> bool:
        """Parameter-set placement filter: a shard only serves requests
        whose evaluation keys match its engine's parameter set (every
        shard is built from the router's one context, so this holds by
        construction — the hook is where heterogeneous parameter pools
        would route)."""
        return self.engine.params == params

    # -- worker interface ----------------------------------------------------
    def worker_engine(self, request: Optional[int] = None):
        """The engine facade a request interpreter executes against:
        the shard scheduler's fusion proxy (its spans carry `request`),
        or the bare engine."""
        return (self.scheduler.proxy(self.engine, request)
                if self.scheduler is not None else self.engine)

    def acquire(self) -> None:
        """Claim one slot (router lock held).  Registers the request
        with the shard's fusion barrier BEFORE its worker thread starts,
        so a wave of admissions forms one full barrier."""
        self.inflight += 1
        self._c_admitted.inc()
        self._g_inflight.set(self.inflight)
        if self.scheduler is not None:
            self.scheduler.register()

    def release(self, outcome: str) -> None:
        """Return one slot (router lock held); outcome is "completed" or
        "failed".  The scheduler unregister happens on the worker thread
        itself (it may complete the barrier for the remaining
        requests)."""
        self.inflight -= 1
        (self._c_completed if outcome == "completed"
         else self._c_failed).inc()
        self._g_inflight.set(self.inflight)

    # -- elastic control -----------------------------------------------------
    def recent_occupancy(self) -> Optional[float]:
        """Mean of the shard's last few fused-round occupancy samples
        (None when unfused or before the first round) — the controller's
        'are my barriers full?' signal."""
        if self.scheduler is None:
            return None
        recent = self.scheduler._recent_occ
        if not recent:
            return None
        return float(sum(recent) / len(recent))

    def elastic_observe(self, queue_depth: int) -> bool:
        """One controller step against the router's queue depth; returns
        True if this shard's limit changed (router lock held)."""
        if self.elastic is None:
            return False
        changed = self.elastic.observe(queue_depth, self.inflight,
                                       self.recent_occupancy())
        if changed:
            self._g_limit.set(self.limit)
        return changed


def build_shards(ctx, engine: Optional[TaurusEngine] = None, *,
                 n_shards: int = 1, fused: bool = True, dedup: bool = True,
                 ks_dedup: bool = True, max_inflight: int = 8,
                 elastic=None, kernel_backend: Optional[str] = None,
                 telemetry: Optional[Telemetry] = None,
                 device_sets: Optional[list] = None) -> list:
    """Construct a `ServeRuntime`'s shard list.

    Shard 0 adopts the caller's prebuilt `engine` when given (so
    `shards=1` serves through exactly the object the caller warmed);
    every other shard gets its own `TaurusEngine` over the same context
    and kernel backend — separate engine objects, hence per-shard round
    batches, over the context's one resident pack.

    `elastic`: None/False for static limits, True for the default
    `ElasticPolicy` with `max_inflight` as ceiling, or an
    `ElasticPolicy` to share across shards (each shard still gets its
    OWN `ElasticAdmission` state).

    `device_sets` overrides `launch.mesh.shard_devices(n_shards,
    [ctx.device])` — one device tuple per shard.

    The shards' telemetry also goes to every engine that has none (the caller's
    engine keeps its own), so the engines' spans and `engine.*`
    counters land beside the scheduler's: inside each `fused_round` the
    engine spans are the leader's time to enqueue the round's launches.
    """
    if n_shards < 1:
        raise ConfigError(f"shards must be >= 1, got {n_shards}")
    kb = (engine.kernel_backend if engine is not None
          else (kernel_backend or "fused"))
    if device_sets is None:
        device_sets = shard_devices(n_shards, [ctx.device])
    elif len(device_sets) != n_shards:
        raise ConfigError(
            f"device_sets has {len(device_sets)} entries for "
            f"{n_shards} shards")
    if elastic is True:
        policy: Optional[ElasticPolicy] = ElasticPolicy(ceiling=max_inflight)
    elif isinstance(elastic, ElasticPolicy):
        policy = elastic
    elif elastic in (None, False):
        policy = None
    else:
        raise TypeError(
            f"elastic must be None/False, True, or an ElasticPolicy, "
            f"got {elastic!r}")
    shards = []
    for i in range(n_shards):
        devs = tuple(device_sets[i])
        if i == 0 and engine is not None:
            eng = engine
        elif len(devs) > 1 and kb == "reference":
            # a multi-device shard's rounds split over its devices
            eng = TaurusEngine.from_context(ctx, mesh=shard_mesh(devs),
                                            kernel_backend=kb)
        else:
            # the fused kernels run per device (fused + mesh is a
            # ConfigError): a multi-device fused shard runs on devs[0]
            eng = TaurusEngine.from_context(ctx, device=devs[0],
                                            kernel_backend=kb)
        shard = EngineShard(
            i, ctx, eng, fused=fused, dedup=dedup, ks_dedup=ks_dedup,
            max_inflight=max_inflight,
            elastic=ElasticAdmission(policy) if policy is not None else None,
            telemetry=telemetry, devices=devs)
        if getattr(eng, "telemetry", None) is None:
            eng.telemetry = shard.telemetry
        shards.append(shard)
    return shards
