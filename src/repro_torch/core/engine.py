"""TaurusEngine: the paper's 4-cluster accelerator as a mesh of devices.

Mapping (paper -> here):
  compute cluster            -> one entry of the engine's `ClusterMesh`
  12 round-robin cts/cluster -> `batch_per_device` (default 12)
  48-ct scheduling batch     -> engine.batch_size = 12 * n_clusters
  global BSK/KSK buffer      -> keys replicated once per distinct device
  full synchronization       -> each PBS round splits its rows evenly over
                                the clusters and gathers them on mesh[0]

Without a mesh the engine runs on one device, one cluster.  The engine is
the execution backend later layers (integers, compiler, serving) call.
Kernel backends: `kernel_backend="fused"` (the default)
runs `repro_torch.kernels.fused_pbs` — the FFT / external-product /
keyswitch stages as hand-written CUDA kernels against a `FusedPbsPack`
of resident transform-domain key operands, built lazily on first use,
shared by every engine of one key and reused across every round (the
paper's key-reuse strategy).  On a card the pack replays each round's
blind rotation as a captured CUDA graph (`FusedPbsPack.pbs_from_small`);
the telemetry counts how each rotation ran.
`"reference"` runs the plain PyTorch pipeline in `repro_torch.core.batch`.
Both are decrypt-identical; the keyswitch stage is bit-identical.

The engine runs on the card unless the caller names another device; on
the CPU the fused backend runs each kernel's plain version.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.core import batch as batch_mod, glwe, lwe, torus
from repro_torch.core.params import TFHEParams
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import ClusterMesh, shard_mesh

I64 = torch.int64
KERNEL_BACKENDS = ("fused", "reference")
# how the fused pack ran a blind rotation -> the counter of such rotations
GRAPH_COUNTERS = {"replay": "engine.graph_replays", "capture": "engine.graph_captures",
                  "eager": "engine.graph_eager"}


class ConfigError(ValueError):
    """An unsupported engine/runtime configuration, rejected at
    construction time (not at first `lut_batch`).

    Supported (kernel_backend, mesh) combinations:

      reference + mesh=None   single-device plain PyTorch PBS
      reference + mesh        `pbs_batch` over the mesh's clusters
      fused     + mesh=None   the hand-written kernels, per device

    fused + mesh is NOT supported: the fused kernels run per device.
    The sharded `ServeRuntime` routes around this: a multi-device shard
    requesting the fused backend gets a single-device engine instead of
    raising here (see `repro_torch.serve.shard.build_shards`)."""


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
    # the cluster mesh (`launch.mesh.shard_mesh`); None = one device
    mesh: Optional[ClusterMesh] = None
    batch_per_device: int = 12  # paper's round-robin depth (Fig. 13b)
    # optional telemetry (duck-typed: span/counter/histogram); None keeps
    # the hot path untouched
    telemetry: Optional[object] = None
    kernel_backend: str = "fused"
    # None = the current CUDA device (raises without one); mesh[0] with a
    # mesh
    device: Optional[object] = None

    def __post_init__(self):
        if self.kernel_backend not in KERNEL_BACKENDS:
            raise ValueError(
                f"kernel_backend must be one of {KERNEL_BACKENDS}, "
                f"got {self.kernel_backend!r}")
        if self.kernel_backend == "fused" and self.mesh is not None:
            raise ConfigError(
                "kernel_backend='fused' + mesh is not a supported engine "
                "configuration — the fused kernels run per-device. "
                "Supported combinations: reference + mesh=None, "
                "reference + mesh, fused + mesh=None. Use the reference "
                "backend for multi-cluster meshes, or drop the mesh for "
                "the fused engine room (the sharded ServeRuntime does "
                "the latter automatically).")
        if self.mesh is not None:
            self.mesh = shard_mesh(self.mesh)
            if self.device is not None and torch.device(self.device) != self.mesh[0]:
                raise ValueError(f"device {self.device} is not the mesh's first "
                                 f"device {self.mesh[0]}")
            self.device = self.mesh[0]
        self.device = resolve_device(self.device)
        self.bsk_f = self.bsk_f.to(self.device)
        self.ksk = self.ksk.to(self.device)
        # the keys once per distinct device of the mesh
        self._keys = {self.device: (self.bsk_f, self.ksk)}
        for dev in self.mesh or ():
            if dev not in self._keys:
                self._keys[dev] = (self.bsk_f.to(dev), self.ksk.to(dev))

    # -- derived -----------------------------------------------------------
    @property
    def key_bytes(self) -> tuple:
        """(bsk_bytes, ksk_bytes) of the evaluation keys as streamed per
        PBS round — the quantity the bandwidth ledger accounts."""
        return (self.bsk_f.numel() * self.bsk_f.element_size(),
                self.ksk.numel() * self.ksk.element_size())

    @property
    def n_clusters(self) -> int:
        return 1 if self.mesh is None else len(self.mesh)

    @property
    def supports_ks_split(self) -> bool:
        """Whether `keyswitch` + `lut_batch_small` may replace a
        `lut_batch` (the serving scheduler's KS-level partial dedup).
        Single-device engines only: the mesh path runs full PBS rounds
        over its clusters and has no half-round entry."""
        return self.mesh is None

    @property
    def batch_size(self) -> int:
        return self.batch_per_device * self.n_clusters

    @property
    def fused_pack(self):
        """The resident `FusedPbsPack` for the fused backend: one per key
        (`FusedPbsPack.shared`), so engines of one context share it.
        Built on first use."""
        pack = getattr(self, "_fused_pack", None)
        if pack is None:
            from repro_torch.kernels.fused_pbs import FusedPbsPack
            pack = self._fused_pack = FusedPbsPack.shared(
                self.bsk_f, self.ksk, self.params)
            self._gauge_residency()
        return pack

    def _gauge_residency(self) -> None:
        """Set the gauge `engine.fft_clusters_resident`: the clusters (rows)
        of the CMux step's FFT launches that fit on the card at once at
        this engine's N, the fewer of the two entry points'
        (`fourstep_fft.residency`).  On a card, with telemetry only."""
        tel = self.telemetry
        if tel is None or self.device.type != "cuda":
            return
        from repro_torch.kernels import fourstep_fft
        res = fourstep_fft.residency(self.params.N)
        tel.gauge("engine.fft_clusters_resident").set(
            min(r["clusters"] for r in res.values()))

    # -- linear ops (LPU; no bootstrapping, Fig. 2b step 4) -----------------
    def add(self, a, b):
        return lwe.add(a, b)

    def sub(self, a, b):
        return lwe.sub(a, b)

    def scalar_mul(self, a, c):
        return lwe.scalar_mul(a, c)

    def add_plain(self, a, msg):
        return lwe.add_plain(a, torus.encode(msg, self.params.delta,
                                             device=a.device))

    def trivial(self, msg) -> torch.Tensor:
        m = torus.encode(msg, self.params.delta, device=self.device)
        return lwe.trivial(m, self.params.big_n)

    # -- PBS ------------------------------------------------------------------
    def _observe(self, name: str, rows: int, run, pad=None, counted=True):
        """Run `run` under the telemetry's span and counters: `rows`
        logical rows, plus `pad` rows of padding (counted in
        `engine.pbs_rows` and `engine.pbs_rows_padded`) where given.
        `counted=False` (the keyswitch alone) opens the span only.  A
        blind rotation the fused pack ran on a card gives the span the
        arg `graph` and a count in `engine.graph_replays` / `_captures` /
        `_eager`; a capture also counts its graph's bytes in
        `engine.graph_bytes_captured`, and those of the graph it evicted in
        `engine.graph_bytes_released`."""
        tel = self.telemetry
        if tel is None:
            return run()
        attrs = {"rows": rows} if pad is None else {"rows": rows, "padded": pad}
        with tel.span(name, cat="engine", **attrs) as sp:
            out = run()
            how = self._rotation() if counted else None
            if how is not None:
                sp.set(graph=how)
        if not counted:
            return out
        if how is not None:
            tel.counter(GRAPH_COUNTERS[how]).inc()
        if how == "capture":
            captured, released = self.fused_pack.last_graph_bytes()
            tel.counter("engine.graph_bytes_captured").inc(captured)
            tel.counter("engine.graph_bytes_released").inc(released)
        tel.counter(f"engine.lut_batches_{self.kernel_backend}").inc()
        tel.counter("engine.lut_batches").inc()
        tel.counter("engine.pbs_rows").inc(rows + (pad or 0))
        if pad is not None:
            tel.counter("engine.pbs_rows_padded").inc(pad)
        tel.histogram("engine.lut_batch_rows").observe(rows)
        return out

    def _rotation(self):
        """How the fused pack ran this thread's last blind rotation
        (`FusedPbsPack.last_rotation`); None on the CPU and off the pack."""
        if self.mesh is not None or self.kernel_backend != "fused":
            return None
        return self.fused_pack.last_rotation()

    def _mesh_round(self, cts: torch.Tensor, lut_polys: torch.Tensor) -> torch.Tensor:
        """One PBS round over the clusters: the (padded) rows split evenly,
        each cluster's share through `pbs_batch` on its device, the
        results gathered on mesh[0]."""
        per = cts.shape[0] // len(self.mesh)
        outs = []
        for i, dev in enumerate(self.mesh):
            bsk_f, ksk = self._keys[dev]
            rows = slice(i * per, (i + 1) * per)
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                outs.append(batch_mod.pbs_batch(cts[rows].to(dev), lut_polys[rows].to(dev),
                                                bsk_f, ksk, self.params))
        return torch.cat([o.to(self.device) for o in outs])

    def lut_batch(self, cts: torch.Tensor, lut_polys: torch.Tensor) -> torch.Tensor:
        """Apply per-ciphertext LUTs with noise refresh.

        cts: (B, k*N+1); lut_polys: (B, N) torus polys
        (`glwe.make_lut_poly` encodes integer tables).
        Pads B up to a multiple of the cluster count with copies of the
        first rows, as the reference does, and returns the first B rows.
        """
        B = cts.shape[0]
        if lut_polys.shape[0] != B:
            raise ValueError(
                f"lut_batch: {B} ciphertexts but {lut_polys.shape[0]} LUT "
                f"polynomials — counts must match per batch row")
        cts, lut_polys = cts.to(self.device), lut_polys.to(self.device)
        pad = (-B) % self.n_clusters
        if pad:
            rep = torch.arange(pad, device=self.device) % B
            cts = torch.cat([cts, cts[rep]])
            lut_polys = torch.cat([lut_polys, lut_polys[rep]])
        if self.mesh is not None:
            run = lambda: self._mesh_round(cts, lut_polys)
        elif self.kernel_backend == "fused":
            run = lambda: self.fused_pack.pbs_batch(cts, lut_polys)
        else:
            run = lambda: batch_mod.pbs_batch(cts, lut_polys, self.bsk_f,
                                              self.ksk, self.params)
        return self._observe("lut_batch", B, run, pad=pad)[:B]

    # -- the split PBS entries (KS-level partial dedup) -----------------------
    def _require_ks_split(self, name: str) -> None:
        if not self.supports_ks_split:
            raise ConfigError(
                f"{name} needs a single-device engine "
                "(supports_ks_split) — the mesh path dispatches full PBS "
                "rounds only")

    def keyswitch(self, big_cts: torch.Tensor) -> torch.Tensor:
        """The keyswitch stage alone: (B, k*N+1) big-key cts -> (B, n+1)
        small-key cts, bit-identical to the first stage of `lut_batch`."""
        self._require_ks_split("keyswitch/lut_batch_small")
        big_cts = big_cts.to(self.device)
        if self.kernel_backend == "fused":
            run = lambda: self.fused_pack.keyswitch(big_cts)
        else:
            run = lambda: batch_mod.keyswitch_batch(big_cts, self.ksk, self.params)
        return self._observe("keyswitch", int(big_cts.shape[0]), run, counted=False)

    def lut_batch_small(self, small_cts: torch.Tensor,
                        lut_polys: torch.Tensor) -> torch.Tensor:
        """`lut_batch` minus the keyswitch: (B, n+1) small-key cts +
        (B, N) LUT polys -> (B, k*N+1).  `keyswitch` then
        `lut_batch_small` computes exactly what `lut_batch` computes."""
        self._require_ks_split("lut_batch_small")
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

    def lut_batch_xpu(self, cts: torch.Tensor, lut_polys: torch.Tensor) -> torch.Tensor:
        """Morphling-XPU-style baseline: no cross-ciphertext BSK reuse.

        The fused backend runs each row as its own one-row round (one
        keyswitch launch and n of each FFT and the MAC per ciphertext, so
        the BSK streams once per ciphertext); the reference backend runs
        `batch.pbs_unbatched_loop`.  The JAX engine always takes its plain
        loop: following `kernel_backend` makes the comparison on the card
        one of batching, not of kernels against plain PyTorch."""
        B = cts.shape[0]
        if lut_polys.shape[0] != B:
            raise ValueError(
                f"lut_batch_xpu: {B} ciphertexts but {lut_polys.shape[0]} LUT "
                f"polynomials — counts must match per batch row")
        cts, lut_polys = cts.to(self.device), lut_polys.to(self.device)
        if self.kernel_backend == "fused":
            pack = self.fused_pack
            run = lambda: torch.cat([pack.pbs_batch(cts[i:i + 1], lut_polys[i:i + 1])
                                     for i in range(B)])
        else:
            run = lambda: batch_mod.pbs_unbatched_loop(cts, lut_polys, self.bsk_f,
                                                       self.ksk, self.params)
        return self._observe("lut_batch_xpu", B, run)

    @classmethod
    def from_context(cls, ctx, mesh=None, **kw) -> "TaurusEngine":
        """An engine over `ctx`'s keys.  With a `mesh` and no backend named,
        the backend is "reference", the reference's own default and the
        only one a mesh takes; an explicit "fused" with a mesh raises
        `ConfigError`."""
        if mesh is not None:
            kw.setdefault("kernel_backend", "reference")
        return cls(ctx.params, ctx.bsk_f, ctx.ksk, mesh=mesh, **kw)

