"""Elastic capacity management, two faces of one idea: the port of
`repro.runtime.elastic`.

`ElasticMesh`       rebuild the (data, model) `DeviceMesh` over the
                    healthy ranks when ranks come and go, and re-shard
                    live state onto the new topology (training survives
                    host loss).
`ElasticAdmission`  resize a serving shard's concurrency limit
                    (`max_inflight`) from observed queue depth and
                    recent fused-wave occupancy — the per-shard
                    controller behind `ServeRuntime(..., elastic=True)`.
                    Deterministic and lock-free: the runtime calls
                    `observe` under its own admission lock, so the
                    controller is plain state + policy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.launch.mesh import placements


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """Tuning knobs for `ElasticAdmission`.

    ceiling          hard upper bound on the shard's concurrency limit
                     (the configured `max_inflight` — never exceeded).
    floor            lower bound the limit decays toward when idle.
    step_up          slots added per grow decision (backlog present,
                     every current slot busy, occupancy healthy).
    step_down        slots removed per shrink decision (no backlog and
                     spare slots).
    occupancy_floor  minimum recent fused-wave occupancy for growing:
                     adding workers to a shard whose barrier rounds are
                     already running half-empty only dilutes them.  A
                     shard with no occupancy signal yet (unfused, or no
                     round dispatched) is allowed to grow.
    """
    ceiling: int = 8
    floor: int = 1
    step_up: int = 1
    step_down: int = 1
    occupancy_floor: float = 0.5

    def __post_init__(self):
        if not (1 <= self.floor <= self.ceiling):
            raise ValueError(
                f"need 1 <= floor ({self.floor}) <= ceiling "
                f"({self.ceiling})")
        if self.step_up < 1 or self.step_down < 1:
            raise ValueError("step_up and step_down must be >= 1")


class ElasticAdmission:
    """Queue-depth + occupancy driven `max_inflight` controller.

    One instance per `EngineShard`.  The serving router consults
    `limit` on every admission and calls `observe` at the two points
    where shard pressure changes: when admission stalls with work still
    queued (a grow opportunity) and when a worker finishes with the
    queue empty (a shrink opportunity).  `high_water` records the
    largest limit ever granted — the burst tests pin it against the
    ceiling.
    """

    def __init__(self, policy: Optional[ElasticPolicy] = None):
        self.policy = policy if policy is not None else ElasticPolicy()
        self._limit = self.policy.floor
        self.high_water = self._limit
        self.grows = 0
        self.shrinks = 0

    @property
    def limit(self) -> int:
        return self._limit

    def observe(self, queue_depth: int, inflight: int,
                occupancy: Optional[float] = None) -> bool:
        """One controller step; returns True if the limit changed.

        Grow when there is a backlog, every granted slot is busy, and
        the occupancy signal (when present) clears the policy floor.
        Shrink toward max(floor, inflight) when the queue is empty and
        slots sit idle — the limit never cuts below work already
        running."""
        p = self.policy
        if queue_depth > 0 and inflight >= self._limit:
            if occupancy is not None and occupancy < p.occupancy_floor:
                return False
            new = min(p.ceiling, self._limit + p.step_up)
            if new != self._limit:
                self._limit = new
                self.high_water = max(self.high_water, new)
                self.grows += 1
                return True
            return False
        if queue_depth == 0 and inflight < self._limit:
            new = max(p.floor, inflight, self._limit - p.step_down)
            if new != self._limit:
                self._limit = new
                self.shrinks += 1
                return True
        return False


@dataclasses.dataclass
class ElasticMesh:
    """(data, model) meshes over the ranks of the process group.  Every
    method is collective: each rank of the group calls it, a rank outside
    the new mesh too (it holds no shard of the result)."""
    model_parallel: int = 1
    axis_names: tuple = ("data", "model")

    def build(self, ranks: Optional[Sequence[int]] = None):
        """Largest (data, model) `DeviceMesh` over the healthy ranks.

        `model_parallel` is fixed (the weights' layout must survive
        restarts); the data axis absorbs rank loss: data = n_ranks // model."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        ranks = list(ranks if ranks is not None else range(dist.get_world_size()))
        mp = self.model_parallel
        dp = len(ranks) // mp
        if dp < 1:
            raise RuntimeError(f"{len(ranks)} ranks cannot host model_parallel={mp}")
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return DeviceMesh(kind, torch.tensor(ranks[:dp * mp]).reshape(dp, mp),
                          mesh_dim_names=self.axis_names)

    def reshard(self, tree: dict, specs: dict, new_mesh) -> dict:
        """Re-shard {name: tensor} onto `new_mesh` by {name: spec}: each
        DTensor gathers its full value (`full_tensor`), then
        `distribute_tensor` lays it out on the new mesh from the new mesh's
        first rank of each dim.  A rank outside the old mesh holds no
        value and passes a placeholder of the global shape."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        out = {}
        for name, x in tree.items():
            if isinstance(x, DTensor):
                x = (x.full_tensor() if x.device_mesh.get_coordinate() is not None
                     else torch.empty(x.shape, dtype=x.dtype, device=x.device))
            out[name] = distribute_tensor(x, new_mesh, placements(specs[name], new_mesh))
        return out

    def shrink_then_grow(self, tree: dict, specs: dict, lost: int):
        """Lose the last `lost` ranks, then recover them.
        Returns (tree_on_small, small_mesh, tree_back, full_mesh)."""
        import torch.distributed as dist
        full = self.build()
        small = self.build(range(dist.get_world_size() - lost))
        t_small = self.reshard(tree, specs, small)
        t_back = self.reshard(t_small, specs, full)
        return t_small, small, t_back, full
