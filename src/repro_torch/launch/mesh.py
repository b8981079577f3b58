"""Meshes and sharding rules: the port of `repro.launch.mesh`.

Two kinds of mesh, because the reference has two mechanisms:

  * the engine's cluster mesh (`shard_mesh`): one process owns every
    device, as JAX's single controller does.  A `ClusterMesh` is a 1-D
    tuple of `torch.device`s on the axis "data"; a `TaurusEngine` given
    one splits each PBS round's rows over its devices.
  * the LM stack's FSDP x TP mesh (`make_host_mesh`): one process per
    device under `torch.distributed`, a `DeviceMesh` over the process
    group, and DTensor placements in place of GSPMD's PartitionSpecs.

Sharding strategy (FSDP x TP hybrid, ZeRO-style), as the reference's:
  * 2-D weights shard BOTH axes: the reduction/input axis over "data"
    and the output/head/ff axis over "model";
  * the batch axis of activations shards over ("pod", "data");
  * vocab shards over "model" for the embedding table and LM head;
  * MoE expert tensors shard (experts: none, d: data, ff: model);
  * small vectors (norms, gates, SSD decay constants) replicate.

A spec is a tuple with one entry per tensor axis: a mesh axis name, a
tuple of names, or None.  The spec functions are pure: they read only
the mesh's axis names and sizes (`axis_sizes`), so a stand-in with
`axis_names` and a `shape` mapping reaches the production shapes (16, 16)
and (2, 16, 16) without 256 ranks.  `placements` turns a spec into
DTensor placements: `Shard(i)` on the mesh dim that axis i names,
`Replicate()` on every other.

The dry run's production meshes (`make_production_mesh`) are real
`DeviceMesh`es of 256 or 512 ranks over a fake process group held by this
one process as rank 0: collectives return at once, and the tensors laid
out on them are meta shards (`input_specs`), so a step runs its ops on
rank 0's local shapes without memory or communication.
"""
from __future__ import annotations

import contextlib
import math
import os

import torch


class ClusterMesh(tuple):
    """The engine's 1-D ("data",) mesh: a tuple of devices, one per
    compute cluster.  Entries may repeat (several clusters on one card)."""
    axis_names = ("data",)

    @property
    def shape(self) -> dict:
        return {"data": len(self)}


def shard_mesh(devices) -> ClusterMesh:
    """A 1-D ("data",) mesh over one shard's devices: the engine-group
    topology a multi-device `EngineShard` runs its PBS rounds on."""
    devs = ClusterMesh(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("shard_mesh needs at least one device")
    return devs


def shard_devices(n_shards: int, devices=None) -> list:
    """Device -> serving-shard assignment: partition the device list
    into `n_shards` per-shard device tuples.

    `devices` defaults to every visible CUDA device.  With >= n_shards
    devices, each shard gets a contiguous slice of
    len(devices) // n_shards devices (remainder devices are left idle so
    shards stay symmetric).  With FEWER devices than shards (one card or
    the CPU, several shards), shards share devices round-robin — shard i
    gets device i % n_devices; oversubscription is explicit in the
    returned assignment rather than hidden.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if not devs:
        raise RuntimeError("no devices available for shard assignment")
    if len(devs) >= n_shards:
        per = len(devs) // n_shards
        return [tuple(devs[i * per:(i + 1) * per]) for i in range(n_shards)]
    return [(devs[i % len(devs)],) for i in range(n_shards)]


def make_host_mesh(model: int = 1):
    """A (world // model, model) ("data", "model") `DeviceMesh` over the
    initialised process group, one rank per device (the card's of the
    rank, or the CPU under gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process group "
                           "(torchrun, or init_process_group in each rank)")
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"model_parallel={model} does not divide the world size {world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (world // model, model), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def process_group(device=None):
    """Under `torchrun` (WORLD_SIZE in the environment) and with no group
    yet, one process group for the block: gloo for device "cpu", else NCCL
    with the rank's card (LOCAL_RANK) made current.  Otherwise nothing."""
    import torch.distributed as dist
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        yield
        return
    if device is not None and torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        backend = "nccl"
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The dry run's mesh: (16, 16) ("data", "model"), or (2, 16, 16)
    ("pod", "data", "model") with `multi_pod`, over a fake process group of
    that world size with this process as rank 0, on the card's device type
    (or `device`'s).  A fake group of another size is replaced; any other
    initialised group is refused."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh(shape, axes, device)


def fake_mesh(shape: tuple, axes: tuple, device=None):
    """A `DeviceMesh` of `shape` over a fake process group of its size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a fake mesh needs this process's group to be fake, "
                               f"not {dist.get_backend()}")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    kind = "cuda" if device is None else torch.device(device).type
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def input_specs(cfg, shape, mesh=None, device="meta") -> dict:
    """Every model input of this (arch, shape) cell as a tensor without
    data (meta by default), a DTensor laid out on `mesh` when given:
    train/prefill {"tokens", "labels"[, "frontend"]} of (B, S), decode
    {"tokens", "pos"} of (B, 1), int32 (the frontend f32).  The batch
    axis shards over the data axes when they divide it, as the
    reference's `input_specs`."""
    B, S = shape.global_batch, shape.seq_len
    dp = None
    if mesh is not None:
        sizes, axes = axis_sizes(mesh), batch_axes(mesh)
        size = math.prod(sizes[a] for a in axes)
        dp = (axes if len(axes) > 1 else axes[0]) if B % size == 0 else None

    def make(shp, dtype):
        t = torch.empty(shp, dtype=dtype, device=device)
        if mesh is None:
            return t
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, mesh, placements((dp,) + (None,) * (len(shp) - 1), mesh))

    if shape.kind in ("train", "prefill"):
        out = {"tokens": make((B, S), torch.int32), "labels": make((B, S), torch.int32)}
        if cfg.frontend != "none":
            out["frontend"] = make((B, cfg.frontend_len, cfg.frontend_dim), torch.float32)
        return out
    return {"tokens": make((B, 1), torch.int32), "pos": make((B, 1), torch.int32)}


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh`, a `ClusterMesh` or a stand-in
    with `axis_names` and a `shape` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


# --------------------------------------------------------------------------
# parameter sharding rules
# --------------------------------------------------------------------------

_RULES_2D = {
    # name-suffix -> (axis0, axis1)
    "embed": ("model", "data"),          # (V, d)
    "lm_head": ("data", "model"),        # (d, V)
    "frontend_proj": ("data", None),
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "w_in": ("data", "model"),
    "w_gate": ("data", "model"),
    "w_out": ("model", "data"),
    "in_proj": ("data", "model"),
    "out_proj": ("model", "data"),
    "gate_a": ("data", "model"),
    "gate_x": ("data", "model"),
    "router": ("data", None),
    "conv_w": (None, "model"),
}

_RULES_3D = {
    # MoE expert stacks: (E, d, ff) / (E, ff, d)
    "w_in": (None, "data", "model"),
    "w_gate": (None, "data", "model"),
    "w_out": (None, "model", "data"),
}


def _spec_for(names: list, nd: int) -> tuple:
    """The reference's rule for the leaf at path `names` of `nd` axes."""
    name = names[-1] if names else ""
    if nd <= 1:
        return ()
    if nd == 2 and name in _RULES_2D:
        return _RULES_2D[name]
    if nd == 3 and name in _RULES_3D and "moe" in names:
        return _RULES_3D[name]
    # stacked-over-blocks variants: leading scan axis, shift rules right
    if nd == 3 and name in _RULES_2D:
        return (None, *_RULES_2D[name])
    if nd == 4 and name in _RULES_3D and "moe" in names:
        return (None, *_RULES_3D[name])
    if nd == 3 and name == "conv_w":
        return (None, None, "model")
    return (None,) * nd


def _fit(shape, spec: tuple, sizes: dict) -> tuple:
    """Axes whose dimension the mesh axes do not divide replicate."""
    dims = []
    for n, ax in zip(shape, spec):
        size = 1
        for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
            size *= sizes[a]
        dims.append(ax if ax is not None and n % size == 0 else None)
    return tuple(dims)


def param_specs(model, mesh=None, mode: str = "train") -> dict:
    """{parameter name: spec} for `model`'s parameters.

    The reference stacks a scanned layer's tensors on a leading block axis
    and shards by the stacked leaf (`Model.reference_leaf`); that axis is
    never sharded, so a port tensor's spec is the stacked leaf's without
    its leading None.  With `mesh`, axes whose dimension is not divisible
    by the mesh-axis size replicate.  mode="serve" drops the FSDP ('data')
    axis: weights replicate across the data ranks."""
    sizes = axis_sizes(mesh) if mesh is not None else None
    out = {}
    for name, p in model.named_parameters():
        leaf = model.reference_leaf(name)
        stacked = leaf != name
        spec = _spec_for(leaf.split("."), p.ndim + stacked)[stacked:]
        if mode == "serve":
            spec = tuple(None if ax == "data" else ax for ax in spec)
        out[name] = _fit(p.shape, spec, sizes) if sizes is not None else spec
    return out


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of `spec` on `mesh`: Shard(i) on the mesh dim
    that tensor axis i names, Replicate() on every other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for dim_name in axis_sizes(mesh):
        hit = [i for i, ax in enumerate(spec)
               if ax == dim_name or (isinstance(ax, tuple) and dim_name in ax)]
        out.append(Shard(hit[0]) if hit else Replicate())
    return out


def param_shardings(mesh, model, mode: str = "train") -> dict:
    """{parameter name: DTensor placements} on `mesh`."""
    return {n: placements(s, mesh) for n, s in param_specs(model, mesh, mode).items()}


@torch.no_grad()
def distribute_params(model, mesh, mode: str = "train"):
    """Replace every parameter of `model` by a DTensor laid out by
    `param_shardings`, in place; returns the model.  Every rank must hold
    the same values (the seeded init gives them)."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor
    shardings = param_shardings(mesh, model, mode)
    for mod_name, mod in model.named_modules():
        for pname, p in list(mod._parameters.items()):
            if p is None:
                continue
            full = f"{mod_name}.{pname}" if mod_name else pname
            mod._parameters[pname] = nn.Parameter(
                distribute_tensor(p.detach(), mesh, shardings[full]),
                requires_grad=p.requires_grad)
    return model


def cache_specs(cache: list, mesh, global_batch: int) -> list:
    """Decode-cache specs, one dict per layer of the port's cache: batch
    over the dp axes (if divisible), kv-heads / channels over model where
    the layout allows.  A layer's specs are the reference's for its leaf
    without the stacked block axis."""
    sizes = axis_sizes(mesh)
    dp = batch_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    # one axis by its name, as a PartitionSpec normalises it
    bax = (dp if len(dp) > 1 else dp[0]) if global_batch % dp_size == 0 else None
    model = sizes.get("model", 1)

    def spec(name, leaf):
        if not isinstance(leaf, torch.Tensor):
            return None                      # the int write index
        nd = leaf.dim()
        if name == "index":
            return (None,) * nd
        body = [None] * nd
        if body:
            body[0] = bax                    # batch axis first in every cache leaf
        if name in ("k", "v") and nd == 4:
            if leaf.shape[-2] % model == 0:
                body[2] = "model"            # kv-head sharding
            elif leaf.shape[-1] % model == 0:
                body[3] = "model"            # GQA G < TP: shard head_dim
        if name in ("conv", "h", "H") and nd >= 2:
            ch = leaf.shape[-1] if name != "H" else leaf.shape[1]
            pos = (nd - 1) if name != "H" else 1
            if ch % model == 0:
                body[pos] = "model"
        return tuple(body)

    return [{name: spec(name, leaf) for name, leaf in layer.items()} for layer in cache]
