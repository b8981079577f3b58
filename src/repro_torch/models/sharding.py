"""Logical sharding constraints usable from inside model code: the port of
`repro.models.sharding`.

`constrain(x, *logical)` redistributes a DTensor to the logical layout
and is a no-op on a plain tensor, which is what model code sees without
a mesh.  Logical names:

    batch -> ("pod","data") when the mesh has a pod axis, else ("data",)
    model -> "model"   (TP axis: heads / ff / vocab / channels)
    None  -> unsharded axis

`use_mesh(mesh)` is the port's `with mesh:`: the launchers lay their
inputs out on `current_mesh()` (`distribute`).  Model code takes the mesh
from the DTensors it is given, so a checkpointed layer's recompute, which
autograd runs on its own thread for a card, sees the same layout.  A
constant made inside model code (the RoPE tables, iotas, masks, zero
buffers) meets sharded activations as a replicated DTensor
(`replicated_like`), so autograd saves DTensors for the backward pass.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.launch.mesh import axis_sizes, placements

_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)


def current_mesh():
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` (a `DeviceMesh`) the active mesh, as the reference's
    `with mesh:`; `use_mesh(None)` changes nothing."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def logical_spec(shape, logical, mesh) -> tuple:
    """The mesh spec of `logical` names for a tensor of `shape`, by the
    reference's rule: the batch axis is never sharded finer than its size.
    An axis of size 1 is not sharded at all (on a mesh dim of size 1 that
    is the same layout, and DTensor's view rules drop a sharded axis of
    size 1 badly)."""
    sizes = axis_sizes(mesh)
    spec = []
    for n, ax in zip(shape, logical):
        if n == 1:
            spec.append(None)
        elif ax == "batch":
            spec.append(("pod", "data") if "pod" in sizes else "data")
        elif ax == "model":
            spec.append("model" if "model" in sizes else None)
        else:
            spec.append(None)
    dp = spec[0] if spec else None
    if dp is not None and logical[0] == "batch":
        dp_size = 1
        for a in (dp if isinstance(dp, tuple) else (dp,)):
            dp_size *= sizes[a]
        if shape[0] % dp_size != 0:
            spec[0] = None
    return tuple(spec)


def _placed(x, *logical) -> list:
    mesh = x.device_mesh
    return placements(logical_spec(x.shape, logical, mesh), mesh)


class _Constrain(torch.autograd.Function):
    """Lay a DTensor out in `want`, and its gradient too: the reference's
    `with_sharding_constraint` pins the layout of both passes, while
    DTensor's own backward would hand the gradient on in whatever layout
    it arrives (a `Partial` sum from the vocab-sharded head, which the next
    matmul's backward then meets by gathering its weight whole)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        if list(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and list(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def constrain(x: torch.Tensor, *logical):
    if not is_dtensor(x):
        return x
    want = _placed(x, *logical)
    if x.device_mesh.size() == 1:
        # one rank: every layout holds the same data, so no gradient needs
        # pinning, and the autograd node would cost a DTensor op a call
        return x if list(x.placements) == want else x.redistribute(x.device_mesh, want)
    return _Constrain.apply(x, want)


def regroup(x: torch.Tensor, *shape) -> torch.Tensor:
    """x.reshape(*shape) where the reshape regroups the leading (batch)
    axis, as the MoE's token groups do.  A DTensor is made whole first:
    DTensor's view rules cannot carry a shard of the batch into groups
    that cut across it (and do not agree between PyTorch versions on the
    cases they can)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        x = x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    return x.reshape(*shape)


def split_heads(x: torch.Tensor, *shape) -> torch.Tensor:
    """x.reshape(*shape) where the last axis splits into (heads, width).
    A DTensor sharded on that axis keeps the shard on the heads when they
    divide its mesh dim, and is gathered whole first when they do not:
    DTensor cannot cut one shard across two axes (GSPMD tiles both)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        last, mesh = x.ndim - 1, x.device_mesh
        split = [isinstance(p, Shard) and p.dim in (-1, last) for p in x.placements]
        if any(s and shape[-2] % mesh.size(m) for m, s in enumerate(split)):
            x = x.redistribute(mesh, [Replicate() if s else p
                                      for s, p in zip(split, x.placements)])
    return x.reshape(*shape)


def merge_heads(x: torch.Tensor, *shape) -> torch.Tensor:
    """x.reshape(*shape) where the last two axes (heads, width) merge.  A
    DTensor split on its width is made whole on "model" first (DTensor
    merges two axes only when the first carries the shard); when the
    heads do not divide "model", the merged tensor stays whole there in
    both passes, so that the next matmul's backward does not hand the
    reshape a gradient split across the two axes."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    from torch.distributed.tensor import Shard
    uneven = x.shape[-2] % axis_sizes(x.device_mesh).get("model", 1)
    if uneven or any(isinstance(p, Shard) and p.dim in (-1, x.ndim - 1)
                     for p in x.placements):
        x = constrain(x, "batch", *(None,) * (x.ndim - 1))
    y = x.reshape(*shape)
    return constrain(y, "batch", *(None,) * (y.ndim - 1)) if uneven else y


def replicated_like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`t`, a plain tensor with the same value on every rank, as a
    replicated DTensor on `x`'s mesh when `x` is a DTensor; else `t`.
    Differentiable and without communication."""
    if not is_dtensor(x) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def distribute(x: torch.Tensor, *logical):
    """A plain tensor, the same on every rank, as a DTensor laid out by
    `logical` on the active mesh; `x` itself without a mesh."""
    mesh = current_mesh()
    if mesh is None or is_dtensor(x):
        return x
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements(logical_spec(x.shape, logical, mesh), mesh))


def full(x):
    """The global value of a DTensor (a collective: every rank of its mesh
    calls it); anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def _rows(table, idx):
    return table[idx.long()]


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] (B, S) -> (B, S, d), the embedding lookup.  A DTensor
    table is gathered whole and each batch shard looks its rows up locally
    (`local_shards`); its gradient is summed over the data axes.  DTensor's
    own lookups off a vocab-sharded table mask the wrong shape when the
    indices are batch-sharded, and their backward (`index_put`) has no
    layout for sharded indices on every PyTorch version."""
    return local_shards(_rows, (table, idx), ((None, None), ("batch", None)),
                        ((*idx.shape, table.shape[-1]), ("batch", None, None)))


def _split_last(x: torch.Tensor) -> bool:
    """True when a DTensor's last axis is split over more than one rank."""
    from torch.distributed.tensor import Shard
    return any(isinstance(p, Shard) and p.dim in (-1, x.ndim - 1) and x.device_mesh.size(m) > 1
               for m, p in enumerate(x.placements))


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """torch.logsumexp(x, dim=-1).  A DTensor split on its last axis
    reduces its shard's max and sum across the split (two small
    all-reduces) instead of gathering the axis whole, as DTensor's own
    logsumexp does."""
    if not is_dtensor(x) or not _split_last(x):
        return torch.logsumexp(x, dim=-1)
    rest = ("batch",) + (None,) * (x.ndim - 1)
    m = constrain(torch.amax(x.detach(), dim=-1, keepdim=True), *rest)
    s = constrain(torch.sum(torch.exp(x - m), dim=-1, keepdim=True), *rest)
    return (m + torch.log(s))[..., 0]


def take_label(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[..., labels] (the gold logit of each position).  A DTensor
    split on the vocabulary takes it as a masked sum over its own shard
    (exact: one term is not zero), so its gradient keeps the logits'
    layout; DTensor's own gather answers its backward with a zero tensor
    of the whole logits on every rank."""
    rest = ("batch",) + (None,) * (labels.ndim - 1)
    if not is_dtensor(logits) or not _split_last(logits):
        gold = torch.gather(logits, -1, labels[..., None].long())
        return constrain(gold, *rest, None)[..., 0]
    vocab = torch.arange(logits.shape[-1], device=labels.device)
    vocab = constrain(replicated_like(vocab, logits), "model")
    hit = labels[..., None].long() == vocab
    return constrain(torch.sum(torch.where(hit, logits, 0.0), dim=-1), *rest)


def topk(x: torch.Tensor, k: int):
    """`torch.topk(x, k, dim=-1)`.  A DTensor's is taken shard by shard
    with its last axis whole: DTensor's own topk caches its output's
    global shape without `k`, so a second `k` on the same input layout
    gets the first one's shape."""
    if not is_dtensor(x):
        return torch.topk(x, k, dim=-1)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    last = x.ndim - 1
    x = x.redistribute(x.device_mesh, [Replicate() if isinstance(p, Shard) and
                                       p.dim in (-1, last) else p for p in x.placements])
    vals, idx = torch.topk(x.to_local(), k, dim=-1)
    shape = (*x.shape[:-1], k)
    return tuple(DTensor.from_local(t, x.device_mesh, x.placements, shape=shape,
                                    stride=torch.empty(shape, device="meta").stride())
                 for t in (vals, idx))


def local_shards(fn, args, in_logical, out):
    """fn(*args) run shard by shard (`local_map`), the reference's
    `shard_map`: each tensor argument laid out by its logical names (a
    plain one is first replicated), and its output by `out`, a (global
    shape, logical names) pair, or a list of them for a tuple of outputs.
    An argument replicated over a mesh dim that an output is split on
    feeds every shard, so its gradient is that dim's sum (`Partial`).
    Without a DTensor argument, fn itself."""
    lead = next((a for a in args if is_dtensor(a)), None)
    if lead is None:
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = lead.device_mesh
    args = [replicated_like(a, lead) for a in args]
    in_pl = [_placed(a, *lg) for a, lg in zip(args, in_logical)]
    single = not isinstance(out, list)
    out_pl = [placements(logical_spec(shape, lg, mesh), mesh)
              for shape, lg in ([out] if single else out)]
    split = {m for pl in out_pl for m, p in enumerate(pl) if isinstance(p, Shard)}
    grad_pl = [[Partial() if m in split and isinstance(p, Replicate) else p
                for m, p in enumerate(pl)] for pl in in_pl]
    run = local_map(fn, out_placements=out_pl[0] if single else tuple(out_pl),
                    in_placements=tuple(in_pl), in_grad_placements=tuple(grad_pl),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(*args)


def attention_shards(fn, q, k, v, q_pos, kv_pos):
    """fn(q, k, v, q_pos, kv_pos) -> (B, Sq, H, hd) shard by shard: the
    batch over the data axes and the heads over "model" where both H and
    G divide by its size, the layout the reference's
    `constrain(qf, "batch", None, "model", None)` asks for.  Attention is
    independent per batch row and head, so each shard is its own problem;
    the score einsums flatten (batch, heads), which DTensor's view rules
    refuse when both are sharded.  On plain tensors, fn itself."""
    if not is_dtensor(q):
        return fn(q, k, v, q_pos, kv_pos)
    tp = axis_sizes(q.device_mesh).get("model", 1)
    H, G = q.shape[2], k.shape[2]
    if q.shape[1] > 1 and H % tp == 0 and G % tp:
        # fewer KV heads than shards: each query head gets its own copy of
        # its KV head (the repeat the chunked attention makes anyway), so
        # the heads still split over "model"
        B, S, _, hd = k.shape
        k, v = (t.unsqueeze(3).expand(B, S, G, H // G, hd).reshape(B, S, H, hd)
                for t in (k, v))
    heads = "model" if H % tp == 0 and k.shape[2] % tp == 0 else None
    if heads is None and q.shape[1] == 1 and q.shape[-1] % tp == 0:
        # one decode query whose heads cannot split: the score and value
        # einsums split head_dim instead, where the cache keeps its shard
        # (`launch.mesh.cache_specs`), with the scores summed over "model"
        width = ("batch", None, None, "model")
        return fn(*(constrain(t, *width) for t in (q, k, v)), q_pos, kv_pos)
    qkv = ("batch", None, heads, None)
    if heads is None and q.shape[1] % tp == 0:
        # queries whose heads cannot split: the query positions split
        # instead, each shard against every key (the positions carry the
        # causal and window masks)
        q_spec = ("batch", "model", None, None)
        return local_shards(fn, (q, k, v, q_pos.contiguous(), kv_pos.contiguous()),
                            (q_spec, qkv, qkv, ("batch", "model"), ("batch", None)),
                            (q.shape, q_spec))
    return local_shards(fn, (q, k, v, q_pos.contiguous(), kv_pos.contiguous()),
                        (qkv, qkv, qkv, ("batch", None), ("batch", None)), (q.shape, qkv))
