"""GPipe-style pipeline parallelism over the `pod` mesh dim: the port of
`repro.models.pipeline`.

For multi-pod deployments where the cross-pod link is the scarce
resource, pipelining sends only (B_micro, S, d) activations across it
once per microbatch instead of all-reducing every gradient across pods.

Each rank of the `pod` dim holds one stage (`num_layers / n_stages`
layers; the stage axis is the leading axis of a stacked parameter
tree).  The classic GPipe schedule runs `n_micro + n_stages - 1` ticks;
each tick hands the activation to the next stage with
`batch_isend_irecv` (the reference's `ppermute` ring).  The last stage's
outputs reach every rank through an all-reduce of the masked outputs
(the reference's `psum`).

This is an OPTIONAL execution mode; the data/tensor-parallel path of
`repro_torch.launch.train` remains primary.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_map


def _ring_shift(y: torch.Tensor, group, n_stages: int, stage: int) -> torch.Tensor:
    """Send `y` to stage + 1 and receive stage - 1's (mod n_stages)."""
    import torch.distributed as dist
    if n_stages == 1:
        return y
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)
    recv = torch.empty_like(y)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                                   dist.P2POp(dist.irecv, recv, prv, group)])
    for r in reqs:
        r.wait()
    return recv


def pipeline_apply(stage_fn: Callable, my_params, x_micro: torch.Tensor, *,
                   n_stages: int, group=None) -> torch.Tensor:
    """Run microbatches through pipeline stages laid over the ranks of
    `group` (the `pod` dim's process group; the default group if None).

    stage_fn(stage_params, x) -> x           (one stage's layers)
    my_params: this rank's stage parameters.
    x_micro: (n_micro, B_micro, S, d), every microbatch, the same on
    every rank.  Returns (n_micro, B_micro, S, d) as produced by the LAST
    stage, on every rank."""
    import torch.distributed as dist
    stage = dist.get_rank(group)
    n_micro = x_micro.shape[0]
    inflight = torch.zeros_like(x_micro[0])
    outputs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests microbatch t (when valid); others take the
        # activation forwarded from the previous stage
        x_in = x_micro[t if t < n_micro else 0] if stage == 0 else inflight
        y = stage_fn(my_params, x_in)
        inflight = _ring_shift(y, group, n_stages, stage)
        # the LAST stage emits microbatch (t - n_stages + 1)
        out_idx = t - (n_stages - 1)
        if stage == n_stages - 1 and out_idx >= 0:
            outputs[out_idx] = y
    if stage != n_stages - 1:
        outputs.zero_()
    dist.all_reduce(outputs, group=group)
    return outputs


def make_pipelined_fwd(stage_fn: Callable, mesh, *, n_micro: int,
                       axis_name: str = "pod"):
    """Wrap `pipeline_apply` over the `axis_name` dim of `mesh` (a
    `DeviceMesh`).

    params_stacked leaves have a leading dim of the pod size (plain
    tensors, the same on every rank, or DTensors sharded on it); each rank
    takes its stage's slice.  x: (B, S, d) global, the same on every rank;
    split into n_micro microbatches internally."""
    group = mesh.get_group(axis_name)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis_name))
    stage = mesh.get_local_rank(axis_name)

    def mine(a):
        from torch.distributed.tensor import DTensor
        return a.to_local()[0] if isinstance(a, DTensor) else a[stage]

    def fwd(params_stacked, x):
        B = x.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
        xm = x.reshape(n_micro, B // n_micro, *x.shape[1:])
        y = pipeline_apply(stage_fn, tree_map(mine, params_stacked), xm,
                           n_stages=n_stages, group=group)
        return y.reshape(B, *x.shape[1:])
    return fwd
