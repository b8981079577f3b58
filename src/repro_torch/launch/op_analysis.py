"""Per-device op counts of an eager step: the port's role of
`repro.launch.hlo_analysis`.

The reference reads FLOPs, bytes and collective bytes from a compiled
per-device HLO module.  Eager PyTorch has no such module, so the port
runs the step once, on a fake process group whose ranks are all in this
process (`launch.mesh.make_production_mesh`), with meta tensors as each
rank's shards, and counts the ops that rank 0 would run under a
`TorchDispatchMode` (`OpCounter`).  The fields and their definitions are
`HloCosts`':

  * flops           — 2 * m * n * k per matmul (torch.utils.flop_counter's
                      formulas: mm, bmm, addmm, baddbmm, convolution,
                      attention), x4 for complex;
  * hbm_bytes       — operand plus result bytes of every op that is not a
                      view (nothing is fused in eager mode, so this is the
                      reference's pessimistic term);
  * hbm_bytes_major — the same for matmul, gather, scatter, index and
                      slice-update ops only (the optimistic term);
  * coll_bytes      — result bytes of every `_c10d_functional` collective,
                      by the reference's op names in `coll_breakdown`.

All numbers are per device: an op whose arguments are DTensors is passed
through (`NotImplemented`), so only the local ops under it are counted, on
local shapes; the global-shape ops that DTensor runs on fake tensors to
propagate its shardings are not counted either.  Python loops need no
trip counts: every iteration dispatches its ops.  The counter also keeps
the peak bytes of the storages its ops create and that are still alive
(`peak_bytes`), the step's working set beyond its arguments, and which
storages its ops read: `count(run, args)` gives the bytes of the
arguments the step reads (`arg_bytes`), as a compiled program keeps only
the parameters it uses.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# `_c10d_functional` op -> the reference's HLO collective name
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
# ops that move no bytes of their own
FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
        "detach", "lift_fresh", "alias", "_local_scalar_dense", "wait_tensor",
        "_wrap_tensor_autograd", "sym_size", "sym_stride", "sym_numel"}
MAJOR = {"mm", "bmm", "addmm", "baddbmm", "convolution", "_convolution",
         "convolution_backward", "gather", "scatter", "scatter_add", "scatter_add_",
         "scatter_reduce", "scatter_", "index", "index_put", "index_put_",
         "_index_put_impl_", "index_add", "index_add_", "index_select", "embedding",
         "embedding_dense_backward", "slice_scatter", "select_scatter", "take_along_dim"}


@dataclasses.dataclass
class OpCosts:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    hbm_bytes_major: float = 0.0
    coll_bytes: float = 0.0
    coll_breakdown: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0                    # live storages the counted ops made
    arg_bytes: int = 0                     # the arguments the ops read
    flops_by_op: dict = dataclasses.field(default_factory=dict)
    ops: int = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched under it (see the module docstring);
    `costs` holds the totals."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._flop = flop_registry
        self.costs = OpCosts()
        self._live = 0
        self._seen: set = set()
        self.read: set = set()                 # storages the counted ops read
        self._by_op = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented          # count the local ops under it
        out = func(*args, **kwargs)
        from torch._subclasses.fake_tensor import FakeTensor
        ins = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                     # DTensor's global-shape propagation
        self._count(func, args, kwargs, out, ins, outs)
        return out

    def _count(self, func, args, kwargs, out, ins, outs) -> None:
        c = self.costs
        c.ops += 1
        self.read.update(id(t.untyped_storage()) for t in ins)
        name = func._overloadpacket.__name__
        packet = func._overloadpacket
        if packet in self._flop:
            f = float(self._flop[packet](*args, **kwargs, out_val=out))
            if outs and outs[0].is_complex():
                f *= 4
            c.flops += f
            self._by_op[name] += f
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVES.get(name)
            if kind is not None:
                b = sum(_nbytes(o) for o in outs)
                c.coll_bytes += b
                c.coll_breakdown[kind] = c.coll_breakdown.get(kind, 0.0) + b
                c.hbm_bytes += b + sum(_nbytes(a) for a in ins)
            self._track(func, outs)
            return
        if name in FREE or not outs or _is_view(func):
            self._track(func, outs)
            return
        b = sum(_nbytes(t) for t in ins) + sum(_nbytes(o) for o in outs)
        c.hbm_bytes += b
        if name in MAJOR or (name == "copy_" and ins[0]._is_view()):
            c.hbm_bytes_major += b
        self._track(func, outs)

    def _track(self, func, outs) -> None:
        """Add the storages `func` made to the live bytes; each is taken
        off when it is freed."""
        if any(r.alias_info is not None for r in func._schema.returns):
            return                          # a view, or written in place
        for o in outs:
            st = o.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self._live += n
            self.costs.peak_bytes = max(self.costs.peak_bytes, self._live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self._live -= n

    def __exit__(self, *exc):
        self.costs.flops_by_op = dict(self._by_op)
        return super().__exit__(*exc)


def local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def count(run, args=()) -> OpCosts:
    """Run `run()` once under an `OpCounter`; its per-device costs, with
    `arg_bytes` the bytes of this rank's shards of `args` (tensors or
    DTensors) that the run read."""
    # the arguments' storages, held from before the run: an id is unique
    # only among live objects
    shards = [(local(a).untyped_storage(), local(a)) for a in args]
    with OpCounter() as counter:
        run()
    seen = set()
    for st, t in shards:
        if id(st) in counter.read and id(st) not in seen:
            seen.add(id(st))
            counter.costs.arg_bytes += _nbytes(t)
    return counter.costs
