"""Rank programs for the port's multi-process tests (`test_torch_mesh.py`,
`test_torch_dist.py`), and the spawn that runs them.

Each rank joins a gloo group through a FileStore under the test's
`tmp_path` (never a fixed port, so parallel test workers cannot meet),
runs on the CPU with one intra-op thread, and rank 0 writes what the
parent test checks into an `.npz`.  This module imports neither JAX nor
the JAX package: the spawned ranks load it, and the parent does the JAX
side.
"""
import os
import time

import numpy as np
import torch
import torch.distributed as dist

ARCH = "qwen3-0.6b"
TRAIN = dict(batch=4, seq=16, reduced=True, log_every=100, device="cpu")
SERVE = dict(batch=4, prompt_len=4, gen=4, device="cpu")
# the other families' layers (the SSD scan, MoE routing with two top-k in
# turn): one train step and a short decode each
FAMILIES = ("mamba2-130m", "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")
FAMILY_TRAIN = dict(TRAIN, steps=1)
FAMILY_SERVE = dict(SERVE, prompt_len=2, gen=2)
PIPE = dict(n_stages=4, n_micro=8, B=16, S=4, d=8)     # the reference test's sizes


def spawn(fn, tmp_path, *args, world: int = 4, timeout: float = 240.0) -> None:
    """Run fn(rank, world, store_path, *args) in `world` spawned ranks; fail
    if a rank raises or the ranks outlive `timeout` seconds."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(world, os.path.join(tmp_path, "store"), *args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{fn.__name__}: ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


def _join(rank: int, world: int, store_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)


def lm_ranks(rank, world, store_path, out_dir):
    """qwen3 reduced at (data 2, model 2): two train steps saved at step 2,
    a resumed run whose step 2 fails and is restored, and a greedy serve;
    model_parallel 3 does not divide the world; then FAMILIES."""
    from repro_torch.core.engine import ConfigError
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    _join(rank, world, store_path)
    try:
        try:
            train(ARCH, steps=1, model_parallel=3, **TRAIN)
            refused = False
        except ConfigError:
            refused = True
        ckpt = os.path.join(out_dir, "mesh_ckpt")
        losses, _ = train(ARCH, steps=2, ckpt_dir=ckpt, model_parallel=2, **TRAIN)
        rerun, stats = train(ARCH, steps=3, ckpt_dir=ckpt, resume=True, fail_at_step=2,
                             model_parallel=2, **TRAIN)
        run = serve(ARCH, model_parallel=2, **SERVE)
        fam = {}
        for arch in FAMILIES:
            fam[f"{arch}/losses"] = np.array(train(arch, model_parallel=2, **FAMILY_TRAIN)[0])
            r = serve(arch, model_parallel=2, **FAMILY_SERVE)
            fam[f"{arch}/tokens"], fam[f"{arch}/logits"] = r.tokens, r.logits.numpy()
        if rank == 0:
            np.savez(os.path.join(out_dir, "lm.npz"), losses=np.array(losses),
                     rerun=np.array(rerun), failures=stats["failures"],
                     tokens=run.tokens, logits=run.logits.numpy(), refused=refused, **fam)
    finally:
        dist.destroy_process_group()


def _stage(W, h):
    return torch.tanh(h @ W)


def pipeline_inputs():
    """The reference test's stage weights and input, from numpy seed 0."""
    p = PIPE
    rng = np.random.default_rng(0)
    Ws = (rng.normal(size=(p["n_stages"], p["d"], p["d"])) / np.sqrt(p["d"])).astype(np.float32)
    x = rng.normal(size=(p["B"], p["S"], p["d"])).astype(np.float32)
    return Ws, x


def sequential(Ws, x):
    h = torch.as_tensor(x)
    for W in torch.as_tensor(Ws):
        h = _stage(W, h)
    return h.numpy()


def mesh_ranks(rank, world, store_path, out_dir):
    """GPipe over a 4-rank ("pod",) mesh, then `ElasticMesh(model_parallel=2)`
    shrinking by 0 and by 1 rank and growing back, and `sharding.topk` of
    a sharded tensor for two k in turn."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import placements
    from repro_torch.models import sharding
    from repro_torch.models.pipeline import make_pipelined_fwd
    from repro_torch.runtime.elastic import ElasticMesh
    _join(rank, world, store_path)
    try:
        Ws, x = pipeline_inputs()
        pod = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
        fwd = make_pipelined_fwd(_stage, pod, n_micro=PIPE["n_micro"])
        out = fwd(torch.as_tensor(Ws)[:, None], torch.as_tensor(x))

        em = ElasticMesh(model_parallel=2)
        full = em.build()
        w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        b = torch.arange(8, dtype=torch.float32)
        specs = {"w": ("data", "model"), "b": ()}
        tree = {"w": distribute_tensor(w, full, placements(specs["w"], full)),
                "b": distribute_tensor(b, full, placements(specs["b"], full))}
        res = {"pipeline": out.numpy(), "full_shape": np.array(full.mesh.shape)}
        for lost in (0, 1):
            t_small, small, t_back, _ = em.shrink_then_grow(tree, specs, lost)
            member = small.get_coordinate() is not None
            kept_small = all(torch.equal(t_small[k].full_tensor(), v)
                             for k, v in (("w", w), ("b", b))) if member else True
            kept_back = all(torch.equal(t_back[k].full_tensor(), v) for k, v in (("w", w), ("b", b)))
            flags = torch.tensor([kept_small, kept_back], dtype=torch.int64)
            dist.all_reduce(flags, op=dist.ReduceOp.MIN)
            res[f"lost{lost}_small_shape"] = np.array(small.mesh.shape)
            res[f"lost{lost}_kept"] = flags.numpy()
            res[f"lost{lost}_small_local_w"] = np.array(
                t_small["w"].to_local().shape if member else (0, 0))

        x = torch.randn((4, 6, 8), generator=torch.Generator().manual_seed(1))
        xd = distribute_tensor(x, full, placements(("data", None, "model"), full))
        for k in (2, 3):
            vals, idx = sharding.topk(xd, k)
            want = torch.topk(x, k, dim=-1)
            res[f"topk{k}_ok"] = (tuple(vals.shape) == (4, 6, k)
                                  and torch.equal(vals.full_tensor(), want.values)
                                  and torch.equal(idx.full_tensor(), want.indices))
        if rank == 0:
            np.savez(os.path.join(out_dir, "mesh.npz"), **res)
    finally:
        dist.destroy_process_group()
