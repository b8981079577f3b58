"""End-to-end fault-tolerant training loop: the port of
`repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 300 --batch 8 --seq 256 --ckpt-dir build/ckpt [--full]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --model-parallel 2 --device cpu            # 4 gloo ranks, (2, 2)

Wires together: model zoo -> AdamW under a cosine schedule -> synthetic
data -> checkpoint/restart -> StepRunner (retry + straggler watch) ->
optional int8 gradient compression.  Weights come from the port's own
seeded init (`torch.Generator` seed 0, as the reference's `PRNGKey(0)`).
Runs on the card unless given `device`.  The error-feedback buffer of
`compress_grads` stays in the optimizer state from step to step and is
checkpointed with it.

Without a process group this is the one-device path.  Under an
initialised process group (one rank per device) it builds
`make_host_mesh(model_parallel)`, lays the parameters out by
`param_shardings` as DTensors, and the AdamW moments and the error
feedback follow their placements; each batch shards over the data axis,
and the step runs under `sharding.use_mesh`.  Checkpoints hold full
tensors (rank 0 writes them) and are redistributed on restore.
"""
from __future__ import annotations

import argparse
import importlib
import time

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get
from repro_torch.core.engine import ConfigError
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import distribute_params, make_host_mesh, process_group
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build
from repro_torch.models.sharding import distribute, full, use_mesh
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime import FaultConfig, Int8Compressor, StepRunner


def reduced_config(arch: str):
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod.reduced()


def launch_mesh(model_parallel: int):
    """The (data, model) mesh over the initialised process group, or None
    without one (the one-device path)."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if model_parallel < 1 or world % model_parallel:
            raise ConfigError(f"model_parallel={model_parallel} does not divide "
                              f"the world size {world}")
        return make_host_mesh(model_parallel)
    if model_parallel != 1:
        raise ConfigError(
            f"model_parallel={model_parallel} needs an initialised process "
            "group (torchrun, or init_process_group in each rank)")
    return None


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 256,
          ckpt_dir: str | None = None, reduced: bool = True,
          model_parallel: int = 1, lr: float = 3e-3, log_every: int = 10,
          compress_grads: bool = False, resume: bool = True,
          fail_at_step: int | None = None, device=None):
    """Train `steps` steps (resuming from `ckpt_dir`'s latest checkpoint)
    and return (the losses of the steps run, the runner's stats).  A step
    that still fails after the runner's retries restores the latest
    checkpoint and goes on from there; with none on disk it raises.
    `fail_at_step` injects such a failure once.  Under a process group
    every rank calls it with the same arguments; the losses are the
    global batch's."""
    mesh = launch_mesh(model_parallel)
    cfg = reduced_config(arch) if reduced else get(arch)
    device = resolve_device(device)
    model = build(cfg, device).init(torch.Generator(device).manual_seed(0))
    if mesh is not None:
        distribute_params(model, mesh, "train")
    lead = mesh is None or dist.get_rank() == 0
    opt = AdamW(lr=cosine_schedule(lr, warmup=steps // 10, total=steps))
    data = SyntheticLMData(DataConfig(cfg.vocab_size, seq, batch))
    comp = Int8Compressor() if compress_grads else None

    params = dict(model.named_parameters())
    opt_state = opt.init(params)
    compress = None
    if comp is not None:
        opt_state["ef"] = comp.init(params)
        groups = {n: model.reference_leaf(n) for n in params}

        def compress(grads, state):
            g, ef = comp.roundtrip(grads, state["ef"], groups)
            return g, {**state, "ef": ef}
    raw_step = make_train_step(cfg, opt, loss_chunk=min(seq, 512), compress=compress)
    state = {"opt": opt_state}

    def live() -> dict:
        return {"model": model.state_dict(), **state["opt"]}

    def snapshot() -> dict:
        """The state as full tensors (a collective under a mesh)."""
        return tree_map(full, live())

    def save(step: int) -> None:
        tree = snapshot()
        if lead:
            ckpt.save(step, tree)
        if mesh is not None:
            dist.barrier()

    def restore() -> int:
        tree, step = ckpt.restore(live())     # a DTensor gives its global shape
        if mesh is not None:          # back into each live tensor's placements
            from torch.distributed.tensor import distribute_tensor
            tree = tree_map(lambda t, x: distribute_tensor(t, x.device_mesh, x.placements),
                            tree, live())
        with torch.no_grad():
            model.load_state_dict(tree.pop("model"))
        state["opt"] = tree
        return step

    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt is not None and resume and ckpt.latest_step() is not None:
        start = restore()
        if lead:
            print(f"[train] resumed from step {start}")

    inject = {"step": fail_at_step}

    def one_step(step_i):
        batch_i = {k: distribute(v, "batch", None)
                   for k, v in data.batch(step_i, device).items()}
        if inject["step"] is not None and step_i == inject["step"]:
            raise RuntimeError("injected failure (fault-tolerance test)")
        state["opt"], metrics = raw_step(model, state["opt"], batch_i, step_i)
        names = list(metrics)
        values = torch.stack([full(metrics[k]).to(device=device, dtype=torch.float32)
                              for k in names]).tolist()     # one sync per step
        return state["opt"], dict(zip(names, values))

    runner = StepRunner(one_step, FaultConfig())
    losses = []
    t0 = time.time()
    step_i = start
    with use_mesh(mesh):
        while step_i < steps:
            try:
                out = runner.run(step_i)
            except Exception as e:
                if ckpt is None or ckpt.latest_step() is None:
                    raise
                if lead:
                    print(f"[train] step {step_i} failed ({e}); restoring")
                step_i = restore()
                inject["step"] = None      # the failed node was replaced
                continue
            if out is not None:
                metrics = out[-1]
                losses.append(metrics["loss"])
                if step_i % log_every == 0 and lead:
                    print(f"[train] step {step_i} loss={losses[-1]:.4f} "
                          f"gnorm={metrics['grad_norm']:.3f}", flush=True)
            if ckpt is not None and (step_i + 1) % FaultConfig().checkpoint_every == 0:
                save(step_i + 1)
            step_i += 1
        if ckpt is not None:
            save(steps)
    dt = time.time() - t0
    if lead:
        print(f"[train] {steps - start} steps in {dt:.1f}s "
              f"({(steps - start) / max(dt, 1e-9):.2f} it/s); "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
              f"runner stats {runner.stats}")
    return losses, runner.stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config (default: reduced)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="e.g. cpu (default: the card; under torchrun, the rank's)")
    args = ap.parse_args()
    with process_group(args.device):
        train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
              ckpt_dir=args.ckpt_dir, reduced=not args.full,
              model_parallel=args.model_parallel, lr=args.lr,
              compress_grads=args.compress_grads, device=args.device)


if __name__ == "__main__":
    main()
