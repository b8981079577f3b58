"""End-to-end fault-tolerant training loop: the port of
`repro.launch.train` on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 300 --batch 8 --seq 256 --ckpt-dir build/ckpt [--full]

Wires together: model zoo -> AdamW under a cosine schedule -> synthetic
data -> checkpoint/restart -> StepRunner (retry + straggler watch) ->
optional int8 gradient compression.  Weights come from the port's own
seeded init (`torch.Generator` seed 0, as the reference's `PRNGKey(0)`).
Runs on the card unless given `device`; one card only (`model_parallel`
1).  The error-feedback buffer of `compress_grads` stays in the optimizer
state from step to step and is checkpointed with it.
"""
from __future__ import annotations

import argparse
import importlib
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get
from repro_torch.core.engine import ConfigError
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime import FaultConfig, Int8Compressor, StepRunner


def reduced_config(arch: str):
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod.reduced()


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 256,
          ckpt_dir: str | None = None, reduced: bool = True,
          model_parallel: int = 1, lr: float = 3e-3, log_every: int = 10,
          compress_grads: bool = False, resume: bool = True,
          fail_at_step: int | None = None, device=None):
    """Train `steps` steps (resuming from `ckpt_dir`'s latest checkpoint)
    and return (the losses of the steps run, the runner's stats).  A step
    that still fails after the runner's retries restores the latest
    checkpoint and goes on from there; with none on disk it raises.
    `fail_at_step` injects such a failure once."""
    if model_parallel != 1:
        raise ConfigError(
            f"model_parallel={model_parallel}: the port trains on one card; "
            "sharded training waits for its multi-device slice "
            "(launch/mesh.py's sharding rules, models/sharding.py)")
    cfg = reduced_config(arch) if reduced else get(arch)
    device = resolve_device(device)
    model = build(cfg, device).init(torch.Generator(device).manual_seed(0))
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

    def snapshot() -> dict:
        return {"model": model.state_dict(), **state["opt"]}

    def load(tree: dict) -> None:
        with torch.no_grad():
            model.load_state_dict(tree.pop("model"))
        state["opt"] = tree

    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt is not None and resume and ckpt.latest_step() is not None:
        tree, start = ckpt.restore(snapshot())
        load(tree)
        print(f"[train] resumed from step {start}")

    inject = {"step": fail_at_step}

    def one_step(step_i):
        batch_i = data.batch(step_i, device)
        if inject["step"] is not None and step_i == inject["step"]:
            raise RuntimeError("injected failure (fault-tolerance test)")
        state["opt"], metrics = raw_step(model, state["opt"], batch_i, step_i)
        names = list(metrics)
        values = torch.stack([metrics[k].to(device=device, dtype=torch.float32)
                              for k in names]).tolist()     # one sync per step
        return state["opt"], dict(zip(names, values))

    runner = StepRunner(one_step, FaultConfig())
    losses = []
    t0 = time.time()
    step_i = start
    while step_i < steps:
        try:
            out = runner.run(step_i)
        except Exception as e:
            if ckpt is None or ckpt.latest_step() is None:
                raise
            print(f"[train] step {step_i} failed ({e}); restoring")
            tree, step_i = ckpt.restore(snapshot())
            load(tree)
            inject["step"] = None      # the failed node was replaced
            continue
        if out is not None:
            metrics = out[-1]
            losses.append(metrics["loss"])
            if step_i % log_every == 0:
                print(f"[train] step {step_i} loss={losses[-1]:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f}", flush=True)
        if ckpt is not None and (step_i + 1) % FaultConfig().checkpoint_every == 0:
            ckpt.save(step_i + 1, snapshot())
        step_i += 1
    if ckpt is not None:
        ckpt.save(steps, snapshot())
    dt = time.time() - t0
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
    args = ap.parse_args()
    train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
          ckpt_dir=args.ckpt_dir, reduced=not args.full,
          model_parallel=args.model_parallel, lr=args.lr,
          compress_grads=args.compress_grads)


if __name__ == "__main__":
    main()
