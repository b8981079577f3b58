"""Batched serving driver: prefill + greedy decode against a KV/state
cache.  The port of `repro.launch.serve`:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --batch 4 --prompt-len 32 --gen 64 [--full]

Weights come from the port's own seeded init (`torch.Generator` seed 0,
as the reference's `PRNGKey(0)`), prompts from numpy's `default_rng(seed)`
(the reference's prompts).  The prompt is fed token by token through the
decode step, which exercises the cache exactly as decode does, then
`gen` tokens are decoded greedily.  Runs on the card unless given
`device`; one card only (`model_parallel` 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.core.engine import ConfigError
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.launch.train import reduced_config
from repro_torch.models import Model, build


@dataclasses.dataclass
class ServeRun:
    tokens: np.ndarray        # (batch, gen) generated tokens
    prompts: torch.Tensor     # (batch, prompt_len) int32
    logits: torch.Tensor      # (batch, V) f32, after the last decoded token
    prefill_s: float
    decode_s: float
    model: Model
    cache: list


def serve(arch: str, *, batch: int = 4, prompt_len: int = 32, gen: int = 32,
          reduced: bool = True, model_parallel: int = 1, seed: int = 0,
          device=None) -> ServeRun:
    if model_parallel != 1:
        raise ConfigError(
            f"model_parallel={model_parallel}: the port serves on one card; "
            "tensor-parallel serving waits for its multi-device slice "
            "(launch/mesh.py's sharding rules, models/sharding.py)")
    cfg = reduced_config(arch) if reduced else get(arch)
    device = resolve_device(device)
    model = build(cfg, device).init(torch.Generator(device).manual_seed(0))
    max_len = prompt_len + gen
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                              dtype=torch.int32, device=device)
    step = make_serve_step(cfg)
    cache = model.init_cache(batch, max_len)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def positions(t):
        return torch.full((batch, 1), t, dtype=torch.int32, device=device)

    sync()
    t0 = time.perf_counter()
    logits = None
    for t in range(prompt_len):
        logits, cache = step(model, cache, prompts[:, t:t + 1], positions(t))
    sync()
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    t0 = time.perf_counter()
    for t in range(prompt_len, max_len):
        out_tokens.append(tok[:, 0].cpu().numpy())
        logits, cache = step(model, cache, tok, positions(t))
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    sync()
    t_decode = time.perf_counter() - t0

    toks = np.stack(out_tokens, axis=1)
    print(f"[serve] prefill {prompt_len} toks x{batch} in {t_prefill:.2f}s; "
          f"decode {gen} toks x{batch} in {t_decode:.2f}s "
          f"({batch * gen / max(t_decode, 1e-9):.1f} tok/s)")
    print(f"[serve] first generated tokens: {toks[:, :8].tolist()}")
    return ServeRun(toks, prompts, logits, t_prefill, t_decode, model, cache)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    args = ap.parse_args()
    serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
          gen=args.gen, reduced=not args.full,
          model_parallel=args.model_parallel)


if __name__ == "__main__":
    main()
