"""Host-clock times of two one-device paths: the fused B = 12
`lut_batch_tables` round at gpt2 (port keygen seed 2509) and one
full-width qwen3-0.6b train step (bf16, batch 8 x seq 256, lr 3e-3 under
the cosine schedule), each the median of its repeats after a warm-up,
printed as one JSON line beside the card's name and power limit.

    python3 src/repro_torch/launch/one_device_times.py

It imports the `repro_torch` of the tree it sits in.  To compare two
commits on one card, unpack the other into a git-ignored directory, copy
this file to the same path there, and run the two in turns (A, B, B, A)
in one call: times on the host's clock move between calls.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 2509
ROUNDS, STEPS, WARM = 10, 5, 2


def main() -> int:
    src = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(src))
    import torch
    from repro_torch.configs import get
    from repro_torch.core.engine import TaurusEngine
    from repro_torch.core.params import PAPER_PARAMS
    from repro_torch.core.pbs import TFHEContext
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim import AdamW, cosine_schedule

    if not torch.cuda.is_available():
        print("one_device_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def timed(run, n):
        out = []
        for i in range(WARM + n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            if i >= WARM:
                out.append(time.perf_counter() - t0)
        return out

    p = PAPER_PARAMS["gpt2"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ctx = TFHEContext.create(gen, p, device="cuda")
    engine = TaurusEngine.from_context(ctx)
    msgs = (torch.arange(12, device="cuda") * 11 + 3) % p.plaintext_modulus
    cts = ctx.encrypt(gen, msgs)
    table = (torch.arange(p.plaintext_modulus) * 5 + 7) % p.plaintext_modulus
    rounds = timed(lambda: engine.lut_batch_tables(cts, table), ROUNDS)
    del engine, ctx, cts

    cfg = get("qwen3-0.6b")
    model = build(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=0, total=WARM + STEPS))
    state = {"opt": opt.init(dict(model.named_parameters())), "i": 0}
    step = make_train_step(cfg, opt, loss_chunk=256)
    data = SyntheticLMData(DataConfig(cfg.vocab_size, 256, 8))

    def train_step():
        state["opt"], metrics = step(model, state["opt"], data.batch(state["i"]), state["i"])
        metrics["loss"].item()
        state["i"] += 1

    steps = timed(train_step, STEPS)
    print(json.dumps({"tree": str(src.parent), "card": smi,
                      "round12_s": rounds, "round12_median_s": statistics.median(rounds),
                      "train_step_ms": [s * 1e3 for s in steps],
                      "train_step_median_ms": statistics.median(steps) * 1e3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
