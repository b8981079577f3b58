"""The user demos, on the port: one module per demo of the JAX package's
`examples/`, with its parameter set, values and programs, printing its
`got (expect want)` lines.

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.encrypted_int32 [--device cpu]
    python -m repro_torch.examples.fhe_gpt2 [--device cpu]
    python -m repro_torch.examples.serve_requests [--device cpu]
    python -m repro_torch.examples.sim_scenario [--device cpu]
    python -m repro_torch.examples.trace_serve [--device cpu] [--out trace_serve.json]

Each runs on the card unless `--device` names another device.  The keys
and encryptions come from seeded `torch.Generator`s on that device: they
are not the JAX demos' bits, so a value printed from the randomness (a
noise, a quantized input) may differ; every oracle and every program is
the demo's.  `train_lm.py`'s role is `python -m repro_torch.launch.train`.
"""
from __future__ import annotations

import argparse
import re

import torch

from repro_torch.device import resolve_device


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where keys and kernels run (default: the card)")
    return ap


def generator(device, seed: int) -> torch.Generator:
    """A seeded generator on `device` (resolved: the card by default)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def got_expect(line: str) -> tuple:
    """(got, want) integer lists of a demo's `... = got   (... expect
    want)` line: the numbers after its first '=' and after 'expect'."""
    at = line.index("expect")
    pre = line[:line.rindex("(", 0, at)]
    want = re.split(r"[;)]", line[at + len("expect"):])[0]

    def ints(text):
        return [int(t, 0) for t in re.findall(r"0x[0-9A-Fa-f]+|-?\d+", text)]
    return ints(pre.split("=", 1)[1]), ints(want)


def checked_lines(stdout: str) -> list:
    """[(line, got, want)] for every got/expect line of a demo's output."""
    return [(ln, *got_expect(ln)) for ln in stdout.splitlines()
            if "expect" in ln and "=" in ln]
