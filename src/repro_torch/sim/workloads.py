"""Workload mix registry for the traffic simulator.  The port of
`repro.sim.workloads`.

Each `Workload` wraps one of the `repro_torch.serve.programs` /
`repro_torch.fhe_ml.lower` builders into the uniform shape the runners
need: a (lazily traced, cached) graph + IntSpec lists, a seeded
plaintext sampler, an integer oracle for end-to-end validation, and a
mean service-time prior the deterministic virtual runner's service
model starts from.

A `WorkloadMix` is a weighted distribution over workloads —
`mix.sample(rng)` draws the workload for each arriving request, so a
mixed-tenant scenario interleaves cheap const-op analytics with
PBS-heavy radix arithmetic on one runtime.  The plaintext draws come
from the same `random.Random` streams as the reference's, so a request
encrypts the same integers.

Registry (all parameterized by radix width / digit size)::

    radix_add         D-digit encrypted add        (carry-propagation PBS)
    radix_mul         D-digit encrypted multiply   (PBS-heaviest int op)
    radix_relu        two's-complement ReLU        (sign-LUT PBS)
    analytics_const   k*x + c with plaintext k, c  (LPU-only — zero PBS)
    analytics_linear  radix_linear matmul analytics query
    gpt2_block        reduced single-head encrypted transformer block
"""
from __future__ import annotations

import random
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api.session import trace_program
from repro_torch.api.tracing import IntSpec


class Workload:
    """One program template: `build()` traces (once) to
    (graph, in_specs, out_specs); `sample_values(rng)` draws the flat
    list of plaintext ints a request encrypts; `oracle(values)` is the
    expected decrypted output (None ⇒ skip validation)."""

    def __init__(self, name: str, builder: Callable,
                 sample: Callable, oracle: Optional[Callable] = None,
                 mean_service_s: float = 1.0):
        self.name = name
        self._builder = builder
        self._sample = sample
        self.oracle = oracle
        self.mean_service_s = mean_service_s
        self._built = None

    def build(self):
        """(graph, in_specs, out_specs) — traced on first call, cached."""
        if self._built is None:
            self._built = self._builder()
        return self._built

    def sample_values(self, rng: random.Random) -> list:
        return self._sample(rng)

    def encrypt(self, ic, generator: torch.Generator, values: list) -> list:
        """Encrypt the flat value list per the graph's input specs (a
        shape-(V,) spec consumes V ints, concatenated on the digit
        axis exactly as the interpreter expects).  Every integer's digits
        are drawn from `generator` in order, where the reference splits a
        JAX key per integer; the generator lives on the keys' device."""
        _, in_specs, _ = self.build()
        enc, vals = [], iter(values)
        for spec in in_specs:
            n = int(np.prod(spec.shape)) if spec.shape else 1
            digs = [ic.encrypt(generator, int(next(vals)) % spec.modulus,
                               spec.bits, spec.msg_bits).digits
                    for _ in range(n)]
            enc.append(torch.cat(digs, dim=0) if n > 1 else digs[0])
        return enc

    def decrypt(self, ic, outputs: list) -> list:
        """Flat list of output ints (client side)."""
        from repro_torch.serve.programs import decrypt_radix_output
        _, _, out_specs = self.build()
        res = []
        for spec, arr in zip(out_specs, outputs):
            res.extend(decrypt_radix_output(ic, arr, spec.bits,
                                            spec.msg_bits))
        return res

    def __repr__(self):
        return f"Workload({self.name!r})"


# --------------------------------------------------------------------------
# builders
# --------------------------------------------------------------------------

def _uniform(n: int, bits: int):
    mod = 1 << bits
    return lambda rng: [rng.randrange(mod) for _ in range(n)]


def _binop(name: str, fn, oracle_fn, bits: int, msg_bits: int,
           mean_service_s: float) -> Workload:
    spec = IntSpec(bits, msg_bits)
    mod = 1 << bits

    def builder():
        prog = trace_program(fn, (spec, spec))
        return prog.graph, prog.in_specs, prog.out_specs

    return Workload(name, builder, _uniform(2, bits),
                    lambda v: [oracle_fn(v[0], v[1]) % mod],
                    mean_service_s)


def radix_add(bits: int = 8, msg_bits: int = 2) -> Workload:
    return _binop("radix_add", lambda a, b: a + b, lambda x, y: x + y,
                  bits, msg_bits, mean_service_s=0.6)


def radix_mul(bits: int = 8, msg_bits: int = 2) -> Workload:
    return _binop("radix_mul", lambda a, b: a * b, lambda x, y: x * y,
                  bits, msg_bits, mean_service_s=1.6)


def radix_relu(bits: int = 8, msg_bits: int = 2) -> Workload:
    spec = IntSpec(bits, msg_bits)
    mod = 1 << bits

    def builder():
        prog = trace_program(lambda a: a.relu(), (spec,))
        return prog.graph, prog.in_specs, prog.out_specs

    return Workload("radix_relu", builder, _uniform(1, bits),
                    lambda v: [0 if v[0] >= mod // 2 else v[0]],
                    mean_service_s=0.8)


def analytics_const(bits: int = 8, msg_bits: int = 2) -> Workload:
    """k*x + c with plaintext constants — pure-LPU traffic (zero PBS
    rounds), the cheap high-rate tenant in a mixed scenario.  Constants
    are picked to stay inside the carry window at the given digit size,
    so no renormalization PBS sneaks in."""
    k, c = (3, 41) if msg_bits >= 2 else (2, 1)
    spec = IntSpec(bits, msg_bits)
    mod = 1 << bits

    def builder():
        prog = trace_program(lambda x: x * k + c, (spec,))
        return prog.graph, prog.in_specs, prog.out_specs

    return Workload("analytics_const", builder, _uniform(1, bits),
                    lambda v: [(k * v[0] + c) % mod],
                    mean_service_s=0.02)


def analytics_linear(bits: int = 8, msg_bits: int = 2,
                     v: int = 2) -> Workload:
    """radix_linear analytics query: an encrypted length-`v` record
    against a plaintext aggregation matrix."""
    W = (np.arange(v * v).reshape(v, v) % 3 - 1).astype(np.int64)
    W[0, 0] = 2                      # keep the matrix non-degenerate
    spec = IntSpec(bits, msg_bits, shape=(v,))
    mod = 1 << bits

    def builder():
        prog = trace_program(lambda x: x.linear(W), (spec,))
        return prog.graph, prog.in_specs, prog.out_specs

    def oracle(vals):
        q = np.asarray(vals, np.int64)
        return [int(x) % mod for x in q @ W]

    return Workload("analytics_linear", builder, _uniform(v, bits), oracle,
                    mean_service_s=1.2)


def gpt2_block(bits: int = 16, msg_bits: int = 2, d: int = 2,
               seed: int = 0) -> Workload:
    """Encrypted-transformer traffic: the reduced single-head GPT-2
    block of `repro_torch.fhe_ml.lower` (PBS-heaviest workload by far —
    use sparingly in scenario mixes)."""
    from repro_torch.serve.programs import fhe_ml_block_program
    graph, meta = fhe_ml_block_program("gpt2", d, bits, msg_bits,
                                       seed=seed)
    mod = 1 << bits
    qmax = int(meta["input_qmax"])

    def oracle(vals):
        return [int(x) % mod for x in meta["int_fn"](vals)]

    return Workload(
        "gpt2_block",
        lambda: (graph, meta["in_specs"], meta["out_specs"]),
        lambda rng: [rng.randrange(qmax + 1) for _ in range(d)],
        oracle, mean_service_s=18.0)


REGISTRY = {
    "radix_add": radix_add,
    "radix_mul": radix_mul,
    "radix_relu": radix_relu,
    "analytics_const": analytics_const,
    "analytics_linear": analytics_linear,
    "gpt2_block": gpt2_block,
}


class WorkloadMix:
    """Weighted distribution over workloads.  Construct from instances
    (`WorkloadMix([(w, 3.0), ...])`) or names via `WorkloadMix.of`
    (`WorkloadMix.of({"radix_add": 3, "analytics_const": 1}, bits=8,
    msg_bits=2)`)."""

    def __init__(self, entries: list):
        if not entries:
            raise ValueError("empty workload mix")
        self.entries = [(w, float(wt)) for w, wt in entries]
        total = sum(wt for _, wt in self.entries)
        if total <= 0:
            raise ValueError("workload mix weights must sum > 0")
        self._total = total

    @classmethod
    def of(cls, weights: dict, **kw) -> "WorkloadMix":
        return cls([(REGISTRY[name](**kw), wt)
                    for name, wt in weights.items()])

    @property
    def workloads(self) -> list:
        return [w for w, _ in self.entries]

    def sample(self, rng: random.Random) -> Workload:
        u = rng.random() * self._total
        acc = 0.0
        for w, wt in self.entries:
            acc += wt
            if u < acc:
                return w
        return self.entries[-1][0]
