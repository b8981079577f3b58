"""A stand-in PBS for CPU tests: it decrypts each row with the client's
key, looks the message up in the row's test polynomial and encrypts the
result afresh.  Same contract as the engine's `lut_batch`, no kernels."""
import dataclasses

import torch

from perfbench import client, harness

TINY = {"n": 32, "N": 256, "k": 1, "width": 4, "pbs_base_log": 16, "pbs_level": 2,
        "ks_base_log": 4, "ks_level": 4, "lwe_std": 2.0 ** -45, "glwe_std": 2.0 ** -45,
        "padding_bits": 1}


def standin_lut_batch(keys: client.ClientKeys, gen: torch.Generator):
    p = keys.params
    reps = p.N // p.modulus
    shift = p.delta.bit_length() - 1

    def lut_batch(cts, polys):
        ph = client.phase(keys, cts.to(keys.big_sk.device))
        idx = ((ph + (p.delta >> 1)) >> shift) & ((1 << (64 - shift)) - 1)
        idx = idx % (2 * p.modulus)
        col = (idx % p.modulus) * reps
        val = torch.gather(polys.to(idx.device), 1, col[:, None])[:, 0]
        val = torch.where(idx < p.modulus, val, -val)
        return client.lwe_encrypt(gen, keys.big_sk, val, p.glwe_std)
    return lut_batch


def install(engine, keys, lut_batch):
    """Put `lut_batch` in the engine's place, the keyswitch split too."""
    engine.lut_batch = lut_batch
    engine.keyswitch = lambda cts: cts
    engine.lut_batch_small = lut_batch


def standin_hook(engine, keys):
    install(engine, keys, standin_lut_batch(keys, torch.Generator().manual_seed(7)))


CELL = "uint8-saturated"


def tiny_spec(workload: str = CELL, params=None, **traffic) -> dict:
    """The cell's spec at a size a CPU test holds."""
    spec = harness.cell_spec(workload)
    spec["config"] = dict(spec["config"], params=dict(params or TINY))
    spec["traffic"] = dict(spec["traffic"], **traffic)
    return spec


def run(workload: str = CELL, seconds=1.5, trace=False, hook=standin_hook, seed=5, spec=None,
        **traffic):
    return harness.run_cell(workload, seed, seconds, trace, device="cpu",
                            spec=spec or tiny_spec(workload, **traffic), engine_hook=hook,
                            log=lambda *a: None)
