"""Device assignment for the sharded `ServeRuntime`.

The port of `repro.launch.mesh.shard_devices` alone.  The reference's
production meshes and sharding rules (`make_production_mesh`,
`shard_mesh`, ...) serve its JAX engine mesh path and LM stack, which
are not ported: on one card the engine is one cluster.
"""
from __future__ import annotations

import torch


def shard_devices(n_shards: int, devices=None) -> list:
    """Device -> serving-shard assignment: partition the device list
    into `n_shards` per-shard device tuples.

    `devices` defaults to every visible CUDA device.  With >= n_shards
    devices, each shard gets a contiguous slice of
    len(devices) // n_shards devices (remainder devices are left idle so
    shards stay symmetric).  With FEWER devices than shards (one card or
    the CPU, several shards), shards share devices round-robin — shard i
    gets device i % n_devices; oversubscription is explicit in the
    returned assignment rather than hidden.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if not devs:
        raise RuntimeError("no devices available for shard assignment")
    if len(devs) >= n_shards:
        per = len(devs) // n_shards
        return [tuple(devs[i * per:(i + 1) * per]) for i in range(n_shards)]
    return [(devs[i % len(devs)],) for i in range(n_shards)]
