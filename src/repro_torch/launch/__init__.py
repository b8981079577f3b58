"""Launch-time helpers.  Ported so far: `mesh.shard_devices` (the device
assignment of the serving shards), `roofline` (the card's peaks and the
per-round PBS traffic model) and `pbs_dryrun` (the batched PBS against
the per-ciphertext XPU loop, as roofline terms)."""
