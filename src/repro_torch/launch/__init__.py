"""Launch-time helpers.  Ported so far: `mesh.shard_devices` (the device
assignment of the serving shards), `roofline` (the card's peaks, the
per-round PBS traffic model and the LM stack's `model_flops`),
`pbs_dryrun` (the batched PBS against the per-ciphertext XPU loop, as
roofline terms), `steps` (the prefill and serve steps), `serve` (the LM
serving driver) and `train.reduced_config`."""
