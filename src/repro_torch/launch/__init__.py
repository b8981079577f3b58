"""Launch-time helpers: the port of `repro.launch`.

`mesh` (the serving shards' device assignment, the engine's cluster
mesh, the LM stack's host mesh and sharding rules, and the dry run's
fake production meshes and input specs), `roofline` (the card's peaks,
the per-round PBS traffic model and the LM stack's `model_flops`),
`pbs_dryrun` (the batched PBS against the per-ciphertext XPU loop, as
roofline terms), `steps` (the train, prefill and serve steps, and the dry
run's cells), `op_analysis` (per-device op counts of a step, the role of
the reference's `hlo_analysis`), `dryrun` and `report` (every LM cell on
fake 256- and 512-rank meshes, as roofline tables), `serve` (the LM
serving driver) and `train` (the LM training driver)."""
