"""Launch-time helpers.  Ported so far: `mesh` (the serving shards'
device assignment, the engine's cluster mesh, the LM stack's host mesh
and its sharding rules), `roofline` (the card's peaks, the
per-round PBS traffic model and the LM stack's `model_flops`),
`pbs_dryrun` (the batched PBS against the per-ciphertext XPU loop, as
roofline terms), `steps` (the prefill and serve steps), `serve` (the LM
serving driver) and `train` (the LM training driver).  The dry run
(`make_production_mesh`, `input_specs`, `steps.shaped_*` / `lower_cell`,
`dryrun`) is not ported yet."""
