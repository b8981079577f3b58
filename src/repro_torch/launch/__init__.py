"""Launch-time helpers.  Ported so far: `mesh.shard_devices`, the device
assignment of the serving shards."""
