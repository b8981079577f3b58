"""Runtime policies the serving stack uses: fault-tolerant step
execution (`StepRunner`, `FaultConfig`) and elastic per-shard admission
(`ElasticPolicy`, `ElasticAdmission`)."""
from repro_torch.runtime.elastic import ElasticAdmission, ElasticPolicy  # noqa: F401
from repro_torch.runtime.fault import FaultConfig, StepRunner  # noqa: F401
