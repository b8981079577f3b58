"""Runtime policies: fault-tolerant step execution (`StepRunner`,
`FaultConfig`), elastic meshes (`ElasticMesh`) and per-shard admission
(`ElasticPolicy`, `ElasticAdmission`) and int8 gradient compression
(`Int8Compressor`)."""
from repro_torch.runtime.compress import Int8Compressor  # noqa: F401
from repro_torch.runtime.elastic import (ElasticAdmission, ElasticMesh,  # noqa: F401
                                         ElasticPolicy)
from repro_torch.runtime.fault import FaultConfig, StepRunner  # noqa: F401
