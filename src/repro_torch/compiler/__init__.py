"""The companion compiler (paper §V), ported as a copy of `repro.compiler`.

FHELinAlg-style tensor IR + tracing, the two deduplication passes
(KS-dedup, ACC-dedup), the batch scheduler with BRU/LPU overlap, and the
paper's Taurus cycle/bandwidth cost model.  Numpy only: the reference
package reaches JAX through `repro.compiler.workloads`, so the port keeps
its own copy.
"""
from repro_torch.compiler.ir import Graph, FheTensor, trace  # noqa: F401
from repro_torch.compiler.passes import lower_to_physical, DedupStats  # noqa: F401
from repro_torch.compiler.schedule import Schedule, build_schedule  # noqa: F401
from repro_torch.compiler.cost import TaurusModel, CpuModel, GpuModel  # noqa: F401
