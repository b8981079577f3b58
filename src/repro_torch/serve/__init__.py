"""The serving layer.  Ported so far: `IrInterpreter`, the IR execution
contract the `local` backend runs.  The fused round scheduler, the
shards and the runtime are not ported yet."""
from repro_torch.serve.interpreter import IrInterpreter  # noqa: F401
