"""repro_torch.serve — the multi-tenant FHE serving runtime, the port of
`repro.serve`.

The compiler (`repro_torch.compiler`) plans programs and the engine
(`repro_torch.core.engine.TaurusEngine`) executes batched PBS on the
card; this package serves CONCURRENT clients, turning the paper's two
throughput levers — key-reuse-aware batching of bootstraps and
operation deduplication — into online, cross-request mechanisms:

  interpreter  `IrInterpreter` executes compiled `repro_torch.compiler.ir`
               graphs (including the radix_* wide-integer ops) on real
               ciphertexts, routing every bootstrap through
               `engine.lut_batch`.
  scheduler    `FusedLutScheduler` barriers the in-flight requests'
               ready LUT rounds, groups them by engine (parameter set /
               bootstrapping key), deduplicates identical (ciphertext,
               table) rows online, and dispatches ONE fused `lut_batch`
               per group — the BSK streams once for everyone (paper
               §III-B, Fig. 13).
  shard        `EngineShard` / `build_shards`: per-shard engine, fusion
               barrier and concurrency limit behind the router.
  runtime      `ServeRuntime` is the async front door: request queue,
               admission control (`max_inflight`,
               `max_queued_per_client`), round-robin per-client
               fairness, placement over shards, and fault retry through
               `repro_torch.runtime.fault.StepRunner`.
  programs     client-side helpers that trace radix programs into IR and
               encrypt/decrypt their inputs/outputs —
               `fhe_ml_block_program` mints quantized-to-radix
               transformer blocks (encrypted-LLM traffic).

Typical serving loop::

    ctx = TFHEContext.create(generator, params)    # client keys
    rt = ServeRuntime(ctx, max_inflight=8)         # server
    g = radix_binop_program("radix_add", bits=16, msg_bits=2)
    h = rt.submit(g, encrypt_request_inputs(ic, generator, [a, b], 16), "alice")
    result = decrypt_radix_output(ic, h.outputs()[0], 16)   # client
"""
from repro_torch.core.engine import ConfigError
from repro_torch.serve.interpreter import IrInterpreter
from repro_torch.serve.programs import (decrypt_radix_output,
                                        encrypt_request_inputs,
                                        fhe_ml_block_program,
                                        radix_binop_program, radix_unop_program)
from repro_torch.serve.runtime import (AdmissionError, OutputFuture,
                                       RequestAbandonedError, RequestHandle,
                                       RuntimeClosedError, ServeRequest,
                                       ServeRuntime, SubmitValidationError)
from repro_torch.serve.scheduler import FusedEngineProxy, FusedLutScheduler
from repro_torch.serve.shard import EngineShard, build_shards

__all__ = [
    "AdmissionError", "ConfigError", "EngineShard", "FusedEngineProxy",
    "FusedLutScheduler",
    "IrInterpreter", "OutputFuture", "RequestAbandonedError",
    "RequestHandle", "RuntimeClosedError",
    "ServeRequest", "ServeRuntime", "SubmitValidationError",
    "build_shards",
    "decrypt_radix_output", "encrypt_request_inputs",
    "fhe_ml_block_program", "radix_binop_program", "radix_unop_program",
]
