"""The port's front door: one traced program contract for eager,
in-process and served FHE (the port of `repro.api`).

    from repro_torch.api import Session, IntSpec

    sess = Session(ctx, backend="local", kernel_backend="fused")
    prog = sess.trace(lambda a, b: (a * b).relu(),
                      IntSpec(16), IntSpec(16))     # operators record IR
    enc  = sess.encrypt_inputs(generator, [x, y], prog)
    vals = sess.decrypt_outputs(prog, sess.run(prog, enc))

  tracing   `EncryptedInt` / `EncryptedTensor`: Python operators record
            `radix_*`/linear/`lut` nodes into a
            `repro_torch.compiler.ir.Graph`.
  session   `Session.trace` -> `Program`; `Session.compile` adopts
            hand-lowered graphs (`repro_torch.fhe_ml`);
            encrypt/run/decrypt.
  backends  `EagerBackend` (direct IntegerContext + KS/ACC-dedup PBS),
            `LocalBackend` (`serve.IrInterpreter`, optionally over a
            private fused scheduler), `ServeBackend` (the multi-tenant
            `serve.ServeRuntime`; `Session.submit` is its async path).
"""
from repro_torch.api.backends import (Backend, EagerBackend, LocalBackend,  # noqa: F401
                                      ServeBackend, eval_linear_ct_op,
                                      eval_radix_vector, make_backend)
from repro_torch.api.session import Program, Session, trace_program  # noqa: F401
from repro_torch.api.tracing import (EncryptedInt, EncryptedTensor,  # noqa: F401
                                     EncryptedValue, IntSpec, RawSpec, TensorSpec)
