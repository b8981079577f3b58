"""Encrypted 32-bit integers from multi-bit TFHE digits, on the port.

    python -m repro_torch.examples.encrypted_int32 [--device cpu]

The paper's multi-bit message space turns into wide integers by the
radix construction: a 32-bit value is a vector of digits, linear ops are
bootstrap-free, and every carry-propagation round is ONE batched PBS
through the round-robin engine.  The port of `examples/encrypted_int32.py`.
"""
from __future__ import annotations

import sys

from repro_torch.api import IntSpec, Session
from repro_torch.core.engine import TaurusEngine
from repro_torch.core.integer import IntegerContext
from repro_torch.core.params import TEST_PARAMS_4BIT
from repro_torch.core.pbs import TFHEContext
from repro_torch.device import resolve_device
from repro_torch.examples import generator, parser

X = 0xDEADBEEF
A, B = 51234, 17777
NEG, POS = -1234, 1234


def wants() -> dict:
    """The demo's plaintext oracles."""
    return {"x": X, "a+b": (A + B) % 2 ** 16, "a*b": (A * B) % 2 ** 16,
            "b-a": (B - A) % 2 ** 16, "relu(-1234)": 0, "relu(+1234)": POS,
            "compare": 2, "a<b": int(A < B)}


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    params = TEST_PARAMS_4BIT            # 4-bit window: 2 msg + 2 carry bits
    ctx = TFHEContext.create(generator(device, 0), params, device=device)
    ic = IntegerContext.create(ctx, TaurusEngine.from_context(ctx, device=device))
    want = wants()

    # --- 32-bit round trip ------------------------------------------------
    ct = ic.encrypt(generator(device, 1), X, 32)
    print(f"encrypt(0x{X:08X}) -> {ct.spec.n_digits} digit ciphertexts "
          f"({ct.spec.msg_bits} msg bits each)")
    print(f"decrypt            = 0x{ic.decrypt(ct):08X}   (expect 0x{want['x']:08X})")

    # --- 16-bit arithmetic: every carry round is one lut_batch -------------
    ca = ic.encrypt(generator(device, 2), A, 16)
    cb = ic.encrypt(generator(device, 3), B, 16)

    ic.reset_stats()
    s = ic.add(ca, cb)
    print(f"dec(a+b) = {ic.decrypt(s):5d}   (expect {want['a+b']}; "
          f"{ic.stats['lut_batches']} PBS batches, "
          f"min batch {min(ic.stats['batch_sizes'])} of "
          f"{ca.spec.n_digits} digits)")

    ic.reset_stats()
    m = ic.mul(ca, cb)
    print(f"dec(a*b) = {ic.decrypt(m):5d}   (expect {want['a*b']}; "
          f"{ic.stats['lut_batches']} PBS batches, {ic.stats['pbs']} PBS)")

    d = ic.sub(cb, ca)                     # wraps mod 2^16
    print(f"dec(b-a) = {ic.decrypt(d):5d}   (expect {want['b-a']})")

    # --- signed ReLU clamp --------------------------------------------------
    r = ic.relu_clamp(ic.encrypt(generator(device, 4), NEG, 16))
    print(f"relu(-1234) = {ic.decrypt(r)}   (expect {want['relu(-1234)']})")
    r2 = ic.relu_clamp(ic.encrypt(generator(device, 5), POS, 16))
    print(f"relu(+1234) = {ic.decrypt(r2)}   (expect {want['relu(+1234)']})")

    # --- encrypted comparison ----------------------------------------------
    verdict = int(ctx.decrypt(ic.compare(ca, cb)))
    print(f"compare(a, b) = {verdict}   (0 eq / 1 lt / 2 gt; expect {want['compare']})")

    # --- the same arithmetic, traced once through the api front door -------
    prog = None
    for backend in ("eager", "local"):
        sess = Session(ctx, ic.engine, backend=backend)
        prog = prog or sess.trace(lambda x, y: (x + y, x * y, x < y),
                                  IntSpec(16), IntSpec(16))
        s2, m2, lt = sess(prog, generator(device, 9), A, B)
        print(f"traced/{backend:5s}: a+b={s2}, a*b={m2}, "
              f"[a<b]={int(lt[0])}   (expect {want['a+b']}, {want['a*b']}, {want['a<b']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
