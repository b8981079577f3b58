"""Quickstart: multi-bit TFHE in 60 seconds, on the port.

    python -m repro_torch.examples.quickstart [--device cpu]

Shows the paper's Figure-2(b) programming model: linear ops are
bootstrap-free; arbitrary functions are LUTs evaluated by programmable
bootstrapping (PBS).  The port of `examples/quickstart.py`.
"""
from __future__ import annotations

import sys

from repro_torch.core.params import TEST_PARAMS_4BIT
from repro_torch.core.pbs import TFHEContext
from repro_torch.device import resolve_device
from repro_torch.examples import generator, parser

A, B = 5, 9
SQUARE_MOD16 = [(i * i) % 16 for i in range(16)]
RELU_SHIFT = [max(i - 8, 0) for i in range(16)]


def wants() -> dict:
    """The demo's plaintext oracles."""
    return {"a+b": (A + B) % 16, "2a+b": (2 * A + B) % 16, "a^2": (A * A) % 16,
            "relu(a+b-8)": max((A + B) % 16 - 8, 0)}


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    params = TEST_PARAMS_4BIT            # 4-bit messages
    print(f"params: n={params.n} N={params.N} k={params.k} width={params.width} "
          f"on {device}")
    ctx = TFHEContext.create(generator(device, 0), params, device=device)
    gen = generator(device, 1)
    want = wants()

    # --- encrypt two 4-bit integers ---------------------------------------
    ct_a = ctx.encrypt(gen, A)
    ct_b = ctx.encrypt(gen, B)
    print(f"encrypt({A}), encrypt({B})  ->  {ct_a.shape[-1]}-element LWE cts")

    # --- linear ops: no bootstrapping -------------------------------------
    ct_sum = ct_a + ct_b                 # homomorphic addition (wrapping)
    ct_lin = ct_a * 2 + ct_b             # 2a + b with a plaintext scalar
    print(f"dec(a+b)    = {int(ctx.decrypt(ct_sum))}   (expect {want['a+b']})")
    print(f"dec(2a+b)   = {int(ctx.decrypt(ct_lin))}   (expect {want['2a+b']})")

    # --- a LUT via programmable bootstrapping ------------------------------
    ct_sq = ctx.lut(ct_a, SQUARE_MOD16)
    print(f"dec(a^2)    = {int(ctx.decrypt(ct_sq))}   (expect {want['a^2']})")

    # PBS also refreshes noise: chain as many as you like
    ct_relu = ctx.lut(ct_sum, RELU_SHIFT)
    print(f"relu(a+b-8) = {int(ctx.decrypt(ct_relu))}   (expect {want['relu(a+b-8)']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
