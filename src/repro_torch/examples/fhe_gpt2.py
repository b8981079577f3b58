"""Encrypted GPT-2 block inference, in both activation representations,
on the port.

    python -m repro_torch.examples.fhe_gpt2 [--device cpu]

Part 1 (narrow-LUT): quantizes a single-head GPT-2-style block to 3-bit
affine activations, lowers it to requant-LUT FHE IR, runs attention and
the GELU MLP under real TFHE, and checks the decrypted output against the
plaintext integer oracle bit for bit; then what the same graph costs on
the Taurus accelerator model.

Part 2 (quantize-to-radix): the same block shape on 16-bit two's-
complement radix activations, traced into ONE program that runs on the
eager backend and through `Session(ctx, backend="serve")`, whose radix
rounds fuse in the multi-tenant runtime.  The port of `examples/fhe_gpt2.py`.
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.api import Session
from repro_torch.compiler import TaurusModel, build_schedule, passes
from repro_torch.core.params import PAPER_PARAMS, TEST_PARAMS_4BIT, TEST_PARAMS_6BIT
from repro_torch.core.pbs import TFHEContext
from repro_torch.device import resolve_device
from repro_torch.examples import generator, parser
from repro_torch.fhe_ml import executor, lower
from repro_torch.fhe_ml.quantize import (QuantSpec, RadixQuantSpec, calibrate_radix,
                                         dequantize_radix, quantize_to_radix)

NARROW_D, RADIX_D, BITS, MSG_BITS = 4, 2, 16, 2


def narrow_inputs():
    """The narrow block's graph, its 3-bit input and its plaintext oracle."""
    g, _ = lower.lower_gpt2_block(NARROW_D, QuantSpec(3, 0.25, 4), TEST_PARAMS_6BIT.width,
                                  seed=1)
    x = np.random.default_rng(0).integers(0, 8, (NARROW_D,))
    want = executor.interpret(g, [x], TEST_PARAMS_6BIT.width)[g.outputs[0]]
    return g, x, want


def radix_inputs():
    """The radix block's graph and meta, its float and quantized input,
    the quantization, and its integer oracle mod 2^BITS."""
    g, meta = lower.lower_gpt2_block_radix(RADIX_D, bits=BITS, msg_bits=MSG_BITS, seed=1)
    xf = np.random.default_rng(3).uniform(-1, 1, size=(RADIX_D,))
    rq = calibrate_radix(xf, BITS, MSG_BITS, qmax=meta["input_qmax"])
    q = quantize_to_radix(xf, rq)
    return g, meta, xf, rq, q, np.asarray(meta["int_fn"](q)) % (1 << BITS)


def narrow_lut_demo(device) -> None:
    print("== encrypted GPT-2 block (narrow-LUT, 3-bit activations) ==")
    p = TEST_PARAMS_6BIT
    print(f"scheme: n={p.n} N={p.N} width={p.width}")
    g, x, want = narrow_inputs()
    n_lut = sum(n.n_elements for n in g.nodes if n.op == "lut")
    print(f"graph: {len(g.nodes)} nodes, {n_lut} PBS applications")

    ctx = TFHEContext.create(generator(device, 42), p, device=device)
    sess = Session(ctx, backend="eager")
    prog = sess.compile(g)
    print(f"input (3-bit quantized): {x}")
    enc = sess.encrypt_inputs(generator(device, 7), [x], prog)
    got = sess.decrypt_outputs(prog, sess.run(prog, enc))[0]
    print(f"decrypted output = {' '.join(map(str, got))}   "
          f"(expect {' '.join(map(str, want))})")
    assert np.array_equal(got, want), "FHE != oracle!"
    print(f"bit-exact   engine stats: {sess.backend.stats}")

    ops, stats = passes.lower_to_physical(g)
    sched = build_schedule(ops)
    t, util = TaurusModel(PAPER_PARAMS["gpt2"]).bandwidth_bound_runtime(sched)
    print(f"\nTaurus model @ paper GPT-2 params: {t * 1e3:.2f} ms "
          f"({sched.total_pbs} PBS, util {util:.0%}, "
          f"KS-dedup saved {stats.ks_saved_frac:.0%})")


def radix_serve_demo(device) -> None:
    p = TEST_PARAMS_4BIT
    print(f"\n== encrypted GPT-2 block (quantize-to-radix, {BITS}-bit activations) "
          "on the serve path ==")
    print(f"scheme: n={p.n} N={p.N} width={p.width} "
          f"(digits of {MSG_BITS} message bits, D={BITS // MSG_BITS})")
    g, meta, xf, rq, q, want = radix_inputs()
    print(f"graph: {len(g.nodes)} nodes "
          f"({[n.op for n in g.nodes if n.op != 'input']}), "
          f"{g.lut_applications()} planned PBS applications, "
          f"input_qmax={meta['input_qmax']}")
    print(f"input (float): {xf}\ninput (radix-quantized): {q}  scale={rq.scale:.4g}")

    ctx = TFHEContext.create(generator(device, 42), p, device=device)
    with Session(ctx, backend="eager") as sess:
        prog = sess.compile(g, meta["in_specs"], meta["out_specs"])
        eager_out = np.asarray(sess(prog, generator(device, 7), q)[0])
    with Session(ctx, backend="serve") as sess:
        prog = sess.compile(g, meta["in_specs"], meta["out_specs"])
        serve_out = np.asarray(sess(prog, generator(device, 7), q)[0])
        sched = sess.backend.scheduler
        print(f"serve scheduler: {sched.stats['fused_rounds']} fused rounds, "
              f"occupancy {sched.mean_occupancy:.0%}, "
              f"{sched.stats['logical_luts']} logical LUTs")

    print(f"decrypted (eager) = {' '.join(map(str, eager_out % (1 << BITS)))}   "
          f"(expect {' '.join(map(str, want))})")
    print(f"decrypted (serve) = {' '.join(map(str, serve_out % (1 << BITS)))}   "
          f"(expect {' '.join(map(str, want))})")
    assert np.array_equal(eager_out % (1 << BITS), want), "FHE != oracle!"
    assert np.array_equal(eager_out, serve_out), "serve != eager!"

    out_rq = RadixQuantSpec(BITS, MSG_BITS, rq.scale ** meta["out_scale_pow"])
    yhat = dequantize_radix(eager_out, out_rq)
    yf = meta["float_fn"](xf)
    print(f"dequantized: {yhat}\nfloat model: {yf}")
    print("bit-exact across backends "
          f"(max |dequant - float| = {np.max(np.abs(yhat - yf)):.3g})")

    ops, _ = passes.lower_to_physical(g)
    sched_m = build_schedule(ops)
    t, util = TaurusModel(PAPER_PARAMS["gpt2"]).bandwidth_bound_runtime(sched_m)
    print(f"Taurus model @ paper GPT-2 params: {t * 1e3:.2f} ms "
          f"({sched_m.total_pbs} PBS, util {util:.0%})")


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    narrow_lut_demo(device)
    radix_serve_demo(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
