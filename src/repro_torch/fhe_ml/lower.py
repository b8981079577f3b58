"""Lower quantized NN blocks to the FHE IR.

The port's copy of `repro.fhe_ml.lower`, on `repro_torch.compiler.ir`
and `repro_torch.api.tracing`: numpy only, and the weights come from the
same `default_rng` streams, so every lowered graph equals the
reference's node for node.

Two lowering families:

*Narrow-LUT* (Concrete-ML style, `lower_mlp` / `lower_gpt2_block`):
activations are single width-bit ciphertexts; every layer ends in a
requant PBS.  RANGE DISCIPLINE: every value entering a LUT must lie in
[0, 2^width) — one padding bit — otherwise programmable bootstrapping
negacyclically flips the result (dec = 2^w - T[x]).  Lowerings keep
signed accumulators as OFFSET-shifted unsigned values
(offset = 2^(width-1)) and size weights / activation widths so the
bound holds; `executor.interpret(..., check_range=True)` verifies it on
every run.

*Quantize-to-radix* (`lower_mlp_radix` / `lower_gpt2_block_radix`): the
paper's 16/32-bit encrypted-activation path.  Activations are radix
digit vectors (`repro_torch.core.integer`), linear layers lower to
tensor-level `radix_linear` nodes (exact integer matmul — NO requant LUT) and
the activation is two's-complement `radix_relu`.  RANGE DISCIPLINE:
interval arithmetic propagates worst-case magnitudes through the block
and `quantize.check_radix_range` certifies every intermediate stays
below 2^(bits-1); the largest input magnitude that passes is returned
as meta["input_qmax"], which `calibrate_radix` turns into the
quantization scale.  These graphs carry ready-made IntSpec in/out specs
so `Session.compile(graph, **specs)` runs them on any backend ("eager"
and "local"; the multi-tenant "serve" runtime is not ported yet).
"""
from __future__ import annotations

import numpy as np

from repro_torch.api.tracing import IntSpec
from repro_torch.compiler.ir import FheTensor, trace
from repro_torch.fhe_ml.quantize import QuantSpec, check_radix_range


def _gelu(x):
    return x * 0.5 * (1 + np.tanh(0.7978845608 * (x + 0.044715 * x ** 3)))


def _clip_w(w, mag=1):
    """Quantize weights to small ints {-mag..mag}; returns (W, scale)."""
    s = (np.max(np.abs(w)) + 1e-9) / mag
    return np.clip(np.round(w / s), -mag, mag).astype(np.int64), s


def _requant_lut(width: int, offset: int, acc_scale: float, out_qmax: int,
                 out_zero: int, out_scale: float, fn=None) -> np.ndarray:
    """Index i = acc + offset; signed acc = i - offset; output quantized
    to [0, out_qmax]."""
    n = 1 << width
    acc = np.arange(n) - offset
    xs = acc * acc_scale
    if fn is not None:
        xs = fn(xs)
    q = np.round(xs / out_scale) + out_zero
    return np.clip(q, 0, out_qmax).astype(np.uint64)


def lower_mlp(w1: np.ndarray, w2: np.ndarray, in_spec: QuantSpec,
              width: int, act="gelu"):
    """x -> requant(GELU(x@W1)) @ W2 -> requant, range-safe for `width`.

    Bounds: inputs q in [0, in_qmax], weights in {-1,0,1}:
      |acc1| <= in_qmax * d_in   and   |acc2| <= h_qmax * d_h,
    both required < 2^(width-1).
    """
    offset = 1 << (width - 1)
    fn = _gelu if act == "gelu" else (lambda x: np.maximum(x, 0))
    W1, s1 = _clip_w(w1)
    W2, s2 = _clip_w(w2)
    d_in, d_h = W1.shape

    h_qmax = 3                               # 2-bit hidden activations
    assert in_spec.qmax * d_in < offset, "acc1 overflows the padding bit"
    assert h_qmax * d_h < offset, "acc2 overflows the padding bit"

    acc1_scale = in_spec.scale * s1
    h_scale = acc1_scale * in_spec.qmax * d_in / (2 * h_qmax)
    h_spec = QuantSpec(width, h_scale, h_qmax // 2 + 1)
    acc2_scale = h_scale * s2
    out_qmax = (1 << width) - 1
    out_scale = acc2_scale * h_qmax * d_h / out_qmax
    out_spec = QuantSpec(width, out_scale, offset // 2)

    t1 = _requant_lut(width, offset, acc1_scale, h_qmax, h_spec.zero,
                      h_spec.scale, fn)
    t2 = _requant_lut(width, offset, acc2_scale, out_qmax, out_spec.zero,
                      out_spec.scale, None)

    def f(x):
        a = x.linear(W1) + (offset - in_spec.zero * W1.sum(axis=0))
        h = a.lut(t1, name="gelu_requant")
        b = h.linear(W2) + (offset - h_spec.zero * W2.sum(axis=0))
        return b.lut(t2, name="out_requant")
    g = trace(f, (d_in,))
    meta = {"in_spec": in_spec, "h_spec": h_spec, "out_spec": out_spec,
            "W1": W1, "W2": W2, "s1": s1, "s2": s2, "offset": offset}
    return g, meta


# ---------------------------------------------------------------------------
# quantize-to-radix lowerings (16/32-bit encrypted activations)
# ---------------------------------------------------------------------------

def _interval_linear(lo, hi, W):
    """Interval bounds of x @ W for elementwise x in [lo, hi]."""
    Wp, Wn = np.clip(W, 0, None), np.clip(-W, 0, None)
    return lo @ Wp - hi @ Wn, hi @ Wp - lo @ Wn


def _interval_mul(la, ha, lb, hb):
    """Interval bounds of the elementwise product a * b."""
    cands = np.stack([la * lb, la * hb, ha * lb, ha * hb])
    return cands.min(axis=0), cands.max(axis=0)


def _max_input_qmax(bound_fn, bits: int, what: str) -> int:
    """Largest integer input magnitude A whose worst-case intermediate
    (bound_fn(A), monotone in A) stays below 2^(bits-1)."""
    half = float(1 << (bits - 1))
    check_radix_range(bits, bound_fn(1), what)     # raises if even A=1 fails
    a = 1
    while bound_fn(2 * a) < half:
        a *= 2
    lo, hi = a, 2 * a
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if bound_fn(mid) < half:
            lo = mid
        else:
            hi = mid
    return lo


def lower_mlp_radix(w1: np.ndarray, w2: np.ndarray, bits: int,
                    msg_bits: int):
    """x -> relu(x @ W1) @ W2 on `bits`-wide radix activations.

    Weights quantize to {-1, 0, 1} (scales s1/s2 ride along in meta);
    the linear layers are EXACT integer `radix_linear` nodes and the
    activation is two's-complement `radix_relu` — no requant LUT, so
    the only approximation error is the input quantization itself.
    Returns (graph, meta) with:

      input_qmax   largest |q| the interval certificate admits — pass to
                   `calibrate_radix(x, bits, msg_bits, qmax=...)`
      in_specs / out_specs   IntSpec lists for `Session.compile`
      int_fn       exact integer oracle q -> q_out
      float_fn     the clipped-weight float model x -> y
      out_scale_mul  s1*s2: y_hat = dequant(q_out) with scale
                   rq.scale * out_scale_mul
      tol_fn       rq -> per-output |y_hat - float_fn(x)| bound
    """
    W1, s1 = _clip_w(w1)
    W2, s2 = _clip_w(w2)
    d_in, d_h = W1.shape
    d_out = W2.shape[1]
    n_digits = bits // msg_bits

    def bound(a):
        lo, hi = np.full(d_in, -float(a)), np.full(d_in, float(a))
        l1, h1 = _interval_linear(lo, hi, W1)
        lr, hr = np.clip(l1, 0, None), np.clip(h1, 0, None)
        l2, h2 = _interval_linear(lr, hr, W2)
        return float(max(np.abs(np.concatenate([l1, h1, l2, h2])).max(), a))

    input_qmax = _max_input_qmax(bound, bits, "MLP accumulator")
    check_radix_range(bits, bound(input_qmax), "MLP accumulator")

    def f(x):
        return x.radix_linear(W1, msg_bits).radix_relu(msg_bits) \
                .radix_linear(W2, msg_bits)
    g = trace(f, (d_in, n_digits))

    def int_fn(q):
        return np.maximum(np.asarray(q, np.int64) @ W1, 0) @ W2

    def float_fn(xf):
        return np.maximum(np.asarray(xf, np.float64) @ (W1 * s1), 0) \
            @ (W2 * s2)

    def tol_fn(rq):
        # |dx| <= scale/2 per input propagates through |W1| then |W2|
        # (relu is 1-Lipschitz); + scale slack for the clip at qmax
        units = np.ones(d_in) @ np.abs(W1) @ np.abs(W2)
        return rq.scale * s1 * s2 * (0.5 * units + 1e-9) + 1e-12

    meta = {"W1": W1, "W2": W2, "s1": s1, "s2": s2,
            "input_qmax": input_qmax,
            "in_specs": [IntSpec(bits, msg_bits, (d_in,))],
            "out_specs": [IntSpec(bits, msg_bits, (d_out,))],
            "int_fn": int_fn, "float_fn": float_fn,
            "out_scale_mul": s1 * s2, "tol_fn": tol_fn}
    return g, meta


def lower_gpt2_block_radix(d: int, bits: int, msg_bits: int, seed=0):
    """Reduced single-head GPT-2-style block on `bits`-wide radix
    activations: ct*ct attention via exact `radix_mul`, ReLU MLP — the
    encrypted-LLM workload (the paper's GPT-2 demonstration on wide
    encrypted activations).

    Unlike the narrow-LUT `lower_gpt2_block`, nothing here requantizes:
    q/k/v projections, attention products and the MLP all run as exact
    integer radix ops, and the interval certificate proves every
    intermediate fits signed `bits`-bit integers for inputs up to
    meta["input_qmax"].  Output values carry scale rq.scale**3 (two
    ct*ct products), exposed as meta["out_scale_pow"].

    Returns (graph, meta); run it with::

        g, meta = lower_gpt2_block_radix(4, bits=16, msg_bits=2)
        rq = calibrate_radix(x, 16, 2, qmax=meta["input_qmax"])
        prog = sess.compile(g, meta["in_specs"], meta["out_specs"])
    """
    rng = np.random.default_rng(seed)
    Wq = rng.integers(-1, 2, (d, d)).astype(np.int64)
    Wk = rng.integers(-1, 2, (d, d)).astype(np.int64)
    Wv = rng.integers(-1, 2, (d, d)).astype(np.int64)
    W1 = rng.integers(-1, 2, (d, 2 * d)).astype(np.int64)
    W2 = rng.integers(-1, 2, (2 * d, d)).astype(np.int64)
    n_digits = bits // msg_bits

    def bound(a):
        lo, hi = np.full(d, -float(a)), np.full(d, float(a))
        lq, hq = _interval_linear(lo, hi, Wq)
        lk, hk = _interval_linear(lo, hi, Wk)
        lv, hv = _interval_linear(lo, hi, Wv)
        ls, hs = _interval_mul(lq, hq, lk, hk)        # attention scores
        lp, hp = _interval_mul(ls, hs, lv, hv)        # score-weighted v
        l1, h1 = _interval_linear(lp, hp, W1)
        lr, hr = np.clip(l1, 0, None), np.clip(h1, 0, None)
        l2, h2 = _interval_linear(lr, hr, W2)
        every = np.concatenate([lq, hq, lk, hk, lv, hv, ls, hs,
                                lp, hp, l1, h1, l2, h2])
        return float(max(np.abs(every).max(), a))

    input_qmax = _max_input_qmax(bound, bits, "GPT-2 block accumulator")
    check_radix_range(bits, bound(input_qmax), "GPT-2 block accumulator")

    def f(x):
        q = x.radix_linear(Wq, msg_bits)
        k = x.radix_linear(Wk, msg_bits)
        v = x.radix_linear(Wv, msg_bits)
        s = q.radix_mul(k, msg_bits)                  # ct*ct attention
        pv = s.radix_mul(v, msg_bits)
        h = pv.radix_linear(W1, msg_bits).radix_relu(msg_bits)
        return h.radix_linear(W2, msg_bits)
    g = trace(f, (d, n_digits))

    def int_fn(q):
        q = np.asarray(q, np.int64)
        qq, kk, vv = q @ Wq, q @ Wk, q @ Wv
        pv = (qq * kk) * vv
        return np.maximum(pv @ W1, 0) @ W2

    def float_fn(xf):
        xf = np.asarray(xf, np.float64)
        qq, kk, vv = xf @ Wq, xf @ Wk, xf @ Wv
        pv = (qq * kk) * vv
        return np.maximum(pv @ W1, 0) @ W2

    meta = {"Wq": Wq, "Wk": Wk, "Wv": Wv, "W1": W1, "W2": W2,
            "input_qmax": input_qmax,
            "in_specs": [IntSpec(bits, msg_bits, (d,))],
            "out_specs": [IntSpec(bits, msg_bits, (d,))],
            "int_fn": int_fn, "float_fn": float_fn, "out_scale_pow": 3}
    return g, meta


def lower_gpt2_block(d: int, in_spec: QuantSpec, width: int, seed=0):
    """Reduced single-head GPT-2-style block under FHE: ct*ct attention
    via requantized square LUTs, GELU MLP.  All LUT inputs provably in
    [0, 2^width) for 3-bit activations and {-1,0,1} weights (see asserts).
    """
    rng = np.random.default_rng(seed)
    offset = 1 << (width - 1)
    n = 1 << width
    a_qmax = 7                               # 3-bit activation lattice

    Wq = rng.integers(-1, 2, (d, d)).astype(np.int64)
    Wk = rng.integers(-1, 2, (d, d)).astype(np.int64)
    Wv = rng.integers(-1, 2, (d, d)).astype(np.int64)
    W1 = rng.integers(-1, 2, (d, 2 * d)).astype(np.int64)
    W2 = rng.integers(-1, 2, (2 * d, d)).astype(np.int64)
    assert in_spec.qmax * d < offset
    assert a_qmax * d < offset and a_qmax * 2 * d < 2 * offset

    # 3-bit requant of a signed accumulator
    req3 = np.clip((np.arange(n) - offset) // 8 + 4, 0, a_qmax).astype(np.uint64)
    # requantized square: ((i-offset)^2 >> 3), clipped to 3 bits
    sq3 = np.clip(((np.arange(n) - offset) ** 2) >> 3, 0, a_qmax).astype(np.uint64)
    # gelu-ish on the shifted lattice, 2-bit output (keeps acc2 in range)
    gel2 = np.clip(np.round(_gelu((np.arange(n) - offset) / 8.0)) + 1,
                   0, 3).astype(np.uint64)

    def ct_mul(a: FheTensor, b: FheTensor):
        """Square-trick product, requantized to 3 bits.
        inputs in [0,7] => a+b in [0,14], a-b in [-7,7]: both +offset are
        in range; sq3 outputs [0,7]; s-dif in [-7,7] => final in range."""
        s = (a + b + (offset - 7)).lut(sq3, name="sq+")
        dif = (a - b + offset).lut(sq3, name="sq-")
        return (s - dif + offset).lut(req3, name="req_mul")

    def f(x):
        q = (x.linear(Wq) + offset).lut(req3, name="req_q")
        k = (x.linear(Wk) + offset).lut(req3, name="req_k")
        v = (x.linear(Wv) + offset).lut(req3, name="req_v")
        s = ct_mul(q, k)
        pv = ct_mul(s, v)
        h = (pv.linear(W1) + offset).lut(gel2, name="gelu")
        o = (h.linear(W2) + offset).lut(req3, name="req_out")
        return o
    g = trace(f, (d,))
    return g, {"Wq": Wq, "Wk": Wk, "Wv": Wv, "W1": W1, "W2": W2,
               "offset": offset}
