"""Table-II workload graphs (paper §VI-C), built through the tracer.

The port's copy of `repro.compiler.workloads` (numpy only).

Graph structure mirrors each application's published shape (e.g. the
decision tree is the paper's 91-node/18-depth scikit-learn model); tensor
sizes are chosen so the resulting PBS counts land at Taurus runtimes in
the paper's reported range — the *ratios* (CPU/GPU/XPU speedups, dedup
percentages, utilization-vs-batch curves) are what the benchmarks check.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.compiler.ir import Graph, FheTensor, trace
from repro_torch.core.params import PAPER_PARAMS, TFHEParams


def _table(width: int, fn) -> np.ndarray:
    n = 1 << width
    return np.asarray([fn(i) % n for i in range(n)], dtype=np.uint64)


def relu_table(width):
    half = 1 << (width - 1)
    return _table(width, lambda i: i if i < half else 0)


def gelu_table(width):
    half = 1 << (width - 1)

    def f(i):
        x = (i - half) / half * 4.0
        y = x * 0.5 * (1 + math.tanh(0.7978845 * (x + 0.044715 * x ** 3)))
        return int(round((y / 4.0) * half + half))
    return _table(width, f)


def exp_table(width):
    n = 1 << width
    return _table(width, lambda i: int(round(math.exp((i - n // 2) / (n // 4)) * 4)))


def recip_table(width):
    n = 1 << width
    return _table(width, lambda i: n // (i + 1))


def square_table(width):
    n = 1 << width
    return _table(width, lambda i: (i * i) >> width)


def cmp_table(width, thr):
    return _table(width, lambda i: 1 if i >= thr else 0)


def _rng(seed):
    return np.random.default_rng(seed)


def _int_w(rng, shape, lo=-3, hi=4):
    return rng.integers(lo, hi, shape).astype(np.int64)


# ---------------------------------------------------------------------------

def cnn(n_layers: int, hw: int, ch: int, width: int, seed=0) -> Graph:
    """PTQ CNN: n_layers x (linear conv-as-matmul + ReLU LUT)."""
    rng = _rng(seed)
    relu = relu_table(width)
    feat = hw * hw * ch

    def f(x):
        for i in range(n_layers):
            x = x.linear(_int_w(rng, (feat, feat)))
            x = x.lut(relu, name=f"relu{i}")
        return x.linear(_int_w(rng, (feat, 10)))
    return trace(f, (feat,))


def gpt2_block_graph(n_layers: int, seq: int, d: int, n_heads: int,
                     width: int, seed=0) -> Graph:
    """Quantized GPT-2: per layer QKV linear, ct*ct attention via square
    LUTs ((a+b)^2 - (a-b)^2)/4, softmax exp+recip LUTs, GELU MLP.

    Concrete-style detail: the requantization after each matmul applies a
    second (digit/carry) LUT to the SAME ciphertext the activation LUT
    reads — the fanout pattern KS-dedup exploits (Obs. 6)."""
    rng = _rng(seed)
    gelu = gelu_table(width)
    expt = exp_table(width)
    rcp = recip_table(width)
    sq = square_table(width)
    carry = _table(width, lambda i: i >> (width // 2))

    def ct_dot(a: FheTensor, b: FheTensor):
        """ct.ct inner product via the square trick: 2 LUTs per element."""
        s = (a + b).lut(sq, name="sq+")
        dif = (a - b).lut(sq, name="sq-")
        return s - dif

    def f(x):  # x: (seq, d)
        for li in range(n_layers):
            q = x.linear(_int_w(rng, (d, d)))
            k = x.linear(_int_w(rng, (d, d)))
            v = x.linear(_int_w(rng, (d, d)))
            for h in range(n_heads):
                s = ct_dot(q, k)                          # (seq, d) elementwise
                s = s.linear(_int_w(rng, (d, seq), 0, 2))  # fold hd -> scores
                e = s.lut(expt, name="exp")
                _hi = s.lut(carry, name="exp_carry")       # fanout on s
                z = e.linear(np.ones((seq, 1), np.int64))
                zi = z.lut(rcp, name="recip")
                if h == 0:
                    e0, zi0 = e, zi
            # prob * V: ct*ct again (square trick), folded to (seq, d)
            pv = ct_dot(e0.linear(_int_w(rng, (seq, d), 0, 2)), v)
            x = x + pv.linear(_int_w(rng, (d, d)))
            h1 = x.linear(_int_w(rng, (d, 4 * d)))
            a1 = h1.lut(gelu, name="gelu")
            _c1 = h1.lut(carry, name="gelu_carry")         # fanout on h1
            x = x + a1.linear(_int_w(rng, (4 * d, d)))
        return x
    return trace(f, (seq, d))


def decision_tree_graph(n_nodes: int, depth: int, width: int,
                        n_features: int = 16, seed=0) -> Graph:
    """Paper's tree: 91 nodes / 18 depth.  Every node compares ONE scalar
    feature ciphertext against its threshold — all comparisons run in one
    parallel wave (same feature ct fans out to many cmp LUTs: KS-dedup),
    then a log-depth bivariate-AND tree aggregates path indicators."""
    rng = _rng(seed)
    and_t = _table(width, lambda i: 1 if i == 3 else 0)   # a*2+b == 3

    def f(*feats):  # n_features x (1,) ciphertexts
        comps = [feats[int(rng.integers(0, n_features))].lut(
            cmp_table(width, int(rng.integers(1, 1 << width))),
            name=f"cmp{i}") for i in range(n_nodes)]
        level = comps
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level) - 1, 2):
                nxt.append(level[i].lut2(level[i + 1], and_t, radix=2,
                                         name="and"))
            if len(level) % 2:
                nxt.append(level[-1])
            level = nxt
        return level[0]
    return trace(f, *([(1,)] * n_features))


def knn_graph(n_train: int, k: int, width: int, n_features: int = 8,
              seed=0) -> Graph:
    """KNN: parallel distance computation, then a mostly-SERIAL tournament
    top-k (the latency-bound workload: only 3.2x over the XPU variant)."""
    rng = _rng(seed)
    sq = square_table(width)
    half = width // 2
    min2 = _table(width, lambda i: min(i >> half, i % (1 << half)))

    def f(*feats):
        dists = []
        for i in range(n_train):
            parts = [(feats[j] + int(rng.integers(0, 4))).lut(sq, name="sq")
                     for j in range(n_features)]
            acc = parts[0]
            for p in parts[1:]:
                acc = acc + p
            dists.append(acc * 1)
        # k rounds of tournament min-reduction (serial across rounds)
        sel = dists
        for _ in range(k):
            level = sel
            while len(level) > 1:
                nxt = []
                for i in range(0, len(level) - 1, 2):
                    nxt.append(level[i].lut2(level[i + 1], min2,
                                             radix=1 << half, name="min"))
                if len(level) % 2:
                    nxt.append(level[-1])
                level = nxt
            sel = sel[1:]  # winner removed; next round over the rest
        return level[0]
    return trace(f, *([(1,)] * n_features))


def xgboost_graph(n_trees: int, depth: int, width: int, n_features: int = 16,
                  seed=0) -> Graph:
    """50 estimators x depth 4: all trees evaluate in parallel (the
    highest-utilization workload, Fig. 15)."""
    rng = _rng(seed)
    nodes_per_tree = 2 ** depth - 1
    and_t = _table(width, lambda i: 1 if i == 3 else 0)

    def f(*feats):
        leaves = []
        for t in range(n_trees):
            comps = [feats[int(rng.integers(0, n_features))].lut(
                cmp_table(width, int(rng.integers(1, 1 << width))),
                name="cmp") for _ in range(nodes_per_tree)]
            acc = comps[0]
            for c in comps[1:depth]:
                acc = acc.lut2(c, and_t, radix=2, name="and")
            leaves.append(acc)
        out = leaves[0]
        for l in leaves[1:]:
            out = out + l
        return out
    return trace(f, *([(1,)] * n_features))


# ---------------------------------------------------------------------------
# wide-integer (radix) workloads — the "beyond Table II" direction: the
# multi-bit digit space carries 16/32-bit integers, every carry round one
# PBS batch (repro_torch.core.integer).  No paper reference numbers; these feed
# the dedup/scheduler/cost pipeline (exercised by tests/test_compiler.py).

def wide_add_graph(bits: int = 32, msg_bits: int = 4) -> Graph:
    d = bits // msg_bits

    def f(a, b):
        return a.radix_add(b, msg_bits)
    return trace(f, (d,), (d,))


def wide_mul_graph(bits: int = 16, msg_bits: int = 4) -> Graph:
    d = bits // msg_bits

    def f(a, b):
        return a.radix_mul(b, msg_bits)
    return trace(f, (d,), (d,))


def wide_affine_relu_graph(bits: int = 16, msg_bits: int = 4) -> Graph:
    """ReLU(a * w + b): the quantized-inference inner loop on wide ints."""
    d = bits // msg_bits

    def f(a, w, b):
        return a.radix_mul(w, msg_bits).radix_add(b, msg_bits).radix_relu(
            msg_bits)
    return trace(f, (d,), (d,), (d,))


def build_wide() -> dict:
    """name -> (graph, params); xgboost's 8-bit space gives 4-bit digits."""
    p = PAPER_PARAMS["xgboost"]
    return {
        "wide_add32": (wide_add_graph(32, 4), p),
        "wide_mul16": (wide_mul_graph(16, 4), p),
        "wide_affine_relu16": (wide_affine_relu_graph(16, 4), p),
    }


@dataclasses.dataclass
class Workload:
    name: str
    graph: Graph
    params: TFHEParams
    paper_cpu_s: float
    paper_gpu_s: float | None
    paper_taurus_ms: float
    paper_xpu_ms: float


def build_all() -> dict:
    P = PAPER_PARAMS
    return {
        "cnn20": Workload("CNN-20 (PTQ)", cnn(20, 5, 4, 6), P["cnn20"],
                          3.85, 6.096, 11.60, 78.65),
        "cnn50": Workload("CNN-50 (PTQ)", cnn(50, 6, 4, 6), P["cnn50"],
                          15.31, 49.714, 74.27, 506.27),
        "decision_tree": Workload("Decision Tree",
                                  decision_tree_graph(91, 18, 9),
                                  P["decision_tree"],
                                  645.40, 522.2351, 409.19, 2794.60),
        "gpt2": Workload("GPT2", gpt2_block_graph(12, 4, 16, 1, 6),
                         P["gpt2"], 1218.13, 721.14, 860.94, 5851.00),
        "gpt2_12head": Workload("GPT2 (12-head)",
                                gpt2_block_graph(12, 4, 16, 12, 6),
                                P["gpt2_12head"],
                                23685.14, None, 10649.33, 75219.27),
        "knn": Workload("KNN", knn_graph(30, 3, 9), P["knn"],
                        284.69, 204.6, 306.66, 982.49),
        "xgboost": Workload("XGBoost Reg", xgboost_graph(50, 4, 8),
                            P["xgboost"], 1793.27, 912.11, 689.29, 4749.30),
    }
