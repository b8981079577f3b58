"""Decision trees under FHE: a seeded tree generator and the tensor
("GEMM") lowering that Hummingbird and Concrete-ML use for encrypted
trees, on `repro_torch.compiler.ir`.

A tree is held in scikit-learn's array layout (`DecisionTree`): node 0
is the root, nodes are numbered in preorder, and a leaf has no children
(-1).  Features are unsigned `in_bits`-bit integers; an internal node
sends x to its right child when x[feature] >= threshold (scikit-learn's
`x <= t - 0.5` goes left).

`lower_decision_tree(tree, width)` evaluates every comparison and every
leaf at once, in two PBS rounds:

  1. `linear`: y_i = x[f(i)] - t_i + 2^(width-1) for each internal node i
  2. `lut` (step): b_i = [y_i >= 2^(width-1)], the comparison bits
  3. `linear`: s_l = 2^(width-1) - R_l + sum over l's path of +b_i (a
     right turn) or -b_i (a left turn), R_l the right turns: s_l equals
     2^(width-1) exactly when every comparison on the path holds, and
     lies below it otherwise
  4. `lut` (equality): the one-hot leaf [s_l == 2^(width-1)]
  5. `linear`: the class, sum over leaves of class_l * onehot_l

With in_bits = width - 1 every LUT input stays inside [0, 2^width), the
padding bit's range: y in [1, 2^width - 1], s in [2^(width-1) - depth,
2^(width-1)].
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.api.tracing import RawSpec, TensorSpec
from repro_torch.compiler.ir import trace


@dataclasses.dataclass(frozen=True)
class DecisionTree:
    """A binary classification tree in scikit-learn's array layout, node
    ids in preorder.  At a leaf `left`/`right`/`feature` are -1 and
    `threshold` 0; at an internal node `value` is -1."""
    left: tuple
    right: tuple
    feature: tuple
    threshold: tuple
    value: tuple
    features: int
    classes: int
    in_bits: int

    def internal(self) -> list:
        return [v for v in range(len(self.left)) if self.left[v] >= 0]

    def leaves(self) -> list:
        return [v for v in range(len(self.left)) if self.left[v] < 0]

    def paths(self) -> dict:
        """{leaf: [(internal node, turned right), ...] from the root}."""
        out, stack = {}, [(0, [])]
        while stack:
            v, path = stack.pop()
            if self.left[v] < 0:
                out[v] = path
            else:
                stack.append((self.right[v], path + [(v, True)]))
                stack.append((self.left[v], path + [(v, False)]))
        return out

    def depth(self) -> int:
        return max(len(p) for p in self.paths().values())


def random_tree(seed: int, nodes: int = 91, depth: int = 18, features: int = 16,
                classes: int = 2, in_bits: int = 8) -> DecisionTree:
    """A seeded tree of `nodes` nodes whose deepest leaf sits at `depth`.

    A root-to-leaf spine of `depth` internal nodes (each turning left or
    right by the seed) fixes the depth; the other internal nodes split
    leaves shallower than `depth`, chosen by the seed.  Each internal node
    takes a feature uniform in [0, features) and a threshold uniform in
    [1, 2^in_bits - 1]; each leaf a class uniform in [0, classes)."""
    n_internal = (nodes - 1) // 2
    if nodes % 2 == 0 or not 1 <= depth <= n_internal:
        raise ValueError(f"no binary tree of {nodes} nodes has depth {depth}")
    rng = np.random.default_rng(seed)
    children: dict = {0: None}
    level = {0: 0}

    def split(v: int) -> tuple:
        kids = (len(level), len(level) + 1)
        for c in kids:
            children[c], level[c] = None, level[v] + 1
        children[v] = kids
        return kids

    v = 0
    for _ in range(depth):
        v = split(v)[int(rng.integers(2))]
    for _ in range(n_internal - depth):
        shallow = [u for u in sorted(level) if children[u] is None and level[u] < depth]
        if not shallow:
            raise ValueError(f"no leaf above depth {depth} left to split")
        split(shallow[int(rng.integers(len(shallow)))])
    order, stack = [], [0]
    while stack:                                   # preorder: the node, left, right
        u = stack.pop()
        order.append(u)
        if children[u] is not None:
            stack += [children[u][1], children[u][0]]
    new = {u: i for i, u in enumerate(order)}
    rows = []                                      # (left, right, feature, threshold, value)
    for u in order:
        if children[u] is None:
            rows.append((-1, -1, -1, 0, int(rng.integers(classes))))
        else:
            rows.append((new[children[u][0]], new[children[u][1]],
                         int(rng.integers(features)), int(rng.integers(1, 1 << in_bits)), -1))
    return DecisionTree(*zip(*rows), features, classes, in_bits)


def lower_decision_tree(tree: DecisionTree, width: int):
    """The tree as a five-node graph over one (features,) input of
    width-bit ciphertexts; outputs the one-hot leaf (leaves in id order)
    and the class.  Returns (graph, meta) with:

      in_specs / out_specs   for `Session.compile(graph, ...)`
      pbs, rounds            PBS a request needs (internal nodes plus
                             leaves) and the rounds they run in (2)
      int_fn                 the lowering's integer oracle: (B, features)
                             -> ((B, leaves) one-hot, (B,) class)
    """
    if tree.in_bits > width - 1:
        raise ValueError(f"{tree.in_bits}-bit features need a width of at least "
                         f"{tree.in_bits + 1}, not {width}")
    offset = 1 << (width - 1)
    inner, leaves = tree.internal(), tree.leaves()
    row = {v: i for i, v in enumerate(inner)}
    W1 = np.zeros((tree.features, len(inner)), np.int64)
    W1[[tree.feature[v] for v in inner], np.arange(len(inner))] = 1
    b1 = offset - np.array([tree.threshold[v] for v in inner], np.int64)
    W2 = np.zeros((len(inner), len(leaves)), np.int64)
    b2 = np.full(len(leaves), offset, np.int64)
    paths = tree.paths()
    for j, leaf in enumerate(leaves):
        for v, turned_right in paths[leaf]:
            W2[row[v], j] = 1 if turned_right else -1
            b2[j] -= int(turned_right)
    W3 = np.array([[tree.value[v]] for v in leaves], np.int64)
    slots = np.arange(1 << width)
    step = (slots >= offset).astype(np.uint64)
    equal = (slots == offset).astype(np.uint64)

    def f(x):
        bits = x.linear(W1, b1).lut(step, name="tree_compare")
        onehot = bits.linear(W2, b2).lut(equal, name="tree_leaf")
        return onehot, onehot.linear(W3)
    g = trace(f, (tree.features,))

    def int_fn(x):
        x = np.asarray(x, np.int64).reshape(-1, tree.features)
        bits = (x @ W1 + b1 >= offset).astype(np.int64)
        onehot = (bits @ W2 + b2 == offset).astype(np.int64)
        return onehot, (onehot @ W3)[:, 0]

    meta = {"in_specs": [TensorSpec((tree.features,))],
            "out_specs": [RawSpec((len(leaves),)), RawSpec((1,))],
            "pbs": len(inner) + len(leaves), "rounds": 2, "int_fn": int_fn}
    return g, meta
