"""dtree: one inference of a decision tree over a client's encrypted
record.

The client encrypts its features, one width-bit ciphertext each; the
server runs the tree lowered to the tensor form (`repro_torch.fhe_ml.
trees.lower_decision_tree`: 45 comparisons, then 46 leaf tests, in two
rounds); the client decrypts the one-hot leaf and the class.  The tree
is the configuration's: its `tree` block holds the five arrays, frozen
as a model's checkpoint is, and this file checks their shape before
anything runs.  The port gets them only through its `DecisionTree`
type; the answers they are checked against come from this file's own
walk of the same arrays, which imports nothing from the port.
"""
import functools
import types

PBS = 91    # logical PBS a request needs, frozen from the plan this benchmark was defined on
ARRAYS = ("left", "right", "feature", "threshold", "value")


def levels(t) -> dict:
    """{node: its number of internal nodes above it}, for every node
    reached from the root."""
    out, stack = {}, [(0, 0)]
    while stack:
        v, d = stack.pop()
        out[v] = d
        if t.left[v] >= 0:
            stack += [(t.left[v], d + 1), (t.right[v], d + 1)]
    return out


def checked(block: dict):
    """The block's arrays as a tree, after checking that they form one
    binary tree of `nodes` nodes ((nodes - 1) / 2 internal, the rest
    leaves) whose deepest leaf sits at `depth`, with features, thresholds
    and classes in their ranges."""
    t = types.SimpleNamespace(**{k: tuple(block[k]) for k in ARRAYS})
    n = block["nodes"]
    if any(len(getattr(t, k)) != n for k in ARRAYS):
        raise ValueError(f"the tree's arrays do not all hold {n} nodes")
    inner = [v for v in range(n) if t.left[v] >= 0]
    kids = sorted(c for v in inner for c in (t.left[v], t.right[v]))
    if (kids != list(range(1, n)) or any(t.right[v] >= 0 for v in range(n) if t.left[v] < 0)
            or len(levels(t)) != n):
        raise ValueError("the tree's arrays are not one binary tree rooted at node 0")
    depth = max(levels(t).values())
    if len(inner) != (n - 1) // 2 or depth != block["depth"]:
        raise ValueError(f"the tree has {len(inner)} internal nodes and depth {depth}, "
                         f"not {(n - 1) // 2} and {block['depth']}")
    for v in range(n):
        if t.left[v] >= 0:
            ok = (0 <= t.feature[v] < block["features"]
                  and 1 <= t.threshold[v] < 1 << block["in_bits"])
        else:
            ok = 0 <= t.value[v] < block["classes"]
        if not ok:
            raise ValueError(f"node {v}'s feature, threshold or class is out of range")
    return t


@functools.lru_cache(maxsize=4)
def _tree(text: str):
    import json
    return checked(json.loads(text))


def tree(config):
    """The configuration's tree, checked: scikit-learn's arrays, node ids
    in preorder."""
    import json
    return _tree(json.dumps(config["tree"], sort_keys=True))


def build(config):
    from repro_torch.api.session import Program
    from repro_torch.fhe_ml.trees import DecisionTree, lower_decision_tree
    block, t = config["tree"], tree(config)
    g, meta = lower_decision_tree(
        DecisionTree(*(getattr(t, k) for k in ARRAYS), block["features"], block["classes"],
                     block["in_bits"]),
        config["params"]["width"])
    return Program.from_graph(g, meta["in_specs"], meta["out_specs"])


def sample(rng, config) -> list:
    block = config["tree"]
    return [rng.randrange(1 << block["in_bits"]) for _ in range(block["features"])]


def input_messages(values, config) -> list:
    return [list(values)]


def walk(t, values) -> tuple:
    """The leaf `values` reaches from the root (right where the feature is
    at least the node's threshold) as a one-hot list over the leaves in
    id order, and its class."""
    v = 0
    while t.left[v] >= 0:
        v = t.right[v] if values[t.feature[v]] >= t.threshold[v] else t.left[v]
    leaves = [u for u in range(len(t.left)) if t.left[u] < 0]
    return [int(u == v) for u in leaves], t.value[v]


def expected_messages(values, config) -> list:
    onehot, cls = walk(tree(config), values)
    return [onehot, [cls]]
