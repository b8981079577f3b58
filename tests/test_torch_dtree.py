"""Decision trees under FHE (`repro_torch.fhe_ml.trees`) against the plain
tree walk (`repro_torch.fhe_ml.tree_reference`).

The generator's shape; the lowered graph's integer semantics
(`executor.interpret`) against the walk, exactly, on seeded trees and
inputs; the plan at Taurus's 9-bit decision-tree set (`PAPER_PARAMS
["decision_tree"]`, N 65536) from a shapes-only dry run; a small tree
encrypted at the 6-bit test keys through the eager, local and serve
backends, decrypting to the walk's answer; and the reference's imports.
"""
import ast
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.core import params  # noqa: E402
from repro_torch.fhe_ml import executor, tree_reference, trees  # noqa: E402
from test_torch_api import port_context  # noqa: E402
from torch_stand_in import StandInEngine  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

REFERENCE = Path(tree_reference.__file__)


@pytest.mark.parametrize("seed", [0, 1, 2026])
def test_random_tree_shape(seed):
    """45 internal nodes and 46 leaves, the deepest leaf at depth 18,
    features, thresholds and classes in range, the same tree from the same
    seed and another from another seed."""
    t = trees.random_tree(seed)
    inner, leaves = t.internal(), t.leaves()
    assert (len(inner), len(leaves), t.depth()) == (45, 46, 18)
    assert all(0 <= t.feature[v] < 16 and 1 <= t.threshold[v] <= 255 for v in inner)
    assert all(t.value[v] in (0, 1) for v in leaves)
    assert sorted(t.paths()) == leaves
    assert t == trees.random_tree(seed) and t != trees.random_tree(seed + 1)


def test_random_tree_refuses_impossible_shapes():
    with pytest.raises(ValueError):
        trees.random_tree(0, nodes=90)
    with pytest.raises(ValueError):
        trees.random_tree(0, nodes=15, depth=8)


@pytest.mark.parametrize("seed", range(20))
def test_interpret_matches_the_tree_walk(seed):
    """The width-9 graph's integer semantics equal the walk on 64 seeded
    inputs, every LUT input inside the padding bit's range; so does the
    lowering's own oracle."""
    t = trees.random_tree(seed)
    g, meta = trees.lower_decision_tree(t, 9)
    x = np.random.default_rng(seed).integers(0, 256, (64, 16))
    onehot, cls = tree_reference.predict(t, x)
    for i in range(64):
        vals = executor.interpret(g, [x[i]], 9)
        np.testing.assert_array_equal(vals[g.outputs[0]], onehot[i].numpy())
        np.testing.assert_array_equal(vals[g.outputs[1]], [cls[i].item()])
    got_onehot, got_cls = meta["int_fn"](x)
    np.testing.assert_array_equal(got_onehot, onehot.numpy())
    np.testing.assert_array_equal(got_cls, cls.numpy())


def test_lowering_refuses_features_wider_than_the_width_allows():
    with pytest.raises(ValueError, match="width"):
        trees.lower_decision_tree(trees.random_tree(0), 8)


class SplitStandIn(StandInEngine):
    """The stand-in with the eager backend's KS-first split: the keyswitch
    returns its input and `lut_batch_small` logs the round."""

    def keyswitch(self, cts):
        return cts

    def lut_batch_small(self, small, polys):
        return self.lut_batch(small, polys)


@pytest.mark.parametrize("backend", ["eager", "local"])
def test_dry_run_plan_at_the_decision_tree_set(backend):
    """At N 65536 a request is 91 PBS in 2 rounds (45 comparisons, then 46
    leaves), on a stand-in engine whose PBS returns its input."""
    p = params.PAPER_PARAMS["decision_tree"]
    g, meta = trees.lower_decision_tree(trees.random_tree(7), p.width)
    prog = api.Program.from_graph(g, meta["in_specs"], meta["out_specs"])
    eng = SplitStandIn("cpu")
    be = api.make_backend(backend, types.SimpleNamespace(params=p, device="cpu"), eng)
    outs = be.execute(prog, [torch.zeros((16, p.big_n + 1), dtype=torch.int64)])
    assert [tuple(o.shape) for o in outs] == [(46, p.big_n + 1), (1, p.big_n + 1)]
    assert eng.rows == [45, 46]
    assert (sum(eng.rows), len(eng.rows)) == (meta["pbs"], meta["rounds"]) == (91, 2)


@pytest.fixture(scope="module")
def small_tree(ctx_6bit):
    """A 15-node, depth-4 tree of 5-bit features at the 6-bit test keys,
    its program and two encrypted inputs with the walk's answers."""
    tctx = port_context(ctx_6bit)
    t = trees.random_tree(11, nodes=15, depth=4, in_bits=5)
    g, meta = trees.lower_decision_tree(t, tctx.params.width)
    x = np.random.default_rng(11).integers(0, 32, (2, 16))
    onehot, cls = tree_reference.predict(t, x)
    want = [[onehot[i].tolist(), [cls[i].item()]] for i in range(2)]
    return tctx, g, meta, x, want


@pytest.mark.parametrize("backend", ["eager", "local", "serve"])
def test_small_tree_encrypted_decrypts_to_the_walk(small_tree, backend):
    tctx, g, meta, x, want = small_tree
    with api.Session(tctx, backend=backend, kernel_backend="fused") as sess:
        prog = sess.compile(g, meta["in_specs"], meta["out_specs"])
        gen = torch.Generator().manual_seed(5)
        encs = [sess.encrypt_inputs(gen, [row], prog) for row in x]
        if backend == "serve":
            handles = [sess.submit(prog, enc, client_id=f"c{i}") for i, enc in enumerate(encs)]
            outs = [h.outputs() for h in handles]
        else:
            outs = [sess.run(prog, enc) for enc in encs]
        got = [[np.asarray(v).tolist() for v in sess.decrypt_outputs(prog, o)] for o in outs]
    assert got == want


def test_tree_reference_imports_torch_alone():
    """The reference's own imports name torch alone, and it loads and
    predicts with JAX and the port's package blocked."""
    tree = ast.parse(REFERENCE.read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert names == {"torch"}
    code = (
        "import sys, types, importlib.util\n"
        "for m in ('jax', 'jaxlib', 'repro', 'repro_torch'):\n"
        "    sys.modules[m] = None\n"
        f"spec = importlib.util.spec_from_file_location('tree_reference', {str(REFERENCE)!r})\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "t = types.SimpleNamespace(left=(1, -1, -1), right=(2, -1, -1), feature=(0, -1, -1),\n"
        "                          threshold=(5, 0, 0), value=(-1, 0, 1))\n"
        "onehot, cls = mod.predict(t, [[4], [5]])\n"
        "assert onehot.tolist() == [[1, 0], [0, 1]] and cls.tolist() == [0, 1]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
