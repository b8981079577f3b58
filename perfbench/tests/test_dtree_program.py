"""CPU tests of the decision-tree cell (`dtree9-closed`) and the solo
cell (`uint8-solo`): the program's frozen count against the served plan,
the benchmark's own tree walk against the port's plain reference, a PBS
returning its input caught by the check, the graph-memory reader on the
program's counters, and a whole run's last line of each cell on a
stand-in PBS.  The roofline readers need the profiler and a card."""
import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.programs import dtree
from perfbench.tests import standin

CELL = "dtree9-closed"
# width 9 needs N >= 1024; the stand-in PBS reads no other parameter
TINY9 = dict(standin.TINY, N=1024, width=9)
CARD_ONLY = {"launch_ms.saturated", "round_device_ms.saturated", "between_rounds.saturated",
             "graph_gb.dtree9"}
LOAD = dict(clients=2, stagger_groups=2, pool_per_client=3, lead_rounds=2)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def spec(**traffic):
    return standin.tiny_spec(CELL, params=TINY9, **dict(LOAD, **traffic))


def test_frozen_pbs_count_matches_the_served_plan():
    """One client, so that the window's ends (on answers) hold whole
    requests: 91 PBS in 2 rounds each."""
    keep = {}
    res = harness.run_cell(CELL, 4, 0.5, False, device="cpu",
                           spec=spec(clients=1, stagger_groups=1),
                           engine_hook=standin.standin_hook, log=lambda *a: None, keep=keep)
    run = keep["run"]
    done = run.delta("serve.completed")
    assert res["correct"] and done > 0
    assert run.delta("sched.logical_luts") == done * dtree.PBS
    assert run.delta("sched.fused_rounds") == 2 * done


def block_of(seed):
    """A tree block as a configuration holds one, with the arrays of the
    port's seeded generator (`seed` None: the cell's frozen tree)."""
    block = dict(harness.cell_spec(CELL)["config"]["tree"])
    if seed is not None:
        from repro_torch.fhe_ml.trees import random_tree
        t = random_tree(seed)
        block.update(seed=seed, **{k: list(getattr(t, k)) for k in dtree.ARRAYS})
    return block


@pytest.mark.parametrize("seed", [0, 5, None])
def test_the_benchmarks_walk_matches_the_ports_reference(seed):
    from repro_torch.fhe_ml import tree_reference
    config = {"tree": block_of(seed)}
    t = dtree.tree(config)
    x = np.random.default_rng(seed or 0).integers(0, 256, (64, 16))
    onehot, cls = tree_reference.predict(t, x)
    for i, row in enumerate(x.tolist()):
        assert dtree.expected_messages(row, config) == [onehot[i].tolist(), [cls[i].item()]]
    assert sum(onehot.sum(0) > 0) > 1          # the inputs reach more than one leaf


def test_the_cells_frozen_tree_has_the_papers_shape():
    """91 nodes: 45 internal and 46 leaves, the deepest leaf at 18."""
    t = dtree.tree(harness.cell_spec(CELL)["config"])
    levels = dtree.levels(t)
    leaves = [v for v in levels if t.left[v] < 0]
    assert (len(levels), len(levels) - len(leaves), len(leaves)) == (91, 45, 46)
    assert max(levels[v] for v in leaves) == 18


def _moved(block, node, key, value):
    arr = list(block[key])
    arr[node] = value
    return dict(block, **{key: arr})


def _cut_subtree(block):
    """The first internal node whose two children are leaves made a leaf:
    89 nodes' worth of tree in 91 slots."""
    v = next(v for v in range(91) if block["left"][v] >= 0
             and block["left"][block["left"][v]] < 0 and block["left"][block["right"][v]] < 0)
    b = _moved(_moved(block, v, "left", -1), v, "right", -1)
    return _moved(_moved(b, v, "feature", -1), v, "value", 0)


@pytest.mark.parametrize("fault", ["short", "subtree", "depth", "feature", "threshold", "cls"])
def test_a_tree_off_its_shape_is_refused(fault):
    block = block_of(None)
    inner = [v for v in range(91) if block["left"][v] >= 0]
    leaf = next(v for v in range(91) if block["left"][v] < 0)
    bad = {"short": lambda: dict(block, value=block["value"][:-1]),
           "subtree": lambda: _cut_subtree(block),
           "depth": lambda: dict(block, depth=17),
           "feature": lambda: _moved(block, inner[0], "feature", 16),
           "threshold": lambda: _moved(block, inner[0], "threshold", 0),
           "cls": lambda: _moved(block, leaf, "value", 2)}[fault]()
    with pytest.raises(ValueError):
        dtree.checked(bad)


def test_a_pbs_returning_its_input_fails_the_check():
    def hook(engine, keys):
        standin.install(engine, keys, lambda cts, polys: cts)
    res = standin.run(CELL, seconds=0.5, hook=hook, spec=spec())
    assert not res["correct"]
    assert res["checks"]["wrong_outputs"]["value"] > 0


def test_graph_gb_reads_the_programs_counters():
    """The reader takes captured less released bytes at the window's end;
    on the CPU nothing captures, so the hook counts a capture of 3 GB and
    the eviction of 1 GB at the first round; without the counters (a
    program that keeps none) it returns None."""
    def hook(engine, keys):
        good = standin.standin_lut_batch(keys, torch.Generator().manual_seed(7))
        once = []

        def lut_batch(cts, polys):
            if not once:
                once.append(1)
                engine.telemetry.counter("engine.graph_bytes_captured").inc(3_000_000_000)
                engine.telemetry.counter("engine.graph_bytes_released").inc(1_000_000_000)
            return good(cts, polys)
        standin.install(engine, keys, lut_batch)
    keep = {}
    harness.run_cell(CELL, 6, 0.5, False, device="cpu", spec=spec(), engine_hook=hook,
                     log=lambda *a: None, keep=keep)
    reader = harness.load_file("metrics", "graph_gb.dtree9")
    assert reader.read(keep["run"]) == pytest.approx(2.0)
    harness.run_cell(CELL, 6, 0.5, False, device="cpu", spec=spec(),
                     engine_hook=standin.standin_hook, log=lambda *a: None, keep=keep)
    assert reader.read(keep["run"]) is None


@pytest.mark.parametrize("cell", [CELL, "uint8-solo"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_of_the_new_cells_on_a_standin_pbs(cell, trace):
    """Correct, with each metric the cell lists that a CPU run can read:
    every host-clock and program metric but those of the engine's spans
    and CUDA events, which a stand-in PBS on the CPU never opens or
    records, and the graph bytes, which the CPU never captures."""
    s = spec() if cell == CELL else standin.tiny_spec(cell, pool_per_client=6, lead_rounds=2)
    res = standin.run(cell, trace=trace, spec=s)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    listed = {m["name"]: m for m in s["per_layer" if trace else "end_to_end"]}
    assert all(cell in m.get("workloads", [cell]) for m in listed.values())
    host_only = {n for n, m in listed.items()
                 if m.get("source", "host_clock") != "device_trace" and "mfu" not in n
                 and n not in CARD_ONLY}
    assert host_only <= set(res["metrics"]) <= set(listed)


def test_the_mac_roofline_reads_the_cells_mac_launches():
    """On a synthetic traced segment at the decision-tree set: a MAC
    launch whose device time equals its least time by the frozen counts
    reads 100%, and one at twice that 50% in all; launches of another
    (J, K) or size are left out; no traced segment reads None."""
    from perfbench import client, profiling
    from perfbench.counts import pbs as counts
    p = client.Params(**harness.cell_spec(CELL)["config"]["params"])
    peaks = counts.card_peaks("NVIDIA H100 80GB HBM3")
    K, J, M = counts.shapes(p)
    least_us = 1e6 * counts.launch_min_s(counts.external_product_mac(p, 192), peaks)
    name = "void (anonymous namespace)::external_product_mac_kernel<double, {}, {}>(double const*)"
    events = [profiling.DeviceEvent(name.format(J, K), 0.0, least_us, 7, (M // 128, 96, 1)),
              profiling.DeviceEvent(name.format(2, 2), 1e4, 5.0, 7, (M // 128, 96, 1)),
              profiling.DeviceEvent(name.format(J, K), 2e4, 5.0, 7, (8, 96, 1))]
    run = harness.Run(params=p, config={}, traffic={}, seconds=1.0, peaks=peaks,
                      trace=profiling.DeviceTrace(events, [], 1.0))
    reader = harness.load_file("metrics", "mac_roofline.dtree9")
    assert reader.read(run) == pytest.approx(100.0)
    run.trace.events.append(profiling.DeviceEvent(name.format(J, K), 3e4, 3 * least_us, 7,
                                                  (M // 128, 96, 1)))
    assert reader.read(run) == pytest.approx(50.0)
    run.trace = None
    assert reader.read(run) is None
