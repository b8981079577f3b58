"""The port's meshes against the reference's: the sharding rules of
`launch/mesh.py`, the engine's cluster mesh, `build_shards`' mesh
shards, and (in 4 spawned gloo ranks) GPipe and `ElasticMesh`.

Placements are compared leaf for leaf with the reference's
`param_specs` and `cache_specs` for all ten published configs at
(data 2, model 2), (16, 16) and (pod 2, 16, 16), through stand-in
meshes (only axis names and sizes are read); the reference's leaves come
from `jax.eval_shape`, the port's from a model built on the meta device.
The engine runs the reference test's check (8 rows of (3m + 2) mod p on
a 4-cluster mesh) on JAX-made keys and ciphertexts.  Tolerances: exact
(specs, decrypts, bits of the mesh round against the one-device
round); GPipe within 1e-5 of the sequential stages (f32, the reference
test's bound); `ElasticMesh` keeps values exactly.
"""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.core import glwe as jglwe  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.configs import ARCH_IDS, get  # noqa: E402
from repro_torch.core.engine import ConfigError, TaurusEngine  # noqa: E402
from repro_torch.interop import u64_to_tensor  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402
from test_torch_serve import (BITS, engine4, ic4, jic4, serve_wave,  # noqa: E402,F401
                              tctx_2bit, tctx_4bit, to_port)
import torch_dist_ranks as ranks  # noqa: E402

MESHES = {"data2_model2": (("data", "model"), (2, 2)),
          "data16_model16": (("data", "model"), (16, 16)),
          "pod2_data16_model16": (("pod", "data", "model"), (2, 16, 16))}


def stand_in(key):
    names, sizes = MESHES[key]
    return types.SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def full_models():
    """{arch: (the port's meta-device model, the reference's abstract
    params)} at the published widths."""
    out = {}
    for arch in ARCH_IDS:
        jm = JModel(jget(arch))
        out[arch] = (build(get(arch), "meta"),
                     jax.eval_shape(jm.init, jax.random.PRNGKey(0)), jm)
    return out


def ref_leaf(tree, model, name):
    """The reference's leaf for port parameter or cache entry `name`, and
    whether it carries the stacked block axis."""
    cfg = model.cfg
    period = len(cfg.layer_pattern)
    n_scan = cfg.num_layers // period * period
    parts = name.split(".")
    if parts[0] == "layers":
        i = int(parts[1])
        if i < n_scan:
            node, stacked = tree["blocks"][f"l{i % period}"], True
        else:
            node, stacked = tree["tail"][i - n_scan], False
        parts = parts[2:]
    else:
        node, stacked = tree, False
    for p in parts:
        node = node[p]
    return node, stacked


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(full_models, arch, mesh_key, mode):
    model, jparams, _ = full_models[arch]
    m = stand_in(mesh_key)
    want = jmesh.param_specs(jparams, m, mode)
    raw = jmesh.param_specs(jparams, None, mode)
    got = mesh.param_specs(model, m, mode)
    got_raw = mesh.param_specs(model, None, mode)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, spec in got.items():
        ref, stacked = ref_leaf(want, model, name)
        assert tuple(ref) == (None,) * stacked + spec, name
        ref_raw, _ = ref_leaf(raw, model, name)
        assert tuple(ref_raw) == (None,) * stacked + got_raw[name], name


@pytest.mark.parametrize("global_batch", [32, 3])
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(full_models, arch, mesh_key, global_batch):
    model, _, jm = full_models[arch]
    m = stand_in(mesh_key)
    jcache = jax.eval_shape(lambda: jm.init_cache(global_batch, 64))
    want = jmesh.cache_specs(jcache, m, global_batch)
    cache = model.init_cache(global_batch, 64)
    got = mesh.cache_specs(cache, m, global_batch)
    assert len(got) == model.cfg.num_layers
    for i, layer in enumerate(got):
        for name, spec in layer.items():
            ref, stacked = ref_leaf(want, model, f"layers.{i}.{name}")
            if spec is None:          # the port's write index is a Python int
                assert name == "index" and all(ax is None for ax in ref)
            else:
                assert tuple(ref) == (None,) * stacked + spec, (i, name)


def test_placements_and_logical_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = stand_in("pod2_data16_model16")
    assert mesh.placements((("pod", "data"), None, "model"), m) == [Shard(0), Shard(0), Shard(2)]
    assert mesh.placements((), m) == [Replicate()] * 3
    assert mesh.batch_axes(m) == ("pod", "data")
    assert sharding.logical_spec((64, 8, 4), ("batch", None, "model"), m) == \
        (("pod", "data"), None, "model")
    # never shard the batch axis finer than its size
    assert sharding.logical_spec((3, 8), ("batch", "model"), m) == (None, "model")
    m2 = stand_in("data2_model2")
    assert sharding.logical_spec((4, 8), ("batch", "model"), m2) == ("data", "model")
    # no mesh: constrain and distribute are no-ops
    x = torch.ones(4, 8)
    assert sharding.current_mesh() is None
    assert sharding.constrain(x, "batch", "model") is x
    assert sharding.distribute(x, "batch", None) is x
    with sharding.use_mesh(None):
        assert sharding.current_mesh() is None


def test_shard_mesh_and_host_mesh_errors():
    m = mesh.shard_mesh(["cpu"] * 4)
    assert m == (torch.device("cpu"),) * 4 and m.shape == {"data": 4}
    assert m.axis_names == ("data",) and mesh.axis_sizes(m) == {"data": 4}
    with pytest.raises(ValueError, match="at least one"):
        mesh.shard_mesh([])
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_host_mesh(1)


# --- the engine's cluster mesh --------------------------------------------------

@pytest.fixture(scope="module")
def mesh_engine(tctx_2bit):
    return TaurusEngine.from_context(tctx_2bit, mesh=mesh.shard_mesh(["cpu"] * 4))


def jax_round(ctx, B, seed):
    """B JAX encryptions of m % p (the reference test's keys and table)."""
    mod = ctx.params.plaintext_modulus
    msgs = jnp.arange(B, dtype=jnp.uint64) % mod
    cts = jax.vmap(lambda k, m: ctx.encrypt(k, m))(
        jax.random.split(jax.random.key(seed), B), msgs)
    table = [(3 * m + 2) % mod for m in range(mod)]
    poly = jglwe.make_lut_poly(jnp.asarray(table, dtype=jnp.uint64), ctx.params)
    return cts, jnp.broadcast_to(poly, (B,) + poly.shape), table, np.asarray(msgs)


@pytest.mark.parametrize("B", [8, 6])
def test_engine_on_4_cluster_mesh(ctx_2bit, engine_2bit, tctx_2bit, mesh_engine, B):
    """The reference's distributed-engine check on the port: n_clusters 4,
    batch_size 48 (the paper's 4 x 12); 8 rows, and 6 rows padded by 2,
    decrypt to the table as the JAX one-device engine's do, and equal the
    port's one-device round bit for bit."""
    eng = mesh_engine
    assert eng.n_clusters == 4 and eng.batch_size == 48
    assert eng.kernel_backend == "reference" and eng.device == torch.device("cpu")
    assert not eng.supports_ks_split
    cts, polys, table, msgs = jax_round(ctx_2bit, B, 51)
    want = [table[int(m)] for m in msgs]
    jgot = [int(v) for v in jax.vmap(ctx_2bit.decrypt)(engine_2bit.lut_batch(cts, polys))]
    eng.telemetry = tel = Telemetry()
    try:
        out = eng.lut_batch(u64_to_tensor(np.asarray(cts), "cpu"),
                            u64_to_tensor(np.asarray(polys), "cpu"))
    finally:
        eng.telemetry = None
    assert tuple(out.shape) == (B, tctx_2bit.params.big_n + 1)
    assert tctx_2bit.decrypt(out).tolist() == want == jgot
    one = TaurusEngine.from_context(tctx_2bit, kernel_backend="reference", device="cpu")
    assert torch.equal(out, one.lut_batch(u64_to_tensor(np.asarray(cts), "cpu"),
                                          u64_to_tensor(np.asarray(polys), "cpu")))
    pad = (-B) % 4
    c = tel.snapshot()["counters"]
    assert c["engine.pbs_rows"] == B + pad and c["engine.pbs_rows_padded"] == pad
    assert c["engine.lut_batches_reference"] == 1


def test_engine_mesh_tables_and_keys_once(tctx_2bit, mesh_engine):
    """`lut_batch_tables` through the mesh; the keys are held once per
    distinct device (four clusters on one device: one copy)."""
    eng = mesh_engine
    p = tctx_2bit.params
    g = torch.Generator().manual_seed(3)
    msgs = torch.arange(5) % p.plaintext_modulus
    cts = tctx_2bit.encrypt(g, msgs)
    tables = torch.tensor([[(m * 3 + r) % p.plaintext_modulus for m in range(p.plaintext_modulus)]
                           for r in range(5)])
    out = eng.lut_batch_tables(cts, tables)
    assert tctx_2bit.decrypt(out).tolist() == [tables[r, m].item() for r, m in enumerate(msgs)]
    assert list(eng._keys) == [torch.device("cpu")]
    assert eng._keys[torch.device("cpu")][0] is eng.bsk_f


def test_engine_mesh_config_errors(tctx_2bit, mesh_engine):
    with pytest.raises(ConfigError, match="per-device"):
        TaurusEngine.from_context(tctx_2bit, mesh=mesh.shard_mesh(["cpu"] * 2),
                                  kernel_backend="fused")
    with pytest.raises(ConfigError, match="per-device"):
        TaurusEngine(tctx_2bit.params, tctx_2bit.bsk_f, tctx_2bit.ksk,
                     mesh=mesh.shard_mesh(["cpu"] * 2))      # the port's default is fused
    big = torch.zeros((2, tctx_2bit.params.big_n + 1), dtype=torch.int64)
    with pytest.raises(ConfigError, match="single-device"):
        mesh_engine.keyswitch(big)
    small = torch.zeros((2, tctx_2bit.params.n + 1), dtype=torch.int64)
    with pytest.raises(ConfigError, match="single-device"):
        mesh_engine.lut_batch_small(small, torch.zeros((2, tctx_2bit.params.N),
                                                       dtype=torch.int64))
    with pytest.raises(ValueError, match="first device"):
        TaurusEngine.from_context(tctx_2bit, mesh=["cpu"], device="meta")
    one = TaurusEngine.from_context(tctx_2bit, mesh=mesh.shard_mesh(["cpu"]))
    assert one.n_clusters == 1 and one.batch_size == 12 and one.kernel_backend == "reference"


def test_build_shards_gives_multi_device_reference_shards_a_mesh(tctx_2bit):
    sets = [(torch.device("cpu"),) * 2, (torch.device("cpu"),)]
    ref = serve.build_shards(tctx_2bit, n_shards=2, kernel_backend="reference",
                             device_sets=sets)
    assert ref[0].engine.mesh == mesh.shard_mesh(sets[0]) and ref[0].engine.n_clusters == 2
    assert ref[1].engine.mesh is None
    fused = serve.build_shards(tctx_2bit, n_shards=2, kernel_backend="fused", device_sets=sets)
    assert all(s.engine.mesh is None and s.engine.kernel_backend == "fused" for s in fused)


def test_mesh_shard_serves_radix_wave_like_reference(ctx_4bit, engine_4bit, jic4,
                                                     tctx_4bit, ic4):
    """A two-request radix wave through one shard on a 2-device CPU set (a
    2-cluster mesh engine) decrypts as `repro.serve`'s one-device wave."""
    m = jic4.spec(BITS).msg_bits
    rng = np.random.default_rng(21)
    jobs, jjobs = [], []
    for i, op in enumerate(("radix_add", "radix_sub")):
        a, b = (int(v) for v in rng.integers(0, 1 << BITS, 2))
        enc = jserve.encrypt_request_inputs(jic4, jax.random.key(130 + i), [a, b], BITS)
        jjobs.append((f"c{i}", jserve.radix_binop_program(op, BITS, m), enc))
        jobs.append((f"c{i}", serve.radix_binop_program(op, BITS, m), to_port(enc)))
    _, jouts = serve_wave(jserve.ServeRuntime, ctx_4bit, engine_4bit, jjobs)
    rt, outs = serve_wave(serve.ServeRuntime, tctx_4bit, None, jobs,
                          kernel_backend="reference",
                          shard_devices=[(torch.device("cpu"),) * 2])
    assert rt.shards[0].engine.n_clusters == 2
    want = [jserve.decrypt_radix_output(jic4, o, BITS)[0] for o in jouts]
    assert [serve.decrypt_radix_output(ic4, o, BITS)[0] for o in outs] == want


# --- GPipe and ElasticMesh on 4 gloo ranks ----------------------------------------

def test_pipeline_and_elastic_mesh_on_4_ranks(tmp_path):
    ranks.spawn(ranks.mesh_ranks, str(tmp_path), str(tmp_path))
    res = np.load(os.path.join(tmp_path, "mesh.npz"))
    Ws, x = ranks.pipeline_inputs()
    err = float(np.max(np.abs(res["pipeline"] - ranks.sequential(Ws, x))))
    assert err < 1e-5, err
    assert res["full_shape"].tolist() == [2, 2]
    assert res["lost0_small_shape"].tolist() == [2, 2]
    assert res["lost1_small_shape"].tolist() == [1, 2]        # 3 ranks host (1, 2)
    assert res["lost0_small_local_w"].tolist() == [4, 4]
    assert res["lost1_small_local_w"].tolist() == [8, 4]
    assert res["lost0_kept"].tolist() == [1, 1] and res["lost1_kept"].tolist() == [1, 1]
    assert bool(res["topk2_ok"]) and bool(res["topk3_ok"])
