"""The LM stack's FSDP x TP path on 4 spawned gloo ranks against the
one-rank port: `launch.train` and `launch.serve` with `model_parallel=2`
on a (data 2, model 2) `DeviceMesh`, parameters, AdamW moments and
batches as DTensors, and `sharding.constrain` at the reference's sites.

qwen3-0.6b reduced (f32).  Tolerances: losses within 1e-5 (absolute:
the sharded matmuls sum in another order); the updated parameters by
the card-against-CPU rule of `chip_smoke.py` (TRAIN_CARD_CPU_TOL 1e-4
absolute but for a TRAIN_CARD_CPU_OUTLIERS share of the elements, each
within two steps of lr: Adam's first step turns the rounding of a
gradient near zero into a share of a whole step); a restart under the
mesh gives the one-rank run's loss; greedy tokens exactly; logits within
1e-5.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import ConfigError  # noqa: E402
from repro_torch.launch.mesh import process_group  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import launch_mesh, train  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402

LOSS_TOL = 1e-5
PARAM_TOL, PARAM_OUTLIERS, LR = 1e-4, 1e-4, 3e-3     # chip_smoke.py's train rule


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_launch_mesh_without_a_group():
    assert launch_mesh(1) is None
    with pytest.raises(ConfigError, match="process group"):
        launch_mesh(2)
    with pytest.raises(ConfigError, match="process group"):
        train(ranks.ARCH, steps=1, model_parallel=2, **ranks.TRAIN)
    with pytest.raises(ConfigError, match="process group"):
        serve(ranks.ARCH, model_parallel=2, **ranks.SERVE)
    with process_group("cpu"):          # no WORLD_SIZE: no group
        assert not torch.distributed.is_initialized()


def _model_arrays(ckpt_dir, step):
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")) as f:
        return {k: f[k] for k in f.files if k.startswith("model/")}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The 4 ranks' results (one spawn for the module) and its directory."""
    d = tmp_path_factory.mktemp("mesh")
    ranks.spawn(ranks.lm_ranks, str(d), str(d), timeout=360.0)
    return dict(np.load(os.path.join(d, "lm.npz"))), d


def test_train_and_serve_on_2x2_gloo_mesh(mesh_run):
    res, tmp_path = mesh_run
    assert bool(res["refused"])

    one = str(tmp_path / "one_ckpt")
    losses, _ = train(ranks.ARCH, steps=2, ckpt_dir=one, **ranks.TRAIN)
    clean, _ = train(ranks.ARCH, steps=3, ckpt_dir=one, resume=True, **ranks.TRAIN)
    assert np.max(np.abs(res["losses"] - losses)) <= LOSS_TOL
    # run two under the mesh: step 2 fails, is retried, restored and rerun
    assert int(res["failures"]) == 4 and len(res["rerun"]) == len(clean) == 1
    assert np.max(np.abs(res["rerun"] - clean)) <= LOSS_TOL

    # the parameters after two steps, as the mesh's rank 0 saved them
    mesh_p, one_p = (_model_arrays(d, 2) for d in (str(tmp_path / "mesh_ckpt"), one))
    assert set(mesh_p) == set(one_p)
    errs = np.concatenate([np.abs(mesh_p[k] - one_p[k]).ravel() for k in one_p])
    assert (errs > PARAM_TOL).sum() <= PARAM_OUTLIERS * errs.size, (errs > PARAM_TOL).sum()
    assert errs.max() <= 2 * LR * 2, errs.max()

    run = serve(ranks.ARCH, **ranks.SERVE)
    assert np.array_equal(res["tokens"], run.tokens)
    assert np.max(np.abs(res["logits"] - run.logits.numpy())) <= LOSS_TOL


@pytest.mark.parametrize("arch", ranks.FAMILIES)
def test_other_families_on_2x2_gloo_mesh(mesh_run, arch):
    """mamba2's SSD scan and the MoE routing (qwen2-moe's top-2, then
    moonshot's top-3 on the same layout) train a step and decode on the
    mesh as on one rank."""
    res, _ = mesh_run
    losses, _ = train(arch, **ranks.FAMILY_TRAIN)
    assert np.max(np.abs(res[f"{arch}/losses"] - losses)) <= LOSS_TOL
    run = serve(arch, **ranks.FAMILY_SERVE)
    assert np.array_equal(res[f"{arch}/tokens"], run.tokens)
    assert np.max(np.abs(res[f"{arch}/logits"] - run.logits.numpy())) <= LOSS_TOL
