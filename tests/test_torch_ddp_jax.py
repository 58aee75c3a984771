"""Step 1 of 2 gloo ranks of the port (otvm_tpu_torch/parallel/dist.py,
the trainer's process group) against the JAX package's data-parallel
step: otvm_tpu.parallel.mesh.make_mesh(2) and shard_batch over 2 of the
suite's virtual CPU devices, on one global batch of 4 (2 a rank) whose
rows differ in contrast, from JAX's seeded init carried by
convert.from_jax.  Scale-4 models, 64x64, S 2.  The loss within 1e-5
(relative), and RAdam's first moment (0.1 x the gradient) within
tests/test_torch_train_forward.py's GRAD_TOL per top-level module.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from otvm_tpu.config import get_cfg_defaults as jax_cfg_defaults
from otvm_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from otvm_tpu.train.trainer import init_train_state as jax_init_train_state
from otvm_tpu.train.trainer import make_optimizer as jax_make_optimizer
from otvm_tpu.train.trainer import make_train_step as jax_make_train_step
from otvm_tpu_torch import convert
from otvm_tpu_torch.config import get_cfg_defaults
from otvm_tpu_torch.parallel import dist as D
from otvm_tpu_torch.tools import ddp_check as C
from otvm_tpu_torch.train import trainer as T
from otvm_tpu_torch.utils.checkpoint import restore_train_state, save_train_state
from tests import ddp_workers
from tests.test_torch_train_forward import GRAD_TOL
from tests.torch_port import one_thread  # noqa: F401

SCALE, HW, S = 4, 64, 2


def _cfg():
    cfg = get_cfg_defaults()
    cfg.train.stage, cfg.model_scale, cfg.train.frame_num = 4, SCALE, S
    cfg.train.train_input_size = (HW, HW)
    return cfg


def test_step_one_matches_jax_data_mesh(tmp_path):
    """The JAX package's make_train_step on make_mesh(2) with shard_batch
    against 2 ranks, from JAX's init carried by convert.from_jax (as a
    1-process checkpoint the ranks resume), on one float global batch.  The
    ranks' checkpoint then resumes in one process; ranks seeded apart are
    refused."""
    jcfg = jax_cfg_defaults()
    jcfg.train.stage, jcfg.model_scale, jcfg.train.frame_num = 4, SCALE, S
    jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(3), None, HW, HW)
    tx = jax_make_optimizer(jcfg, jstate.params, iters_per_epoch=1)
    jstate = jstate.replace(opt_state=tx.init(jstate.params))
    np_params = jax.tree_util.tree_map(np.asarray, jstate.params)
    stm_sd, fba_sd = convert.from_jax(
        {"params": np_params["stm"], "batch_stats": jax.tree_util.tree_map(
            np.asarray, jstate.batch_stats)}, {"params": np_params["fba"]}, stage=4, scale=SCALE)

    cfg = _cfg()
    state = T.init_train_state(cfg, device="cpu")
    state.stm.load_state_dict(stm_sd, strict=True)
    state.fba.load_state_dict(fba_sd, strict=True)
    save_train_state(str(tmp_path / "alone"), state)
    wire = C.global_batches(cfg, 1, seed=4)[0]
    batch = {k: v.astype(np.float32) / 255.0 for k, v in wire.items() if k != "tri"}
    batch["tri"] = np.eye(3, dtype=np.float32)[wire["tri"]]
    np.savez(tmp_path / "batch.npz", **batch)

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(D.spawn, ddp_workers.resumed_step_rank, 2, cfg,
                            str(tmp_path / "alone"), str(tmp_path / "batch.npz"),
                            str(tmp_path / "ranks"))
        mesh = make_mesh(2)
        with mesh:
            jstate, metrics = jax_make_train_step(jcfg, tx)(
                replicate(mesh, jstate), shard_batch(mesh, {k: jnp.asarray(v)
                                                            for k, v in batch.items()}))
        jloss = float(metrics["loss"])
        (loss, refused), (loss1, _) = ranks.result()
    assert refused and "differ" in refused
    assert loss == loss1
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)

    resumed = restore_train_state(str(tmp_path / "ranks"), T.init_train_state(cfg, device="cpu"))
    assert resumed.step == 1
    _, m, _ = convert.radam_state_to_jax(resumed.optimizer, resumed.stm, resumed.fba, 4, SCALE)
    jm = jax.tree_util.tree_map(np.asarray, jstate.opt_state.exp_avg)
    for net in jm:
        for top in jm[net]:
            a = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(jm[net][top])])
            b = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(m[net][top])])
            err = np.linalg.norm(a - b) / np.linalg.norm(a)
            assert err <= GRAD_TOL, f"{net}/{top}: {err:.3e}"
