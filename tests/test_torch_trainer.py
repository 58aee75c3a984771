"""The port's trainer and its utilities (otvm_tpu_torch.train.trainer,
data.loader, utils.checkpoint, utils.logging, config, the training-state
half of convert) on the CPU, at the scale-4 model and 64x64 crops: stage 2
and 3 freezing, resuming from a checkpoint, stage chaining, the trimap
step, and the pieces shared with the JAX package held to its own.  Stage
2 and 3 freezing (7 steps each) is in test_torch_trainer_frozen.py, a file
the suite's workers take beside this one."""
import dataclasses
import logging

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from otvm_tpu import config as jconfig
from otvm_tpu.data import loader as jloader
from otvm_tpu.train import optim as jopt
from otvm_tpu.train.trainer import stage_trainable_mask as jax_stage_trainable_mask
from otvm_tpu.utils import logging as jlogging
from otvm_tpu_torch import config, convert
from otvm_tpu_torch.data.loader import decode_wire, encode_wire, epoch_indices
from otvm_tpu_torch.models.otvm import init_models
from otvm_tpu_torch.train import trainer as T
from otvm_tpu_torch.train.optim import RAdam
from otvm_tpu_torch.utils import checkpoint as ckpt
from otvm_tpu_torch.utils.logging import AverageMeter, StepTimer, create_logger
# one torch thread a module (the CPU's conv weight gradients repeat bit for bit)
from tests.torch_port import one_thread  # noqa: F401

HW, SCALE = 64, 4


def _cfg(stage, bf16=False):
    cfg = config.get_cfg_defaults()
    cfg.train.stage, cfg.model_scale, cfg.train.bf16 = stage, SCALE, bf16
    return cfg


def _batches(n, seed=0, b=1, s=3):
    """encode_wire batches of smooth seeded clips in VM108Train's layout."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        fg, bg = rng.rand(b, s, HW, HW, 3), rng.rand(b, s, HW, HW, 3)
        alpha = rng.rand(b, s, HW, HW, 1)
        tri = np.eye(3)[rng.randint(0, 3, (b, s, HW, HW))]
        out.append(encode_wire(dict(fg=fg, bg=bg, alpha=alpha, tri=tri)))
    return out


def _snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _same(module, snap):
    return all(torch.equal(v, snap[k]) for k, v in module.state_dict().items())


def test_stage_masks_match_jax_and_pick_the_optimizer_params():
    fake = {"stm": {"a": jnp.ones(2)}, "fba": {"c": jnp.ones(2)}}
    for stage in (1, 2, 3, 4):
        want = {top: bool(leaf["a" if top == "stm" else "c"])
                for top, leaf in jax_stage_trainable_mask(fake, stage).items()}
        assert T.stage_trainable_mask(stage) == want
        state = T.init_train_state(_cfg(stage), seed=0, device="cpu")
        held = {id(p) for p in state.optimizer.param_groups[0]["params"]}
        for top, net in (("stm", state.stm), ("fba", state.fba)):
            assert all((id(p) in held) == want[top] == p.requires_grad
                       for p in net.parameters()), (stage, top)


def test_checkpoint_resumes_at_the_saved_step(tmp_path, one_thread):
    """Stage 4: 5 steps, save, restore into a fresh state; the next two
    steps of the original and the restored run agree bit for bit."""
    cfg = _cfg(4)
    batches = _batches(7, seed=4)
    step = T.make_train_step(cfg)
    state = T.init_train_state(cfg, seed=2, device="cpu")
    state, _ = T.run_epoch(state, step, batches[:5])
    path = str(tmp_path / "run" / "ckpt.pt")
    ckpt.save_train_state(path, state)
    restored = ckpt.restore_train_state(path, T.init_train_state(cfg, seed=3, device="cpu"))
    assert restored.step == 5
    for batch in batches[5:]:
        state, m1 = step(state, batch)
        restored, m2 = step(restored, batch)
        assert m1["loss"].item() == m2["loss"].item()
    assert restored.step == state.step == 7
    for name in ("stm", "fba"):
        assert _same(getattr(restored, name), _snapshot(getattr(state, name)))


def test_run_epoch_averages_the_metrics():
    cfg = _cfg(1)
    batches = _batches(3, seed=5)
    state = T.init_train_state(cfg, seed=4, device="cpu")
    each = []
    step = T.make_train_step(cfg)

    def logged(st, batch):
        st, metrics = step(st, batch)
        each.append(metrics)
        return st, metrics

    state, mean = T.run_epoch(state, logged, batches)
    for k in mean:
        np.testing.assert_allclose(mean[k].item(), np.mean([m[k].item() for m in each]),
                                   rtol=1e-6)
    assert mean["L_tri"].item() == 0.0 and state.step == 3


def test_restore_params_only_chains_stage_2_into_stage_3(tmp_path, capsys):
    s2 = T.init_train_state(_cfg(2), seed=6, device="cpu")
    path = str(tmp_path / "s2.pt")
    ckpt.save_train_state(path, s2)
    s3 = T.init_train_state(_cfg(3), seed=7, device="cpu")
    fresh = {name: _snapshot(getattr(s3, name)) for name in ("stm", "fba")}
    ckpt.restore_params_only(path, s3)
    assert "keys not in" in capsys.readouterr().out
    for name in ("stm", "fba"):
        loaded = getattr(s2, name).state_dict()
        for k, v in getattr(s3, name).state_dict().items():
            want = loaded[k] if k in loaded else fresh[name][k]   # stage 3's new keys stay fresh
            assert torch.equal(v, want), f"{name}.{k}"
    assert s3.step == 0 and not s3.optimizer.state


def test_trimap_s1_step_composites_and_labels():
    cfg = _cfg(1)
    state = T.init_train_state(cfg, seed=8, device="cpu")
    step = T.make_trimap_s1_train_step(cfg)
    batch = _batches(1, seed=9)[0]
    state, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"]) and state.step == 1
    for k in ("pred_lab", "gt_lab"):
        assert metrics[k].dtype == torch.uint8 and metrics[k].shape == (1, 3, HW, HW)
    np.testing.assert_array_equal(metrics["gt_lab"].numpy(), batch["tri"])
    # frame 0's prediction is the GT trimap itself
    np.testing.assert_array_equal(metrics["pred_lab"][:, 0].numpy(), batch["tri"][:, 0])
    assert any(p.grad is not None for p in state.stm.parameters())
    assert all(p.grad is None for p in state.fba.parameters())
    # the FBA, which the loss does not reach, has zero moments, as in JAX
    _, m, v = convert.radam_state_to_jax(state.optimizer, state.stm, state.fba, 1, SCALE)
    assert not any(np.any(np.asarray(x)) for x in jax.tree_util.tree_leaves((m["fba"], v["fba"])))
    assert any(np.any(np.asarray(x)) for x in jax.tree_util.tree_leaves(m["stm"]))


def test_radam_state_carries_to_jax_and_back():
    """Stage 4, the scale-4 model: the same gradients (numpy, per JAX leaf)
    through the JAX package's RAdam and the port's, 7 steps; the port's
    moments, as JAX trees, equal JAX's (1e-6 of each leaf's largest value),
    and so do the parameters' changes, to the 2e-4 of the rectification
    scale (tests/test_torch_optim.py) and the fp32 rounding of each sum;
    JAX's state loads back exactly."""
    stm, fba = init_models(seed=9, stage=4, scale=SCALE)
    params = convert.params_to_jax(dict(stm.named_parameters()), dict(fba.named_parameters()),
                                   4, SCALE)
    rng = np.random.RandomState(10)
    grads = [jax.tree_util.tree_map(lambda a: (0.1 * rng.randn(*a.shape)).astype(np.float32),
                                    params) for _ in range(7)]
    tx = jopt.radam(1e-3, weight_decay=1e-4)
    jstate, jparams = tx.init(params), params
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    opt = RAdam([*stm.parameters(), *fba.parameters()], lr=1e-3, weight_decay=1e-4)
    for g in grads:
        u, jstate = update(g, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda a, b: a + b, jparams, u)
        g_stm, g_fba = convert.params_from_jax(g, 4, SCALE)
        for net, gd in ((stm, g_stm), (fba, g_fba)):
            for n, p in net.named_parameters():
                p.grad = gd[n]
        opt.step()
    step, m, v = convert.radam_state_to_jax(opt, stm, fba, 4, SCALE)
    assert step == int(jstate.step) == 7
    close = lambda a, b: np.testing.assert_allclose(a, b, rtol=0,
                                                    atol=1e-6 * max(np.abs(b).max(), 1e-30))
    jax.tree_util.tree_map(close, m, jax.tree_util.tree_map(np.asarray, jstate.exp_avg))
    jax.tree_util.tree_map(close, v, jax.tree_util.tree_map(np.asarray, jstate.exp_avg_sq))
    got = convert.params_to_jax(dict(stm.named_parameters()), dict(fba.named_parameters()),
                                4, SCALE)
    jax.tree_util.tree_map(
        lambda a, b, p0: np.testing.assert_allclose(   # plus fp32 ulps of the sums
            a - p0, b - p0, rtol=0,
            atol=2e-4 * np.abs(b - p0).max() + 4 * np.spacing(np.abs(b).max())),
        got, jax.tree_util.tree_map(np.asarray, jparams), params)

    other = RAdam([*stm.parameters(), *fba.parameters()], lr=1e-3, weight_decay=1e-4)
    convert.radam_state_from_jax(other, stm, fba, int(jstate.step),
                                 jax.tree_util.tree_map(np.asarray, jstate.exp_avg),
                                 jax.tree_util.tree_map(np.asarray, jstate.exp_avg_sq), 4, SCALE)
    back = convert.radam_state_to_jax(other, stm, fba, 4, SCALE)
    assert back[0] == 7
    jax.tree_util.tree_map(np.testing.assert_array_equal, back[1],
                           jax.tree_util.tree_map(np.asarray, jstate.exp_avg))


def test_params_trees_are_strict():
    stm, fba = init_models(seed=11, stage=4, scale=SCALE)
    named = lambda m: dict(m.named_parameters())
    tree = convert.params_to_jax(named(stm), named(fba), 4, SCALE)
    s, f = convert.params_from_jax(tree, 4, SCALE)
    assert set(s) == set(named(stm)) and set(f) == set(named(fba))
    assert torch.equal(s["KV_Q_r4.Key.weight"], stm.KV_Q_r4.Key.weight.detach())
    with pytest.raises(KeyError):
        convert.params_to_jax({k: v for k, v in named(stm).items() if "Key" not in k},
                              named(fba), 4, SCALE)
    with pytest.raises(KeyError):
        convert.params_to_jax(dict(named(stm), stray=torch.zeros(1)), named(fba), 4, SCALE)
    opt = RAdam([*fba.parameters()], lr=1e-3)     # a stage-2 optimizer lacks the STM
    with pytest.raises(KeyError):
        convert.radam_state_to_jax(opt, stm, fba, 4, SCALE)


def test_wire_format_matches_jax():
    batch = _batches(1, seed=12)[0]
    assert batch["fg"].dtype == np.uint8 and batch["tri"].shape == (1, 3, HW, HW)
    got = decode_wire({k: torch.from_numpy(v) for k, v in batch.items()})
    want = jloader.decode_wire({k: jnp.asarray(v) for k, v in batch.items()})
    for k in ("fg", "bg", "alpha", "tri"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    same = decode_wire({"fg": torch.ones(2)})
    assert same["fg"].dtype == torch.float32 and torch.equal(same["fg"], torch.ones(2))
    np.testing.assert_array_equal(encode_wire({"img": np.ones(3)})["img"], np.ones(3))


@pytest.mark.parametrize("n,epoch,procs", [(10, 0, 1), (7, 3, 3), (5, 1, 4)])
def test_epoch_indices_match_jax(n, epoch, procs):
    for rank in range(procs):
        np.testing.assert_array_equal(
            epoch_indices(n, epoch, 20, 111, rank, procs),
            jloader.epoch_indices(n, epoch, 20, 111, rank, procs))


def test_config_matches_jax():
    assert dataclasses.asdict(config.get_cfg_defaults()) == dataclasses.asdict(
        jconfig.get_cfg_defaults())
    cfg, jcfg = config.get_cfg_defaults(), jconfig.get_cfg_defaults()
    for stage in (1, 2, 3, 4):
        cfg.train.stage = jcfg.train.stage = stage
        assert config.get_model_name(cfg) == jconfig.get_model_name(jcfg)
    assert config.MODEL_NAMES == jconfig.MODEL_NAMES


def test_logging_matches_jax(tmp_path):
    mine, theirs = AverageMeter(), jlogging.AverageMeter()
    for val, weight in ((1.0, 1), (3.0, 2), (0.5, 4)):
        mine.update(val, weight)
        theirs.update(val, weight)
    assert vars(mine) == vars(theirs)
    timer = StepTimer(window=2)
    assert np.isnan(timer.eta(5))
    for _ in range(3):
        timer.tick()
    assert len(timer.times) == 2 and timer.eta(4) == pytest.approx(2 * sum(timer.times))
    logger, run_dir = create_logger(str(tmp_path), "s4_OTVM")
    logger.info("hello")
    for handler in logger.handlers:
        handler.flush()
    logs = list((tmp_path / "s4_OTVM").glob("s4_OTVM_*_train.log"))
    assert run_dir == str(tmp_path / "s4_OTVM") and len(logs) == 1
    assert "hello" in logs[0].read_text()
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    assert isinstance(logger, logging.Logger)


def test_init_train_state_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_train_state(_cfg(1))
    cfg = _cfg(1)
    cfg.alpha.arch = "resnet50_BN"          # no width-scaled BN trunk, in either package
    with pytest.raises(TypeError):
        T.init_train_state(cfg, device="cpu")
    cfg.alpha.arch = "resnet18_GN_WS"       # not a trunk the reference selects
    with pytest.raises(KeyError):
        T.init_train_state(cfg, device="cpu")
