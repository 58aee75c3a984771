"""The port's training CLIs (otvm_tpu_torch/cli/train.py, train_s1_trimap.py)
on the CPU, and the pieces they bring: the eval CLI's weight loading,
make_viz_forward, the training image grids and profile_trace.

The CLIs run `main(argv)` with `--device cpu --testmode` on a DIM and a
VideoMatting108 tree written here (96x128), at `--input-size 64
--batch-size 2`, the model cut to scale 4 through the CLI modules'
get_cfg_defaults (the CLIs have no scale flag, as the JAX package's have
none), in a temporary working directory: the recipe's chain, trimap-s1 ->
stage 2 (--init-trimap) -> stage 4 (--init) -> --resume, each checkpoint
carried over as the flags say.
"""
import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from otvm_tpu_torch.cli import eval as cli_eval
from otvm_tpu_torch.cli import train as cli_train
from otvm_tpu_torch.cli import train_s1_trimap as cli_s1
from otvm_tpu_torch.config import get_cfg_defaults
from otvm_tpu_torch.convert import load_pth
from otvm_tpu_torch.models.otvm import init_models
from otvm_tpu_torch.train.trainer import init_train_state, make_viz_forward
from otvm_tpu_torch.utils.logging import profile_trace
from otvm_tpu_torch.utils.viz import make_grid, save_train_grid

from tests.torch_port import jax_joint_variables, one_thread, write_train_tree  # noqa: F401

SCALE = 4
H, W = 96, 128


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return write_train_tree(tmp_path_factory.mktemp("train_data"), H, W)


def _scaled_cfg():
    cfg = get_cfg_defaults()
    cfg.model_scale = SCALE
    return cfg


@pytest.fixture
def scaled(monkeypatch, tmp_path):
    for mod in (cli_train, cli_s1, cli_eval):
        monkeypatch.setattr(mod, "get_cfg_defaults", _scaled_cfg)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _args(data_root):
    return ["--device", "cpu", "--testmode", "--data-root", data_root, "--input-size", "64",
            "--batch-size", "2", "--repeats", "2", "--workers", "2"]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_the_training_chain(data_root, scaled):
    s1 = cli_s1.main(_args(data_root) + ["--max-iters", "1"])
    assert s1["state"].step == 1 and np.isfinite(s1["losses"]).all() and len(s1["ious"]) == 1
    assert 0.0 <= s1["ious"][0] <= 100.0
    trimap = _load("weights/s1_OTVM_trimap")
    assert trimap["step"] == 1

    s2 = cli_train.main(_args(data_root) + ["--stage", "2", "--init-trimap",
                                            "weights/s1_OTVM_trimap"])
    assert s2["state"].step == 2 and np.isfinite(s2["losses"]).all()
    s2_ckpt = _load("weights/s2_OTVM_alpha")
    for k, v in trimap["stm"].items():                 # the STM moved over, frozen at stage 2
        torch.testing.assert_close(s2_ckpt["stm"][k], v, rtol=0, atol=0)
    run_dir = s2["run_dir"]
    assert os.path.exists(os.path.join(run_dir, "ckpt_e1"))
    assert "stage: 2" in open(os.path.join(run_dir, "config.yaml")).read()

    s4 = cli_train.main(_args(data_root) + ["--stage", "4", "--init", "weights/s2_OTVM_alpha"])
    assert s4["state"].step == 2 and np.isfinite(s4["losses"]).all()
    s4_ckpt = _load("weights/s4_OTVM")
    assert "refine.conv1.0.weight" in s4_ckpt["fba"] and "Encoder_M.conv1_h.weight" in s4_ckpt["stm"]

    again = cli_train.main(_args(data_root) + ["--stage", "4", "--resume", "weights/s4_OTVM"])
    assert again["state"].step == 2 and again["start_epoch"] == 1 and again["losses"] == []
    fresh = cli_train.main(_args(data_root) + ["--stage", "4", "--resume", "weights/none",
                                               "--epochs", "1"])
    assert fresh["start_epoch"] == 0 and fresh["state"].step == 2


def test_image_grids_and_bare_pth_init(data_root, scaled, monkeypatch):
    """cfg.train.image_freq writes make_viz_forward's grids; --init takes a
    released STM-only .pth (module.-prefixed, as STM_weights.pth)."""
    stm, _ = init_models(3, stage=1, scale=SCALE)
    torch.save({f"module.{k}": v for k, v in stm.state_dict().items()}, "STM_weights.pth")
    stm_sd, fba_sd = load_pth("STM_weights.pth")
    assert fba_sd == {} and sorted(stm_sd) == sorted(stm.state_dict())
    res = cli_s1.main(_args(data_root) + ["--max-iters", "1", "--init", "STM_weights.pth"])
    assert res["state"].step == 1
    with pytest.raises(ValueError, match="released .pth"):      # JAX's CLI reads .pth only
        cli_s1.main(_args(data_root) + ["--init", "weights/s1_OTVM_trimap"])

    def with_images():
        cfg = _scaled_cfg()
        cfg.train.image_freq = 1
        return cfg

    monkeypatch.setattr(cli_train, "get_cfg_defaults", with_images)
    res = cli_train.main(_args(data_root) + ["--stage", "1"])
    images = sorted(os.listdir(os.path.join(res["run_dir"], "images")))
    assert images == ["e0_i0.jpg", "e0_i1.jpg"]
    grid = cv2.imread(os.path.join(res["run_dir"], "images", images[0]))
    assert grid.shape == (4 * (64 + 2) + 2, 2 * 3 * (64 + 2) + 2, 3)


def test_one_process_and_cuda_by_default(data_root, scaled, monkeypatch):
    """WORLD_SIZE > 1 without torchrun's rendezvous raises (no rank trains
    alone); without a card, the default device raises."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    for key in ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    for main, extra in ((cli_train.main, ["--stage", "4"]), (cli_s1.main, [])):
        with pytest.raises(RuntimeError, match="WORLD_SIZE=2 without RANK, LOCAL_RANK, "
                                               "MASTER_ADDR, MASTER_PORT"):
            main(_args(data_root) + extra)
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((cli_train.main, ["--stage", "4", "--data-root", data_root]),
                       (cli_s1.main, ["--data-root", data_root]),
                       (cli_eval.main, ["--data-root", data_root])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert not os.path.exists("weights")


def test_eval_load_weights(data_root, scaled, capsys):
    """The port's own checkpoint (GN trunk detected by its missing running
    statistics, with the JAX CLI's warning), a released .pth, random
    weights, and a refused orbax directory."""
    cfg = _scaled_cfg()
    cfg.train.stage, cfg.stm_norm = 4, "gn"
    state = init_train_state(cfg, seed=4, device="cpu")
    from otvm_tpu_torch.utils.checkpoint import save_train_state

    save_train_state("gn_ckpt", state)
    stm_sd, fba_sd = cli_eval.load_weights("gn_ckpt", stage=4)
    assert "no BN running stats" in capsys.readouterr().out
    for got, want in ((stm_sd, state.stm.state_dict()), (fba_sd, state.fba.state_dict())):
        assert sorted(got) == sorted(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    sd = {f"trimap.model.{k}": v for k, v in stm_sd.items()}
    sd.update({f"NET.{k}": v for k, v in fba_sd.items()})
    torch.save({"state_dict": sd}, "joint.pth")
    stm2, fba2 = cli_eval.load_weights("joint.pth")
    assert sorted(stm2) == sorted(stm_sd) and sorted(fba2) == sorted(fba_sd)
    stm3, _ = cli_eval.load_weights(None, stage=2)
    assert "random weights" in capsys.readouterr().out and "KV_M_r4.Key.weight" in stm3
    os.makedirs("orbax_ckpt")
    with pytest.raises(ValueError, match="orbax"):
        cli_eval.load_weights("orbax_ckpt")


def test_viz_forward_and_grids_equal_jax(tmp_path):
    """make_viz_forward against the JAX package's on the same weights
    (JAX's seeded variables carried over by convert.from_jax) and batch, at
    full width: JAX's viz forward builds the full-width models whatever
    cfg.model_scale says.  Tolerance as tests/test_torch_train_forward.py's
    outputs: frame 0 within 1e-3, later frames (a propagated trimap through
    an argmax) at most 1% of values off by more than 1e-3.  The image grids
    are then equal to JAX's bytes."""
    import jax

    from otvm_tpu.config import get_cfg_defaults as jax_cfg_defaults
    from otvm_tpu.train.trainer import TrainState as JaxTrainState
    from otvm_tpu.train.trainer import make_viz_forward as jax_make_viz_forward
    from otvm_tpu.utils import viz as jviz
    from otvm_tpu_torch.convert import from_jax

    stm_vars, fba_vars = jax_joint_variables(4, 1, 64, 64, seed=1)
    cfg = get_cfg_defaults()
    cfg.train.stage = 4
    state = init_train_state(cfg, seed=1, device="cpu")
    stm_sd, fba_sd = from_jax(stm_vars, fba_vars, stage=4)
    state.stm.load_state_dict(stm_sd, strict=True)
    state.fba.load_state_dict(fba_sd, strict=True)
    jcfg = jax_cfg_defaults()
    jcfg.train.stage = 4
    jstate = JaxTrainState({"stm": stm_vars["params"], "fba": fba_vars["params"]},
                           stm_vars["batch_stats"], None, np.zeros((), np.int32))
    rng = np.random.RandomState(2)
    lab = rng.randint(0, 3, (1, 3, 64, 64))
    batch = dict(fg=rng.rand(1, 3, 64, 64, 3).astype(np.float32),
                 bg=rng.rand(1, 3, 64, 64, 3).astype(np.float32),
                 alpha=rng.rand(1, 3, 64, 64, 1).astype(np.float32),
                 tri=np.eye(3, dtype=np.float32)[lab])
    aux = make_viz_forward(cfg)(state, batch)
    want = jax.tree_util.tree_map(np.asarray, jax_make_viz_forward(jcfg)(jstate, batch))
    assert all(p.grad is None for p in state.fba.parameters())
    for k in ("alphas", "comps"):
        assert aux[k].shape == want[k].shape and aux[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(aux[k][:, 0], want[k][:, 0], rtol=0, atol=1e-3, err_msg=k)
        bad = np.abs(aux[k][:, 1:] - want[k][:, 1:]) > 1e-3
        assert bad.mean() <= 0.01, f"{k}: {bad.mean():.3%} of values off by more than 1e-3"
    tiles = [rng.rand(8, 12, 3).astype(np.float32) for _ in range(5)] + [rng.rand(8, 12)]
    np.testing.assert_array_equal(make_grid(tiles, nrow=4), jviz.make_grid(tiles, nrow=4))
    save_train_grid(str(tmp_path / "port" / "g.jpg"), batch, aux)
    jviz.save_train_grid(str(tmp_path / "jax" / "g.jpg"), batch, aux)
    assert (tmp_path / "port" / "g.jpg").read_bytes() == (tmp_path / "jax" / "g.jpg").read_bytes()


def test_profile_trace(tmp_path):
    """Off: nothing written, None yielded.  On (as tools/profile_train.py's
    profile_step runs it): the profiler, for its key_averages(), and the
    Chrome trace."""
    with profile_trace(str(tmp_path / "off")) as prof:
        torch.ones(4).sum()
    assert prof is None and not (tmp_path / "off").exists()
    with profile_trace(str(tmp_path / "on"), enabled=True) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert any("mm" in e.key for e in prof.key_averages())
    trace = json.loads((tmp_path / "on" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
