"""Port weight conversion (otvm_tpu_torch.convert) and the port's
boundaries: the JAX package's own converter inverts from_jax exactly, the
port's modules load what from_jax gives strictly, the port never imports
JAX or the JAX package, and its entry points never fall back to the CPU."""
import ast
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from otvm_tpu.convert import convert_fba, convert_stm
from otvm_tpu_torch import convert
from otvm_tpu_torch.eval.runner import EvalProtocol, StreamingEvaluator
from otvm_tpu_torch.models.otvm import make_eval_bank, make_models
from tests.torch_port import jax_joint_variables

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), f"{path}: {sorted(set(a) ^ set(b))[:6]}"
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{path}/{k}")


@pytest.mark.parametrize("stage", [2, 4])
def test_jax_converter_inverts_from_jax(stage):
    """from_jax, then the JAX package's own strict torch->JAX converter,
    gives back the original variables exactly (full width)."""
    stm_vars, fba_vars = jax_joint_variables(stage, 1, 64, 64, seed=7)
    stm_sd, fba_sd = convert.from_jax(stm_vars, fba_vars, stage=stage)
    hdim = 16 if stage > 2 else -1
    _assert_trees_equal(convert_stm(stm_sd, hdim, strict=True), stm_vars)
    _assert_trees_equal(convert_fba(fba_sd, stage > 2, strict=True), fba_vars)
    _assert_trees_equal(convert.to_jax(stm_sd, fba_sd, stage=stage)[0], stm_vars)
    _assert_trees_equal(convert.to_jax(stm_sd, fba_sd, stage=stage)[1], fba_vars)


@pytest.mark.parametrize("stage,scale,norm", [(4, 1, "frozen_bn"), (2, 1, "frozen_bn"),
                                              (4, 4, "frozen_bn"), (4, 4, "gn")])
def test_port_loads_from_jax_strictly(stage, scale, norm):
    stm_vars, fba_vars = jax_joint_variables(stage, scale, 64, 64, seed=8, stm_norm=norm)
    stm_sd, fba_sd = convert.from_jax(stm_vars, fba_vars, stage=stage, scale=scale)
    stm, fba = make_models(stage, scale, norm)
    stm.load_state_dict(stm_sd, strict=True)
    fba.load_state_dict(fba_sd, strict=True)
    # the mapping is a transpose, not a reshape: a 7x7 stem kernel keeps its taps
    w = stm.Encoder_Q.conv1.weight.detach().numpy()
    k = stm_vars["params"]["Encoder_Q"]["conv1"]["conv"]["kernel"]
    np.testing.assert_array_equal(w[5, 1, 2, 3], k[2, 3, 1, 5])
    back = convert.to_jax(stm_sd, fba_sd, stage=stage, scale=scale)
    _assert_trees_equal(back[0], stm_vars)
    _assert_trees_equal(back[1], fba_vars)


def test_from_jax_is_strict_both_ways():
    stm_vars, fba_vars = jax_joint_variables(4, 4, 64, 64, seed=9)
    extra = {"params": dict(fba_vars["params"], stray={"kernel": np.zeros(3, np.float32)})}
    with pytest.raises(KeyError, match="no port key"):
        convert.fba_from_jax(extra, True, 4)
    missing = {"params": {k: v for k, v in fba_vars["params"].items() if k != "refine"}}
    with pytest.raises(KeyError, match="lack"):
        convert.fba_from_jax(missing, True, 4)
    stm_sd, fba_sd = convert.from_jax(stm_vars, fba_vars, stage=4, scale=4)
    with pytest.raises(KeyError):
        convert.to_jax(stm_sd, dict(fba_sd, stray=torch.zeros(1)), stage=4, scale=4)


def test_load_pth_reads_a_joint_checkpoint(tmp_path):
    """A checkpoint laid out as the released s4_OTVM.pth ('NET.*' alpha,
    'trimap.model.*' STM, loss buffers, DataParallel 'module.' prefix)."""
    stm, fba = make_models(4, 4)
    sd = {f"module.trimap.model.{k}": v for k, v in stm.state_dict().items()}
    sd.update({f"module.NET.{k}": v for k, v in fba.state_dict().items()})
    sd.update({"module.IMG_MEAN": torch.zeros(3), "module.LAPLOSS.KERNEL": torch.zeros(5, 5)})
    path = tmp_path / "s4.pth"
    torch.save({"state_dict": sd}, path)
    stm_sd, fba_sd = convert.load_pth(str(path))
    stm2, fba2 = make_models(4, 4)
    stm2.load_state_dict(stm_sd, strict=True)
    fba2.load_state_dict(fba_sd, strict=True)
    torch.testing.assert_close(stm2.KV_Q_r4.Key.weight, stm.KV_Q_r4.Key.weight)


_BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "otvm_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "otvm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(f.relative_to(ROOT / "otvm_tpu_torch")) for f in files[:-1]}
    assert {"cli/eval.py", "cli/train.py", "cli/train_s1_trimap.py", "data/augs.py",
            "data/datasets.py", "data/trimap.py", "data/loader.py", "eval/metrics.py",
            "utils/viz.py"} <= names
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in _BANNED, f"{f.relative_to(ROOT)} imports {name}"


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stm, fba = make_models(4, 4)
    proto = EvalProtocol(scale=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingEvaluator(stm.state_dict(), fba.state_dict(), proto)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_bank(1, 64, 64, 2, scale=4)
    ev = StreamingEvaluator(stm.state_dict(), fba.state_dict(), proto, device="cpu")
    assert next(ev.fba.parameters()).device.type == "cpu"
    assert make_eval_bank(1, 64, 64, 2, scale=4, device="cpu").keys.device.type == "cpu"
