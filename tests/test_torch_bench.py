"""The port's bench (otvm_tpu_torch/bench.py) and its batched step on the
CPU, against the JAX package's bench.py and eval_frame_step:

  * every mode of `python -m otvm_tpu_torch.bench --device cpu` (default,
    BENCH_BATCH=2, BENCH_CHUNK=2, BENCH_WIRE=1, BENCH_WIRE_OUT=1) at 64x64,
    on one shared scale-4 model: one JSON line with bench.py's keys (and
    "device"), and the metric name bench.py:147-153 derives from the same
    environment (bench.py read by its own module code); chunk mode takes
    its memorize flags from the global frame index (bench.py:104-109);
  * the batched step, B=2 streams in one bank, at scale 4: the same seeded
    inputs and weights (convert.from_jax) through JAX's eval_frame_step and
    the port's, 64x64, 6 frames, a bank of at most 2, memorize every 2nd
    frame (so eviction runs).  tests/test_torch_stream.py's rule: frame 0
    within 1e-3; later frames at most 1% of values off by more than 1e-3
    and at least 99% of labels agreeing (random weights leave near-tied
    argmaxes); the banks' counts equal and their valid slots held the same
    way;
  * CUDA graphs asked for on the CPU raise.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from otvm_tpu.models import otvm as jotvm
from otvm_tpu_torch import bench
from otvm_tpu_torch.convert import from_jax
from otvm_tpu_torch.eval.runner import (EvalProtocol, MultiStreamEvaluator, StreamingEvaluator,
                                        TrimapEvaluator)
from otvm_tpu_torch.models.graphs import AlphaGraphs, FrameStepGraphs, TrimapStepGraphs
from otvm_tpu_torch.models.otvm import (eval_frame_step, make_eval_bank, make_models,
                                        serving_models)
from otvm_tpu_torch.nn.layers import freeze_for_inference
from tests.torch_port import jax_joint_variables, one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODES = {"default": {}, "batch2": {"BENCH_BATCH": "2"}, "chunk2": {"BENCH_CHUNK": "2"},
         "wire": {"BENCH_WIRE": "1"}, "wire_out": {"BENCH_WIRE_OUT": "1"}}


@pytest.fixture(scope="module")
def models():
    return serving_models("cpu", scale=4)


def _jax_bench_metric() -> str:
    """bench.py's metric name for the current environment: its module code
    parses the variables, and the name is bench.py:147-153's expression."""
    spec = importlib.util.spec_from_file_location("_jax_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    metric = ("fps_512p_joint_s4" if (mod.H, mod.W) == (512, 512) and mod.B == 1
              and mod.CHUNK == 1 else f"fps_{mod.H}x{mod.W}_b{mod.B}_c{mod.CHUNK}_joint_s4")
    if mod.WIRE_OUT:
        metric += "_wireio"
    elif mod.WIRE:
        metric += "_wire"
    return metric


@pytest.mark.parametrize("mode", list(MODES))
def test_bench_line_has_bench_py_keys_and_metric(models, mode, monkeypatch, capsys):
    for k, v in dict(BENCH_RES="64x64", BENCH_FRAMES="4", BENCH_DTYPE="fp32",
                     **MODES[mode]).items():
        monkeypatch.setenv(k, v)
    line = bench.main(["--device", "cpu"], models=models)
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 and json.loads(printed[0]) == line
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert line["metric"] == _jax_bench_metric()
    assert line["unit"] == "frames/sec" and line["device"] == "cpu" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 30.0, 4)


def test_bench_metric_names_at_the_default_size():
    assert bench.Settings().metric == "fps_512p_joint_s4"
    assert bench.Settings(batch=4).metric == "fps_512x512_b4_c1_joint_s4"
    assert bench.Settings(chunk=8, wire=True, wire_out=True).metric == \
        "fps_512x512_b1_c8_joint_s4_wireio"


def test_bench_chunks_take_memorize_flags_from_the_global_frame_index(models, monkeypatch):
    """BENCH_CHUNK=4 over 12 frames (skip 10): the warm-up chunk, then the
    untimed and the timed pass over chunks starting at frames 0, 4, 8; a
    chunk-local index would memorize at each chunk's first frame."""
    seen = []
    chunk_step = bench.eval_chunk_step

    def recording(*args, **kwargs):
        seen.append(list(args[6]))
        return chunk_step(*args, **kwargs)

    monkeypatch.setattr(bench, "eval_chunk_step", recording)
    settings = bench.Settings(height=64, width=64, chunk=4, frames=12, dtype="fp32")
    assert bench.run(settings, *models) > 0
    at = lambda start: [(start + i) % 10 == 0 for i in range(4)]
    assert seen == [at(0)] + [at(0), at(4), at(8)] * 2


def test_batched_step_matches_jax():
    """B=2 streams in one bank through eval_frame_step, port vs JAX."""
    b, h, w, n, max_num = 2, 64, 64, 6, 2
    stm_vars, fba_vars = jax_joint_variables(4, 4, h, w, seed=11)
    stm_sd, fba_sd = from_jax(stm_vars, fba_vars, stage=4, scale=4)
    stm, fba = make_models(4, 4)
    stm.load_state_dict(stm_sd, strict=True)
    fba.load_state_dict(fba_sd, strict=True)
    stm, fba = (freeze_for_inference(m.eval().requires_grad_(False)) for m in (stm, fba))
    rng = np.random.RandomState(12)
    frames = rng.rand(n, b, h, w, 3).astype(np.float32)
    tri = bench._nested_box(b, h, w)
    tri[1] = tri[1, ::-1].copy()                       # the second stream's trimap differs
    jbank = jotvm.make_eval_bank(b, h, w, max_num, scale=4)
    tbank = make_eval_bank(b, h, w, max_num, scale=4, device="cpu")
    for i in range(n):
        first, mem, last = i == 0, i % 2 == 0, i == n - 1
        jout = jotvm.eval_frame_step(stm_vars, fba_vars, jbank, jnp.asarray(frames[i]),
                                     jnp.asarray(tri), jnp.asarray(first), jnp.asarray(mem),
                                     jnp.asarray(last), stage=4, max_memory_num=max_num,
                                     scale=4)
        tout = eval_frame_step(stm, fba, tbank, torch.from_numpy(frames[i]),
                               torch.from_numpy(tri), first, mem, last, max_memory_num=max_num)
        jbank, tbank = jout.bank, tout.bank
        count = int(jbank.count)
        assert tbank.count == count, f"frame {i}"
        pairs = [(tout.alpha, jout.alpha, "alpha"), (tout.trimap, jout.trimap, "trimap"),
                 (tbank.keys[:, :count], jbank.keys[:, :count], "bank keys"),
                 (tbank.values[:, :count], jbank.values[:, :count], "bank values")]
        for got, want, what in pairs:
            bad = np.abs(got.numpy() - np.asarray(want)) > 1e-3
            assert (not bad.any()) if i == 0 else bad.mean() <= 0.01, \
                f"{what} frame {i}: {bad.mean():.3%} off by > 1e-3"
        agree = (tout.trimap.numpy().argmax(-1) == np.asarray(jout.trimap).argmax(-1)).mean()
        assert agree == 1.0 if i == 0 else agree >= 0.99, f"labels frame {i}: {agree:.3%}"
    assert tbank.count == max_num                          # appended, then evicted


def test_graphs_on_the_cpu_raise(models):
    stm, fba = models
    for make in (lambda: FrameStepGraphs(stm, fba), lambda: TrimapStepGraphs(stm),
                 lambda: AlphaGraphs(fba)):
        with pytest.raises(ValueError, match="CUDA"):
            make()
    stm_sd, fba_sd = (m.state_dict() for m in make_models(4, 4))
    stm1_sd, fba2_sd = make_models(1, 4)[0].state_dict(), make_models(2, 4)[1].state_dict()
    evaluators = [lambda **kw: StreamingEvaluator(stm_sd, fba_sd, EvalProtocol(scale=4), **kw),
                  lambda **kw: MultiStreamEvaluator(stm_sd, fba_sd, EvalProtocol(scale=4), **kw),
                  lambda **kw: StreamingEvaluator(None, fba2_sd, EvalProtocol(stage=2, scale=4),
                                                  **kw),
                  lambda **kw: TrimapEvaluator(stm1_sd, EvalProtocol(scale=4), **kw)]
    for evaluator in evaluators:
        with pytest.raises(ValueError, match="CUDA graphs"):
            evaluator(device="cpu", graphs=True)
        assert evaluator(device="cpu").step_graphs is None
