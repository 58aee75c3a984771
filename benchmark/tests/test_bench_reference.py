"""The benchmark's plain reference against the port, on the CPU at model
scale 4 and tiny sizes, fp32: the joint stream and the trimap stream frame
for frame, and the stage-4 train step's loss, first gradient and update.
One seeded state loads into both sides strictly."""
import numpy as np
import pytest
import torch

from benchmark.harness.traffic import StreamTraffic, train_batches
from benchmark.reference import nets, stream as rs
from benchmark.reference.train import RAdam, decode, joint_loss
from benchmark.reference.weights import seeded_state

PARAMS = {"height": 64, "width": 96, "clip_frames": 13, "distinct_frames": 3,
          "distinct_trimaps": 1}


def _states(network, seed):
    ref = nets.build(network, 4)
    states = {k: seeded_state(m, seed + j, "cpu") for j, (k, m) in enumerate(ref.items())}
    for k, m in ref.items():
        m.load_state_dict(states[k])
    return ref, states


@pytest.mark.parametrize("network", ["joint", "trimap"])
def test_stream_matches_port(network):
    from otvm_tpu_torch.eval.runner import EvalProtocol, StreamingEvaluator, TrimapEvaluator

    ref, states = _states(network, 21)
    frames, tri = StreamTraffic(PARAMS, 21, "cpu").clip(0)
    protocol = EvalProtocol(scale=4)
    if network == "joint":
        alphas, trimaps, _ = StreamingEvaluator(states["stm"], states["fba"], protocol,
                                                device="cpu").run_video(frames, tri)
    else:
        trimaps, _ = TrimapEvaluator(states["stm"], protocol, device="cpu").run_video(frames, tri)
    ra, rt, _ = rs.run_clip(ref, frames, tri, "cpu", torch.float32, network == "joint")
    for i in range(len(frames)):
        np.testing.assert_allclose(trimaps[i], rt[i], atol=1e-5)
        if network == "joint":
            np.testing.assert_allclose(alphas[i], ra[i], atol=1e-5)


def test_train_step_matches_port():
    from otvm_tpu_torch.config import Config
    from otvm_tpu_torch.train.trainer import init_train_state, make_train_step

    ref, states = _states("joint", 31)
    cfg = Config()
    cfg.train.stage, cfg.train.batch_size, cfg.model_scale = 4, 2, 4
    cfg.train.train_input_size = (64, 64)
    state = init_train_state(cfg, device="cpu")
    state.stm.load_state_dict(states["stm"])
    state.fba.load_state_dict(states["fba"])
    step = make_train_step(cfg, graphs=False)
    batches = train_batches({"batch": 2, "frames": 3, "height": 64, "width": 64,
                             "distinct_batches": 6}, 31)
    params = [p for k in ("stm", "fba") for p in ref[k].parameters()]
    opt = RAdam(params, cfg.train.base_lr, cfg.train.weight_decay)
    for i, b in enumerate(batches):
        _, metrics = step(state, b)
        loss, _ = joint_loss(ref["stm"], ref["fba"], decode({k: torch.as_tensor(v)
                                                            for k, v in b.items()}))
        for p in params:
            p.grad = None
        loss.backward()
        opt.step()
        assert float(metrics["loss"]) == pytest.approx(loss.item(), rel=1e-5)
        if i == 0:
            got = [state.optimizer.state[p]["exp_avg"] for k in ("stm", "fba")
                   for p in getattr(state, k).parameters()]
            g, m = (torch.cat([x.flatten() for x in xs]) for xs in (got, opt.m))
            assert float((g - m).norm()) <= 1e-4 * float(m.norm())
    mine = [p for k in ("stm", "fba") for p in getattr(state, k).parameters()]
    start = [v for k in ("stm", "fba") for n, v in states[k].items()
             if n in dict(ref[k].named_parameters())]
    d = torch.cat([(p - s0).detach().flatten() for p, s0 in zip(mine, start)])
    e = torch.cat([(q - s0).detach().flatten() for q, s0 in zip(params, start)])
    assert float(e.norm()) > 0
    # the first update is ~1e-7 an element: fp32's rounding of p + update
    # alone is ~1e-2 of it
    assert float((d - e).norm()) <= 2e-2 * float(e.norm())
