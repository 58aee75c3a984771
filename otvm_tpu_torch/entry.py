"""The entry points of __graft_entry__.py, on the port.

    python -m otvm_tpu_torch.entry [dryrun N | dryrun_eval N]
        [--device cuda|cpu] [--backend nccl|gloo] [--scale S]

entry()                   -> (fn, example_args): one joint stage-4
                             eval_frame_step at 256x256 with a bank of 5.
dryrun_multichip(n)       -> n ranks take one stage-4 train step
                             (forward, gradients averaged over the ranks,
                             RAdam) on a global batch of n at 64x64, S 2.
dryrun_multichip_eval(n)  -> multi-stream serving: one stream a rank, 3
                             joint frames, each rank's bank its own.

The JAX dry runs respawn into a virtual n-device CPU mesh.  These spawn n
processes (parallel/dist.py spawn) on the device asked for: CUDA by
default, one card a rank over NCCL; with backend="gloo" ranks may share
cards (rank % the card count), and device="cpu" runs them on the CPU over
gloo.  The models are full width unless `scale` cuts them (config.py's
model_scale), with random weights from seed 0.
"""
from __future__ import annotations

import argparse
from typing import Optional, Tuple

import numpy as np
import torch

from . import resolve_device
from .config import get_cfg_defaults
from .kernels import memory_attn as ma
from .models.otvm import eval_frame_step, make_eval_bank, serving_models
from .parallel import dist as D
from .train.trainer import init_train_state, make_train_step

ENTRY_HW, ENTRY_MEMORY = 256, 5
DRYRUN_HW, DRYRUN_FRAMES = 64, 2
EVAL_FRAMES, EVAL_MEMORY = 3, 3


def entry(device=None, weights: Optional[Tuple[dict, dict]] = None):
    """(fn, example_args): fn(frame01, first_trimap3, first_frame, memorize,
    last_frame) -> (alpha, trimap), one joint stage-4 eval_frame_step of
    the full-width models at 256x256 on an empty bank of 5 slots (each call
    starts from its own, as the JAX function reads its closure's bank).
    weights: (STM, FBA) state_dicts; default random from seed 0."""
    device = resolve_device(device)
    stm, fba = serving_models(device, weights=weights)
    h = w = ENTRY_HW

    def fn(frame01, first_trimap3, first_frame, memorize, last_frame):
        bank = make_eval_bank(1, h, w, max_memory_num=ENTRY_MEMORY, device=device)
        with torch.no_grad():
            out = eval_frame_step(stm, fba, bank, frame01, first_trimap3, first_frame, memorize,
                                  last_frame, max_memory_num=ENTRY_MEMORY)
        return out.alpha, out.trimap

    first_trimap = torch.zeros((1, h, w, 3), device=device)
    first_trimap[..., 0] = 1.0
    return fn, (torch.zeros((1, h, w, 3), device=device), first_trimap, True, False, False)


def dryrun_batch(n: int, h: int = DRYRUN_HW, w: int = DRYRUN_HW, s: int = DRYRUN_FRAMES):
    """The dry run's global batch of n clips, as __graft_entry__.py draws it
    (numpy RandomState(0)): fg, bg, alpha uniform, a one-hot random trimap."""
    rng = np.random.RandomState(0)
    tri_lab = rng.randint(0, 3, (n, s, h, w))
    return dict(fg=rng.rand(n, s, h, w, 3).astype(np.float32),
                bg=rng.rand(n, s, h, w, 3).astype(np.float32),
                alpha=rng.rand(n, s, h, w, 1).astype(np.float32),
                tri=np.eye(3, dtype=np.float32)[tri_lab])


def _train_rank(device, backend, scale):
    device = D.init_distributed(device, backend)
    group, rank, n = D.data_group(), D.process_index(), D.process_count()
    cfg = get_cfg_defaults()
    cfg.train.stage, cfg.model_scale = 4, scale
    cfg.train.frame_num, cfg.train.batch_size = DRYRUN_FRAMES, n
    state = init_train_state(cfg, seed=0, iters_per_epoch=100, device=device, group=group)
    batch = {k: v[rank:rank + 1] for k, v in dryrun_batch(n).items()}
    reads = ma.launches
    state, metrics = make_train_step(cfg)(state, batch)
    loss = D.all_reduce_mean([metrics["loss"]], group)[0].item()
    params = state.optimizer.param_groups[0]["params"]
    moments = [state.optimizer.state[p][k] for p in params for k in ("exp_avg", "exp_avg_sq")]
    equal = D.ranks_equal([*params, *moments], group)
    assert np.isfinite(loss), f"rank {rank}: non-finite loss {loss}"
    assert equal, f"rank {rank}: parameters or moments differ between ranks after the step"
    return dict(rank=rank, device=str(device), backend=D.backend(),
                loss=loss, rank_loss=metrics["loss"].item(), reads=ma.launches - reads,
                ranks_equal=equal)


def dryrun_multichip(n: int, device=None, backend: Optional[str] = None, scale: int = 1):
    """One stage-4 train step of the models at `scale` over n ranks (one
    row of the global batch each, 64x64, S 2): the loss (the global
    batch's) must be finite and every rank's parameters and RAdam moments
    bit-identical.  Returns each rank's result."""
    resolve_device(device)
    results = D.spawn(_train_rank, n, device, backend, scale)
    print(f"dryrun_multichip({n}): one s4 train step OK on {results[0]['backend']}, "
          f"loss={results[0]['loss']:.4f} (" + ", ".join(
              f"rank {r['rank']} {r['device']}: its rows {r['rank_loss']:.4f}, "
              f"{r['reads']} reads" for r in results) + "), ranks bit-equal")
    return results


def eval_streams(n: int, h: int = DRYRUN_HW, w: int = DRYRUN_HW):
    """(frames [EVAL_FRAMES, n, H, W, 3], first trimaps [n, H, W, 3]) as
    __graft_entry__.py draws them: streams 1..n-1 one video, stream 0
    another; nested boxes of unknown and foreground."""
    rng = np.random.RandomState(0)
    shared = rng.rand(EVAL_FRAMES, 1, h, w, 3).astype(np.float32)
    frames = np.broadcast_to(shared, (EVAL_FRAMES, n, h, w, 3)).copy()
    frames[:, 0] = rng.rand(EVAL_FRAMES, h, w, 3) * 0.2
    tri = np.zeros((n, h, w, 3), np.float32)
    tri[..., 0] = 1.0
    tri[:, 16:48, 16:48] = (0, 1, 0)
    tri[:, 24:40, 24:40] = (0, 0, 1)
    return frames, tri


def _eval_rank(device, backend, scale):
    device = D.init_distributed(device, backend)
    group, rank, n = D.data_group(), D.process_index(), D.process_count()
    stm, fba = serving_models(device, scale=scale)
    frames, tri = eval_streams(n)
    h, w = tri.shape[1:3]
    bank = make_eval_bank(1, h, w, max_memory_num=EVAL_MEMORY, scale=scale, device=device)
    first_tri = torch.from_numpy(tri[rank:rank + 1]).to(device)
    reads = ma.launches
    with torch.no_grad():
        for i in range(EVAL_FRAMES):
            out = eval_frame_step(stm, fba, bank, torch.from_numpy(frames[i, rank:rank + 1]).to(
                device), first_tri, i == 0, True, False, max_memory_num=EVAL_MEMORY)
            bank = out.bank
            assert bool(out.alpha.isfinite().all()), f"rank {rank}: non-finite alpha, frame {i}"
            assert bool(out.trimap.isfinite().all()), f"rank {rank}: non-finite trimap, frame {i}"
    keys = D.all_gather_rows(bank.keys[0], group).cpu().numpy()     # [n, T, HW, Ck]
    # stream 0 saw other frames: another bank; streams 1.. the same: the same bank
    isolated = not np.allclose(keys[0], keys[1])
    identical = all(np.allclose(keys[b], keys[1], atol=1e-5) for b in range(2, n))
    assert isolated, "bank leaked across streams"
    assert identical, "identical streams must build identical banks"
    return dict(rank=rank, device=str(device), backend=D.backend(),
                reads=ma.launches - reads, isolated=isolated, identical=identical)


def dryrun_multichip_eval(n: int, device=None, backend: Optional[str] = None, scale: int = 1):
    """Multi-stream serving over n ranks, one stream each (B 1, 64x64),
    through eval_frame_step for 3 frames, memorizing every frame into a
    bank of 3: finite alphas and trimaps on every rank, and the ranks'
    bank keys, gathered, show each bank depends on its own stream alone.
    n >= 2.  Returns each rank's result."""
    if n < 2:
        raise ValueError("the isolation check compares two streams at least")
    resolve_device(device)
    results = D.spawn(_eval_rank, n, device, backend, scale)
    print(f"dryrun_multichip_eval({n}): {EVAL_FRAMES} frames x {n} streams OK on "
          f"{results[0]['backend']}, banks isolated (" + ", ".join(
              f"rank {r['rank']} {r['device']}: {r['reads']} reads" for r in results) + ")")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description="__graft_entry__.py's entry points on the port")
    p.add_argument("mode", nargs="?", default="entry", choices=("entry", "dryrun", "dryrun_eval"))
    p.add_argument("n", nargs="?", type=int, default=8, help="ranks of a dry run (default 8)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--backend", default=None, help="nccl (default on cuda) or gloo")
    p.add_argument("--scale", type=int, default=1, help="model width divisor of the dry runs")
    args = p.parse_args(argv)
    if args.mode == "dryrun":
        dryrun_multichip(args.n, args.device, args.backend, args.scale)
    elif args.mode == "dryrun_eval":
        dryrun_multichip_eval(args.n, args.device, args.backend, args.scale)
    else:
        fn, example = entry(args.device)
        print("entry OK:", [tuple(x.shape) for x in fn(*example)])


if __name__ == "__main__":
    main()
