"""The five training stages of the port, chained on the synthetic fixture
and scored: the counterpart of scripts/train_chain_r4.sh.

    python -m otvm_tpu_torch.tools.train_chain [--root build/chain] [--data DIR]
        [--repeats 20] [--epochs 3,4,2,2,8] [--workers 2] [--device cuda]

In --root (the CLIs write train_log/ and weights/ under their working
directory; the report goes to <root>/chain_report.json):
  0. the fixture: scripts/make_synth_data.py's defaults (112 train and 8
     val clips of 28 frames, 100 DIM foregrounds, seed 0) in <root>/data
     unless --data names one; the random-weight baseline
     (quality_check.random_baseline);
  1. trimap-s1 at lr 1e-4, then the learning gate (quality_check.gate,
     --min-gain 5): the chain stops if it fails;
  2. stage 1 at lr 1e-4, then dim_overfit tagged post_s1;
  3. stage 2 at lr 5e-5, from stage 1's FBA and trimap-s1's STM;
  4. stage 3 at lr 5e-5, then trained tagged pre_s4;
  5. stage 4 at lr 3e-5, then trained and onsynth tagged post_s4.
Each stage runs through its CLI's main(argv) in this process, with the
recipe's flags (--input-size 320 --bf16 --batch-size 2 --stm-gn, a
checkpoint every epoch, --resume of the stage's own checkpoint, which a
fresh stage does not have yet), and so replays its step from a CUDA graph
on CUDA.  A finished stage leaves train_log/chain/<stage>.done and is
skipped when the chain is run again; an unfinished one resumes from its
last epoch's checkpoint (`resume_check`): its first logged loss must
equal, bit for bit, the loss an eager step gives from that checkpoint on
the same batch, and on CUDA the graphed step from that checkpoint (eager
first, then captured, then replayed) must equal the eager step over
REPLAY_STEPS of the epoch's batches under torch's deterministic
algorithms (tools/train_graphs_check.py lockstep); else the chain stops
before the stage's .done.  A section already in the report is not run
again.  --repeats and --epochs scale the chain, and the report lists what
was cut.  To check a resume, kill a first run after a checkpoint and run
the chain again.

Per stage the report holds the steps, the wall seconds and ms a step,
the loop's wait on its batches (the CLI's loader_wait_s), the graphed
step alone at the stage's shape (CUDA events, the median of TIMED_STEPS
after a warm-up, from a fresh state on seeded batches) and the wall's
ratio to it, the Loader alone (ms a batch over TIMED_BATCHES of epoch 0,
no step), the logged losses with their running averages and steps, and
the head and tail means of the losses (the gate's fifths).  A non-finite
loss stops the stage at its log line, naming the first such step.
Needs a CUDA card unless --device cpu.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import itertools
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from . import quality_check as Q
from . import train_graphs_check as G

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMED_STEPS = 10
TIMED_BATCHES = 50
REPLAY_STEPS = 3        # the resume check's graphed steps: eager, captured, replayed


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str                 # the .done marker's name
    cli: str                  # otvm_tpu_torch.cli.<cli>
    stage: Optional[int]      # --stage (None: the trimap-s1 CLI)
    lr: str
    epochs: int               # the r4 recipe's
    weights: str              # the stage's checkpoint, weights/<model>
    init: tuple = ()          # the earlier stages' checkpoints it starts from

    def argv(self, data: str, epochs: int, workers: int, repeats: int = 20) -> List[str]:
        """train_chain_r4.sh's command line of the stage (and --repeats
        where it is not the CLIs' 20)."""
        stage = [] if self.stage is None else ["--stage", str(self.stage)]
        save = [] if self.stage is None else ["--save-every", "1"]
        return (stage + ["--data-root", data, "--input-size", "320", "--bf16", "--epochs",
                         str(epochs), "--batch-size", "2", "--lr", self.lr, "--workers",
                         str(workers)] + save + ["--stm-gn", *self.init, "--resume", self.weights]
                + ([] if repeats == 20 else ["--repeats", str(repeats)]))


STAGES = (
    Stage("s1t", "train_s1_trimap", None, "1e-4", 3, "weights/s1_OTVM_trimap"),
    Stage("s1", "train", 1, "1e-4", 4, "weights/s1_OTVM_alpha"),
    Stage("s2", "train", 2, "5e-5", 2, "weights/s2_OTVM_alpha",
          ("--init", "weights/s1_OTVM_alpha", "--init-trimap", "weights/s1_OTVM_trimap")),
    Stage("s3", "train", 3, "5e-5", 2, "weights/s3_OTVM", ("--init", "weights/s2_OTVM_alpha")),
    Stage("s4", "train", 4, "3e-5", 8, "weights/s4_OTVM", ("--init", "weights/s3_OTVM")),
)


def cli_main(cli: str) -> Callable:
    from importlib import import_module

    return import_module(f"otvm_tpu_torch.cli.{cli}").main


def stage_config(stage: Stage, argv: Sequence[str]):
    """(cfg, args) as the stage's CLI builds them from argv."""
    from ..cli import train as T

    cli = sys.modules[cli_main(stage.cli).__module__]
    args = cli.parse_args(argv)
    cfg = cli.get_cfg_defaults()
    cfg.train.stage = stage.stage or 1
    T.apply_overrides(cfg, args)
    return cfg, args


def _step_factory(stage: Stage, cfg, graphs: Optional[bool]):
    from ..train.trainer import make_train_step, make_trimap_s1_train_step

    if stage.cli == "train_s1_trimap":
        return make_trimap_s1_train_step(cfg, graphs=graphs)
    return make_train_step(cfg, graphs=graphs)


class _Restored:
    """train_graphs_check.lockstep's networks: the stage's checkpoint,
    restored into a fresh state at each run."""
    group = None

    def __init__(self, path: str, iters: int, device):
        self.path, self.iters, self.device = path, iters, device

    def fresh(self, cfg, optimizer):
        from ..train.trainer import init_train_state
        from ..utils.checkpoint import restore_train_state

        return restore_train_state(self.path, init_train_state(
            cfg, cfg.system.random_seed, self.iters, device=self.device))


def resume_check(stage: Stage, argv: Sequence[str], device) -> Optional[Dict]:
    """What the stage's run must give when it resumes from its checkpoint,
    on the first batches of the epoch it resumes at: `eager_loss`, the
    loss of one eager step (the run's first logged loss); on CUDA
    `replay`, the losses of REPLAY_STEPS graphed steps from the
    checkpoint, and `failures`, where those parted from the eager steps
    from the same states under torch's deterministic algorithms (loss,
    gradients, update, moments).  None if that epoch is past the last."""
    from ..cli import train as T
    from ..data.loader import encode_wire

    cfg, args = stage_config(stage, argv)
    dataset = T.training_set(cfg)
    iters = max(len(dataset) * args.repeats // cfg.train.batch_size, 1)
    restored = _Restored(stage.weights, iters, device)
    state = restored.fresh(cfg, None)
    epoch = state.step // iters
    if epoch >= cfg.train.total_epochs:
        return None
    keys = ("fg", "bg", "alpha", "tri") if stage.cli == "train_s1_trimap" else None
    batches = [encode_wire({k: b[k] for k in keys or b}) for b in itertools.islice(
        T.epoch_loader(cfg, dataset, epoch, args.repeats, cfg.train.batch_size), REPLAY_STEPS)]
    _, metrics = _step_factory(stage, cfg, graphs=False)(state, batches[0])
    out = dict(eager_loss=float(metrics["loss"].item()))
    del state, metrics
    if device.type == "cuda":
        case = G.Case(stage.name, REPLAY_STEPS, stage=cfg.train.stage,
                      trimap=stage.cli == "train_s1_trimap", bf16=cfg.train.bf16)
        result = G.lockstep(case, cfg, restored, batches)
        out.update(replay=[s["loss"] for s in result["steps"]], failures=G.verify(result))
    return out


def step_alone_ms(stage: Stage, argv: Sequence[str], device) -> float:
    """The stage's train step alone at its shape and dtype, as the CLI
    runs it (graphed on CUDA): the median CUDA-event ms of TIMED_STEPS
    after the eager first step and the capture, from a fresh state on
    seeded batches."""
    from ..train.trainer import init_train_state
    from .profile_train import seeded_batches, timed_step

    cfg, _ = stage_config(stage, argv)
    state = init_train_state(cfg, cfg.system.random_seed, 1000, device=device)
    step = _step_factory(stage, cfg, graphs=None)
    times = []
    for batch in seeded_batches(cfg, TIMED_STEPS + 2, seed=1):
        state, _, ms, _, _ = timed_step(step, state, batch)
        times.append(ms)
    return float(np.median(times[2:]))


def loader_alone_ms(stage: Stage, argv: Sequence[str]) -> float:
    """The stage's Loader alone, with no step: ms a batch over TIMED_BATCHES
    of epoch 0 after its first."""
    from ..cli import train as T

    cfg, args = stage_config(stage, argv)
    loader = T.epoch_loader(cfg, T.training_set(cfg), 0, args.repeats, cfg.train.batch_size)
    batches = iter(loader)
    next(batches)
    t0, n = time.perf_counter(), 0
    for n, _ in enumerate(itertools.islice(batches, TIMED_BATCHES), 1):
        pass
    batches.close()
    return 1e3 * (time.perf_counter() - t0) / max(n, 1)


def _head_tail(values: Sequence[float]) -> Dict:
    if len(values) < 4:
        return {}
    k = max(2, len(values) // 5)
    return dict(head_mean=float(np.mean(values[:k])), tail_mean=float(np.mean(values[-k:])))


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_stage(stage: Stage, argv: List[str], device) -> Dict:
    """One stage through its CLI; its record for the report, whose
    `failures` (a resume that parted from its checkpoint) stop the chain."""
    resumed = os.path.exists(stage.weights)
    check = resume_check(stage, argv, device) if resumed else None
    _free(device)
    t0 = time.perf_counter()
    res = cli_main(stage.cli)(argv + ["--device", str(device)])
    wall = time.perf_counter() - t0
    first = res["steps"][0] - 1 if res["steps"] else res["state"].step
    steps = res["state"].step - first
    rec = dict(argv=argv, resumed=resumed, start_epoch=res["start_epoch"],
               final_step=res["state"].step, steps=steps, wall_s=wall,
               wall_ms_a_step=1e3 * wall / max(steps, 1),
               loader_wait_s=res["loader_wait_s"],
               loader_wait_ms_a_step=1e3 * res["loader_wait_s"] / max(steps, 1),
               losses=res["losses"], averages=res["averages"], logged_steps=res["steps"],
               failures=[], **_head_tail(res["losses"]))
    if "ious" in res:
        rec["ious"] = res["ious"]
    if check is not None and res["losses"]:
        rec["resume_check"] = dict(first_logged_loss=res["losses"][0], **check)
        rec["failures"] = list(check.get("failures", []))
        if res["losses"][0] != check["eager_loss"]:
            rec["failures"].append(f"the first logged loss {res['losses'][0]!r} is not the "
                                   f"eager step's from the checkpoint, {check['eager_loss']!r}")
    del res
    _free(device)
    if device.type == "cuda":
        rec["step_alone_ms"] = step_alone_ms(stage, argv, device)
        rec["wall_over_step"] = rec["wall_ms_a_step"] / rec["step_alone_ms"]
        rec["loader_alone_ms_a_batch"] = loader_alone_ms(stage, argv)
        _free(device)
    return rec


def make_fixture(data: str) -> float:
    """make_synth_data.py's defaults into `data`; its seconds."""
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_synth_data.py"), data],
                   check=True, capture_output=True, text=True, timeout=3600)
    return time.perf_counter() - t0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default="build/chain")
    p.add_argument("--data", default=None, help="the fixture (default <root>/data, made there)")
    p.add_argument("--repeats", type=int, default=20, help="the datasets' repeats an epoch")
    p.add_argument("--epochs", default=",".join(str(s.epochs) for s in STAGES),
                   help="epochs of s1t,s1,s2,s3,s4")
    p.add_argument("--workers", type=int, default=2, help="the Loader's threads")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Runs what is left of the chain; returns the report."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":   # the resume check's lockstep, before the first cuBLAS call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", G.CUBLAS_DETERMINISTIC)
    epochs = [int(e) for e in args.epochs.split(",")]
    if len(epochs) != len(STAGES):
        raise ValueError(f"--epochs {args.epochs}: one count for each of {len(STAGES)} stages")
    os.makedirs(args.root, exist_ok=True)
    data = os.path.abspath(args.data or os.path.join(args.root, "data"))
    report_path = os.path.abspath(os.path.join(args.root, "chain_report.json"))
    cwd = os.getcwd()
    os.chdir(args.root)
    try:
        report = {}
        if os.path.exists(report_path):
            with open(report_path) as f:
                report = json.load(f)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip() if device.type == "cuda" else "cpu"
        report.setdefault("cards", []).append(card)
        report["reduced"] = {k: v for k, v in dict(
            repeats=None if args.repeats == 20 else f"{args.repeats} (r4: 20)",
            epochs=None if epochs == [s.epochs for s in STAGES]
            else f"{args.epochs} (r4: {','.join(str(s.epochs) for s in STAGES)})").items() if v}

        def save():
            with open(report_path, "w") as f:
                json.dump(report, f, indent=1)

        def section(key: str, fn: Callable[[], Dict]) -> None:
            if key not in report:
                t0 = time.perf_counter()
                report.update(fn())
                report.setdefault("section_s", {})[key] = time.perf_counter() - t0
                save()
                print(f"[chain] {key}: {json.dumps(report[key])}", flush=True)

        if args.data is None and not os.path.exists(os.path.join(data, "VideoMatting108")):
            report["fixture_s"] = make_fixture(data)
        section("trained_vm108_synth_random",
                lambda: Q.random_baseline(data, device=device))
        os.makedirs(os.path.join("train_log", "chain"), exist_ok=True)
        for stage, n in zip(STAGES, epochs):
            done = os.path.join("train_log", "chain", f"{stage.name}.done")
            if not os.path.exists(done):
                argv = stage.argv(data, n, args.workers, args.repeats)
                print(f"[chain] {stage.name}: {stage.cli} {' '.join(argv)}", flush=True)
                rec = run_stage(stage, argv, device)
                report.setdefault("stages", {}).setdefault(stage.name, []).append(rec)
                save()
                print(f"[chain] {stage.name}: {rec['steps']} steps, {rec['wall_s']:.1f} s, "
                      f"{rec['wall_ms_a_step']:.1f} ms a step (alone "
                      f"{rec.get('step_alone_ms', float('nan')):.1f}, waiting on the Loader "
                      f"{rec['loader_wait_ms_a_step']:.1f}), losses "
                      f"{rec['losses'][:1]} .. {rec['losses'][-1:]}, running average "
                      f"{rec['averages'][:1]} .. {rec['averages'][-1:]}, resume check "
                      f"{rec.get('resume_check')}", flush=True)
                if rec["failures"]:
                    raise RuntimeError(f"{stage.name} resumed wrongly: {rec['failures']}")
                if stage.name == "s1t":
                    verdict = Q.gate(os.path.join("train_log", "s1_OTVM_trimap"))
                    report.update(verdict)
                    save()
                    print(f"[chain] gate: {json.dumps(verdict)}", flush=True)
                    if not verdict["s1t_gate"]["passed"]:
                        raise SystemExit("trimap-s1 did not learn: the gate failed; the chain "
                                         "stops")
                with open(done, "w"):
                    pass
            if stage.name == "s1":
                section("dim_overfit_post_s1", lambda: Q.dim_overfit(
                    Q.load_weights(stage.weights, 1)[1], data, "post_s1", device=device))
            if stage.name == "s3":
                section("trained_vm108_synth_pre_s4", lambda: Q.trained(
                    *Q.load_weights(stage.weights, 4), data, "pre_s4", device=device))
        section("trained_vm108_synth_post_s4", lambda: Q.trained(
            *Q.load_weights(STAGES[-1].weights, 4), data, "post_s4", device=device))
        section("onsynth_variants_post_s4", lambda: Q.onsynth(
            *Q.load_weights(STAGES[-1].weights, 4), data, "post_s4", device=device))
        return report
    finally:
        os.chdir(cwd)


if __name__ == "__main__":
    main()
