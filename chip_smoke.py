#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (otvm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the memory-read kernels from otvm_tpu_torch/kernels/csrc (nvcc,
     sm_90a), timed; print ptxas's registers and spills; count the
     tensor-core instructions (HGMMA: wgmma, of them HGMMA ... TF32 the
     fp32 read's 3xTF32 ones; a TF32 HMMA, mma.sync, must be absent),
     TMA loads (UTMALDG) and cluster barriers
     (UCGABAR_*: the split reads' cluster merge) in the library: each must
     be there; print how many blocks and clusters of 2..8 blocks of each
     read kernel the card holds at once (the split rule's limits);
  3. the kernel against its plain PyTorch version on the card, fp32 (TF32
     off in the plain version) and bf16, at the stream's shapes (512p:
     HW=1024, T=6, 1..6 valid slots; 1088x1920: HW=8160, T=3), ragged
     tiles with a non-prefix mask, and no valid slot; split reads (one
     launch, merged in the kernel: in one cluster a tile, or through L2)
     at forced splits 2..8, each merge forced, and the chosen split, at
     512p, the training shapes, empty splits, ragged tiles, Ck=32 and
     Cv=384; a forced L2-merged read at 512p fp32 beside a kernel that
     holds 40 SMs on another CUDA stream (otvm_tpu_torch/tools/
     coresidency.py, in a child process): launched cooperatively, it must
     wait for them and match the plain read; then the whole read's time at
     512p count 5, 1088x1920 count 2 and 5 of 6, and the training shapes (B 4, HW 400,
     T 1 and 2) beside the plain version's, SDPA's (a yardstick only: the
     port never calls it) and the bound (fp32: at the 3xTF32 rate, the
     CUDA-core bound printed beside it).  Each comparison is the
     norm-relative error (otvm_tpu_torch/tools/kernel_check.py), and a
     lower-precision control must fail it;
  4. the full-width stage-4 stream through StreamingEvaluator.run_video:
     512x512, a bank of at most 5, memorize every 10th frame, random
     weights from a seed, fp32 (the evaluator's default dtype), once with
     the kernel and once with the plain read.  The read kernel must be
     launched once per segment call (frames - 1), each split and merged in
     the kernel (the 512p read splits), every read must match the plain read on the
     same inputs, and the two streams must agree on frames 0 and 1 (later
     frames are printed: see the note in main);
  5. the same stream in bf16 (the serving mode): a lockstep-checked
     warm-up, then timed: frames/sec, finite outputs, and frame 0 within a
     loose bound of the fp32 stream;
  6. training at full width.  First the read's autograd Function at the
     training shapes (B 4, HW 400 of a 320x320 crop, T 1 and 2, no mask,
     fp32 and bf16): its output and its three input gradients against
     autograd through the plain read (a lower-precision control must fail),
     memory_read_cuda refusing inputs that require grad, and the plain
     backward's time.  Then the
     stage-4 train step (make_train_step) at config.py's crop: 320x320,
     B 4, S 3, random weights from a seed, seeded encode_wire batches, fp32:
     8 steps with every read's forward and backward checked in lockstep, 2
     read launches a step, split and merged as launch_geometry says, a finite
     loss, the parameters unchanged through RAdam's 5 held-back steps and
     changed after; then timed steps (CUDA events), the peak memory and the
     read's share of a profiled step.  Then bf16 steps (bf16 kernel, fp32
     masters) and stage-1 trimap steps (make_trimap_s1_train_step), each
     launching the kernel with finite losses;
  7. the runner's other serving paths at full width, 512x512, random
     weights from seeds: MultiStreamEvaluator over three streams (30, 17
     and again the 30 frames) in fp32, every read in lockstep, 74 reads
     merged through L2, each stream equal to its serial run_video bit for
     bit, then in bf16, timed (aggregate frames/s); the chunked stream
     (chunk 8 over 30 frames: 29 reads, equal to run_video bit for bit);
     TrimapEvaluator with the stage-1 STM (29 reads in lockstep) and
     trimap_eval_step(memorize_gt) over 8 frames with a bank of 2 (slot 0
     evicted); stage 2 on given trimaps (no read); and a stage-4 stream on
     the resnet50_BN FBA trunk (6 frames, 5 reads in lockstep);
  8. the command-line entry points (otvm_tpu_torch/cli/) at full width,
     in this process through each one's main(argv), in a temporary working
     directory: scripts/make_synth_data.py writes 512x640 DIM images and
     VM108 clips (8 train, 2 val, 12 frames), a demo tree is made from the
     val clips; the Loader's rate at 8 and 2 threads; fp32 training at the
     recipe's crop and batch: train_s1_trimap (2 steps), stage 2 from its
     STM, stage 4 from stage 2, then --resume of stage 4, each with finite
     losses and 2 reads a step (every read checked in lockstep); then the
     eval CLI on those checkpoints over both val clips: stage 4 (22 reads
     in lockstep, 7 finite metrics), --streams 2 (the same PNG bytes),
     --trimap-net (22 reads, a finite IoU), --stage 2 on given trimaps (0
     reads), --demo --viz (strips written); 12 PNGs a clip each;
  9. data parallelism on the card: two ranks share it over gloo with CUDA
     tensors, asked for by name (NCCL takes one card a rank), through
     otvm_tpu_torch/tools/ddp_check.py: fp32 stage-4 training at the
     recipe's crop and global batch (320x320, 4: 2 a rank, S 3), 6 steps
     with every read (forward and backward) in lockstep in both ranks and
     the ranks' parameters and moments bit-equal after every step, 3 timed
     steps, a remat step (its re-run reads in lockstep too) and a bf16 step,
     and a trimap-s1 step; rank 0 then takes the same steps alone on the
     global batches, and the losses (rtol 1e-5), RAdam's moments and the
     parameters' change (norm-relative 1e-4) must agree; the 2-rank step's
     ms beside the 1-process one's and the gloo all-reduce's; then
     entry.py's dryrun_multichip(2) and dryrun_multichip_eval(2) over gloo;
 10. the compiled serving steps (otvm_tpu_torch/models/graphs.py: each
     frame's step replayed from a CUDA graph, the evaluators' default on
     CUDA), against the eager steps: the full-width 512x512 stream
     (30 frames) in fp32 and in bf16, a run that captures and a run that
     only replays, each equal to the eager stream bit for bit with 29 reads
     counted (replays included); captures, their seconds, frames/s and peak
     memory of each path; bf16 multi-stream (30, 17, 30 frames; 74 reads),
     chunk 8 (29), trimap propagation alone (fp32, 29) and stage 2 on given
     trimaps (0) equal to their eager runs bit for bit; a graph
     captured or replayed under a lockstep check refused; and every mode of
     the port's bench (python -m otvm_tpu_torch.bench, BENCH_FRAMES 60):
     default, BENCH_WIRE_OUT=1, BENCH_BATCH=4, BENCH_CHUNK=8 and default with
     --eager, each line printed;
 11. the compiled train steps (otvm_tpu_torch/train/graphs.py: each step
     after a key's first replayed from a CUDA graph, the trainer's default
     on one card) against the eager steps, through
     otvm_tpu_torch/tools/train_graphs_check.py, at config.py's crop,
     batch and clip length (320x320, B 4, S 3), random weights from a
     seed, seeded_batches: fp32 stage 4 over 11 steps with a stair
     schedule over 10 (RAdam's hold at steps 1-5, its updates from 6, the
     learning rate's drop at 10), bf16 stage 4 over 4, trimap-s1 over 4;
     under torch's deterministic algorithms (nn/ops.py's atomic-free
     forms), each graphed step beside two eager steps from the same state:
     the eager steps equal each other bit for bit, and the graphed one
     equals them (loss, gradients, change to the parameters, RAdam's
     moments), no parameter moved in RAdam's hold; a control with the
     decay alone frozen at a capture before the stair drop must fail that
     check at steps 10-11 and nowhere else; one capture a run, 2 reads a
     step counted at every replay and merged as launch_geometry says; then
     the graphed and the eager step each alone from the init in the
     default (atomic) mode, their losses of steps 1-6 (RAdam's hold: the
     init's parameters) equal bit for bit: ms a step, host ms in the step
     call, captures and their seconds, peak memory allocated and
     reserved;
 12. the data-parallel train step from CUDA graphs over NCCL
     (otvm_tpu_torch/train/graphs.py with a process group: each rank
     replays one graph a step holding GlobalSum's all-reduces and the
     bucketed gradient all-reduce), through otvm_tpu_torch/tools/
     ddp_check.py run_graphed, at full width, 320x320, global batch 4, S 3:
     2 ranks a card each where the machine has 2 cards, else a one-rank
     NCCL group (printed which); fp32 stage 4 over 8 steps (RAdam's hold,
     then its first updates), remat, bf16 and trimap-s1 over 2 each (the
     second a replay), every
     graphed step in lockstep with the eager step from the same state under
     torch's deterministic algorithms, bit for bit (loss, gradients, update,
     moments), the ranks bit-equal after every step, one capture a run, 2
     reads a step (4 with remat) counted at every replay; then the fp32
     step graphed and eager alone: ms a step, host ms, and NCCL's share of
     a profiled replay;
 13. what training teaches, through otvm_tpu_torch/tools/quality_check.py
     on phase 8's fixture (made again): dim_overfit (stage-1 alpha on the
     8 DIM images, the trimap given) on the random weights that
     `cli/train.py --stage 1 --stm-gn` starts from; that CLI's main,
     graphed, on those images (QUALITY_STEPS bf16 steps at the recipe's
     320x320, B 2); dim_overfit on its checkpoint, whose SAD must have
     fallen by SAD_DROP; then onsynth on random stage-4 weights, eagerly,
     its 3 x 11 reads (JFA fp32, exact EDT fp32, JFA bf16 over 12 frames)
     each held to the plain read in lockstep;
 14. the serving group norm (otvm_tpu_torch/kernels/csrc/group_norm.cu,
     built like the read; ptxas's report printed) through
     otvm_tpu_torch/tools/bench_group_norm.py: at every distinct shape of
     a stage-4 frame's 66 group norms at 1088x1920, bf16 and fp32, the
     kernels against F.group_norm and the activation in fp32 rounded once
     (norm-relative error; torch's own bf16 GroupNorm beside it), their
     device time beside the bound (3 x bytes over 3.35 TB/s), the plain
     version's and F.group_norm's (library_ms), summed over the frame.
     Its launches (replays counted) are read from the runs above: phase 5's
     timed graphed bf16 stream (66 a frame), phase 7's trimap-only stream
     and the train steps of phases 6 and 11 (none).
Phases 4-9 check every read of their fp32 paths in lockstep, so those paths
run eagerly (graphs=False, the CLIs' --eager); the others, phase 5's
timed bf16 stream (the main path) among them, are graphed.  The line before the last is a JSON
object with the kernel's numbers (launch counts include graph replays);
the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# phase 11 runs torch's deterministic algorithms, which ask this of cuBLAS
# before its first call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

H = W = 512
N_FRAMES = 30
MAX_MEM = 5
SKIP = 10
# H100 SXM dense peaks.  The fp32 kernel runs 3xTF32: three TF32 products
# (495 TFLOP/s) for each fp32 one.  On the CUDA cores fp32 is 67 TFLOP/s.
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
FP32_CUDA_CORES = 67e12
PEAK_BYTES = 3.35e12
# the stage-4 train step at config.py's defaults: batch, frames a clip, crop
TRAIN_B, TRAIN_S, TRAIN_HW = 4, 3, 320
TRAIN_TOKENS = (TRAIN_HW // 16) ** 2    # HW of the read at the crop: 400
# timed reads: b, hw, t, valid slots (None: no mask, as in training), label
TIMED = [(1, 1024, 6, 5, "512p count 5"), (1, 8160, 3, 2, "1088x1920 count 2"),
         (1, 8160, 6, 5, "1088x1920 count 5 of 6"),
         (TRAIN_B, TRAIN_TOKENS, 1, None, "train T=1"),
         (TRAIN_B, TRAIN_TOKENS, 2, None, "train T=2")]
# split reads held to plain at forced splits 2..8 (merged as the rule
# would), forced merges (cluster 1: through L2; cluster = splits: in a
# cluster), and the chosen split:
# b, hw, t, Ck, Cv, slot mask (per batch row, or one for all; None: none), label
SPLIT_SHAPES = [(1, 1024, 6, 128, 512, [1, 1, 1, 1, 1, 0], "512p count 5"),
                (TRAIN_B, TRAIN_TOKENS, 2, 128, 512, None, "train T=2"),
                (1, 48, 3, 128, 512, [0, 1, 0], "HW=48 (empty splits)"),
                (2, 70, 3, 128, 512, [[1, 0, 1], [0, 1, 1]], "HW=70 ragged, per-row masks"),
                (2, 64, 4, 32, 128, [[1, 1, 0, 0], [0, 0, 0, 1]], "Ck=32 Cv=128"),
                (1, 100, 2, 128, 384, [1, 1], "Cv=384")]
SPLIT_SETTINGS = ([(s, None) for s in range(2, 9)] + [(8, 1), (6, 1), (4, 1), (3, 1), (2, 1)]
                  + [(4, 4), (3, 3), (None, None)])
TRAIN_STEPS = 8         # RAdam holds back steps 1-5 (N_sma < 5) and updates from step 6
TRAIN_TIMED = 4
BF16_STEPS = 3
TRIMAP_STEPS = 3


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sass_counts(ma):
    """Phase 2: HGMMA (of them TF32), TF32 HMMA, UTMALDG and cluster-barrier (UCGABAR_*)
    instructions in the built library, and the cluster barrier's names."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(ma.library_path)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    barriers = re.findall(r"\bUCGABAR_\w+", sass)
    return {"HGMMA": len(re.findall(r"\bHGMMA\b", sass)),
            "HGMMA TF32": len(re.findall(r"\bHGMMA\.\S*TF32\b", sass)),
            "HMMA TF32": len(re.findall(r"\bHMMA\.\S*TF32\b", sass)),
            "UTMALDG": len(re.findall(r"\bUTMALDG\b", sass)),
            "UCGABAR": len(barriers)}, sorted(set(barriers))


def ptxas_report(log):
    """[(kernel<template args>, its -v lines: registers, spills, C75xx
    warnings)] from nvcc's output."""
    report = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d(memory_(?:read_tc|read_f32tc))I(.*?)EEv", line)
            name = f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2))) or m.group(2)}>" \
                if m else line.strip()
            report.append((name, []))
        elif report and ("registers" in line or "spill" in line or "C75" in line):
            report[-1][1].append(line.split(":", 1)[-1].strip())
    return report


def read_cost(dt, b, hw, count, ck=128, cv=512, t=None):
    """(bound ms, bound_by, fp32 CUDA-core bound ms or None) of one read:
    operations on this run's valid positions over the kernel's peak (fp32:
    3xTF32), bytes (q, the valid bank, out, mask) over the memory rate."""
    flops = 2.0 * b * hw * (count * hw) * (ck + cv)
    nbytes = dt.itemsize * (b * hw * ck + b * count * hw * (ck + cv) + b * hw * cv) + b * t
    name = str(dt).split(".")[-1]
    t_ops, t_bytes = flops / PEAK_FLOPS[name], nbytes / PEAK_BYTES
    cuda_cores = 1e3 * max(flops / FP32_CUDA_CORES, t_bytes) if name == "float32" else None
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", cuda_cores


def fmt_row(row) -> str:
    return ", ".join(f"{key} {val:.4g}" if isinstance(val, float) else f"{key} {val}"
                     for key, val in row.items())


def print_faster(dname, label, row):
    faster = row["ms"] < min(row["plain_ms"], row["library_ms"])
    print(f"  {'bf16' if dname == 'bfloat16' else 'fp32'} kernel faster than plain and SDPA "
          f"at {label}: {faster}")


def check(got, want, tol, what, ctl=None):
    """got within `tol` of want (norm-relative); the control, computed the
    plain way on inputs of a narrower type, must not be.  -> (rel, max
    |err|)."""
    from otvm_tpu_torch.tools.kernel_check import rel_err

    if not bool(got.float().isfinite().all()):
        raise AssertionError(f"non-finite output ({what})")
    rel, err = rel_err(got, want), (got.float() - want.float()).abs().max().item()
    line = f"  {what:40s} rel {rel:.3e} max|err| {err:.3e}"
    if ctl is not None:
        rel_ctl = rel_err(ctl, want)
        line += f"  control rel {rel_ctl:.3e}"
        assert rel_ctl > tol, f"the check at {tol} would pass the control ({what})"
    print(line + f"  (tol {tol:g})")
    assert rel <= tol, f"{what}: rel err {rel:.3e} > {tol:g}"
    return rel, err


def kernel_phase(torch, ma):
    """Phase 3: kernel vs plain at the stream's shapes; split reads at
    forced splits 2..8 and the chosen split; timings at 512p count 5,
    1088x1920 count 2 and the training shapes."""
    from otvm_tpu_torch.tools.kernel_check import (READ_TOL, control, device_ms, event_ms,
                                                   rel_err)

    gen = torch.Generator(device="cuda").manual_seed(0)
    prefix = lambda b, t, c: torch.arange(t, device="cuda")[None].expand(b, t) < c
    cases = [(1, 1024, 6, prefix(1, 6, c), f"512p count {c}") for c in (1, 3, 5, 6)]
    cases += [(1, 8160, 3, prefix(1, 3, 2), "1088x1920 count 2"),
              (2, 70, 3, torch.tensor([[True, False, True], [False, True, True]],
                                      device="cuda"), "HW=70 non-prefix mask"),
              (1, 1024, 6, prefix(1, 6, 0), "512p count 0")]
    randn = lambda *shape, dt: torch.randn(*shape, generator=gen, device="cuda").to(dt)
    inputs = lambda b, hw, t, ck, cv, dt: (randn(b, hw, ck, dt=dt), randn(b, t, hw, ck, dt=dt),
                                           randn(b, t, hw, cv, dt=dt))
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for b, hw, t, mask, label in cases:
            q, k, v = inputs(b, hw, t, 128, 512, dt)
            got = ma.memory_read(q, k, v, mask)
            torch.cuda.synchronize()
            want = ma.memory_read_plain(q, k, v, mask)
            ctl = ma.memory_read_plain(control(q), control(k), control(v), mask)
            check(got, want, READ_TOL[dt], f"kernel {dname} {label}", ctl)

    # split reads: one launch each, merged in the kernel; forced 2..8,
    # forced merges (where the L2 merge's grid fits on the card at once),
    # then the wrapper's own choice
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for b, hw, t, ck, cv, rows, label in SPLIT_SHAPES:
            q, k, v = inputs(b, hw, t, ck, cv, dt)
            mask = None if rows is None else \
                torch.tensor(rows, dtype=torch.bool, device="cuda").expand(b, t).contiguous()
            want = ma.memory_read_plain(q, k, v, mask)
            rel_ctl = rel_err(ma.memory_read_plain(control(q), control(k), control(v), mask), want)
            table = ma.max_active_clusters(dt, ck, cv)
            rels = {}
            tiles = -(-hw // ma.query_tile(dt)) * (cv // ma.value_tile(cv)) * b
            for splits, blocks in SPLIT_SETTINGS:
                if blocks == 1 and tiles * splits > table[1]:
                    continue
                n, c = ma.launch_geometry(b, hw, t, cv, dt, table, splits, blocks)[2:]
                before = merges(ma)
                got = ma.memory_read_cuda(q, k, v, mask, _splits=splits, _cluster=blocks)
                torch.cuda.synchronize()
                assert merges(ma) == (before[0] + (c > 1), before[1] + (n > c)), \
                    f"{label}: splits {n}, blocks {c}"
                assert bool(got.float().isfinite().all()), f"non-finite split read ({label})"
                rels[f"{'chosen ' if splits is None else ''}{n}x{c}"] = rel_err(got, want)
            print(f"  split reads {dname:8s} {label}: rel err at splits x blocks " +
                  ", ".join(f"{key} {r:.2e}" for key, r in rels.items()) +
                  f"; control {rel_ctl:.2e} (tol {READ_TOL[dt]:g})")
            rels = list(rels.values())
            assert rel_ctl > READ_TOL[dt], f"the check would pass the control ({label})"
            assert max(rels) <= READ_TOL[dt], f"split read {dname} {label}: rel err {max(rels):.3e}"

    # the L2 merge's wait inside its launch, with SMs held by a kernel on
    # another stream; in a child process, as a trap ends a CUDA context
    from otvm_tpu_torch.tools import coresidency

    held = coresidency.run_case()
    nan = float("nan")
    print(f"  L2 merge beside a kernel holding {held.get('held_resident')} SMs on another "
          f"stream ({coresidency.HOLD_S:g} s): the forced 512p fp32 read "
          f"({held.get('read_blocks')} blocks, {held.get('card_blocks')} on the empty card) "
          f"finished {held.get('finished')}, waited {held.get('wait_s', nan):.3f} s, rel err "
          f"{held.get('rel_err', nan):.3e} (tol {READ_TOL[torch.float32]:g}); the hold still "
          f"running at its end: {held.get('hold_running_at_read_end')}"
          + (f"; {held['error']}" if "error" in held else ""))
    assert held.get("ok"), f"the L2 merge beside held SMs failed: {held}"

    # timings of the whole read (the split merged in its one launch): the
    # stream's steady state (512p, 5 valid slots of 6), 1088x1920 (the
    # VM108 protocol's large inputs: 2 valid slots of 3), and the training
    # shapes (no mask)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    timing = {}
    for b, hw, t, count, label in TIMED:
        for dname in ("bfloat16", "float32"):
            dt = getattr(torch, dname)
            q, k, v = inputs(b, hw, t, 128, 512, dt)
            mask = None if count is None else prefix(b, t, count)
            pos_mask = None if mask is None else \
                mask.repeat_interleave(hw, dim=1)[:, None, None, :]   # [B,1,1,T*HW]
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, None], k.reshape(b, 1, t * hw, 128), v.reshape(b, 1, t * hw, 512),
                attn_mask=pos_mask)
            want = ma.memory_read_plain(q, k, v, mask)
            rel, err = check(ma.memory_read(q, k, v, mask), want, READ_TOL[dt],
                             f"kernel {dname} {label} (timed)",
                             ma.memory_read_plain(control(q), control(k), control(v), mask))
            check(sdpa()[:, 0], want, READ_TOL[dt], f"SDPA yardstick {dname} {label}")
            bound_ms, bound_by, cuda_cores_ms = read_cost(dt, b, hw, count or t, t=t)
            splits, blocks = ma.launch_geometry(b, hw, t, 512, dt,
                                                ma.max_active_clusters(dt, 128, 512))[2:]
            row = timing[dname, label] = dict(
                ms=device_ms(lambda: ma.memory_read(q, k, v, mask), flush=flush),
                event_ms=event_ms(lambda: ma.memory_read(q, k, v, mask), flush=flush),
                plain_ms=device_ms(lambda: ma.memory_read_plain(q, k, v, mask), flush=flush),
                library_ms=device_ms(sdpa, flush=flush),
                bound_ms=bound_ms, bound_by=bound_by, rel_err=rel, max_abs_err=err,
                splits=splits, cluster_blocks=blocks)
            if cuda_cores_ms is not None:
                row["bound_cuda_cores_ms"] = cuda_cores_ms
            print(f"  time {dname:8s} {label}: " + fmt_row(row))
            print_faster(dname, label, row)
    return timing, held


def read_grad_phase(torch, ma, flush):
    """Phase 6, first part: the read's autograd Function at the training
    shapes, against autograd through the plain read; the plain backward's
    time (the forward's is phase 3's)."""
    from otvm_tpu_torch.tools.kernel_check import (GRAD_TOL, READ_TOL, control, device_ms,
                                                   plain_read_grads)

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, hw = TRAIN_B, TRAIN_TOKENS
    timing = {}
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for t in range(1, TRAIN_S):
            label = f"train T={t}"
            q = torch.randn(b, hw, 128, generator=gen, device="cuda").to(dt)
            k = torch.randn(b, t, hw, 128, generator=gen, device="cuda").to(dt)
            v = torch.randn(b, t, hw, 512, generator=gen, device="cuda").to(dt)
            g = torch.randn(b, hw, 512, generator=gen, device="cuda").to(dt)
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            out = ma.memory_read(*leaves)
            assert out.grad_fn is not None, "memory_read on inputs that require grad: no grad_fn"
            grads = torch.autograd.grad(out, leaves, g)
            torch.cuda.synchronize()
            ctl_q, ctl_k, ctl_v = control(q), control(k), control(v)
            check(out.detach(), ma.memory_read_plain(q, k, v), READ_TOL[dt],
                  f"Function forward {dname} {label}", ma.memory_read_plain(ctl_q, ctl_k, ctl_v))
            grad_rel = [check(got, want, GRAD_TOL[dt], f"Function d{name} {dname} {label}", ctl)[0]
                        for got, want, ctl, name in zip(
                            grads, plain_read_grads(q, k, v, None, g),
                            plain_read_grads(ctl_q, ctl_k, ctl_v, None, g), ("q", "k", "v"))]
            refused = False
            try:
                ma.memory_read_cuda(*leaves)
            except RuntimeError:
                refused = True
            assert refused, "memory_read_cuda returned a result without a gradient"
            row = timing[dname, label] = dict(
                grad_rel_err=max(grad_rel),
                backward_plain_ms=device_ms(lambda: ma.memory_read_vjp_plain(q, k, v, None, g),
                                            flush=flush))
            print(f"  time {dname:8s} {label} backward: " + fmt_row(row))
    return timing


def merges(ma):
    """(split launches merged in a cluster, through L2) so far."""
    return ma.cluster_launches, ma.l2_merge_launches


def merges_per_step(ma, dt):
    """Of a clip's reads (banks of 1 .. S-1 slots at the crop), how many
    split and merge in a cluster, and how many through L2."""
    table = ma.max_active_clusters(dt, 128, 512)
    kinds = [ma.launch_geometry(TRAIN_B, TRAIN_TOKENS, t, 512, dt, table)[2:]
             for t in range(1, TRAIN_S)]
    return (sum(c > 1 for _, c in kinds), sum(n > c for n, c in kinds))


def train_phase(torch, ma, card):
    """Phase 6, second part: full-width training through the trainer's
    entry points."""
    from otvm_tpu_torch import config
    from otvm_tpu_torch.kernels import group_norm as gn
    from otvm_tpu_torch.tools.profile_train import profile_step, seeded_batches, timed_step
    from otvm_tpu_torch.tools.kernel_check import lockstep_check, lockstep_grad_check
    from otvm_tpu_torch.train import trainer as T

    cfg = config.get_cfg_defaults()
    cfg.train.stage = 4
    assert (cfg.train.batch_size, cfg.train.frame_num, tuple(cfg.train.train_input_size)) == \
        (TRAIN_B, TRAIN_S, (TRAIN_HW, TRAIN_HW)), "config.py's stage-4 crop changed"
    batches = seeded_batches(cfg, TRAIN_STEPS + TRAIN_TIMED + 1, seed=1)
    state = T.init_train_state(cfg, seed=0)
    step = T.make_train_step(cfg, graphs=False)     # lockstep-checked: eager
    params = state.optimizer.param_groups[0]["params"]
    start = [p.detach().clone() for p in params]
    reads_per_step = TRAIN_S - 1
    split32, split16 = (merges_per_step(ma, dt) for dt in (torch.float32, torch.bfloat16))
    out = dict(params=sum(p.numel() for p in params), reads_per_step=reads_per_step,
               merges_per_step=split32, bf16_merges_per_step=split16)

    torch.cuda.synchronize()
    ma.launches = ma.cluster_launches = ma.l2_merge_launches = gn.launches = 0
    with lockstep_check(torch.float32) as fwd_errs, \
            lockstep_grad_check(torch.float32) as bwd_errs:
        for i in range(TRAIN_STEPS):
            state, metrics = step(state, batches[i])
            loss = metrics["loss"].item()
            moved = any(not torch.equal(p, p0) for p, p0 in zip(params, start))
            print(f"  fp32 step {i + 1}: loss {loss:.6f} (" + ", ".join(
                f"{k} {v.item():.5f}" for k, v in metrics.items() if k != "loss") +
                f"), parameters moved: {moved}")
            assert np.isfinite(loss), f"fp32 step {i + 1}: loss {loss}"
            assert moved == (i >= 5), f"fp32 step {i + 1}: RAdam should " \
                f"{'update' if i >= 5 else 'hold back'} (parameters moved: {moved})"
    out.update(launches=ma.launches, merges=merges(ma), fwd_err=max(fwd_errs),
               bwd_err=max(bwd_errs))
    print(f"  launches in {TRAIN_STEPS} fp32 steps: memory_read {ma.launches}, of them merged in "
          f"a cluster / through L2 {merges(ma)} (want {reads_per_step} and {split32} a step); "
          f"every read vs plain on its own inputs: forward rel err <= {max(fwd_errs):.3e}, "
          f"backward <= {max(bwd_errs):.3e}")
    assert ma.launches == len(fwd_errs) == len(bwd_errs) == reads_per_step * TRAIN_STEPS, \
        "the fp32 train steps did not run the kernel and its backward once per read"
    assert merges(ma) == tuple(n * TRAIN_STEPS for n in split32), \
        "the fp32 train steps did not split their reads as launch_geometry says"

    torch.cuda.reset_peak_memory_stats()
    ev_ms, wall_ms = [], []
    for i in range(TRAIN_TIMED):
        state, metrics, e, w, _ = timed_step(step, state, batches[TRAIN_STEPS + i])
        assert np.isfinite(metrics["loss"].item())
        ev_ms.append(e)
        wall_ms.append(w)
    out.update(step_ms=float(np.median(ev_ms)), step_wall_ms=float(np.median(wall_ms)),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase6_trace")
    state, trace = profile_step(step, state, batches[-1], trace_dir)
    busy_ms, read_ms, bwd_ms = trace["device_busy_ms"], trace["read_ms"], trace["read_backward_ms"]
    out.update(profiled_device_ms=busy_ms, profiled_read_ms=read_ms, profiled_read_bwd_ms=bwd_ms)
    print(f"  fp32 stage-4 step, {TRAIN_HW}x{TRAIN_HW}, B {TRAIN_B}, S {TRAIN_S}: "
          f"{out['step_ms']:.1f} ms (CUDA events, median of {TRAIN_TIMED}: "
          f"{', '.join(f'{x:.1f}' for x in ev_ms)}), wall {out['step_wall_ms']:.1f} ms, "
          f"peak memory {out['peak_gb']:.2f} GB, on {card}")
    share = lambda ms: f"{ms:.3f} ms ({ms / busy_ms:.3%})" if ms and busy_ms else "not measured"
    print(f"  profiled step: device {busy_ms:.1f} ms, read kernels {share(read_ms)}, read "
          f"backward {share(bwd_ms)}; Chrome trace build/phase6_trace/trace.json "
          f"({os.path.getsize(os.path.join(trace_dir, 'trace.json')) / 1e6:.1f} MB)")

    # bf16: the same state; bf16 copies of the weights feed the networks
    cfg.train.bf16 = True
    step16 = T.make_train_step(cfg, graphs=False)
    with lockstep_check(torch.bfloat16) as f16, \
            lockstep_grad_check(torch.bfloat16) as b16:          # warm-up, checked
        state, metrics = step16(state, batches[0])
    assert np.isfinite(metrics["loss"].item())
    torch.cuda.synchronize()
    ma.launches = ma.cluster_launches = ma.l2_merge_launches = 0
    torch.cuda.reset_peak_memory_stats()
    ev16, losses16 = [], []
    for i in range(BF16_STEPS):
        state, metrics, e, _, _ = timed_step(step16, state, batches[1 + i])
        ev16.append(e)
        losses16.append(metrics["loss"].item())
    out.update(bf16_launches=ma.launches, bf16_merges=merges(ma),
               bf16_step_ms=float(np.median(ev16)),
               bf16_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"  bf16 stage-4 steps: losses {', '.join(f'{x:.5f}' for x in losses16)}; "
          f"{out['bf16_step_ms']:.1f} ms a step (median of {BF16_STEPS}), peak memory "
          f"{out['bf16_peak_gb']:.2f} GB; launches memory_read {ma.launches}, of them merged in "
          f"a cluster / through L2 {merges(ma)} (want {split16} a step); warm-up step vs plain: "
          f"forward <= {max(f16):.3e}, backward <= {max(b16):.3e}")
    assert all(np.isfinite(losses16)), "bf16 train step: non-finite loss"
    assert ma.launches == reads_per_step * BF16_STEPS, "the bf16 steps did not run the kernel"
    assert merges(ma) == tuple(n * BF16_STEPS for n in split16)
    del state, step, step16, start
    torch.cuda.empty_cache()

    # stage-1 trimap training: the STM alone, frames composited on the card
    cfg1 = config.get_cfg_defaults()
    state1 = T.init_train_state(cfg1, seed=2)
    step1 = T.make_trimap_s1_train_step(cfg1, graphs=False)
    split1 = merges_per_step(ma, torch.bfloat16 if cfg1.train.bf16 else torch.float32)
    ma.launches = ma.cluster_launches = ma.l2_merge_launches = 0
    losses1, ms1 = [], []
    for i in range(TRIMAP_STEPS):
        state1, metrics, e, _, _ = timed_step(step1, state1, batches[i])
        assert metrics["pred_lab"].shape == (TRAIN_B, TRAIN_S, TRAIN_HW, TRAIN_HW)
        losses1.append(metrics["loss"].item())
        ms1.append(e)
    out.update(trimap_launches=ma.launches, trimap_merges=merges(ma),
               trimap_step_ms=float(np.median(ms1)))
    print(f"  trimap-s1 steps: losses {', '.join(f'{x:.5f}' for x in losses1)}; "
          f"{out['trimap_step_ms']:.1f} ms a step; launches memory_read {ma.launches}, of them "
          f"merged in a cluster / through L2 {merges(ma)} (want {split1} a step)")
    assert all(np.isfinite(losses1)), "trimap-s1 train step: non-finite loss"
    assert ma.launches == reads_per_step * TRIMAP_STEPS, "the trimap steps did not run the kernel"
    assert merges(ma) == tuple(n * TRIMAP_STEPS for n in split1)
    # training keeps nn.GroupNorm: none of the steps above ran the serving norm
    out["group_norm_launches"] = gn.launches
    print(f"  group_norm launches in the fp32, bf16 and trimap-s1 steps above: {gn.launches}")
    assert gn.launches == 0, "a train step ran the serving group norm"
    return out


def reset_counts(torch, ma):
    torch.cuda.synchronize()
    ma.launches = ma.cluster_launches = ma.l2_merge_launches = 0


def serving_phase(torch, ma, card, stm_sd, fba_sd, frames, tri, serial):
    """Phase 7: the runner's other serving paths at full width, 512x512,
    every read of the fp32 paths checked in lockstep.  `serial` is phase
    4's fp32 run_video of `frames` ((alphas, trimaps)), the per-frame
    reference of the multi-stream and chunked runs."""
    from otvm_tpu_torch.eval.runner import (EvalProtocol, MultiStreamEvaluator,
                                            StreamingEvaluator, TrimapEvaluator)
    from otvm_tpu_torch.kernels import group_norm as gn
    from otvm_tpu_torch.models.otvm import init_models, make_eval_bank, trimap_eval_step
    from otvm_tpu_torch.tools.kernel_check import lockstep_check

    out = {}
    proto = dict(memory_max_num=MAX_MEM, memory_skip_frame=SKIP)
    frames_b, tri_b = make_video(17, seed=1)
    clips = [dict(frames=frames, first_trimap=tri), dict(frames=frames_b, first_trimap=tri_b),
             dict(frames=frames, first_trimap=tri)]
    same = lambda xs, ys: len(xs) == len(ys) and all(np.array_equal(x, y) for x, y in zip(xs, ys))

    # multi-stream, fp32: A (30 frames), B (17, another seed), C = A again
    multi = MultiStreamEvaluator(stm_sd, fba_sd, EvalProtocol(dtype="fp32", **proto), graphs=False)
    serial_b = multi.run_video(frames_b, tri_b)[:2]
    reset_counts(torch, ma)
    with lockstep_check(torch.float32) as errs:
        results, fps32 = multi.run_videos(clips)
    out["multistream_fp32"] = dict(launches=ma.launches, merges=merges(ma), read_err=max(errs),
                                   frames_per_s_with_lockstep=fps32)
    want = N_FRAMES - 1 + 16 + N_FRAMES - 1
    print(f"  multi-stream fp32, 3 streams (30, 17, 30 frames): memory_read {ma.launches} launches "
          f"(want {want}), merged in a cluster / through L2 {merges(ma)}; every read vs plain: rel "
          f"err <= {max(errs):.3e}; {fps32:.2f} frames/s (lockstep-checked)")
    assert ma.launches == len(errs) == want and merges(ma) == (0, want), \
        "the multi-stream run did not read once per segment call, each merged through L2"
    for k, (alphas, trimaps) in enumerate(results):
        check_outputs(alphas, trimaps, len(clips[k]["frames"]), f"multi-stream {k}")
    equal = [same(results[0][0], serial[0]) and same(results[0][1], serial[1]),
             same(results[1][0], serial_b[0]) and same(results[1][1], serial_b[1]),
             same(results[2][0], results[0][0]) and same(results[2][1], results[0][1])]
    print(f"  multi-stream vs serial run_video, bit for bit: A {equal[0]}, B {equal[1]}; "
          f"C vs A {equal[2]}")
    assert all(equal), "the multi-stream outputs differ from the serial streams'"
    del multi

    # multi-stream, bf16, graphed, timed after a warm-up that captures its graphs
    multi16 = MultiStreamEvaluator(stm_sd, fba_sd, EvalProtocol(dtype="bf16", **proto))
    multi16.run_videos(clips)
    reset_counts(torch, ma)
    results16, fps16 = multi16.run_videos(clips)
    out["multistream_bf16"] = dict(launches=ma.launches, merges=merges(ma), frames_per_s=fps16)
    for k, (alphas, trimaps) in enumerate(results16):
        check_outputs(alphas, trimaps, len(clips[k]["frames"]), f"bf16 multi-stream {k}")
    assert ma.launches == want, "the bf16 multi-stream run did not read once per segment call"
    print(f"multistream_512p_joint_s4_bf16: {fps16:.3f} frames/s aggregate (3 streams, "
          f"{sum(len(c['frames']) for c in clips)} frames, run_videos, wall clock) on {card}")
    del multi16

    # chunked, fp32: 8 frames a call over 30, the last chunk short
    chunked = StreamingEvaluator(stm_sd, fba_sd, EvalProtocol(dtype="fp32", chunk=8, **proto),
                                 graphs=False)
    reset_counts(torch, ma)
    with lockstep_check(torch.float32) as errs:
        ca, ct, cfps = chunked.run_video(frames, tri)
    out["chunked_fp32"] = dict(launches=ma.launches, merges=merges(ma), read_err=max(errs),
                               frames_per_s_with_lockstep=cfps)
    equal = same(ca, serial[0]) and same(ct, serial[1])
    print(f"  chunked fp32 (chunk 8, 30 frames): memory_read {ma.launches} launches, merged "
          f"{merges(ma)}; rel err <= {max(errs):.3e}; equal to run_video bit for bit: {equal}")
    assert ma.launches == N_FRAMES - 1 and equal, "the chunked stream is not the per-frame one"
    del chunked

    # trimap propagation alone, fp32: the stage-1 STM
    stm1 = init_models(seed=3, stage=1)[0].state_dict()
    trimap_ev = TrimapEvaluator(stm1, EvalProtocol(**proto), graphs=False)
    reset_counts(torch, ma)
    gn.launches = 0
    with lockstep_check(torch.float32) as errs:
        tris, tfps = trimap_ev.run_video(frames, tri)
    out["trimap_fp32"] = dict(launches=ma.launches, merges=merges(ma), read_err=max(errs),
                              frames_per_s_with_lockstep=tfps, group_norm_launches=gn.launches)
    print(f"  trimap-only fp32 (30 frames): memory_read {ma.launches} launches, merged "
          f"{merges(ma)}; rel err <= {max(errs):.3e}; {tfps:.2f} frames/s (lockstep-checked); "
          f"group_norm {gn.launches} launches")
    assert ma.launches == N_FRAMES - 1, "the trimap stream did not read once per segment call"
    assert gn.launches == 0, "the trimap stream (frozen-BN STM, no GroupNorm) ran the group norm"
    assert len(tris) == N_FRAMES and all(t.shape == (H, W, 3) and np.isfinite(t).all()
                                         for t in tris)
    # memorize_gt: every frame memorized with the GT trimap, the bank (at
    # most 2) evicting slot 0 on overflow
    bank = make_eval_bank(1, H, W, 2)
    first_tri = torch.from_numpy(tri[None]).cuda()
    counts, first_key = [], None
    reset_counts(torch, ma)
    with lockstep_check(torch.float32) as errs:
        for i in range(8):
            frame = torch.from_numpy(frames[i][None]).cuda()
            bank, _ = trimap_eval_step(trimap_ev.stm, bank, frame, first_tri, i == 0, i % 3 == 0,
                                       2, memorize_gt=True)
            counts.append(bank.count)
            if i == 0:
                first_key = bank.keys[:, 0].clone()
    evicted = not torch.equal(bank.keys[:, 0], first_key)
    out["trimap_memorize_gt"] = dict(launches=ma.launches, counts=counts, slot0_evicted=evicted)
    print(f"  trimap_eval_step(memorize_gt) 8 frames, bank of at most 2: counts {counts}, slot 0 "
          f"evicted {evicted}; {ma.launches} launches, rel err <= {max(errs):.3e}")
    assert ma.launches == 7 and counts == [1, 2, 2, 2, 2, 2, 2, 2] and evicted
    del trimap_ev

    # given trimaps, stage 2: FBA alone, no read
    fba2 = init_models(seed=4, stage=2)[1].state_dict()
    given = StreamingEvaluator(None, fba2, EvalProtocol(stage=2, **proto))
    gts = [tri, tri[::-1].copy(), tri[:, ::-1].copy(), tri, tri]
    reset_counts(torch, ma)
    ga, gt, _ = given.run_video(frames[:5], tri, gt_trimaps=gts)
    out["given_trimap_stage2"] = dict(launches=ma.launches)
    print(f"  given trimaps, stage 2, 5 frames: memory_read {ma.launches} launches; alpha in "
          f"[{min(a.min() for a in ga):.4f}, {max(a.max() for a in ga):.4f}]")
    assert ma.launches == 0 and len(ga) == 5 and all(t is g for t, g in zip(gt, gts))
    assert all(a.shape == (H, W) and np.isfinite(a).all() and 0 <= a.min() <= a.max() <= 1
               for a in ga)
    del given

    # the BN FBA trunk, stage 4, fp32
    stm_bn, fba_bn = init_models(seed=5, stage=4, arch="resnet50_BN")
    bn = StreamingEvaluator(stm_bn.state_dict(), fba_bn.state_dict(),
                            EvalProtocol(arch="resnet50_BN", **proto), graphs=False)
    reset_counts(torch, ma)
    with lockstep_check(torch.float32) as errs:
        ba, bt, _ = bn.run_video(frames[:6], tri)
    out["bn_trunk_stage4_fp32"] = dict(launches=ma.launches, merges=merges(ma), read_err=max(errs))
    check_outputs(ba, bt, 6, "resnet50_BN stream")
    print(f"  resnet50_BN stage-4 stream, 6 frames: memory_read {ma.launches} launches, merged "
          f"{merges(ma)}; rel err <= {max(errs):.3e}")
    assert ma.launches == 5, "the BN-trunk stream did not read once per segment call"
    del bn
    torch.cuda.empty_cache()
    return out


# phase 8's fixture: scripts/make_synth_data.py's 512x640 clips and images
SYNTH_ARGS = ["--n-train", "8", "--n-val", "2", "--frames", "12", "--dim-fg", "8",
              "--dim-bg", "8", "--seed", "0"]
SYNTH_FRAMES, SYNTH_HW = 12, (512, 640)


def write_demo_tree(root, clips):
    """The demo layout (<seq>/frames/*.jpg, <seq>/trimap/<first>.png) from
    VM108 clips: the frames as JPEG, the first frame's GT trimap (radius
    12) as a gray PNG of labels x 127."""
    import cv2

    from otvm_tpu_torch.data.trimap import trimap_from_alpha

    for vid in clips:
        fdir = os.path.join(root, vid["seq_name"], "frames")
        tdir = os.path.join(root, vid["seq_name"], "trimap")
        os.makedirs(fdir)
        os.makedirs(tdir)
        for name, f in zip(vid["filenames"], vid["frames"]):
            bgr = np.rint(f[..., ::-1] * 255.0).astype(np.uint8)
            cv2.imwrite(os.path.join(fdir, os.path.splitext(name)[0] + ".jpg"), bgr)
        label = trimap_from_alpha(vid["gt_alpha"][0], 12).argmax(-1).astype(np.uint8) * 127
        cv2.imwrite(os.path.join(tdir, os.path.splitext(vid["filenames"][0])[0] + ".png"), label)


LOADER_REPEATS = 12      # 8 DIM foregrounds x 12 / B 4: 24 batches a pass


def loader_rates(root, threads=(8, 2, 2, 8)):
    """The training Loader's rate over DIMTrain at the recipe's crop, batch
    and clip length, at each thread count in turn (in ABBA order, against
    the host's drift): batches/s in steady state, from the arrival of batch
    `n` (n threads, every one of them busy since the start) to the last
    one's, so the pipeline's fill is left out.  Returns [(threads,
    batches/s, batches timed, seconds of the pass)]."""
    from otvm_tpu_torch.data.datasets import DIMTrain
    from otvm_tpu_torch.data.loader import Loader, epoch_indices

    ds = DIMTrain.from_adobe_layout(root, image_shape=(TRAIN_HW, TRAIN_HW), sample_length=TRAIN_S)
    idx = epoch_indices(len(ds), 0, repeats=LOADER_REPEATS)
    rates = []
    for n in threads:
        t0 = time.perf_counter()
        arrivals = [time.perf_counter() for _ in Loader(ds, idx, TRAIN_B, seed=1, num_threads=n)]
        assert len(arrivals) == len(idx) // TRAIN_B > 2 * max(threads)
        timed = len(arrivals) - n
        rates.append((n, timed / (arrivals[-1] - arrivals[n - 1]), timed, arrivals[-1] - t0))
    return rates


def entry_points_phase(torch, ma, card):
    """Phase 8: the command-line entry points (otvm_tpu_torch/cli/), chained
    at full width in this process through each one's main(argv), in a
    temporary working directory: trimap-s1 -> stage 2 -> stage 4 -> resume
    on scripts/make_synth_data.py's data, then the eval CLI on the
    checkpoints, every read counted (and those of the training runs and the
    first eval run checked against the plain read in lockstep)."""
    import shutil
    import tempfile

    from otvm_tpu_torch.cli import eval as cli_eval
    from otvm_tpu_torch.cli import train as cli_train
    from otvm_tpu_torch.cli import train_s1_trimap as cli_s1
    from otvm_tpu_torch.eval.runner import iter_vm108_videos
    from otvm_tpu_torch.tools.kernel_check import lockstep_check, lockstep_grad_check

    repo = os.path.dirname(os.path.abspath(__file__))
    out, times = {}, {}
    t8 = time.perf_counter()
    cwd, tmp = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        os.chdir(tmp)
        t = time.perf_counter()
        subprocess.run([sys.executable, os.path.join(repo, "scripts", "make_synth_data.py"),
                        "data"] + SYNTH_ARGS, check=True, capture_output=True, text=True,
                       timeout=300)
        clips = list(iter_vm108_videos("data", "val"))
        assert [len(v["frames"]) for v in clips] == [SYNTH_FRAMES] * 2
        assert clips[0]["frames"][0].shape[:2] == SYNTH_HW
        write_demo_tree("demo", clips)
        times["fixture"] = time.perf_counter() - t
        print(f"  fixture: make_synth_data.py {' '.join(SYNTH_ARGS)} and the demo tree, "
              f"{times['fixture']:.1f} s")
        hw16 = (SYNTH_HW[0] // 16) * (SYNTH_HW[1] // 16)
        for dname in ("float32", "bfloat16"):
            table = ma.max_active_clusters(getattr(torch, dname), 128, 512)
            q, v, splits, blocks = ma.launch_geometry(1, hw16, MAX_MEM + 1, 512,
                                                      getattr(torch, dname), table)
            route = "in a cluster" if blocks > 1 else "through L2" if splits > 1 else "unsplit"
            out[f"read_512x640_{dname}"] = dict(hw=hw16, splits=splits, blocks=blocks, route=route)
            print(f"  the read at 512x640 (HW {hw16}, T {MAX_MEM + 1}), {dname}: {q} x {v} "
                  f"tiles, {splits} splits, merged {route}")

        t = time.perf_counter()
        rates = loader_rates("data")
        times["loader"] = time.perf_counter() - t
        out["loader_batches_per_s"] = [dict(threads=n, rate=r, batches_timed=k, pass_s=p)
                                       for n, r, k, p in rates]
        print(f"  Loader over DIMTrain, 320x320, B 4, S 3, {os.cpu_count()} host cores, steady "
              "state: " + ", ".join(f"{n} threads {r:.3f} batches/s ({k} batches, pass {p:.1f} s)"
                                    for n, r, k, p in rates))

        # every read in lockstep: the eager step (--eager)
        common = ["--testmode", "--data-root", "data", "--repeats", "1", "--workers", "2",
                  "--eager"]
        chain = [("train_s1_trimap", cli_s1.main, common + ["--max-iters", "2"], 2),
                 ("train stage 2", cli_train.main,
                  common + ["--stage", "2", "--init-trimap", "weights/s1_OTVM_trimap"], 2),
                 ("train stage 4", cli_train.main,
                  common + ["--stage", "4", "--init", "weights/s2_OTVM_alpha"], 2),
                 ("train stage 4 --resume", cli_train.main,
                  common + ["--stage", "4", "--resume", "weights/s4_OTVM"], 0)]
        for name, main, argv, steps in chain:
            t = time.perf_counter()
            reset_counts(torch, ma)
            with lockstep_check(torch.float32) as errs, \
                    lockstep_grad_check(torch.float32) as gerrs:
                res = main(argv)
            launches = ma.launches
            times[name] = time.perf_counter() - t
            state = res["state"]
            print(f"  {name}: {times[name]:.1f} s, step {state.step}, logged losses "
                  f"{res['losses']}{', IoU ' + str(res['ious']) if 'ious' in res else ''}; "
                  f"memory_read {launches} launches, merged in a cluster / through L2 "
                  f"{merges(ma)}, rel err <= {max(errs, default=0):.3e} (backward "
                  f"{len(gerrs)}, <= {max(gerrs, default=0):.3e})")
            assert np.isfinite(res["losses"]).all(), f"{name}: non-finite loss"
            assert len(res["losses"]) == (1 if steps else 0), f"{name}: logged {res['losses']}"
            assert launches == len(errs) == (TRAIN_S - 1) * steps, \
                f"{name}: {launches} reads, want {TRAIN_S - 1} a step over {steps} steps"
            out[name] = dict(seconds=times[name], step=state.step, losses=res["losses"],
                             launches=launches, merges=merges(ma), read_err=max(errs, default=0))
        assert state.step == out["train stage 4"]["step"] == 2 and res["start_epoch"] == 1, \
            "--resume did not restore the stage-4 checkpoint's step"
        del state, res
        torch.cuda.empty_cache()

        n_reads = 2 * (SYNTH_FRAMES - 1)       # memorize every 10th frame: frames 1-11 read
        metric_keys = ("SAD", "MSE", "Grad", "Conn", "SSDA", "dtSSD", "MESSDdt")
        runs = [("eval", ["--weights", "weights/s4_OTVM", "--outdir", "ev1", "--eager"], True,
                 n_reads),
                ("eval --streams 2", ["--weights", "weights/s4_OTVM", "--outdir", "ev2",
                                      "--streams", "2"], False, n_reads),
                ("eval --trimap-net", ["--trimap-net", "--weights", "weights/s1_OTVM_trimap",
                                       "--outdir", "ev3"], False, n_reads),
                ("eval --stage 2", ["--stage", "2", "--weights", "weights/s2_OTVM_alpha",
                                    "--outdir", "ev4"], False, 0),
                ("eval --demo --viz", ["--demo", "--viz", "--weights", "weights/s4_OTVM",
                                       "--data-root", "demo", "--outdir", "ev5"], False, n_reads)]
        for name, argv, checked, want in runs:
            argv = argv if "--data-root" in argv else argv + ["--data-root", "data"]
            t = time.perf_counter()
            reset_counts(torch, ma)
            with (lockstep_check(torch.float32) if checked
                  else contextlib.nullcontext([])) as errs:
                res = cli_eval.main(argv)
            launches = ma.launches
            times[name] = time.perf_counter() - t
            print(f"  {name}: {times[name]:.1f} s, memory_read {launches} launches, merged in a "
                  f"cluster / through L2 {merges(ma)}" +
                  (f", every read vs plain: rel err <= {max(errs):.3e}" if checked else "") +
                  (f"; {json.dumps(res)}" if res else ""))
            assert launches == want, f"{name}: {launches} reads, want {want}"
            assert not checked or len(errs) == want
            out[name] = dict(seconds=times[name], launches=launches, merges=merges(ma),
                             **(dict(read_err=max(errs)) if checked else {}),
                             **({"results": res} if res else {}))
            if res is not None:
                assert res["videos"] == 2, f"{name}: {res['videos']} videos"
                keys = ("iou",) if "--trimap-net" in argv else metric_keys
                assert all(np.isfinite(res[k]) for k in keys), f"{name}: {res}"
        pngs = lambda d, seq: sorted(os.listdir(os.path.join(d, seq)))
        seqs = [v["seq_name"] for v in clips]
        for d in ("ev1/pred", "ev2/pred", "ev3/pred_trimap", "ev4/pred", "ev5/pred"):
            for seq in seqs:
                assert len(pngs(d, seq)) == SYNTH_FRAMES, f"{d}/{seq}: {len(pngs(d, seq))} PNGs"
        for seq in seqs:
            assert len([n for n in pngs("ev5/viz", seq) if n.endswith(".jpg")]) == SYNTH_FRAMES
            for n in pngs("ev1/pred", seq):
                with open(os.path.join("ev1/pred", seq, n), "rb") as a, \
                        open(os.path.join("ev2/pred", seq, n), "rb") as b:
                    assert a.read() == b.read(), f"--streams 2 wrote other bytes: {seq}/{n}"
        assert 0.0 <= out["eval --trimap-net"]["results"]["iou"] <= 1.0
        print(f"  --streams 2 PNGs byte-identical to --streams 1 ({2 * SYNTH_FRAMES}); "
              f"{SYNTH_FRAMES} PNGs a clip in every run, the demo's viz strips written")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = dict(times, total=time.perf_counter() - t8)
    print(f"  phase 8 took {out['seconds']['total']:.1f} s on {card}")
    return out


def ddp_phase(torch, ma, card):
    """Phase 9: data parallelism on the card.  Two ranks share the one card
    over gloo with CUDA tensors, asked for by name (NCCL takes one card a
    rank).  tools/ddp_check.py: fp32 stage-4 training at config.py's crop
    and batch (320x320, global batch 4: 2 a rank, S 3), 6 steps with every
    read in lockstep in both ranks, 3 timed, one remat step (its re-run
    reads in lockstep too) and one bf16 step, then a trimap-s1 step; rank 0
    takes the same steps alone and the two runs are held together
    (ddp_check.verify).  Then __graft_entry__.py's two dry runs on the port
    (entry.py) over gloo.  A rank that fails fails the phase."""
    from otvm_tpu_torch import entry
    from otvm_tpu_torch.tools import ddp_check

    t9 = time.perf_counter()
    geometry = {}
    for dt in (torch.float32, torch.bfloat16):
        table = ma.max_active_clusters(dt, 128, 512)
        for b in (2, 1):
            for t in range(1, TRAIN_S):
                q, v, splits, blocks = ma.launch_geometry(b, TRAIN_TOKENS, t, 512, dt, table)
                kind = "none" if splits == 1 else "cluster" if blocks > 1 else "L2"
                geometry[f"{str(dt)[6:]} B {b} T={t}"] = f"{splits} splits, merged {kind}"
    print(f"  the read at HW {TRAIN_TOKENS} a rank: " +
          "; ".join(f"{k}: {v}" for k, v in geometry.items()))
    results = ddp_check.run(2, backend="gloo")
    print("\n".join("  " + line for line in ddp_check.summary(results).splitlines()))
    ddp_check.verify(results)      # reads and lockstep checks a step, and the bounds
    assert all(r["backend"] == "gloo" and r["device"] == "cuda:0" for r in results)
    cmp = results[0]["compare"]["stage4"]
    assert cmp["params_moved"], "the stage-4 run's parameters did not move by its last held step"
    stage4 = [r["lines"]["stage4"] for r in results]
    alone = results[0]["alone"]["stage4"]["step"]
    timed = [i for i, s in enumerate(alone) if s["kind"] == "timed"]
    out = dict(
        backend="gloo", ranks=2, geometry=geometry,
        reads_per_rank={f"rank {r['rank']}": {name: [s["reads"] for s in line["step"]]
                                              for name, line in r["lines"].items()}
                        for r in results},
        max_fwd_err=max(s["fwd_err"] for line in stage4 for s in line["step"]
                        if s["fwd_err"] is not None),
        max_bwd_err=max(s["bwd_err"] for line in stage4 for s in line["step"]
                        if s["bwd_err"] is not None),
        step_ms=float(np.median([stage4[0]["step"][i]["ms"] for i in timed])),
        step_ms_alone=float(np.median([alone[i]["ms"] for i in timed])),
        all_reduce_ms=float(np.median(stage4[0]["all_reduce_ms"])),
        profiled=stage4[0]["profiled"], compare=results[0]["compare"],
        spread=results[0]["spread"], bounds=ddp_check.bounds(results))
    print(f"  2 ranks over gloo on one card: {out['step_ms']:.1f} ms a step (median of "
          f"{len(timed)}), alone {out['step_ms_alone']:.1f} ms; the gradient all-reduce "
          f"{out['all_reduce_ms']:.1f} ms ({out['all_reduce_ms'] / out['step_ms']:.1%}), on {card}")
    train = entry.dryrun_multichip(2, backend="gloo")
    evals = entry.dryrun_multichip_eval(2, backend="gloo")
    assert all(r["reads"] == 1 for r in train), "dryrun_multichip: a read a rank (S 2)"
    assert all(r["reads"] == 2 and r["isolated"] for r in evals), \
        "dryrun_multichip_eval: 2 reads a rank (frames 1 and 2), banks isolated"
    out.update(dryrun=[dict(rank=r["rank"], loss=r["loss"], rank_loss=r["rank_loss"],
                            reads=r["reads"]) for r in train],
               dryrun_eval=[dict(rank=r["rank"], reads=r["reads"], isolated=r["isolated"])
                            for r in evals],
               seconds=time.perf_counter() - t9)
    print(f"  phase 9 took {out['seconds']:.1f} s")
    return out


@contextlib.contextmanager
def environ(**values):
    """os.environ with `values` set, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


BENCH_MODES = [("default", {}, []), ("BENCH_WIRE_OUT=1", {"BENCH_WIRE_OUT": "1"}, []),
               ("BENCH_BATCH=4", {"BENCH_BATCH": "4"}, []),
               ("BENCH_CHUNK=8", {"BENCH_CHUNK": "8"}, []), ("default --eager", {}, ["--eager"])]


def graphs_phase(torch, ma, card, stm_sd, fba_sd, frames, tri):
    """Phase 10: the serving step from CUDA graphs against the eager step,
    at full width, 512x512."""
    from otvm_tpu_torch import bench
    from otvm_tpu_torch.eval.runner import (EvalProtocol, MultiStreamEvaluator,
                                            StreamingEvaluator, TrimapEvaluator)
    from otvm_tpu_torch.models.graphs import FrameStepGraphs, max_graphs
    from otvm_tpu_torch.models.otvm import init_models, make_eval_bank, serving_models
    from otvm_tpu_torch.tools.kernel_check import lockstep_check

    t10 = time.perf_counter()
    proto = dict(memory_max_num=MAX_MEM, memory_skip_frame=SKIP)
    same = lambda xs, ys: len(xs) == len(ys) and all(np.array_equal(x, y) for x, y in zip(xs, ys))
    out = {}

    def timed_run(ev, clips=None):
        """(outputs, frames/s, reads, peak GB, reserved GB) of one run."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(torch, ma)
        res = ev.run_video(frames, tri) if clips is None else ev.run_videos(clips)
        torch.cuda.synchronize()
        return (res, ma.launches, torch.cuda.max_memory_allocated() / 1e9,
                torch.cuda.memory_reserved() / 1e9)

    streams = {}
    for dname in ("fp32", "bf16"):
        eager = StreamingEvaluator(stm_sd, fba_sd, EvalProtocol(dtype=dname, **proto),
                                   graphs=False)
        graphed = StreamingEvaluator(stm_sd, fba_sd, EvalProtocol(dtype=dname, **proto))
        g = graphed.step_graphs
        row = {}
        for turn in ("first", "second"):
            for name, ev in (("eager", eager), ("graphs", graphed)):
                captures, capture_s = g.captures, g.capture_s
                (a, t, fps), reads, peak, reserved = timed_run(ev)
                row[f"{name} {turn}"] = dict(frames_per_s=fps, reads=reads, peak_gb=peak,
                                             reserved_gb=reserved)
                if name == "graphs":
                    row[f"{name} {turn}"].update(captures=g.captures - captures,
                                                 capture_s=g.capture_s - capture_s,
                                                 equal=same(a, ea) and same(t, et))
                else:
                    ea, et = a, t
                assert reads == N_FRAMES - 1, f"{dname} {name} {turn} run: {reads} reads"
        streams[dname] = row
        check_outputs(ea, et, N_FRAMES, f"{dname} eager stream (phase 10)")
        print(f"  {dname} stream, 30 frames: " + "; ".join(
            f"{k}: {v['frames_per_s']:.3f} frames/s, {v['reads']} reads, peak "
            f"{v['peak_gb']:.2f} GB (reserved {v['reserved_gb']:.2f})" +
            (f", {v['captures']} captures in {v['capture_s']:.2f} s, equal to eager bit for "
             f"bit {v['equal']}" if "equal" in v else "") for k, v in row.items()))
        assert row["graphs first"]["captures"] == 7 and row["graphs second"]["captures"] == 0, \
            "a 30-frame stream meets 7 keys: captured in the first run, replayed in the second"
        assert row["graphs first"]["equal"] and row["graphs second"]["equal"], \
            f"the graphed {dname} stream differs from the eager one"
        assert g.graphs_per_bucket() == [7] and 7 <= max_graphs(MAX_MEM)
        if dname == "bf16":
            eager16, graphed16, ref16 = eager, graphed, (ea, et)
        del eager, graphed
    out["stream"] = streams

    # multi-stream, bf16: A (30 frames), B (17), C = A again; chunk 8
    frames_b, tri_b = make_video(17, seed=1)
    clips = [dict(frames=frames, first_trimap=tri), dict(frames=frames_b, first_trimap=tri_b),
             dict(frames=frames, first_trimap=tri)]
    want = N_FRAMES - 1 + 16 + N_FRAMES - 1
    paths = {}
    for name, graphs in (("eager", False), ("graphs", None)):
        multi = MultiStreamEvaluator(stm_sd, fba_sd, EvalProtocol(dtype="bf16", **proto),
                                     graphs=graphs)
        (res, fps), reads, peak, _ = timed_run(multi, clips)
        paths[name] = (res, dict(frames_per_s=fps, reads=reads, peak_gb=peak))
        assert reads == want, f"multi-stream {name}: {reads} reads, want {want}"
    equal = all(same(x[0], y[0]) and same(x[1], y[1])
                for x, y in zip(paths["graphs"][0], paths["eager"][0]))
    out["multistream_bf16"] = dict(equal=equal, **{k: v[1] for k, v in paths.items()})
    print(f"  bf16 multi-stream (30, 17, 30 frames): graphed {paths['graphs'][1]}, eager "
          f"{paths['eager'][1]}; equal bit for bit {equal} (the graphed run captured its graphs)")
    assert equal, "the graphed multi-stream outputs differ from the eager ones"
    chunked = StreamingEvaluator(stm_sd, fba_sd, EvalProtocol(dtype="bf16", chunk=8, **proto))
    (ca, ct, cfps), reads, peak, _ = timed_run(chunked)
    equal = same(ca, ref16[0]) and same(ct, ref16[1])
    out["chunk8_bf16"] = dict(equal=equal, frames_per_s=cfps, reads=reads, peak_gb=peak)
    print(f"  bf16 chunk 8, graphed: {reads} reads, equal to the eager per-frame stream bit for "
          f"bit {equal}")
    assert reads == N_FRAMES - 1 and equal, "the graphed chunked stream is not the eager one"
    del multi, chunked

    # trimap propagation alone (the stage-1 STM, fp32) and stage 2 on given trimaps
    stm1 = init_models(seed=3, stage=1)[0].state_dict()
    fba2 = init_models(seed=4, stage=2)[1].state_dict()
    gts = [tri, tri[::-1].copy(), tri[:, ::-1].copy(), tri, tri]
    for name, make, run, want in (
            ("trimap-only", lambda g: TrimapEvaluator(stm1, EvalProtocol(**proto), graphs=g),
             lambda ev: ev.run_video(frames, tri)[:1], N_FRAMES - 1),
            ("stage 2, given trimaps", lambda g: StreamingEvaluator(
                None, fba2, EvalProtocol(stage=2, **proto), graphs=g),
             lambda ev: ev.run_video(frames[:5], tri, gt_trimaps=gts)[:1], 0)):
        results = {}
        for path, graphs in (("eager", False), ("graphs", None)):
            ev = make(graphs)
            run(ev)                                       # warm-up (captures)
            reset_counts(torch, ma)
            results[path] = (run(ev), ma.launches)
        equal = all(same(x, y) for x, y in zip(results["graphs"][0], results["eager"][0]))
        out[name] = dict(equal=equal, reads={k: v[1] for k, v in results.items()})
        print(f"  {name}, graphed: reads {out[name]['reads']}, equal to eager bit for bit {equal}")
        assert equal and results["graphs"][1] == results["eager"][1] == want, name
        del ev

    # a lockstep check cannot see a replayed read: a capture under it, and a
    # replay of a graph captured before it, are refused
    refused = {}
    fresh = FrameStepGraphs(eager16.stm, eager16.fba)
    bank = make_eval_bank(1, H, W, MAX_MEM, dtype=torch.bfloat16)
    u8 = torch.from_numpy(np.rint(np.stack(frames[:2]) * 255).astype(np.uint8)).cuda()[:, None]
    first_tri = torch.from_numpy(tri[None]).cuda().to(torch.bfloat16)
    for what, run in (("capture", lambda: fresh(bank, u8[1], first_tri, False, False, False,
                                                 MAX_MEM)),
                      ("replay", lambda: graphed16.run_video(frames[:3], tri))):
        if what == "capture":
            bank = fresh(bank, u8[0], first_tri, True, False, False, MAX_MEM).bank
        try:
            with lockstep_check(torch.bfloat16):
                run()
            refused[what] = False
        except RuntimeError as e:
            refused[what] = str(e)
    out["lockstep_refused"] = refused
    print(f"  under a lockstep check: {refused}")
    assert all(refused.values()), "a graphed read ran under a lockstep check"
    del fresh, eager16, graphed16
    torch.cuda.empty_cache()

    # the port's bench, every mode, on shared bf16 models
    models = serving_models("cuda", torch.bfloat16)
    lines = {}
    for name, env, argv in BENCH_MODES:
        with environ(BENCH_FRAMES="60", **env):
            line = lines[name] = bench.main(argv, models=models)
        print(f"  bench {name}: {json.dumps(line)}")
        assert line["value"] > 0 and line["device"] == torch.cuda.get_device_name(0)
    out["bench"] = lines
    out["seconds"] = time.perf_counter() - t10
    print(f"  phase 10 took {out['seconds']:.1f} s on {card}")
    return out


# phase 12: each stage-4 step graphed and eager alone, so many steps (the
# median of steps 3 on)
PHASE12_TIMED = 6
# phase 11: one fp32 run crosses RAdam's hold (steps 1-5), its first
# updates (6-9) and a stair drop at step 10 of 10; bf16 and trimap-s1 short
TRAIN_GRAPH_STEPS = {"fp32": 11, "bf16": 4, "trimap": 4}


def train_graphs_phase(torch, ma, card):
    """Phase 11: the train steps from CUDA graphs against the eager steps,
    at full width (tools/train_graphs_check.py)."""
    from otvm_tpu_torch import config
    from otvm_tpu_torch.kernels import group_norm as gn
    from otvm_tpu_torch.tools import train_graphs_check as C
    from otvm_tpu_torch.tools.profile_train import seeded_batches

    t11 = time.perf_counter()
    gn.launches = 0
    cfg = config.get_cfg_defaults()
    cfg.train.stage = 4
    batches = seeded_batches(cfg, max(TRAIN_GRAPH_STEPS.values()), seed=1)
    stair = C.Case("fp32 stage 4, stair over 10", TRAIN_GRAPH_STEPS["fp32"], stair_iters=10)
    cases = [(stair, cfg, 4, 0),
             (C.Case("bf16 stage 4", TRAIN_GRAPH_STEPS["bf16"], bf16=True), cfg, 4, 0),
             (C.Case("trimap-s1", TRAIN_GRAPH_STEPS["trimap"], stage=1, trimap=True),
              config.get_cfg_defaults(), 1, 2)]
    out, nets = {}, {}
    for case, base, stage, seed in cases:
        if stage not in nets:               # one stage's networks on the card at a time
            nets.clear()
            torch.cuda.empty_cache()
            base.train.stage = stage
            nets[stage] = C.Nets(base, seed=seed, device="cuda")
        result = C.check_case(case, base, nets[stage], batches)
        print(C.summary(case, result))
        run_cfg = case.config(base)
        reads, merges = case.reads_per_step(run_cfg), case.merges_per_step(run_cfg)
        lock = result["lockstep"]
        out[case.name] = {
            **{k: {key: result[k][key] for key in (
                "step_ms", "host_step_ms", "launches", "merges", "peak_gb", "peak_reserved_gb",
                "captures", "capture_s", "losses") if key in result[k]}
               for k in ("eager", "graphed")},
            "lockstep": {key: lock[key] for key in (
                "launches", "merges", "graphed_launches", "graphed_merges", "captures",
                "steps")},
            "failures": result["failures"]}
        assert not result["failures"], f"{case.name}: graphed parts from eager: " \
            f"{result['failures']}"
        assert result["graphed"]["captures"] == lock["captures"] == 1, \
            f"{case.name}: not one capture"
        for k, launches, merged, n in (
                ("eager", result["eager"]["launches"], result["eager"]["merges"], case.steps),
                ("graphed", result["graphed"]["launches"], result["graphed"]["merges"],
                 case.steps),
                ("lockstep's graphed steps", lock["graphed_launches"], lock["graphed_merges"],
                 case.steps),
                ("lockstep", lock["launches"], lock["merges"], case.steps * (C.EAGER_RUNS + 1))):
            assert launches == reads * n and merged == tuple(x * n for x in merges), \
                f"{case.name} {k}: {launches} reads {merged}, want {reads} and {merges} a step"
        if case is stair:
            # the small-error control: the decay alone frozen at a capture
            # before the stair drop
            frozen = C.lockstep(case, base, nets[stage], batches, eager_first=7,
                                optimizer=C.FrozenDecayRAdam)
            failures = C.verify(frozen)
            print(f"    frozen-decay control (captured at step 9, the drop at 10): {failures}")
            out[case.name]["control_failures"] = failures
            assert [f"delta of step {i}:" in " ".join(failures)
                    for i in range(1, case.steps + 1)] == [False] * 9 + [True] * (case.steps - 9), \
                "the frozen-decay control was not rejected at the drop alone"
    nets.clear()
    torch.cuda.empty_cache()
    # the graphed train steps keep nn.GroupNorm: none replays the serving norm
    out["group_norm_launches"] = gn.launches
    print(f"  group_norm launches in phase 11's graphed and eager steps: {gn.launches}")
    assert gn.launches == 0, "a train step ran the serving group norm"
    out["seconds"] = time.perf_counter() - t11
    print(f"  phase 11 took {out['seconds']:.1f} s on {card}")
    return out


def ddp_graphs_phase(torch, ma, card):
    """Phase 12: the data-parallel train step from CUDA graphs over NCCL,
    at full width (tools/ddp_check.py run_graphed): 2 ranks a card each
    where the machine has 2 cards, else a one-rank NCCL group on the one
    card.  A rank that fails, or runs past its time, fails the phase."""
    from otvm_tpu_torch.tools import ddp_check

    t12 = time.perf_counter()
    ranks = 2 if torch.cuda.device_count() >= 2 else 1
    how = (f"{ranks} ranks over NCCL, one card each" if ranks > 1 else
           "a one-rank NCCL group (world 1: the machine has one card, and NCCL takes one card "
           "a rank), its collectives captured and replayed")
    print(f"  {how}; global batch {TRAIN_B} ({TRAIN_B // ranks} a rank), {TRAIN_HW}x{TRAIN_HW}, "
          f"S {TRAIN_S}")
    # fp32 over 8 steps (RAdam's hold, then its first updates); remat, bf16
    # and trimap-s1 over 2: the eager warm-up, then the capture's replay
    cases = (ddp_check.GRAPHED_CASES[0],
             *(dataclasses.replace(c, steps=2) for c in ddp_check.GRAPHED_CASES[1:]))
    results = ddp_check.run_graphed(ranks, cases=cases, timing=PHASE12_TIMED, eager_runs=1,
                                    timeout=900)
    print("\n".join("  " + line for line in ddp_check.summary_graphed(results).splitlines()))
    ddp_check.verify_graphed(results)     # bit for bit, ranks equal, reads at every replay
    assert all(r["backend"] == "nccl" for r in results)
    first = ddp_check.GRAPHED_CASES[0].name
    res = results[0]["cases"][first]
    g, e, pg = res["graphed"], res["eager"], res["profiled"]["graphed"]
    out = dict(
        ranks=ranks, how=how,
        reads={f"rank {r['rank']}": {name: dict(graphed=c["lockstep"]["graphed_launches"],
                                                all=c["lockstep"]["launches"],
                                                merged=c["lockstep"]["graphed_merges"],
                                                steps=len(c["lockstep"]["steps"]))
                                     for name, c in r["cases"].items()} for r in results},
        step_ms=g["step_ms"], eager_step_ms=e["step_ms"], host_step_ms=g["host_step_ms"],
        eager_host_step_ms=e["host_step_ms"], peak_gb=g["peak_gb"], eager_peak_gb=e["peak_gb"],
        profiled={k: {key: v[key] for key in ("ms", "device_ms", "nccl_ms", "nccl", "memcpy_ms",
                                              "all_reduce_host_ms")}
                  for k, v in res["profiled"].items()},
        captures={name: c["lockstep"]["captures"] for name, c in results[0]["cases"].items()})
    print(f"  {first}: graphed {g['step_ms']:.1f} ms a step, eager {e['step_ms']:.1f} ms "
          f"({e['step_ms'] / g['step_ms']:.2f}x); NCCL's kernels {pg['nccl_ms']:.2f} ms of a "
          f"profiled replay's {pg['ms']:.1f} ms ({pg['nccl_ms'] / pg['ms']:.2%}; copies "
          f"{pg['memcpy_ms']:.2f} ms, a one-rank group's all-reduce among them); on {card}")
    out["seconds"] = time.perf_counter() - t12
    print(f"  phase 12 took {out['seconds']:.1f} s on {card}")
    return out


# phase 13: 8 DIM images x QUALITY_REPEATS / B 2 steps of stage 1
QUALITY_REPEATS = 50
QUALITY_STEPS = 8 * QUALITY_REPEATS // 2
# dim_overfit's SAD must fall by at least this after those steps: two
# runs on an H100 fell by 9.8997 and 9.8270 (15.92 -> 6.03 and 6.10;
# PERF.md, the training chain's findings), so about half the smaller drop
SAD_DROP = 5.0
ONSYNTH_FRAMES = 12


def quality_phase(torch, ma, card):
    """Phase 13: dim_overfit before and after a short graphed stage-1
    overfit through cli/train.py's main, then onsynth on random stage-4
    weights with every read in lockstep (tools/quality_check.py)."""
    import shutil
    import tempfile

    from otvm_tpu_torch.cli import train as cli_train
    from otvm_tpu_torch.tools import quality_check as Q
    from otvm_tpu_torch.tools.kernel_check import lockstep_check

    repo = os.path.dirname(os.path.abspath(__file__))
    out, t13 = {}, time.perf_counter()
    cwd, tmp = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_quality_")
    try:
        os.chdir(tmp)
        subprocess.run([sys.executable, os.path.join(repo, "scripts", "make_synth_data.py"),
                        "data"] + SYNTH_ARGS, check=True, capture_output=True, text=True,
                       timeout=300)
        stm_sd, fba_sd, fba1_sd = Q.random_weights()
        before = Q.dim_overfit(fba1_sd, "data", "random")["dim_overfit_random"]
        t = time.perf_counter()
        reset_counts(torch, ma)
        res = cli_train.main(["--stage", "1", "--data-root", "data", "--input-size", "320",
                              "--bf16", "--epochs", "1", "--batch-size", "2", "--lr", "1e-4",
                              "--workers", "8", "--stm-gn", "--repeats", str(QUALITY_REPEATS)])
        train_s = time.perf_counter() - t
        assert res["state"].step == QUALITY_STEPS, res["state"].step
        assert np.isfinite(res["losses"]).all() and ma.launches == 0
        del res
        torch.cuda.empty_cache()
        after = Q.dim_overfit(Q.load_weights("weights/s1_OTVM_alpha", 1)[1], "data",
                              "post_overfit")["dim_overfit_post_overfit"]
        drop = before["SAD"] - after["SAD"]
        print(f"  dim_overfit over {before['images']} DIM images: SAD {before['SAD']:.4f} "
              f"(random) -> {after['SAD']:.4f} after {QUALITY_STEPS} graphed stage-1 steps "
              f"({train_s:.1f} s), drop {drop:.4f} (must be >= {SAD_DROP}); MSE "
              f"{before['MSE']:.5f} -> {after['MSE']:.5f}")
        out.update(dim_overfit_random=before, dim_overfit_post_overfit=after, sad_drop=drop,
                   train_s=train_s, steps=QUALITY_STEPS)
        assert drop >= SAD_DROP, f"dim_overfit's SAD fell by {drop}, not by {SAD_DROP}"

        reset_counts(torch, ma)
        with lockstep_check() as errs:
            variants = Q.onsynth(stm_sd, fba_sd, "data", "random", max_frames=ONSYNTH_FRAMES,
                                 graphs=False)["onsynth_variants_random"]
        want = 3 * (ONSYNTH_FRAMES - 1)
        print(f"  onsynth on random stage-4 weights, {variants['frames']} frames three ways: "
              f"memory_read {ma.launches} launches, merged in a cluster / through L2 "
              f"{merges(ma)}, every read vs plain: rel err <= {max(errs):.3e}; "
              f"{json.dumps(variants)}")
        assert ma.launches == len(errs) == want, f"{ma.launches} reads, want {want}"
        assert all(np.isfinite(v) for d in (variants["sad"], variants["mse"]) for v in d.values())
        out.update(onsynth_random=variants, onsynth_launches=ma.launches,
                   onsynth_merges=merges(ma), onsynth_read_err=max(errs))
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t13
    print(f"  phase 13 took {out['seconds']:.1f} s on {card}")
    return out


# the frame's group norms must agree with F.group_norm in fp32 rounded once
# to their dtype within these (norm-relative).  On an H100 the kernels read
# at most 6.7e-5 (bf16) and 2.3e-7 (fp32); torch's own bf16 GroupNorm,
# which rounds mean and rstd to bf16, 1.6e-3 to 5.1e-3 (PERF.md).
GN_TOL = {"bfloat16": 5e-4, "float32": 2e-6}


def group_norm_phase(torch, card):
    """Phase 14: the serving group norm's kernels at a stage-4 frame's
    shapes at 1088x1920 against F.group_norm, timed."""
    from otvm_tpu_torch.kernels import group_norm as gn
    from otvm_tpu_torch.tools import bench_group_norm as B

    t14 = time.perf_counter()
    gn.build()
    for line in gn.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.split(':', 1)[-1].strip()}")
    shapes = B.frame_shapes(1088, 1920)
    assert sum(n for _, _, n in shapes) == 66, shapes
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for name in ("bfloat16", "float32"):
        out[name] = B.bench(getattr(torch, name), shapes, 20, flush)
        worst = max(r["rel_err"] for r in out[name]["shapes"])
        print(f"  {name} frame, {out[name]['norms']} norms: "
              + ", ".join(f"{k} {v:.4g}" for k, v in out[name]["frame"].items())
              + f"; worst rel err {worst:.3e} (tol {GN_TOL[name]:g})")
        assert worst <= GN_TOL[name], f"{name}: group norm rel err {worst:.3e}"
    del flush
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t14
    print(f"  phase 14 took {out['seconds']:.1f} s on {card}")
    return out


def make_video(n, seed=0):
    """Smooth seeded frames (a coarse random grid, bilinearly upsampled,
    new per frame) and the bench's nested-box first trimap."""
    rng = np.random.RandomState(seed)
    ys, xs = np.linspace(0, 7, H), np.linspace(0, 7, W)
    y0, x0 = np.minimum(ys.astype(int), 6), np.minimum(xs.astype(int), 6)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    frames = []
    for _ in range(n):
        g = rng.rand(8, 8, 3)
        top = g[y0][:, x0] * (1 - fx) + g[y0][:, x0 + 1] * fx
        bot = g[y0 + 1][:, x0] * (1 - fx) + g[y0 + 1][:, x0 + 1] * fx
        frames.append((top * (1 - fy) + bot * fy).astype(np.float32))
    tri = np.zeros((H, W, 3), np.float32)           # bench.py:75-81
    tri[..., 0] = 1.0
    tri[H // 4:-H // 4, W // 4:-W // 4, 0] = 0.0
    tri[H // 4:-H // 4, W // 4:-W // 4, 1] = 1.0
    tri[3 * H // 8:-3 * H // 8, 3 * W // 8:-3 * W // 8, 1] = 0.0
    tri[3 * H // 8:-3 * H // 8, 3 * W // 8:-3 * W // 8, 2] = 1.0
    return frames, tri


def check_outputs(alphas, trimaps, n, what):
    assert len(alphas) == len(trimaps) == n, what
    for a, t in zip(alphas, trimaps):
        assert a.shape == (H, W) and t.shape == (H, W, 3), what
        assert np.isfinite(a).all() and np.isfinite(t).all(), f"{what}: non-finite output"
        assert a.min() >= 0.0 and a.max() <= 1.0, f"{what}: alpha outside [0, 1]"
        assert np.abs(t.sum(-1) - 1.0).max() < 1e-2, f"{what}: trimap is not a distribution"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from otvm_tpu_torch import set_fp32_numerics
    from otvm_tpu_torch.eval.runner import EvalProtocol, StreamingEvaluator
    from otvm_tpu_torch.tools.kernel_check import lockstep_check
    from otvm_tpu_torch.kernels import group_norm as gn
    from otvm_tpu_torch.kernels import memory_attn as ma
    from otvm_tpu_torch.models.otvm import init_models

    t_all = time.perf_counter()
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind}")
    set_fp32_numerics()

    print("phase 2: build the memory-read kernel")
    t0 = time.perf_counter()
    ma.build()
    print(f"  built in {time.perf_counter() - t0:.2f} s")
    report = ptxas_report(ma.build_log)
    for kernel, lines in report:
        print(f"  ptxas {kernel}: " + "; ".join(lines))
    # The fp32 warpgroups hold all of their registers in the main loop
    # (setmaxnreg): a spill of more than one 4-byte value there is a broken
    # build.
    f32 = [lines for kernel, lines in report if kernel.startswith("memory_read_f32tc")]
    spills = [int(m) for lines in f32 for line in lines
              for m in re.findall(r"(\d+) bytes spill stores", line)]
    assert f32 and spills and max(spills) <= 4, f"the fp32 kernel spills registers: {spills}"
    sass, barriers = sass_counts(ma)
    print(f"  SASS of {ma.library_path.name}: " + ", ".join(f"{op} {n}" for op, n in sass.items())
          + f" ({', '.join(barriers)})")
    assert sass["HGMMA"] > 0, "no wgmma (HGMMA) instruction in the built library"
    assert sass["HGMMA TF32"] > 0, "no TF32 wgmma (HGMMA ... TF32) in the built library"
    assert sass["HMMA TF32"] == 0, "a TF32 mma.sync (HMMA ... TF32) is left in the library"
    assert sass["UTMALDG"] > 0, "no TMA load (UTMALDG) in the built library"
    assert sass["UCGABAR"] > 0, "no cluster barrier (UCGABAR_*) in the built library"
    clusters = {}
    for dname in ("bfloat16", "float32"):
        for ck, cv in ((128, 512), (128, 384), (32, 128)):
            table = clusters[f"{dname} Ck={ck} Cv={cv}"] = \
                ma.max_active_clusters(getattr(torch, dname), ck, cv)
            print(f"  max active clusters, {dname} Ck={ck} Cv={cv} (CVT {ma.value_tile(cv)}), "
                  f"by cluster size (1: blocks): " +
                  ", ".join(f"{s}: {n}" for s, n in table.items()))

    print("phase 3: kernel vs plain")
    timing, held = kernel_phase(torch, ma)

    print("phase 4: full-width stage-4 stream, fp32, kernel vs plain read")
    stm, fba = init_models(seed=0, stage=4)
    stm_sd, fba_sd = stm.state_dict(), fba.state_dict()
    frames, tri = make_video(N_FRAMES)
    proto = EvalProtocol(memory_max_num=MAX_MEM, memory_skip_frame=SKIP, dtype="fp32")
    ev = StreamingEvaluator(stm_sd, fba_sd, proto, graphs=False)
    ev_plain = StreamingEvaluator(stm_sd, fba_sd, proto, memory_impl="plain", graphs=False)
    torch.cuda.synchronize()
    ma.launches = ma.cluster_launches = ma.l2_merge_launches = 0
    with lockstep_check(torch.float32) as read_errs:
        ka, kt, kfps = ev.run_video(frames, tri)
    fp32_launches, fp32_merges = ma.launches, merges(ma)
    pa, pt, _ = ev_plain.run_video(frames, tri)
    print(f"  launches in the fp32 kernel stream: memory_read {fp32_launches}, of them merged "
          f"in a cluster / through L2 {fp32_merges} (segment calls: {N_FRAMES - 1}); every read vs "
          f"plain on its own inputs: rel err <= {max(read_errs):.3e}; fp32 {kfps:.2f} frames/s "
          f"(lockstep-checked)")
    check_outputs(ka, kt, N_FRAMES, "fp32 kernel stream")
    check_outputs(pa, pt, N_FRAMES, "fp32 plain stream")
    assert fp32_launches == len(read_errs) == N_FRAMES - 1, \
        "the stream did not run the kernel once per segment call"
    assert sum(fp32_merges) == N_FRAMES - 1, "the fp32 stream did not split its reads"
    # Stream against stream.  Frame 0 reads no memory: identical.  Frame 1
    # reads a bank written from identical state: the reads differ by fp32
    # summation order (~1e-6); where a trimap argmax sits on a near-tie it
    # may flip and move the distance features nearby, so at most 1% of
    # alpha pixels may move by more than 1e-3 and at least 99% of trimap
    # labels agree.  From frame 2 on, each frame's differences feed the
    # next through the memory; with random weights the foreground seeds are
    # sparse and one flipped seed moves the distance field over a wide area,
    # so the streams may part: printed, not bounded.  Every read on the way
    # is held to the plain read on its own inputs above.
    for i in range(N_FRAMES):
        d = np.abs(ka[i] - pa[i])
        agree = (kt[i].argmax(-1) == pt[i].argmax(-1)).mean()
        print(f"  frame {i:2d}: max|dalpha| {d.max():.3e}  share>1e-3 {(d > 1e-3).mean():.4%}"
              f"  label agreement {agree:.4%}")
    assert np.array_equal(ka[0], pa[0]) and np.array_equal(kt[0], pt[0]), "frame 0 differs"
    d1 = np.abs(ka[1] - pa[1])
    assert (d1 > 1e-3).mean() <= 0.01, "kernel and plain streams differ at frame 1"
    assert (kt[1].argmax(-1) == pt[1].argmax(-1)).mean() >= 0.99, "frame 1 labels differ"

    print("phase 5: full-width stage-4 stream, bf16, graphed, timed")
    proto16 = EvalProtocol(memory_max_num=MAX_MEM, memory_skip_frame=SKIP, dtype="bf16")
    with lockstep_check(torch.bfloat16) as read_errs16:   # both bank branches, eagerly
        StreamingEvaluator(stm_sd, fba_sd, proto16, graphs=False).run_video(frames[:12], tri)
    print(f"  eager warm-up: every bf16 read vs plain on its own inputs: rel err <= "
          f"{max(read_errs16):.3e}")
    ev16 = StreamingEvaluator(stm_sd, fba_sd, proto16)
    ev16.run_video(frames, tri)                           # captures the stream's graphs
    torch.cuda.synchronize()
    ma.launches = ma.cluster_launches = ma.l2_merge_launches = gn.launches = 0
    ba, bt, fps = ev16.run_video(frames, tri)
    bf16_launches, bf16_merges, bf16_norms = ma.launches, merges(ma), gn.launches
    check_outputs(ba, bt, N_FRAMES, "bf16 stream")
    print(f"  launches in the bf16 stream: memory_read {bf16_launches}, of them merged in a "
          f"cluster / through L2 {bf16_merges}; group_norm {bf16_norms} (want 66 a frame)")
    assert bf16_launches == N_FRAMES - 1, "the bf16 stream did not run the kernel per segment"
    assert bf16_norms == 66 * N_FRAMES, "the bf16 stream did not run the serving group norm"
    assert sum(bf16_merges) == N_FRAMES - 1, "the bf16 stream did not split its reads"
    drift = [float(np.abs(b - a).mean()) for a, b in zip(ka, ba)]
    agree0 = (bt[0].argmax(-1) == kt[0].argmax(-1)).mean()
    print(f"  bf16 vs fp32 stream, mean|dalpha| per frame: frame 0 {drift[0]:.4f} "
          f"(labels {agree0:.3%}), frames 1.. max {max(drift[1:]):.4f}")
    # Loose bound, on frame 0 only (same input, GT trimap).  With random
    # weights at 512x512 bf16 moves alpha by ~0.2 on average (and ~6% of
    # labels): rounding at 8 mantissa bits through ~60 GN-WS layers, ending
    # in fba_fusion's division.  The JAX package's bf16 serving drifts
    # alike; tests/test_torch_stream.py::test_bf16_drift_matches_jax holds
    # the port's drift to JAX's.  Above 0.3, or under 90% agreeing labels,
    # the path is broken, not rounded.  Later frames part as in phase 4.
    assert drift[0] <= 0.3 and agree0 >= 0.9, "bf16 frame 0 drifted from fp32"
    print(f"fps_512p_joint_s4_bf16: {fps:.3f} frames/s ({N_FRAMES} frames, run_video from CUDA "
          f"graphs, wall clock) on {card}")
    del ev, ev_plain, ev16
    torch.cuda.empty_cache()

    print("phase 6: training at full width")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for key, row in read_grad_phase(torch, ma, flush).items():
        timing[key].update(row)
    del flush
    train = train_phase(torch, ma, card)
    print(f"train_stage4_320 on {card}: {json.dumps(train)}")

    print("phase 7: the other serving paths at full width")
    t7 = time.perf_counter()
    serving = serving_phase(torch, ma, card, stm_sd, fba_sd, frames, tri, (ka, kt))
    print(f"  phase 7 took {time.perf_counter() - t7:.1f} s")

    print("phase 8: the entry points, chained on the card")
    entry = entry_points_phase(torch, ma, card)
    print(f"  the eval CLI, fp32 with every read checked: "
          f"{entry['eval']['results']['fps']:.3f} frames/s at 512x640 (phase 4's stream at "
          f"512x512: {kfps:.3f}); --streams 2 {entry['eval --streams 2']['results']['fps']:.3f} "
          f"aggregate, unchecked")

    print("phase 9: data parallelism, 2 ranks on the card over gloo")
    torch.cuda.empty_cache()
    ddp = ddp_phase(torch, ma, card)

    print("phase 10: the serving step from CUDA graphs against the eager step")
    graphed = graphs_phase(torch, ma, card, stm_sd, fba_sd, frames, tri)

    print("phase 11: the train steps from CUDA graphs against the eager steps")
    train_graphed = train_graphs_phase(torch, ma, card)

    print("phase 12: the data-parallel train step from CUDA graphs over NCCL")
    torch.cuda.empty_cache()
    ddp_graphed = ddp_graphs_phase(torch, ma, card)

    print("phase 13: what training teaches: dim_overfit and onsynth")
    torch.cuda.empty_cache()
    quality = quality_phase(torch, ma, card)

    print("phase 14: the serving group norm at a stage-4 frame's shapes")
    torch.cuda.empty_cache()
    norms = group_norm_phase(torch, card)

    # top-level numbers: the stream's shape (512p count 5) in bf16, with
    # the graphed bf16 stream's launches (replays counted); every timed shape and dtype under
    # "shapes", the other paths' launches beside.  A split read merges its
    # splits in the same launch, in a cluster or through L2 (the Pallas
    # kernel's K/V carry and _finish, :111-126).
    keys = ("max_abs_err", "rel_err", "ms", "event_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "splits")
    read = timing["bfloat16", TIMED[0][4]]
    src = "otvm_tpu_torch/kernels/csrc/memory_attn.cu"
    print(json.dumps({"kernels": [
        {"name": "memory_read", "route": "cuda", "source": src,
         "replaces": "otvm_tpu/kernels/memory_attn.py:134", "launches": bf16_launches,
         **{key: read[key] for key in keys},
         "cluster": [1, 1, read["cluster_blocks"]],
         "merge": {"in": "split_epilogue (merge_splits: in a cluster through distributed "
                         "shared memory, or through L2 after tile_barrier), the split read's "
                         "epilogue",
                   "replaces": "otvm_tpu/kernels/memory_attn.py:111-126",
                   "cluster_and_l2_merge_launches": bf16_merges,
                   "cluster_and_l2_merge_launches_fp32_stream": fp32_merges,
                   "cluster_and_l2_merge_launches_train": {
                       f"fp32 stage 4, {TRAIN_STEPS} steps": train["merges"],
                       f"bf16 stage 4, {BF16_STEPS} steps": train["bf16_merges"],
                       f"trimap s1, {TRIMAP_STEPS} steps": train["trimap_merges"]}},
         "max_active_clusters": clusters,
         "launches_fp32_stream": fp32_launches,
         "launches_train": {f"fp32 stage 4, {TRAIN_STEPS} steps": train["launches"],
                            f"bf16 stage 4, {BF16_STEPS} steps": train["bf16_launches"],
                            f"trimap s1, {TRIMAP_STEPS} steps": train["trimap_launches"]},
         "serving_paths": serving,
         "serving_graphs": graphed,
         "train_graphs": train_graphed,
         "entry_points": entry,
         "data_parallel": ddp,
         "data_parallel_graphs": ddp_graphed,
         "quality": quality,
         "l2_merge_beside_held_sms": held,
         "shapes": {f"{d} {label}": row for (d, label), row in timing.items()}},
        {"name": "group_norm", "route": "cuda", "source": "otvm_tpu_torch/kernels/csrc/group_norm.cu",
         "replaces": "none (the JAX package's GroupNorm is plain XLA)", "launches": bf16_norms,
         "launches_elsewhere": {
             f"trimap-only fp32 stream, {N_FRAMES} frames":
                 serving["trimap_fp32"]["group_norm_launches"],
             "train steps, phase 6 (eager)": train["group_norm_launches"],
             "train steps, phase 11 (graphed and eager)": train_graphed["group_norm_launches"]},
         **norms}]}))
    print(f"total {time.perf_counter() - t_all:.1f} s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
