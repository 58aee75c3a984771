#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (otvm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the memory-read kernels from otvm_tpu_torch/kernels/csrc (nvcc,
     sm_90a), timed; print ptxas's registers and spills; count the
     tensor-core instructions (HGMMA: the bf16 wgmma; HMMA ... TF32: the
     fp32 3xTF32 mma.sync) and TMA loads (UTMALDG) in the library: each
     must be there;
  3. the kernel against its plain PyTorch version on the card, fp32 (TF32
     off in the plain version) and bf16, at the stream's shapes (512p:
     HW=1024, T=6, 1..6 valid slots; 1088x1920: HW=8160, T=3), ragged
     tiles with a non-prefix mask, and no valid slot; then its time at
     512p count 5 and 1088x1920 count 2 beside the plain version's, SDPA's
     (a yardstick only: the port never calls it) and the bound (fp32: at
     the 3xTF32 rate, the CUDA-core bound printed beside it); the combine
     kernel (which merges the split reads at 512p), bf16 and fp32 output,
     against its plain version, timed.  Each comparison is the
     norm-relative error (otvm_tpu_torch/tools/kernel_check.py), and a
     lower-precision control must fail it;
  4. the full-width stage-4 stream through StreamingEvaluator.run_video:
     512x512, a bank of at most 5, memorize every 10th frame, random
     weights from a seed, fp32 (the evaluator's default dtype), once with
     the kernel and once with the plain read.  The read kernel and the
     combine must each be launched once per segment call (frames - 1),
     every read must match the plain read on the same inputs, and the two
     streams must agree on frames 0 and 1 (later frames are printed: see
     the note in main);
  5. the same stream in bf16 (the serving mode): a lockstep-checked
     warm-up, then timed: frames/sec, finite outputs, and frame 0 within a
     loose bound of the fp32 stream.
The line before the last is a JSON object with the kernel's numbers; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

H = W = 512
N_FRAMES = 30
MAX_MEM = 5
SKIP = 10
# H100 SXM dense peaks.  The fp32 kernel runs 3xTF32: three TF32 products
# (495 TFLOP/s) for each fp32 one.  On the CUDA cores fp32 is 67 TFLOP/s.
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
FP32_CUDA_CORES = 67e12
PEAK_BYTES = 3.35e12
TIMED = [(1, 1024, 6, 5, "512p count 5"), (1, 8160, 3, 2, "1088x1920 count 2")]   # b, hw, t, count


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sass_counts(ma):
    """Phase 2: HGMMA, TF32 HMMA and UTMALDG instructions in the built
    library."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(ma.library_path)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    return {"HGMMA": len(re.findall(r"\bHGMMA\b", sass)),
            "HMMA TF32": len(re.findall(r"\bHMMA\.\S*TF32\b", sass)),
            "UTMALDG": len(re.findall(r"\bUTMALDG\b", sass))}


def ptxas_report(log):
    """[(kernel<template args>, its -v lines: registers, spills, C75xx
    warnings)] from nvcc's output."""
    report = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d(memory_(?:read_tc|read_f32tc|combine))I(.*?)EEv", line)
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
    """Phase 3: kernel vs plain at the stream's shapes; timings at 512p
    count 5 and 1088x1920 count 2; the combine kernel at 512p."""
    from otvm_tpu_torch.tools.kernel_check import (COMBINE_TOL, READ_TOL, combine_control,
                                                   control, device_ms, event_ms)

    gen = torch.Generator(device="cuda").manual_seed(0)
    prefix = lambda b, t, c: torch.arange(t, device="cuda")[None].expand(b, t) < c
    cases = [(1, 1024, 6, prefix(1, 6, c), f"512p count {c}") for c in (1, 3, 5, 6)]
    cases += [(1, 8160, 3, prefix(1, 3, 2), "1088x1920 count 2"),
              (2, 70, 3, torch.tensor([[True, False, True], [False, True, True]],
                                      device="cuda"), "HW=70 non-prefix mask"),
              (1, 1024, 6, prefix(1, 6, 0), "512p count 0")]
    errs = {}
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for b, hw, t, mask, label in cases:
            q = torch.randn(b, hw, 128, generator=gen, device="cuda").to(dt)
            k = torch.randn(b, t, hw, 128, generator=gen, device="cuda").to(dt)
            v = torch.randn(b, t, hw, 512, generator=gen, device="cuda").to(dt)
            got = ma.memory_read(q, k, v, mask)
            torch.cuda.synchronize()
            want = ma.memory_read_plain(q, k, v, mask)
            ctl = ma.memory_read_plain(control(q), control(k), control(v), mask)
            errs[dname, label] = check(got, want, READ_TOL[dt], f"kernel {dname} {label}", ctl)

    # timings at the stream's steady state (512p, 5 valid slots of 6) and
    # at 1088x1920 (the VM108 protocol's large inputs: 2 valid slots of 3)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    timing = {}
    for b, hw, t, count, label in TIMED:
        for dname in ("bfloat16", "float32"):
            dt = getattr(torch, dname)
            q = torch.randn(b, hw, 128, generator=gen, device="cuda").to(dt)
            k = torch.randn(b, t, hw, 128, generator=gen, device="cuda").to(dt)
            v = torch.randn(b, t, hw, 512, generator=gen, device="cuda").to(dt)
            mask = prefix(b, t, count)
            pos_mask = mask.repeat_interleave(hw, dim=1)[:, None, None, :]   # [B,1,1,T*HW]
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, None], k.reshape(b, 1, t * hw, 128), v.reshape(b, 1, t * hw, 512),
                attn_mask=pos_mask)
            check(sdpa()[:, 0], ma.memory_read_plain(q, k, v, mask), READ_TOL[dt],
                  f"SDPA yardstick {dname} {label}")
            bound_ms, bound_by, cuda_cores_ms = read_cost(dt, b, hw, count, t=t)
            row = timing[dname, label] = dict(
                ms=device_ms(lambda: ma.memory_read(q, k, v, mask), flush=flush),
                event_ms=event_ms(lambda: ma.memory_read(q, k, v, mask), flush=flush),
                plain_ms=device_ms(lambda: ma.memory_read_plain(q, k, v, mask), flush=flush),
                library_ms=device_ms(sdpa, flush=flush),
                bound_ms=bound_ms, bound_by=bound_by, rel_err=errs[dname, label][0],
                max_abs_err=errs[dname, label][1])
            if cuda_cores_ms is not None:
                row["bound_cuda_cores_ms"] = cuda_cores_ms
            print(f"  time {dname:8s} {label}: " + ", ".join(
                f"{key} {val:.4g}" if isinstance(val, float) else f"{key} {val}"
                for key, val in row.items()))
            faster = row["ms"] < min(row["plain_ms"], row["library_ms"])
            print(f"  {'bf16' if dname == 'bfloat16' else 'fp32'} kernel faster than plain "
                  f"and SDPA at {label}: {faster}")

    # the combine kernel, on the split partials of the stream's 512p read,
    # merged into each dtype
    b, hw, t, count, label = TIMED[0]
    _, _, splits = ma.launch_geometry(b, hw, t, 512, torch.cuda.get_device_properties(0)
                                      .multi_processor_count)
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        q = torch.randn(b, hw, 128, generator=gen, device="cuda").to(dt)
        k = torch.randn(b, t, hw, 128, generator=gen, device="cuda").to(dt)
        v = torch.randn(b, t, hw, 512, generator=gen, device="cuda").to(dt)
        acc, ml = ma.memory_read_partials_plain(q, k, v, prefix(b, t, count), splits)
        got = ma.memory_combine_cuda(acc, ml, dt)
        want = ma.combine_plain(acc, ml, dt)
        # control: the partials rounded (through bf16, or fp16 for fp32) before the merge
        rel, err = check(got, want, COMBINE_TOL[dt], f"combine {dname} {label}",
                         ma.combine_plain(combine_control(acc, dt), ml, dt))
        nbytes = acc.numel() * 4 + ml.numel() * 4 + got.numel() * dt.itemsize
        timing[f"combine {dname}", label] = row = dict(
            ms=device_ms(lambda: ma.memory_combine_cuda(acc, ml, dt), flush=flush),
            event_ms=event_ms(lambda: ma.memory_combine_cuda(acc, ml, dt), flush=flush),
            plain_ms=device_ms(lambda: ma.combine_plain(acc, ml, dt), flush=flush),
            library_ms=None, bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes",
            rel_err=rel, max_abs_err=err, splits=splits)
        print(f"  time combine {dname} {label} ({splits} splits): " + ", ".join(
            f"{key} {val:.4g}" if isinstance(val, float) else f"{key} {val}"
            for key, val in row.items()))
    return timing


@contextlib.contextmanager
def lockstep_check(torch, ma, dname):
    """While active, every kernel launch on the path is also computed by
    the plain version on the same inputs and held to READ_TOL; yields the
    list of norm-relative errors per read.  The plain calls launch no
    kernel."""
    from otvm_tpu_torch.tools.kernel_check import READ_TOL, rel_err

    launch, errs = ma.memory_read_cuda, []
    tol = READ_TOL[getattr(torch, dname)]

    def checked(q, k, v, mask):
        out = launch(q, k, v, mask)
        want = ma.memory_read_plain(q, k, v, mask)
        errs.append(rel_err(out, want))
        assert errs[-1] <= tol, f"kernel != plain on the stream's read {len(errs) - 1}: " \
            f"rel err {errs[-1]:.3e} > {tol:g}"
        return out

    ma.memory_read_cuda = checked
    try:
        yield errs
    finally:
        ma.memory_read_cuda = launch


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
    f32 = [lines for kernel, lines in report if kernel.startswith("memory_read_f32tc")]
    assert f32 and all(any(" 0 bytes spill stores, 0 bytes spill loads" in line for line in lines)
                       for lines in f32), "the fp32 kernel spills registers"
    sass = sass_counts(ma)
    print(f"  SASS of {ma.library_path.name}: " + ", ".join(f"{op} {n}" for op, n in sass.items()))
    assert sass["HGMMA"] > 0, "no wgmma (HGMMA) instruction in the built library"
    assert sass["HMMA TF32"] > 0, "no TF32 mma.sync (HMMA ... TF32) in the built library"
    assert sass["UTMALDG"] > 0, "no TMA load (UTMALDG) in the built library"

    print("phase 3: kernel vs plain")
    timing = kernel_phase(torch, ma)

    print("phase 4: full-width stage-4 stream, fp32, kernel vs plain read")
    stm, fba = init_models(seed=0, stage=4)
    stm_sd, fba_sd = stm.state_dict(), fba.state_dict()
    frames, tri = make_video(N_FRAMES)
    proto = EvalProtocol(memory_max_num=MAX_MEM, memory_skip_frame=SKIP, dtype="fp32")
    ev = StreamingEvaluator(stm_sd, fba_sd, proto)
    ev_plain = StreamingEvaluator(stm_sd, fba_sd, proto, memory_impl="plain")
    torch.cuda.synchronize()
    ma.launches = ma.combine_launches = 0
    with lockstep_check(torch, ma, "float32") as read_errs:
        ka, kt, kfps = ev.run_video(frames, tri)
    fp32_launches, fp32_combine_launches = ma.launches, ma.combine_launches
    pa, pt, _ = ev_plain.run_video(frames, tri)
    print(f"  launches in the fp32 kernel stream: memory_read {fp32_launches}, memory_combine "
          f"{fp32_combine_launches} (segment calls: {N_FRAMES - 1}); every read vs plain on "
          f"its own inputs: rel err <= {max(read_errs):.3e}; fp32 {kfps:.2f} frames/s "
          f"(lockstep-checked)")
    check_outputs(ka, kt, N_FRAMES, "fp32 kernel stream")
    check_outputs(pa, pt, N_FRAMES, "fp32 plain stream")
    assert fp32_launches == len(read_errs) == N_FRAMES - 1, \
        "the stream did not run the kernel once per segment call"
    assert fp32_combine_launches == N_FRAMES - 1, "the fp32 stream did not merge its split reads"
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

    print("phase 5: full-width stage-4 stream, bf16, timed")
    ev16 = StreamingEvaluator(stm_sd, fba_sd, EvalProtocol(
        memory_max_num=MAX_MEM, memory_skip_frame=SKIP, dtype="bf16"))
    with lockstep_check(torch, ma, "bfloat16") as read_errs16:   # warm-up, both bank branches
        ev16.run_video(frames[:12], tri)
    print(f"  warm-up: every bf16 read vs plain on its own inputs: rel err <= "
          f"{max(read_errs16):.3e}")
    torch.cuda.synchronize()
    ma.launches = ma.combine_launches = 0
    ba, bt, fps = ev16.run_video(frames, tri)
    bf16_launches, combine_launches = ma.launches, ma.combine_launches
    check_outputs(ba, bt, N_FRAMES, "bf16 stream")
    print(f"  launches in the bf16 stream: memory_read {bf16_launches}, "
          f"memory_combine {combine_launches}")
    assert bf16_launches == N_FRAMES - 1, "the bf16 stream did not run the kernel per segment"
    assert combine_launches == N_FRAMES - 1, "the bf16 stream did not merge its split reads"
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
    print(f"fps_512p_joint_s4_bf16: {fps:.3f} frames/s ({N_FRAMES} frames, run_video, "
          f"wall clock) on {card}")

    # top-level numbers: the stream's shape (512p count 5) in bf16, with
    # the bf16 stream's launches; every timed shape and dtype under
    # "shapes", the fp32 stream's launches beside
    keys = ("max_abs_err", "rel_err", "ms", "event_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    main_label = TIMED[0][4]
    read = timing["bfloat16", main_label]
    comb = timing["combine bfloat16", main_label]
    src = "otvm_tpu_torch/kernels/csrc/memory_attn.cu"
    print(json.dumps({"kernels": [
        {"name": "memory_read", "route": "cuda", "source": src,
         "replaces": "otvm_tpu/kernels/memory_attn.py:134", "launches": bf16_launches,
         "launches_fp32_stream": fp32_launches, **{key: read[key] for key in keys},
         "shapes": {f"{d} {label}": row for (d, label), row in timing.items()
                    if not d.startswith("combine")}},
        {"name": "memory_combine", "route": "cuda", "source": src,
         "replaces": "otvm_tpu/kernels/memory_attn.py:124", "launches": combine_launches,
         "launches_fp32_stream": fp32_combine_launches, **{key: comb[key] for key in keys},
         "shapes": {f"{d[len('combine '):]} {label}": row for (d, label), row in timing.items()
                    if d.startswith("combine")}}]}))
    print(f"total {time.perf_counter() - t_all:.1f} s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
