#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (otvm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the memory-read kernel from otvm_tpu_torch/kernels/csrc (nvcc,
     sm_90a), timed;
  3. the kernel against its plain PyTorch version on the card, fp32 (TF32
     off) and bf16, at the stream's shapes (512p: HW=1024, T=6, 1..6 valid
     slots; 1088x1920: HW=8160, T=3), ragged tiles with a non-prefix mask,
     and no valid slot; then its time beside the plain version's, SDPA's
     (a yardstick only: the port never calls it) and the bound;
  4. the full-width stage-4 stream through StreamingEvaluator.run_video:
     512x512, a bank of at most 5, memorize every 10th frame, random
     weights from a seed, fp32, once with the kernel and once with the
     plain read.  The kernel must be launched once per segment call
     (frames - 1), every one of its reads must match the plain read on the
     same inputs, and the two streams must agree on frames 0 and 1 (later
     frames are printed: see the note in main);
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
import subprocess
import sys
import time

import numpy as np

H = W = 512
N_FRAMES = 30
MAX_MEM = 5
SKIP = 10
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM dense, CUDA-core fp32
PEAK_BYTES = 3.35e12
TOL = {
    # both accumulate in fp32, in different orders; outputs are O(1)
    "float32": dict(atol=1e-4, rtol=1e-4),
    # outputs are bf16 (ulp 2^-7 at 1): the kernel rounds the unnormalized
    # p to bf16, the plain version the normalized p, then both round the
    # output: a couple of ulps apart at most
    "bfloat16": dict(atol=2e-2, rtol=1e-2),
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=20, flush=None):
    """Median device time of one call, by CUDA events around each call;
    `flush` (a tensor larger than L2) is rewritten before each call so the
    call finds the cache cold, as it does between frames of the stream."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_phase(torch, ma):
    """Phase 3: kernel vs plain at the stream's shapes; timings at 512p."""
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
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.isfinite(got.float()).all().item()
            print(f"  kernel vs plain {dname:8s} {label:24s} max|err| {err:.3e}")
            if not ok:
                raise AssertionError(f"non-finite kernel output ({dname}, {label})")
            torch.testing.assert_close(got.float(), want.float(), **TOL[dname],
                                       msg=f"kernel != plain ({dname}, {label})")
            errs[dname, label] = err

    # timings at the stream's steady state: 512p, 5 valid slots of 6
    b, hw, t, count = 1, 1024, 6, 5
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    timing = {}
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        q = torch.randn(b, hw, 128, generator=gen, device="cuda").to(dt)
        k = torch.randn(b, t, hw, 128, generator=gen, device="cuda").to(dt)
        v = torch.randn(b, t, hw, 512, generator=gen, device="cuda").to(dt)
        mask = prefix(b, t, count)
        pos_mask = mask.repeat_interleave(hw, dim=1)[:, None, None, :]   # [B,1,1,T*HW]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, None], k.reshape(b, 1, t * hw, 128), v.reshape(b, 1, t * hw, 512),
            attn_mask=pos_mask)
        torch.testing.assert_close(sdpa()[:, 0].float(), ma.memory_read_plain(q, k, v, mask).float(),
                                   **TOL[dname], msg="SDPA yardstick computes another function")
        flops = 2.0 * b * hw * (count * hw) * (128 + 512)
        nbytes = dt.itemsize * (b * hw * 128 + b * count * hw * (128 + 512) + b * hw * 512) + b * t
        timing[dname] = dict(
            ms=time_ms(torch, lambda: ma.memory_read(q, k, v, mask), flush=flush),
            plain_ms=time_ms(torch, lambda: ma.memory_read_plain(q, k, v, mask), flush=flush),
            library_ms=time_ms(torch, sdpa, flush=flush),
            bound_ms=1e3 * max(flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES),
            bound_by="operations" if flops / PEAK_FLOPS[dname] >= nbytes / PEAK_BYTES
            else "bytes",
            max_abs_err=errs[dname, f"512p count {count}"])
        print(f"  time {dname:8s} 512p count {count}: " + ", ".join(
            f"{key} {val:.4g}" if isinstance(val, float) else f"{key} {val}"
            for key, val in timing[dname].items()))
    return timing


@contextlib.contextmanager
def lockstep_check(torch, ma, dname):
    """While active, every kernel launch on the path is also computed by
    the plain version on the same inputs and held to TOL; yields the list
    of max |err| per read.  The plain calls launch no kernel."""
    launch, errs = ma.memory_read_cuda, []

    def checked(q, k, v, mask):
        out = launch(q, k, v, mask)
        want = ma.memory_read_plain(q, k, v, mask)
        torch.testing.assert_close(out.float(), want.float(), **TOL[dname],
                                   msg=f"kernel != plain on the stream's read {len(errs)}")
        errs.append((out.float() - want.float()).abs().max().item())
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
    for line in ma.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    print("phase 3: kernel vs plain")
    timing = kernel_phase(torch, ma)

    print("phase 4: full-width stage-4 stream, fp32, kernel vs plain read")
    stm, fba = init_models(seed=0, stage=4)
    stm_sd, fba_sd = stm.state_dict(), fba.state_dict()
    frames, tri = make_video(N_FRAMES)
    proto = EvalProtocol(memory_max_num=MAX_MEM, memory_skip_frame=SKIP, dtype="fp32")
    ev = StreamingEvaluator(stm_sd, fba_sd, proto)
    ev_plain = StreamingEvaluator(stm_sd, fba_sd, proto, memory_impl="plain")
    ma.launches = 0
    with lockstep_check(torch, ma, "float32") as read_errs:
        ka, kt, kfps = ev.run_video(frames, tri)
    fp32_launches = ma.launches
    pa, pt, _ = ev_plain.run_video(frames, tri)
    print(f"  kernel launches in the kernel stream: {fp32_launches} "
          f"(segment calls: {N_FRAMES - 1}); every read vs plain on its own inputs: "
          f"max|err| {max(read_errs):.3e}; fp32 {kfps:.2f} frames/s (lockstep-checked)")
    check_outputs(ka, kt, N_FRAMES, "fp32 kernel stream")
    check_outputs(pa, pt, N_FRAMES, "fp32 plain stream")
    assert fp32_launches == len(read_errs) == N_FRAMES - 1, \
        "the stream did not run the kernel once per segment call"
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
    print(f"  warm-up: every bf16 read vs plain on its own inputs: max|err| "
          f"{max(read_errs16):.3e}")
    torch.cuda.synchronize()
    ma.launches = 0
    ba, bt, fps = ev16.run_video(frames, tri)
    bf16_launches = ma.launches
    check_outputs(ba, bt, N_FRAMES, "bf16 stream")
    assert bf16_launches == N_FRAMES - 1, "the bf16 stream did not run the kernel per segment"
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

    t = timing["bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "memory_read", "route": "cuda",
        "source": "otvm_tpu_torch/kernels/csrc/memory_attn.cu",
        "replaces": "otvm_tpu/kernels/memory_attn.py:134",
        "launches": bf16_launches, "max_abs_err": t["max_abs_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]}]}))
    print(f"total {time.perf_counter() - t_all:.1f} s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
