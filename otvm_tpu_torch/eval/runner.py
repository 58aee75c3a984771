"""Streaming eval loops, counterpart of otvm_tpu/eval/runner.py.

  * `StreamingEvaluator.run_video`: joint stage-3/4 checkpoints, one frame
    a step (`eval_frame_step`) or `chunk` frames a call (`eval_chunk_step`);
    stage 1-2 checkpoints run FBA alone on given trimaps (`alpha_predict`).
  * `MultiStreamEvaluator.run_videos`: several clips at once, round-robin,
    one bank each.
  * `TrimapEvaluator.run_video`: the stage-1 STM alone (`trimap_eval_step`).
  * `evaluate_vm108` / `evaluate_vm108_trimap`: the VideoMatting108
    protocol over a dataset tree (`iter_vm108_videos`), scored by
    eval/metrics.py; `iter_demo_videos` reads the demo layout.

Protocol (eval.py:117-242): memorize every `memory_skip_frame`-th frame, a
bank of at most `memory_max_num` slots, both adjusted for inputs above
1100 px; frames padded to /32 with the trimap bg-padded; GT trimaps
dilated by the protocol's `trimap_width` (narrow / medium / wide: radius
5 / 12 / 20).  Alpha PNGs (and `write_viz`'s strips) are written after a
clip's timed loop, so `fps` leaves them out.  The PNGs truncate
(`(clip(a, 0, 1) * 255).astype(uint8)`), where `wire_u8_out` rounds, as
in the JAX package (ROADMAP.md §3).

Pipelining: a step's outputs start a non-blocking copy into pinned host
memory as soon as they are enqueued, and are read after the next step is
enqueued, after their CUDA event.

Spans (utils/trace.py, recorded under a profiler or `trace.enable()`):
each frame's host work is a `serve.frame` (ids clip and frame) holding
serve.prepare (padding, the wire dtype), serve.upload, serve.step (the
step call), the previous frame's serve.readback_wait (its CUDA event) and
serve.outputs (the host copy, unpadding), and serve.prefetch; a clip's
last frame reads its own outputs inside its span.  Each frame adds one to
the counter serve.frames.

On CUDA the evaluators serve each frame from CUDA graphs
(models/graphs.py: one replay a frame, as the JAX evaluators always run
the jitted step); `graphs=False` keeps the eager step, for comparisons and
for the lockstep checks, which cannot see replayed reads.  On the CPU the
eager step is the only one, and asking for graphs there raises.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import os
import shutil
import subprocess
import time
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device, set_fp32_numerics
from ..config import TRIMAP_WIDTH_KERNELS
from ..data.trimap import trimap_from_alpha, trimap_from_png
from ..models.graphs import AlphaGraphs, FrameStepGraphs, TrimapStepGraphs
from ..models.otvm import (alpha_predict, eval_chunk_step, eval_frame_step, make_eval_bank,
                           make_models, trimap_eval_step)
from ..models.stm import STM
from ..nn.layers import freeze_for_inference
from ..nn.ops import divide_pad_amounts
from ..utils import trace
from .metrics import trimap_iou, video_metrics

_CLIPS = itertools.count()      # the clip ids of the spans (utils/trace.py)


@dataclasses.dataclass
class EvalProtocol:
    memory_max_num: int = 5
    memory_skip_frame: int = 10
    trimap_width: str = "medium"     # GT trimap dilation of evaluate_vm108*, a key of
                                     # config.TRIMAP_WIDTH_KERNELS
    stage: int = 4                   # 3-4: joint; 1-2: FBA on given trimaps
    arch: str = "resnet50_GN_WS"     # FBA trunk of the checkpoint (models/fba.py)
    large_input_edge: int = 1100     # eval.py:184
    chunk: int = 1                   # frames a call (eval_chunk_step); the same
                                     # per-frame protocol, the real model only
    scale: int = 1                   # width divisor of the served model (>1: tests)
    dtype: str = "fp32"              # "bf16": network and bank in bfloat16;
                                     # outputs are returned in fp32
    wire_u8_out: bool = False        # alpha as uint8 and the trimap as a uint8
                                     # argmax label, made on the device (not on
                                     # the chunked path, as in the JAX package)
    pad_multiple: int = 32           # models/alpha/model.py:408-410

    def __post_init__(self):
        if self.trimap_width not in TRIMAP_WIDTH_KERNELS:
            raise ValueError(f"trimap_width {self.trimap_width!r}: not one of "
                             f"{sorted(TRIMAP_WIDTH_KERNELS)}")

    def flags(self, n_frames: int, height: int, width: int):
        """Per-frame (first, memorize, last) + effective bank size."""
        skip = self.memory_skip_frame
        max_num = self.memory_max_num
        large = min(height, width) > self.large_input_edge
        if large:
            skip *= 2
            max_num = int(max_num / 2)
        out = []
        for i in range(n_frames):
            memorize = (i % skip == 0) if skip > 2 else False
            out.append((i == 0, memorize, i == n_frames - 1))
        return out, max_num, large


def _wire_u8(frame: np.ndarray) -> np.ndarray:
    """Decoded frames are uint8: ship them so, /255 happens on the device."""
    return np.rint(frame * 255.0).astype(np.uint8)


def _pad_frame(frame: np.ndarray, tri: Optional[np.ndarray], multiple: int = 32):
    h, w = frame.shape[:2]
    lw, uw, lh, uh = divide_pad_amounts(h, w, multiple)
    pad = ((lh, uh), (lw, uw))
    f = np.pad(frame, (*pad, (0, 0)))
    t = None
    if tri is not None:
        t = np.stack([
            np.pad(tri[..., 0], pad, constant_values=1.0),   # bg-pad
            np.pad(tri[..., 1], pad),
            np.pad(tri[..., 2], pad),
        ], axis=-1)
    return f, t, (lw, uw, lh, uh)


def _unpad(x: np.ndarray, pad):
    lw, uw, lh, uh = pad
    h, w = x.shape[:2]
    return x[lh:h - uh if uh else h, lw:w - uw if uw else w]


def _use_graphs(device: torch.device, graphs: Optional[bool]) -> bool:
    """An evaluator's `graphs` argument: None serves from CUDA graphs on
    CUDA; graphs=True off CUDA raises."""
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs on {device}: the eager step is the only one off CUDA "
                         "(graphs=False)")
    return device.type == "cuda" if graphs is None else bool(graphs)


def _has_running_stats(state: Optional[Mapping[str, torch.Tensor]]) -> bool:
    """An STM state with BN running stats is the frozen-BN trunk; without,
    the GroupNorm one."""
    return any(k.endswith("running_mean") for k in (state or {}))


class _Device:
    """Host <-> device traffic of the evaluators: pinned uploads, and
    outputs copied back without blocking and read one step later."""

    device: torch.device
    step_graphs = None      # the CUDA graphs (models/graphs.py) the step is served from

    def _frame_input(self, frame: np.ndarray, dtype=torch.uint8) -> Optional[torch.Tensor]:
        """Where a padded frame goes up to: the graphs' static input."""
        if self.step_graphs is None:
            return None
        return self.step_graphs.frame_buffer((1, *frame.shape), dtype)

    def _bank(self, height: int, width: int, max_num: int, dtype, own: bool = False):
        """A stream's bank: the graphs' static one unless `own` (one bank
        a stream), or a fresh one on the eager path."""
        if self.step_graphs is not None and not own:
            return self.step_graphs.bank(1, height, width, max_num, dtype)
        return make_eval_bank(1, height, width, max_num, dtype=dtype, scale=self.protocol.scale,
                              device=self.device)

    def _upload(self, host: np.ndarray, into: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`host` on the device, through pinned memory without blocking;
        into a given device tensor (a graph's static input) if there is one."""
        t = torch.from_numpy(host)
        if self.device.type != "cuda":
            return t.to(self.device)
        if into is None:
            return t.pin_memory().to(self.device, non_blocking=True)
        return into.copy_(t.pin_memory(), non_blocking=True)

    def _prefetch(self, tensors: Sequence[torch.Tensor]):
        """Start the device-to-host copy of a step's outputs now (floating
        ones as fp32)."""
        tensors = [t.float() if t.is_floating_point() else t for t in tensors]
        if self.device.type != "cuda":
            return [t.cpu() for t in tensors], None
        hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for hst, t in zip(hosts, tensors):
            hst.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return hosts, done

    @staticmethod
    def _wait(pending) -> List[torch.Tensor]:
        """The host buffers of a `_prefetch`, once its copy has landed (off
        CUDA at once)."""
        hosts, done = pending
        with trace.span("serve.readback_wait"):
            if done is not None:
                done.synchronize()
        return hosts

    @staticmethod
    def _own(hosts: Sequence[torch.Tensor]) -> List[np.ndarray]:
        """The outputs as host arrays of their own: the pinned buffers go
        back to the allocator's cache for the next step, instead of staying
        page-locked as long as the caller keeps the frames."""
        return [h.numpy().copy() for h in hosts]

    @staticmethod
    def _fetch(pending) -> List[np.ndarray]:
        """`_wait`, then `_own`."""
        return _Device._own(_Device._wait(pending))


def _frame_outputs(a: np.ndarray, t: np.ndarray, pad):
    """One frame's alpha [H, W, 1] and trimap [H, W, 3] (or, from the uint8
    wire, alpha bytes and the argmax label [H, W]) -> fp32 alpha [h, w] and
    trimap [h, w, 3], unpadded."""
    a = a[..., 0]
    if a.dtype == np.uint8:              # wire_u8_out: alpha / 255, label -> one-hot
        a = a.astype(np.float32) / 255.0
        t = np.eye(3, dtype=np.float32)[t]
    return _unpad(a, pad), _unpad(t, pad)


def _png_name(i: int, filenames: Optional[Sequence[str]]) -> str:
    return os.path.splitext(filenames[i])[0] + ".png" if filenames else f"{i:05d}.png"


def _write_clip(frames01, trimaps, alphas, out_dir: Optional[str],
                filenames: Optional[Sequence[str]], viz_dir: Optional[str]) -> None:
    """A clip's alphas [H, W] as 8-bit PNGs in out_dir, named after
    `filenames` (else 00000.png, ...), truncated as the JAX package's
    writers do (runner.py:200-209); `write_viz`'s strips in viz_dir."""
    if out_dir is not None:
        import cv2

        os.makedirs(out_dir, exist_ok=True)
        for i, a in enumerate(alphas):
            cv2.imwrite(os.path.join(out_dir, _png_name(i, filenames)),
                        (np.clip(a, 0, 1) * 255).astype(np.uint8))
    if viz_dir is not None:
        write_viz(viz_dir, frames01, trimaps, alphas)


class StreamingEvaluator(_Device):
    """Holds the networks on one device; call `run_video` per clip.

    trimap_state / alpha_state: the port's STM and FBA state_dicts (the
    original OTVM names; see convert.from_jax and convert.load_pth).  A
    trimap state without BN running stats selects the GroupNorm STM trunk.
    Stage 1-2 checkpoints have no trimap network: trimap_state may be None
    or empty.  Runs on CUDA unless `device` says otherwise.
    memory_impl='plain' swaps the memory-read kernel for its plain version
    (comparisons only).  graphs: serve the step (`eval_frame_step`, or
    `alpha_predict` at stage 1-2) from CUDA graphs (`step_graphs`,
    models/graphs.py); by default on CUDA.  graphs=False runs it eagerly
    (comparisons, lockstep checks); graphs=True on the CPU raises."""

    def __init__(self, trimap_state: Optional[Mapping[str, torch.Tensor]],
                 alpha_state: Mapping[str, torch.Tensor], protocol: EvalProtocol,
                 device=None, memory_impl: Optional[str] = None,
                 graphs: Optional[bool] = None):
        self.device = resolve_device(device)
        graphs = _use_graphs(self.device, graphs)
        self.protocol = protocol
        self.memory_impl = memory_impl
        self.dtype = torch.bfloat16 if protocol.dtype == "bf16" else torch.float32
        if self.dtype == torch.float32:
            set_fp32_numerics()
        self.stm_norm = "frozen_bn" if _has_running_stats(trimap_state) else "gn"
        stm, fba = make_models(protocol.stage, protocol.scale, self.stm_norm, protocol.arch)
        fba.load_state_dict(alpha_state, strict=True)
        serve = lambda m: freeze_for_inference(
            m.to(self.device, self.dtype).eval().requires_grad_(False))
        self.fba = serve(fba)
        self.stm = None
        if protocol.stage > 2:
            stm.load_state_dict(trimap_state, strict=True)
            self.stm = serve(stm)
        if self.stm is not None:
            self.step_graphs = FrameStepGraphs(self.stm, self.fba) if graphs else None
            self._step = self.step_graphs or functools.partial(eval_frame_step, self.stm,
                                                               self.fba)
        else:
            self.step_graphs = AlphaGraphs(self.fba) if graphs else None
            self._step = self.step_graphs or functools.partial(alpha_predict, self.fba)

    def run_video(self, frames01: Sequence[np.ndarray], first_trimap3: np.ndarray,
                  out_dir: Optional[str] = None, filenames: Optional[Sequence[str]] = None,
                  viz_dir: Optional[str] = None,
                  gt_trimaps: Optional[Sequence[np.ndarray]] = None
                  ) -> Tuple[List[np.ndarray], List[np.ndarray], float]:
        """frames01: RGB [H, W, 3] float in [0, 1]; first_trimap3 [H, W, 3]
        one-hot.  Returns (alphas [H, W], trimaps [H, W, 3], fps), fp32.
        out_dir: the alphas as PNGs there, named after `filenames`;
        viz_dir: `write_viz`'s strips there.

        Stage <= 2 runs FBA alone on given trimaps (`alpha_predict`): one
        per frame from `gt_trimaps` (the reference's stage-1/2 eval feeds
        the GT trimap every frame), else first_trimap3 for frame 0 only;
        min(frames, trimaps) frames, and the trimaps returned are the given
        ones.  chunk > 1 runs `chunk` frames a call."""
        p = self.protocol
        if p.stage <= 2:
            alphas, trimaps, fps = self._run_given_trimaps(frames01, first_trimap3, gt_trimaps)
            _write_clip(frames01[:len(alphas)], trimaps, alphas, out_dir, filenames, viz_dir)
            return alphas, trimaps, fps
        n = len(frames01)
        h, w = frames01[0].shape[:2]
        flags, max_num, _ = p.flags(n, h, w)

        f0, t0, pad = _pad_frame(frames01[0], first_trimap3, p.pad_multiple)
        bank = self._bank(f0.shape[0], f0.shape[1], max_num, self.dtype)
        first_tri = torch.from_numpy(t0[None]).to(self.device, self.dtype)
        padded = lambda i: f0 if i == 0 else _pad_frame(frames01[i], None, p.pad_multiple)[0]

        alphas, trimaps = [], []
        t_start = time.perf_counter()
        if p.chunk > 1:
            self._run_chunked(bank, padded, first_tri, flags, max_num, pad, alphas, trimaps)
        else:
            clip, pending = next(_CLIPS), None
            for i in range(n):
                first, memorize, last = flags[i]
                with trace.span("serve.frame", clip=clip, frame=i):
                    with trace.span("serve.prepare"):
                        wire = _wire_u8(padded(i))[None]
                    with trace.span("serve.upload"):
                        frame = self._upload(wire, self._frame_input(f0))
                    with trace.span("serve.step"):
                        out = self._step(bank, frame, first_tri, first, memorize, last,
                                         max_memory_num=max_num, wire_u8_out=p.wire_u8_out,
                                         memory_impl=self.memory_impl)
                    bank = out.bank
                    if pending is not None:
                        self._collect(pending, pad, alphas, trimaps)
                    with trace.span("serve.prefetch"):
                        pending = self._prefetch((out.alpha, out.trimap))
                    if i == n - 1:
                        self._collect(pending, pad, alphas, trimaps)
                trace.count("serve.frames")
        fps = n / (time.perf_counter() - t_start)
        _write_clip(frames01, trimaps, alphas, out_dir, filenames, viz_dir)
        return alphas, trimaps, fps

    def _collect(self, pending, pad, alphas, trimaps):
        hosts = self._wait(pending)
        with trace.span("serve.outputs"):
            a, t = self._own(hosts)
            for aj, tj in zip(a, t):                   # the batch of 1, or a chunk
                alpha, trimap = _frame_outputs(aj, tj, pad)
                alphas.append(alpha)
                trimaps.append(trimap)

    def _run_chunked(self, bank, padded, first_tri, flags, max_num, pad, alphas, trimaps):
        """`chunk` frames a call (`eval_chunk_step`), the flags per frame:
        one upload, one readback and one wait a chunk.  On an H100, chunk 8
        served bf16 6-10% faster than the per-frame loop and fp32 3% slower,
        with the same ops per frame (PERF.md, `profile_stream --serving`).
        JAX pads the tail chunk with repeats of the last frame under
        (first, memorize, last) = (False, False, True), which leave the bank
        as it is and whose outputs it drops; the flags here are host bools,
        so the tail chunk runs its real frames only, and the bank ends as
        JAX's.  Outputs fp32, as JAX's in fp32 (in bf16 JAX returns bf16
        arrays; ROADMAP §3).  A chunk is one serve.frame span, its first
        frame's index its id, and counts its frames in serve.frames."""
        p = self.protocol
        if p.scale != 1:
            raise ValueError("the chunked path serves the real model (scale 1), as in JAX")
        clip, pending = next(_CLIPS), None
        for lo in range(0, len(flags), p.chunk):
            hi = min(lo + p.chunk, len(flags))
            with trace.span("serve.frame", clip=clip, frame=lo):
                with trace.span("serve.prepare"):
                    wire = _wire_u8(np.stack([padded(i) for i in range(lo, hi)]))[:, None]
                with trace.span("serve.upload"):
                    chunk = self._upload(wire)                               # [C, 1, H, W, 3]
                first, mem, last = zip(*flags[lo:hi])
                with trace.span("serve.step"):
                    bank, a, t = eval_chunk_step(self.stm, self.fba, bank, chunk, first_tri, first,
                                                 mem, last, max_memory_num=max_num,
                                                 memory_impl=self.memory_impl,
                                                 graphs=self.step_graphs)
                if pending is not None:
                    self._collect(pending, pad, alphas, trimaps)
                with trace.span("serve.prefetch"):
                    pending = self._prefetch((a[:, 0], t[:, 0]))
                if hi == len(flags):
                    self._collect(pending, pad, alphas, trimaps)
            trace.count("serve.frames", hi - lo)

    def _run_given_trimaps(self, frames01, first_trimap3, gt_trimaps):
        """Stage 1-2 (models/alpha/model.py:419, 456-457 with the trimap
        network bypassed): alpha from a given trimap per frame."""
        p = self.protocol
        tris = list(gt_trimaps) if gt_trimaps is not None else [first_trimap3]
        n = min(len(frames01), len(tris))
        alphas = []

        def collect(pending, pad):
            hosts = self._wait(pending)
            with trace.span("serve.outputs"):
                alphas.append(_unpad(self._own(hosts)[0][0, ..., 0], pad))

        t_start = time.perf_counter()
        clip, pending = next(_CLIPS), None
        for i in range(n):
            with trace.span("serve.frame", clip=clip, frame=i):
                with trace.span("serve.prepare"):
                    f, t, pad = _pad_frame(frames01[i], tris[i], p.pad_multiple)
                    wire, tri = _wire_u8(f)[None], t[None].astype(np.float32)
                with trace.span("serve.upload"):
                    frame = self._upload(wire, self._frame_input(f))
                    tri = self._upload(tri).to(self.dtype)
                with trace.span("serve.step"):
                    alpha, _ = self._step(frame, tri)
                if pending is not None:
                    collect(*pending)
                with trace.span("serve.prefetch"):
                    pending = (self._prefetch((alpha,)), pad)
                if i == n - 1:
                    collect(*pending)
            trace.count("serve.frames")
        fps = n / (time.perf_counter() - t_start)
        return alphas, tris[:n], fps


class MultiStreamEvaluator(StreamingEvaluator):
    """Several clips at once on one card: round-robin B=1 steps through
    `eval_frame_step`, one bank and one pending host copy per stream, all
    on the current CUDA stream (the JAX package's round-robin of one
    executable: its measurements found B=N batching slower than B=1 steps
    in turn).  It serves several clips at once, not faster: on an H100 its
    aggregate rate was that of `run_video` on each clip in turn (within
    4%, the same ops per frame; PERF.md, `profile_stream --serving`), as
    nothing overlaps on one CUDA stream.  Each stream keeps its own bank
    and count, so the protocol (memorize cadence, keep-slot-0 eviction,
    large-input halving) applies to each as in the serial per-clip loop,
    and a stream's outputs are those of `run_video` on its clip alone.
    Clips may differ in length and resolution.

    Graphed (on CUDA by default), the streams share the step's graphs:
    each stream's bank is copied into the static bank before its step and
    back after it, and each step's outputs are copied to the host before
    the next stream's replay overwrites them.  The graphs keep at most 4
    buckets (shapes and settings), so a group of more than 4 resolutions
    captures its graphs again and again.

    Module-level caches are shared by every caller, which is why the
    streams share one CUDA stream: the JFA's CUDA graphs keep one static
    input and output per shape (`nn/edt.py`; streams on separate CUDA
    streams would race on them), and at most 4 shapes; and the memory
    read's L2 workspace is one per CUDA stream (`kernels/memory_attn.py`)."""

    def run_videos(self, videos: Sequence[Dict], out_root: Optional[str] = None,
                   viz_root: Optional[str] = None):
        """videos: dicts with `frames` (list of [H, W, 3] float RGB in
        [0, 1]) and `first_trimap` ([H, W, 3] one-hot), optionally
        `seq_name` and `filenames`.  Returns (results, aggregate_fps):
        results[i] = (alphas, trimaps) of stream i, fp32; aggregate_fps
        counts all frames over the wall clock of the run.  out_root /
        viz_root: each stream's alpha PNGs / viz strips in
        <root>/<seq_name> (else stream<i>), written after the run."""
        p = self.protocol
        if p.stage <= 2:
            raise ValueError("multi-stream serving is the joint path (stage 3-4)")
        sessions = []
        for v in videos:
            frames = v["frames"]
            h, w = frames[0].shape[:2]
            flags, max_num, _ = p.flags(len(frames), h, w)
            f0, t0, pad = _pad_frame(frames[0], v["first_trimap"], p.pad_multiple)
            sessions.append(dict(
                clip=next(_CLIPS), frames=frames, flags=flags, max_num=max_num, pad=pad, f0=f0,
                bank=self._bank(f0.shape[0], f0.shape[1], max_num, self.dtype, own=True),
                first_tri=torch.from_numpy(t0[None]).to(self.device, self.dtype),
                alphas=[], trimaps=[], pending=None))

        total_frames = sum(len(s["frames"]) for s in sessions)
        t_start = time.perf_counter()
        for step in range(max((len(s["frames"]) for s in sessions), default=0)):
            for s in sessions:
                if step >= len(s["frames"]):
                    continue
                first, memorize, last = s["flags"][step]
                with trace.span("serve.frame", clip=s["clip"], frame=step):
                    with trace.span("serve.prepare"):
                        f = s["f0"] if step == 0 else _pad_frame(s["frames"][step], None,
                                                                 p.pad_multiple)[0]
                        wire = _wire_u8(f)[None]
                    with trace.span("serve.upload"):
                        frame = self._upload(wire, self._frame_input(f))
                    with trace.span("serve.step"):
                        out = self._step(s["bank"], frame, s["first_tri"], first, memorize, last,
                                         max_memory_num=s["max_num"], wire_u8_out=p.wire_u8_out,
                                         memory_impl=self.memory_impl)
                    s["bank"] = out.bank
                    # the previous step's copy landed during the other streams' steps
                    if s["pending"] is not None:
                        self._collect(s["pending"], s["pad"], s["alphas"], s["trimaps"])
                    with trace.span("serve.prefetch"):
                        s["pending"] = self._prefetch((out.alpha, out.trimap))
                trace.count("serve.frames")
        # each stream's last outputs, outside its frames' spans: read here, their
        # copies landed during the other streams' steps
        for s in sessions:
            if s["pending"] is not None:
                self._collect(s["pending"], s["pad"], s["alphas"], s["trimaps"])
        agg_fps = total_frames / (time.perf_counter() - t_start)
        for k, (v, s) in enumerate(zip(videos, sessions)):
            sub = v.get("seq_name") or f"stream{k}"
            _write_clip(s["frames"], s["trimaps"], s["alphas"],
                        os.path.join(out_root, sub) if out_root is not None else None,
                        v.get("filenames"),
                        os.path.join(viz_root, sub) if viz_root is not None else None)
        return [(s["alphas"], s["trimaps"]) for s in sessions], agg_fps


class TrimapEvaluator(_Device):
    """Trimap propagation alone (s1_OTVM_trimap checkpoints; trimap
    FullModel_eval, models/trimap/model.py:173-281): the stage-1 STM (hdim
    -1) through `trimap_eval_step`.  Frames go up as fp32 in [0, 1] and the
    bank is fp32, as in the JAX package (protocol.dtype is not read).
    stm_state without BN running stats selects the GroupNorm trunk.  Runs on
    CUDA unless `device` says otherwise, each frame's step from CUDA graphs
    unless graphs=False (StreamingEvaluator's argument)."""

    def __init__(self, stm_state: Mapping[str, torch.Tensor], protocol: EvalProtocol,
                 device=None, graphs: Optional[bool] = None):
        self.device = resolve_device(device)
        graphs = _use_graphs(self.device, graphs)
        self.protocol = protocol
        set_fp32_numerics()
        self.stm_norm = "frozen_bn" if _has_running_stats(stm_state) else "gn"
        stm = STM(hdim=-1, scale=protocol.scale, norm=self.stm_norm)
        stm.load_state_dict(stm_state, strict=True)
        self.stm = freeze_for_inference(stm.to(self.device).eval().requires_grad_(False))
        self.step_graphs = TrimapStepGraphs(self.stm) if graphs else None
        self._step = self.step_graphs or functools.partial(trimap_eval_step, self.stm)

    def run_video(self, frames01: Sequence[np.ndarray], first_trimap3: np.ndarray,
                  out_dir: Optional[str] = None, filenames: Optional[Sequence[str]] = None
                  ) -> Tuple[List[np.ndarray], float]:
        """frames01: RGB [H, W, 3] float in [0, 1]; first_trimap3 [H, W, 3]
        one-hot.  Returns (trimaps [H, W, 3] fp32, fps).  out_dir: each
        trimap's argmax label x 127 as a gray PNG there, after the run."""
        p = self.protocol
        n = len(frames01)
        h, w = frames01[0].shape[:2]
        flags, max_num, _ = p.flags(n, h, w)
        f0, t0, pad = _pad_frame(frames01[0], first_trimap3, p.pad_multiple)
        bank = self._bank(f0.shape[0], f0.shape[1], max_num, torch.float32)
        first_tri = torch.from_numpy(t0[None]).to(self.device)
        trimaps = []

        def collect(pending):
            hosts = self._wait(pending)
            with trace.span("serve.outputs"):
                trimaps.append(_unpad(self._own(hosts)[0][0], pad))

        t_start = time.perf_counter()
        clip, pending = next(_CLIPS), None
        for i in range(n):
            first, memorize, _ = flags[i]
            with trace.span("serve.frame", clip=clip, frame=i):
                with trace.span("serve.prepare"):
                    f = f0 if i == 0 else _pad_frame(frames01[i], None, p.pad_multiple)[0]
                    host = f[None].astype(np.float32)
                with trace.span("serve.upload"):
                    frame = self._upload(host, self._frame_input(f, torch.float32))
                with trace.span("serve.step"):
                    bank, pred = self._step(bank, frame, first_tri, first, memorize,
                                            max_memory_num=max_num)
                if pending is not None:
                    collect(pending)
                with trace.span("serve.prefetch"):
                    pending = self._prefetch((pred,))
                if i == n - 1:
                    collect(pending)
            trace.count("serve.frames")
        fps = n / (time.perf_counter() - t_start)
        if out_dir is not None:
            import cv2

            os.makedirs(out_dir, exist_ok=True)
            for i, t in enumerate(trimaps):
                cv2.imwrite(os.path.join(out_dir, _png_name(i, filenames)),
                            np.argmax(t, axis=-1).astype(np.uint8) * 127)
        return trimaps, fps


def write_viz(viz_dir: str, frames01, trimaps, alphas, fps: int = 10) -> None:
    """A strip per frame, [image | trimap | alpha | composite over green],
    as f00000.jpg, ... (eval.py:96-115, 201-242), and viz.mp4 from them
    where ffmpeg is on the PATH."""
    import cv2

    os.makedirs(viz_dir, exist_ok=True)
    for i, (f, t, a) in enumerate(zip(frames01, trimaps, alphas)):
        a3 = np.repeat(a[..., None], 3, axis=-1)
        green = np.zeros_like(f)
        green[..., 1] = 1.0
        comp = f * a3 + green * (1 - a3)
        strip = np.concatenate([f, t, a3, comp], axis=1)
        cv2.imwrite(os.path.join(viz_dir, f"f{i:05d}.jpg"),
                    (np.clip(strip[..., ::-1], 0, 1) * 255).astype(np.uint8))
    if shutil.which("ffmpeg"):
        subprocess.run(
            ["ffmpeg", "-framerate", str(fps), "-i", os.path.join(viz_dir, "f%05d.jpg"),
             os.path.join(viz_dir, "viz.mp4"), "-nostats", "-loglevel", "0", "-y"],
            check=False)


def frame_window_indices(idx: int, num_frames: int, total: int) -> np.ndarray:
    """EvalDataset's num_frames > 1 window (dataset.py:922-957): a centered,
    edge-clipped window of frame indices around idx, with the reference's
    arange + 0.5 truncation.  The shipped protocol uses num_frames = 1."""
    fi = (np.arange(idx - num_frames / 2, idx + num_frames / 2, 1.0) + 0.5).astype(np.int32)
    return np.clip(fi, 0, total - 1)


def load_frame_window(frames: Sequence[np.ndarray], idx: int, num_frames: int
                      ) -> Tuple[np.ndarray, int]:
    """The centered window stacked [num_frames, H, W, C], and its center
    frame's index (the reference names the output after it, dataset.py:956)."""
    wi = frame_window_indices(idx, num_frames, len(frames))
    return np.stack([frames[i] for i in wi]), int(wi[num_frames // 2])


def iter_demo_videos(data_root: str) -> Iterator[Dict]:
    """The demo layout (Demo_Test, dataset.py:1019-1070): <root>/<seq>/
    frames/*.jpg, and <root>/<seq>/trimap/<first frame>.png for the first
    frame only.  Yields dicts: seq_name, frames (RGB float in [0, 1]),
    first_trimap (one-hot), filenames, gt_alpha None."""
    import cv2

    for seq in sorted(os.listdir(data_root)):
        fdir = os.path.join(data_root, seq, "frames")
        tdir = os.path.join(data_root, seq, "trimap")
        if not os.path.isdir(fdir):
            continue
        names = sorted(os.listdir(fdir))
        frames = []
        for nm in names:
            bgr = cv2.imread(os.path.join(fdir, nm), cv2.IMREAD_COLOR)
            frames.append(bgr[..., ::-1].astype(np.float32) / 255.0)
        tri_name = os.path.splitext(names[0])[0] + ".png"
        tri = trimap_from_png(cv2.imread(os.path.join(tdir, tri_name), cv2.IMREAD_UNCHANGED))
        yield dict(seq_name=seq, frames=frames, first_trimap=tri, filenames=names, gt_alpha=None)


def iter_vm108_videos(data_root: str, mode: str = "val", dilate_radius: int = 12
                      ) -> Iterator[Dict]:
    """The VideoMatting108 layout (VideoMatting108_Test, dataset.py:959-1017):
    <root>/VideoMatting108/FG_done/<seq>/*.png RGBA (alpha in the 4th
    channel), the background of each frame in BG_done2 through
    frame_corr.json (a missing one read as .png), the clips listed in
    {mode}_videos.txt.  Frames are composited fg * a + bg * (1 - a); the
    first trimap is the GT alpha's, dilated by `dilate_radius`.  Yields
    iter_demo_videos' keys with gt_alpha (list of [H, W]) and dilate_radius."""
    import cv2

    root = os.path.join(data_root, "VideoMatting108")
    with open(os.path.join(root, "frame_corr.json")) as f:
        frame_corr = json.load(f)
    with open(os.path.join(root, f"{mode}_videos.txt")) as f:
        seqs = [v.strip() for v in f if v.strip()]

    for seq in seqs:
        fns = [k for k in sorted(frame_corr.keys()) if os.path.dirname(k) == seq]
        frames, gt_alphas = [], []
        for fn in fns:
            raw = cv2.imread(os.path.join(root, "FG_done", fn), cv2.IMREAD_UNCHANGED)
            fg = raw[..., :3].astype(np.float32)
            a = raw[..., 3:4].astype(np.float32) / 255.0
            bgp = os.path.join(root, "BG_done2", frame_corr[fn])
            if not os.path.exists(bgp):
                bgp = os.path.splitext(bgp)[0] + ".png"
            bg = cv2.imread(bgp, cv2.IMREAD_COLOR).astype(np.float32)
            comp = (fg * a + bg * (1 - a))[..., ::-1] / 255.0      # BGR -> RGB in [0, 1]
            frames.append(comp.astype(np.float32))
            gt_alphas.append(a[..., 0])
        tri = trimap_from_alpha(gt_alphas[0], dilate_radius)
        yield dict(seq_name=seq, frames=frames, first_trimap=tri,
                   filenames=[os.path.basename(f) for f in fns],
                   gt_alpha=gt_alphas, dilate_radius=dilate_radius)


def _score_vm108_video(vid: Dict, alphas, radius: int, totals: Dict[str, float]) -> None:
    """Adds one clip's 7 metrics to `totals`, scored on the unknown region
    of each frame's GT trimap at `radius` (utils/tmp/metric.py:114-119)."""
    pred = np.stack(alphas) * 255.0
    gt = np.stack(vid["gt_alpha"]) * 255.0
    mask = np.stack([trimap_from_alpha(a, radius)[..., 1] for a in vid["gt_alpha"]]) * 128.0
    for k, v in video_metrics(pred, gt, mask).items():
        totals[k] = totals.get(k, 0.0) + v


def evaluate_vm108(evaluator: StreamingEvaluator, data_root: str,
                   out_dir: Optional[str] = None, mode: str = "val",
                   max_videos: Optional[int] = None, streams: int = 1) -> Dict[str, float]:
    """The VM108 protocol: every clip of {mode}_videos.txt (at most
    `max_videos`) through the evaluator, scored against its GT alphas on
    the unknown region of the GT trimaps dilated by the protocol's
    trimap_width.  Returns each metric's mean over clips, `fps` (the mean
    of the clips'; with streams > 1 of the groups' aggregate rates) and
    `videos`.  Stage <= 2 feeds every frame's GT trimap (the given-trimap
    protocol).  streams > 1 serves the clips in groups of `streams`
    through a MultiStreamEvaluator (each clip's outputs are those of
    run_video).  out_dir: the alpha PNGs in out_dir/<seq>."""
    radius = TRIMAP_WIDTH_KERNELS[evaluator.protocol.trimap_width]
    totals: Dict[str, float] = {}
    count = 0
    fps_all = []
    if streams > 1:
        if not isinstance(evaluator, MultiStreamEvaluator):
            raise ValueError("streams > 1 needs a MultiStreamEvaluator")
        group: list = []

        def flush():
            results, agg_fps = evaluator.run_videos(group, out_root=out_dir)
            fps_all.append(agg_fps)
            for vid, (alphas, _) in zip(group, results):
                _score_vm108_video(vid, alphas, radius, totals)
            group.clear()

        for vid in iter_vm108_videos(data_root, mode, radius):
            group.append(vid)
            count += 1
            if len(group) == streams:
                flush()
            if max_videos and count >= max_videos:
                break
        if group:
            flush()
    else:
        for vid in iter_vm108_videos(data_root, mode, radius):
            gt_tris = None
            if evaluator.protocol.stage <= 2:
                gt_tris = [trimap_from_alpha(a, radius) for a in vid["gt_alpha"]]
            alphas, _, fps = evaluator.run_video(
                vid["frames"], vid["first_trimap"],
                out_dir=os.path.join(out_dir, vid["seq_name"]) if out_dir else None,
                filenames=vid["filenames"], gt_trimaps=gt_tris)
            fps_all.append(fps)
            _score_vm108_video(vid, alphas, radius, totals)
            count += 1
            if max_videos and count >= max_videos:
                break
    out = {k: v / max(count, 1) for k, v in totals.items()}
    out["fps"] = float(np.mean(fps_all)) if fps_all else 0.0
    out["videos"] = count
    return out


def evaluate_vm108_trimap(evaluator: TrimapEvaluator, data_root: str,
                          out_dir: Optional[str] = None, mode: str = "val",
                          max_videos: Optional[int] = None) -> Dict[str, float]:
    """Trimap propagation on VM108: the mean over clips of the mean
    trimap_iou of each frame's predicted trimap against the GT trimap at
    the protocol's width (train_s1_trimap.py:287-303's metric), with `fps`
    and `videos`.  out_dir: the label PNGs in out_dir/<seq>."""
    radius = TRIMAP_WIDTH_KERNELS[evaluator.protocol.trimap_width]
    ious, fps_all = [], []
    count = 0
    for vid in iter_vm108_videos(data_root, mode, radius):
        trimaps, fps = evaluator.run_video(
            vid["frames"], vid["first_trimap"],
            out_dir=os.path.join(out_dir, vid["seq_name"]) if out_dir else None,
            filenames=vid["filenames"])
        fps_all.append(fps)
        gts = [trimap_from_alpha(a, radius) for a in vid["gt_alpha"]]
        ious.append(float(np.mean([trimap_iou(p, g) for p, g in zip(trimaps, gts)])))
        count += 1
        if max_videos and count >= max_videos:
            break
    return dict(iou=float(np.mean(ious)) if ious else 0.0,
                fps=float(np.mean(fps_all)) if fps_all else 0.0, videos=count)
