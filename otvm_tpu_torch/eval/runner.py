"""Streaming eval loops, counterpart of otvm_tpu/eval/runner.py.

  * `StreamingEvaluator.run_video`: joint stage-3/4 checkpoints, one frame
    a step (`eval_frame_step`) or `chunk` frames a call (`eval_chunk_step`);
    stage 1-2 checkpoints run FBA alone on given trimaps (`alpha_predict`).
  * `MultiStreamEvaluator.run_videos`: several clips at once, round-robin,
    one bank each.
  * `TrimapEvaluator.run_video`: the stage-1 STM alone (`trimap_eval_step`).

Protocol (eval.py:117-242): memorize every `memory_skip_frame`-th frame, a
bank of at most `memory_max_num` slots, both adjusted for inputs above
1100 px; frames padded to /32 with the trimap bg-padded.

Pipelining: a step's outputs start a non-blocking copy into pinned host
memory as soon as they are enqueued, and are read after the next step is
enqueued, after their CUDA event.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device, set_fp32_numerics
from ..models.otvm import (alpha_predict, eval_chunk_step, eval_frame_step, make_eval_bank,
                           make_models, trimap_eval_step)
from ..models.stm import STM
from ..nn.layers import freeze_for_inference
from ..nn.ops import divide_pad_amounts


@dataclasses.dataclass
class EvalProtocol:
    memory_max_num: int = 5
    memory_skip_frame: int = 10
    trimap_width: str = "medium"     # GT trimap dilation, config.TRIMAP_WIDTH_KERNELS:
                                     # "medium" only (see __post_init__)
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
        # The width dilates the GT trimaps of the dataset evaluation, which
        # the port does not have yet: another width would pass unapplied.
        if self.trimap_width != "medium":
            raise ValueError(f"trimap_width {self.trimap_width!r}: only 'medium' until the "
                             "dataset evaluation that applies it is ported")

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


def _has_running_stats(state: Optional[Mapping[str, torch.Tensor]]) -> bool:
    """An STM state with BN running stats is the frozen-BN trunk; without,
    the GroupNorm one."""
    return any(k.endswith("running_mean") for k in (state or {}))


class _Device:
    """Host <-> device traffic of the evaluators: pinned uploads, and
    outputs copied back without blocking and read one step later."""

    device: torch.device

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(host)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

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
    def _fetch(pending) -> List[np.ndarray]:
        """The outputs as host arrays of their own: the pinned buffers go
        back to the allocator's cache for the next step, instead of staying
        page-locked as long as the caller keeps the frames."""
        hosts, done = pending
        if done is not None:
            done.synchronize()
        return [h.numpy().copy() for h in hosts]


def _frame_outputs(a: np.ndarray, t: np.ndarray, pad):
    """One frame's alpha [H, W, 1] and trimap [H, W, 3] (or, from the uint8
    wire, alpha bytes and the argmax label [H, W]) -> fp32 alpha [h, w] and
    trimap [h, w, 3], unpadded."""
    a = a[..., 0]
    if a.dtype == np.uint8:              # wire_u8_out: alpha / 255, label -> one-hot
        a = a.astype(np.float32) / 255.0
        t = np.eye(3, dtype=np.float32)[t]
    return _unpad(a, pad), _unpad(t, pad)


class StreamingEvaluator(_Device):
    """Holds the networks on one device; call `run_video` per clip.

    trimap_state / alpha_state: the port's STM and FBA state_dicts (the
    original OTVM names; see convert.from_jax and convert.load_pth).  A
    trimap state without BN running stats selects the GroupNorm STM trunk.
    Stage 1-2 checkpoints have no trimap network: trimap_state may be None
    or empty.  Runs on CUDA unless `device` says otherwise.
    memory_impl='plain' swaps the memory-read kernel for its plain version
    (comparisons only)."""

    def __init__(self, trimap_state: Optional[Mapping[str, torch.Tensor]],
                 alpha_state: Mapping[str, torch.Tensor], protocol: EvalProtocol,
                 device=None, memory_impl: Optional[str] = None):
        self.device = resolve_device(device)
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

    def run_video(self, frames01: Sequence[np.ndarray], first_trimap3: np.ndarray,
                  gt_trimaps: Optional[Sequence[np.ndarray]] = None
                  ) -> Tuple[List[np.ndarray], List[np.ndarray], float]:
        """frames01: RGB [H, W, 3] float in [0, 1]; first_trimap3 [H, W, 3]
        one-hot.  Returns (alphas [H, W], trimaps [H, W, 3], fps), fp32.

        Stage <= 2 runs FBA alone on given trimaps (`alpha_predict`): one
        per frame from `gt_trimaps` (the reference's stage-1/2 eval feeds
        the GT trimap every frame), else first_trimap3 for frame 0 only;
        min(frames, trimaps) frames, and the trimaps returned are the given
        ones.  chunk > 1 runs `chunk` frames a call."""
        p = self.protocol
        if p.stage <= 2:
            return self._run_given_trimaps(frames01, first_trimap3, gt_trimaps)
        n = len(frames01)
        h, w = frames01[0].shape[:2]
        flags, max_num, _ = p.flags(n, h, w)

        f0, t0, pad = _pad_frame(frames01[0], first_trimap3, p.pad_multiple)
        bank = make_eval_bank(1, f0.shape[0], f0.shape[1], max_num, dtype=self.dtype,
                              scale=p.scale, device=self.device)
        first_tri = torch.from_numpy(t0[None]).to(self.device, self.dtype)
        padded = lambda i: f0 if i == 0 else _pad_frame(frames01[i], None, p.pad_multiple)[0]

        alphas, trimaps = [], []
        t_start = time.perf_counter()
        if p.chunk > 1:
            self._run_chunked(bank, padded, first_tri, flags, max_num, pad, alphas, trimaps)
        else:
            pending = None
            for i in range(n):
                first, memorize, last = flags[i]
                frame = self._upload(_wire_u8(padded(i))[None])
                out = eval_frame_step(self.stm, self.fba, bank, frame, first_tri, first, memorize,
                                      last, max_memory_num=max_num, wire_u8_out=p.wire_u8_out,
                                      memory_impl=self.memory_impl)
                bank = out.bank
                if pending is not None:
                    self._collect(pending, pad, alphas, trimaps)
                pending = self._prefetch((out.alpha, out.trimap))
            self._collect(pending, pad, alphas, trimaps)
        fps = n / (time.perf_counter() - t_start)
        return alphas, trimaps, fps

    def _collect(self, pending, pad, alphas, trimaps):
        a, t = self._fetch(pending)
        for aj, tj in zip(a, t):                       # the batch of 1, or a chunk
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
        arrays; ROADMAP §3)."""
        p = self.protocol
        if p.scale != 1:
            raise ValueError("the chunked path serves the real model (scale 1), as in JAX")
        pending = None
        for lo in range(0, len(flags), p.chunk):
            hi = min(lo + p.chunk, len(flags))
            frames = np.stack([padded(i) for i in range(lo, hi)])
            chunk = self._upload(_wire_u8(frames)[:, None])                   # [C, 1, H, W, 3]
            first, mem, last = zip(*flags[lo:hi])
            bank, a, t = eval_chunk_step(self.stm, self.fba, bank, chunk, first_tri, first, mem,
                                         last, max_memory_num=max_num,
                                         memory_impl=self.memory_impl)
            if pending is not None:
                self._collect(pending, pad, alphas, trimaps)
            pending = self._prefetch((a[:, 0], t[:, 0]))
        self._collect(pending, pad, alphas, trimaps)

    def _run_given_trimaps(self, frames01, first_trimap3, gt_trimaps):
        """Stage 1-2 (models/alpha/model.py:419, 456-457 with the trimap
        network bypassed): alpha from a given trimap per frame."""
        p = self.protocol
        tris = list(gt_trimaps) if gt_trimaps is not None else [first_trimap3]
        n = min(len(frames01), len(tris))
        alphas = []
        t_start = time.perf_counter()
        pending = None
        for i in range(n):
            f, t, pad = _pad_frame(frames01[i], tris[i], p.pad_multiple)
            alpha, _ = alpha_predict(self.fba, self._upload(_wire_u8(f)[None]),
                                     self._upload(t[None].astype(np.float32)).to(self.dtype))
            if pending is not None:
                alphas.append(_unpad(self._fetch(pending[0])[0][0, ..., 0], pending[1]))
            pending = (self._prefetch((alpha,)), pad)
        if pending is not None:
            alphas.append(_unpad(self._fetch(pending[0])[0][0, ..., 0], pending[1]))
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

    Two module-level caches are shared by every caller, which is why the
    streams share one CUDA stream: the JFA's CUDA graphs keep one static
    input and output per shape (`nn/edt.py`; streams on separate CUDA
    streams would race on them), and at most 4 shapes, so a group of more
    than 4 resolutions captures its graphs again and again; and the memory
    read's L2 workspace is one per CUDA stream (`kernels/memory_attn.py`)."""

    def run_videos(self, videos: Sequence[Dict]):
        """videos: dicts with `frames` (list of [H, W, 3] float RGB in
        [0, 1]) and `first_trimap` ([H, W, 3] one-hot).  Returns (results,
        aggregate_fps): results[i] = (alphas, trimaps) of stream i, fp32;
        aggregate_fps counts all frames over the wall clock of the run."""
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
                frames=frames, flags=flags, max_num=max_num, pad=pad, f0=f0,
                bank=make_eval_bank(1, f0.shape[0], f0.shape[1], max_num, dtype=self.dtype,
                                    scale=p.scale, device=self.device),
                first_tri=torch.from_numpy(t0[None]).to(self.device, self.dtype),
                alphas=[], trimaps=[], pending=None))

        total_frames = sum(len(s["frames"]) for s in sessions)
        t_start = time.perf_counter()
        for step in range(max((len(s["frames"]) for s in sessions), default=0)):
            for s in sessions:
                if step >= len(s["frames"]):
                    continue
                f = s["f0"] if step == 0 else _pad_frame(s["frames"][step], None,
                                                         p.pad_multiple)[0]
                first, memorize, last = s["flags"][step]
                out = eval_frame_step(self.stm, self.fba, s["bank"],
                                      self._upload(_wire_u8(f)[None]), s["first_tri"], first,
                                      memorize, last, max_memory_num=s["max_num"],
                                      wire_u8_out=p.wire_u8_out, memory_impl=self.memory_impl)
                s["bank"] = out.bank
                # the previous step's copy landed during the other streams' steps
                if s["pending"] is not None:
                    self._collect(s["pending"], s["pad"], s["alphas"], s["trimaps"])
                s["pending"] = self._prefetch((out.alpha, out.trimap))
        for s in sessions:
            if s["pending"] is not None:
                self._collect(s["pending"], s["pad"], s["alphas"], s["trimaps"])
        agg_fps = total_frames / (time.perf_counter() - t_start)
        return [(s["alphas"], s["trimaps"]) for s in sessions], agg_fps


class TrimapEvaluator(_Device):
    """Trimap propagation alone (s1_OTVM_trimap checkpoints; trimap
    FullModel_eval, models/trimap/model.py:173-281): the stage-1 STM (hdim
    -1) through `trimap_eval_step`.  Frames go up as fp32 in [0, 1] and the
    bank is fp32, as in the JAX package (protocol.dtype is not read).
    stm_state without BN running stats selects the GroupNorm trunk.  Runs on
    CUDA unless `device` says otherwise."""

    def __init__(self, stm_state: Mapping[str, torch.Tensor], protocol: EvalProtocol,
                 device=None):
        self.device = resolve_device(device)
        self.protocol = protocol
        set_fp32_numerics()
        self.stm_norm = "frozen_bn" if _has_running_stats(stm_state) else "gn"
        stm = STM(hdim=-1, scale=protocol.scale, norm=self.stm_norm)
        stm.load_state_dict(stm_state, strict=True)
        self.stm = freeze_for_inference(stm.to(self.device).eval().requires_grad_(False))

    def run_video(self, frames01: Sequence[np.ndarray], first_trimap3: np.ndarray
                  ) -> Tuple[List[np.ndarray], float]:
        """frames01: RGB [H, W, 3] float in [0, 1]; first_trimap3 [H, W, 3]
        one-hot.  Returns (trimaps [H, W, 3] fp32, fps)."""
        p = self.protocol
        n = len(frames01)
        h, w = frames01[0].shape[:2]
        flags, max_num, _ = p.flags(n, h, w)
        f0, t0, pad = _pad_frame(frames01[0], first_trimap3, p.pad_multiple)
        bank = make_eval_bank(1, f0.shape[0], f0.shape[1], max_num, scale=p.scale,
                              device=self.device)
        first_tri = torch.from_numpy(t0[None]).to(self.device)
        trimaps = []
        t_start = time.perf_counter()
        pending = None
        for i in range(n):
            f = f0 if i == 0 else _pad_frame(frames01[i], None, p.pad_multiple)[0]
            first, memorize, _ = flags[i]
            bank, pred = trimap_eval_step(self.stm, bank,
                                          self._upload(f[None].astype(np.float32)), first_tri,
                                          first, memorize, max_memory_num=max_num)
            if pending is not None:
                trimaps.append(_unpad(self._fetch(pending)[0][0], pad))
            pending = self._prefetch((pred,))
        trimaps.append(_unpad(self._fetch(pending)[0][0], pad))
        fps = n / (time.perf_counter() - t_start)
        return trimaps, fps


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
