"""Streaming eval loop, counterpart of otvm_tpu/eval/runner.py
(StreamingEvaluator.run_video for joint stage-3/4 checkpoints, one frame per
step).

Protocol (eval.py:117-242): memorize every `memory_skip_frame`-th frame, a
bank of at most `memory_max_num` slots, both adjusted for inputs above
1100 px; frames padded to /32 with the trimap bg-padded.

Pipelining: frame i+1 is enqueued on the device before frame i's outputs
are read.  Each frame's outputs start a non-blocking copy into pinned host
memory as soon as they are enqueued, and are read one frame later, after
their CUDA event.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device, set_fp32_numerics
from ..models.otvm import eval_frame_step, make_eval_bank, make_models
from ..nn.layers import freeze_for_inference
from ..nn.ops import divide_pad_amounts


@dataclasses.dataclass
class EvalProtocol:
    memory_max_num: int = 5
    memory_skip_frame: int = 10
    stage: int = 4                   # joint checkpoints: 3 or 4
    large_input_edge: int = 1100     # eval.py:184
    scale: int = 1                   # width divisor of the served model (>1: tests)
    dtype: str = "fp32"              # "bf16": network and bank in bfloat16;
                                     # outputs are returned in fp32
    wire_u8_out: bool = False        # alpha as uint8 and the trimap as a uint8
                                     # argmax label, made on the device
    pad_multiple: int = 32           # models/alpha/model.py:408-410

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


class StreamingEvaluator:
    """Holds the two networks on one device; call `run_video` per clip.

    trimap_state / alpha_state: the port's STM and FBA state_dicts (the
    original OTVM names; see convert.from_jax and convert.load_pth).  A
    trimap state without BN running stats selects the GroupNorm STM trunk.
    Runs on CUDA unless `device` says otherwise.  memory_impl='plain' swaps
    the memory-read kernel for its plain version (comparisons only)."""

    def __init__(self, trimap_state: Mapping[str, torch.Tensor],
                 alpha_state: Mapping[str, torch.Tensor], protocol: EvalProtocol,
                 device=None, memory_impl: Optional[str] = None):
        if protocol.stage < 3:
            raise NotImplementedError("stage 1-2 (trimap-given) eval is not ported yet")
        self.device = resolve_device(device)
        self.protocol = protocol
        self.memory_impl = memory_impl
        self.dtype = torch.bfloat16 if protocol.dtype == "bf16" else torch.float32
        if self.dtype == torch.float32:
            set_fp32_numerics()
        self.stm_norm = ("frozen_bn" if any(k.endswith("running_mean") for k in trimap_state)
                         else "gn")
        stm, fba = make_models(protocol.stage, protocol.scale, self.stm_norm)
        stm.load_state_dict(trimap_state, strict=True)
        fba.load_state_dict(alpha_state, strict=True)
        serve = lambda m: freeze_for_inference(
            m.to(self.device, self.dtype).eval().requires_grad_(False))
        self.stm, self.fba = serve(stm), serve(fba)

    def run_video(self, frames01: Sequence[np.ndarray], first_trimap3: np.ndarray
                  ) -> Tuple[List[np.ndarray], List[np.ndarray], float]:
        """frames01: RGB [H, W, 3] float in [0, 1]; first_trimap3 [H, W, 3]
        one-hot.  Returns (alphas [H, W], trimaps [H, W, 3], fps), fp32."""
        p = self.protocol
        n = len(frames01)
        h, w = frames01[0].shape[:2]
        flags, max_num, _ = p.flags(n, h, w)

        f0, t0, pad0 = _pad_frame(frames01[0], first_trimap3, p.pad_multiple)
        bank = make_eval_bank(1, f0.shape[0], f0.shape[1], max_num, dtype=self.dtype,
                              scale=p.scale, device=self.device)
        first_tri = torch.from_numpy(t0[None]).to(self.device, self.dtype)

        alphas, trimaps = [], []
        pending = None
        t_start = time.perf_counter()
        for i in range(n):
            if i == 0:
                f, pad = f0, pad0
            else:
                f, _, pad = _pad_frame(frames01[i], None, p.pad_multiple)
            first, memorize, last = flags[i]
            out = eval_frame_step(self.stm, self.fba, bank, self._upload(_wire_u8(f)[None]),
                                  first_tri, first, memorize, last, max_memory_num=max_num,
                                  wire_u8_out=p.wire_u8_out, memory_impl=self.memory_impl)
            bank = out.bank
            if pending is not None:
                self._collect(pending, alphas, trimaps)
            pending = (self._prefetch(out), pad)
        self._collect(pending, alphas, trimaps)
        fps = n / (time.perf_counter() - t_start)
        return alphas, trimaps, fps

    def _upload(self, frame_u8: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(frame_u8)
        if self.device.type != "cuda":
            return host.to(self.device)
        return host.pin_memory().to(self.device, non_blocking=True)

    def _prefetch(self, out):
        """Start the device-to-host copy of this frame's outputs now."""
        tensors = [t.float() if t.is_floating_point() else t for t in (out.alpha, out.trimap)]
        if self.device.type != "cuda":
            return [t.cpu() for t in tensors], None
        hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for hst, t in zip(hosts, tensors):
            hst.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return hosts, done

    @staticmethod
    def _collect(pending, alphas, trimaps):
        (hosts, done), pad = pending
        if done is not None:
            done.synchronize()
        a = hosts[0].numpy()[0, :, :, 0]
        t = hosts[1].numpy()[0]
        if a.dtype == np.uint8:              # wire_u8_out: alpha / 255, label -> one-hot
            a = a.astype(np.float32) / 255.0
            t = np.eye(3, dtype=np.float32)[t]
        alphas.append(_unpad(a, pad))
        trimaps.append(_unpad(t, pad))
