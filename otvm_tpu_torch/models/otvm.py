"""Joint OTVM streaming inference, counterpart of otvm_tpu/models/otvm.py.

`eval_frame_step` is one frame of joint stage-3/4 inference (alpha
EvalModel.forward, models/alpha/model.py:391-512): segment with the memory
bank -> softmax -> trimap features (argmax, JFA EDT, clicks) -> FBA with
refinement -> memorize -> bank update.  Flags are Python bools and the bank
count a host int, so a frame is enqueued on the device without waiting for
it.  Arrays are NHWC, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import resolve_device
from ..nn.edt import trimap_clicks
from ..nn.layers import init_flax_style
from .fba import FBA
from .memory import MemoryBank, init_bank, update_bank
from .stm import KEY_DIM, STM, VAL_DIM, normalize_image


def argmax_small(x: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis, first max wins (otvm_tpu/train/losses.py)."""
    best = x[..., 0]
    idx = torch.zeros(best.shape, dtype=torch.int64, device=x.device)
    for k in range(1, x.shape[-1]):
        take = x[..., k] > best
        best = torch.where(take, x[..., k], best)
        idx = torch.where(take, torch.full_like(idx, k), idx)
    return idx


def make_trimap_features(tri3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tri3 [B, H, W, 3] soft trimap -> (feats8 [B, H, W, 8], trimask
    [B, H, W, 1]).  feats8 = [bg clicks x3, fg clicks x3, soft bg, soft fg];
    trimask = the hard unknown region (argmax == 1)."""
    am = argmax_small(tri3)
    t2 = torch.stack([(am == 0), (am == 2)], dim=-1).float()
    clicks = trimap_clicks(t2)
    soft = torch.stack([tri3[..., 0], tri3[..., 2]], dim=-1)
    feats = torch.cat([clicks.to(tri3.dtype), soft], dim=-1)
    trimask = (am == 1).to(tri3.dtype)[..., None]
    return feats, trimask


def make_models(stage: int = 4, scale: int = 1, stm_norm: str = "frozen_bn"
                ) -> Tuple[STM, FBA]:
    """The (STM, FBA) pair of a stage, on the CPU, with torch's default init."""
    refinement = stage > 2
    return (STM(hdim=16 if refinement else -1, scale=scale, norm=stm_norm),
            FBA(refinement=refinement, scale=scale))


def init_models(seed: int = 0, stage: int = 4, scale: int = 1,
                stm_norm: str = "frozen_bn") -> Tuple[STM, FBA]:
    """make_models with flax-default random weights drawn from `seed`."""
    stm, fba = make_models(stage, scale, stm_norm)
    g = torch.Generator().manual_seed(seed)
    init_flax_style(stm, g)
    init_flax_style(fba, g)
    return stm, fba


class EvalOutput(NamedTuple):
    bank: MemoryBank
    alpha: torch.Tensor     # [B, H, W, 1] (uint8 with wire_u8_out)
    trimap: torch.Tensor    # [B, H, W, 3] (uint8 argmax label [B, H, W] with wire_u8_out)


@torch.no_grad()
def eval_frame_step(stm: STM, fba: FBA, bank: MemoryBank, frame01: torch.Tensor,
                    first_trimap3: torch.Tensor, first_frame: bool, memorize: bool,
                    last_frame: bool, max_memory_num: int = 5, wire_u8_out: bool = False,
                    memory_impl: Optional[str] = None) -> EvalOutput:
    """One frame of streaming joint inference, on the device of its inputs.

    frame01 [B, H, W, 3] in [0, 1] (or uint8 0..255, decoded here in fp32
    and cast to the serving dtype), H and W multiples of 32.
    first_trimap3 [B, H, W, 3]: the GT trimap, read only on the first frame.
    The bank is updated in place.  memory_impl goes to memory_read (None:
    the kernel on CUDA, the plain version on the CPU)."""
    if frame01.dtype == torch.uint8:
        frame01 = (frame01.float() / 255.0).to(first_trimap3.dtype)
    refinement = fba.refinement
    if first_frame:
        trimap3 = first_trimap3
    else:
        logits = stm.segment(frame01, bank.keys, bank.values, bank.slot_mask,
                             memory_impl=memory_impl)
        trimap3 = torch.softmax(logits, dim=-1)

    feats8, _ = make_trimap_features(trimap3)
    x11 = torch.cat([normalize_image(frame01), feats8], dim=-1)
    out7, hid, rout7, rtri = fba(x11, frame01, feats8[..., -2:])
    alpha = (rout7 if refinement else out7)[..., 0:1]
    # the refinement's trimap replaces the propagated one for BOTH output
    # and memorization, the first frame included (models/alpha/model.py:459-460)
    out_trimap = torch.softmax(rtri, dim=-1) if refinement else trimap3

    if not last_frame:
        kwargs = dict(alpha=alpha[..., 0], hidden=hid) if stm.hdim > 0 else {}
        k, v = stm.memorize(frame01, out_trimap[..., 1], out_trimap[..., 2], **kwargs)
        bank = update_bank(bank, k, v, first_frame, memorize, max_memory_num)
    if wire_u8_out:
        # torch.round rounds half to even, as jnp.round does
        alpha_u8 = torch.round(alpha.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        tri_label = torch.argmax(out_trimap, dim=-1).to(torch.uint8)
        return EvalOutput(bank, alpha_u8, tri_label)
    return EvalOutput(bank, alpha, out_trimap)


def make_eval_bank(batch: int, height: int, width: int, max_memory_num: int = 5,
                   dtype=torch.float32, scale: int = 1, device=None) -> MemoryBank:
    """Bank for the /16 feature maps of a (padded) H x W frame, on CUDA
    unless `device` says otherwise."""
    if height % 16 or width % 16:
        raise ValueError(f"frame {height}x{width} is not a multiple of 16")
    return init_bank(batch, (height // 16) * (width // 16), max_memory_num, dtype,
                     key_dim=KEY_DIM // scale, val_dim=VAL_DIM // scale,
                     device=resolve_device(device))
