"""STM trimap-propagation network, counterpart of otvm_tpu/models/stm.py.

Modules are NCHW and carry the original state_dict names (Encoder_M,
Encoder_Q, KV_M_r4, KV_Q_r4, Decoder; models/trimap/STM.py).  The public
methods `memorize` and `segment` take and return the JAX package's NHWC
arrays, so the two are compared on the same data.

hdim <= 0: the stage-1/2 variant (trimap-only memory); hdim == 16: the joint
variant, whose memory encoder also reads alpha and the FBA hidden state.
scale > 1 builds the width-scaled test model (channels / scale, one
bottleneck per stage, same module tree).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.memory_attn import memory_read
from ..nn.layers import Conv
from ..nn.ops import resize_bilinear, upsample_x2
from ..nn.resnet import ResNet50Trunk

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

KEY_DIM = 128
VAL_DIM = 512


@functools.lru_cache(maxsize=None)
def _imagenet_stats(dtype: torch.dtype, device: torch.device):
    # made once per dtype and device: a host-to-device copy per call would
    # wait for the device and stall the frame pipeline
    return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
            torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def normalize_image(x: torch.Tensor) -> torch.Tensor:
    """(img01 - imagenet mean) / imagenet std on NHWC, in x's dtype."""
    mean, std = _imagenet_stats(x.dtype, x.device)
    return (x - mean) / std


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _Encoder(ResNet50Trunk):
    """A trunk plus the reference's normalization buffers.  The buffers are
    kept only so released checkpoints load strictly; normalize_image uses
    the constants."""

    def __init__(self, width: int, blocks, norm: str):
        super().__init__(width, blocks, norm)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1))
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1))


class EncoderM(_Encoder):
    """Memory encoder (STM.py:32-74): parallel 7x7/s2 convs over the extra
    mask channels are summed into the stem conv."""

    def __init__(self, width: int, blocks, norm: str, hdim: int):
        super().__init__(width, blocks, norm)
        self.conv1_m = Conv(1, width, 7, 2, 3, bias=False)
        self.conv1_o = Conv(1, width, 7, 2, 3, bias=False)
        if hdim > 0:
            self.conv1_a = Conv(1, width, 7, 2, 3, bias=False)
            self.conv1_h = Conv(hdim, width, 7, 2, 3, bias=False)


class ResBlockSTM(nn.Module):
    """STM.py:9-30: pre-activation residual block, convs with bias."""

    def __init__(self, indim: int, outdim: int):
        super().__init__()
        self.conv1 = Conv(indim, outdim, 3, 1, 1)
        self.conv2 = Conv(outdim, outdim, 3, 1, 1)
        self.downsample = Conv(indim, outdim, 3, 1, 1) if indim != outdim else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.conv1(F.relu(x))
        r = self.conv2(F.relu(r))
        if self.downsample is not None:
            x = self.downsample(x)
        return x + r


class Refine(nn.Module):
    """STM.py:105-117: skip fusion + x2 upsample."""

    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        self.convFS = Conv(inplanes, planes, 3, 1, 1)
        self.ResFS = ResBlockSTM(planes, planes)
        self.ResMM = ResBlockSTM(planes, planes)

    def forward(self, f: torch.Tensor, pm: torch.Tensor) -> torch.Tensor:
        s = self.ResFS(self.convFS(f))
        return self.ResMM(s + upsample_x2(pm))


class Decoder(nn.Module):
    """STM.py:119-137: memory readout -> 3-class logits at full resolution."""

    def __init__(self, in_ch: int, r3_ch: int, r2_ch: int, mdim: int = 256):
        super().__init__()
        self.convFM = Conv(in_ch, mdim, 3, 1, 1)
        self.ResMM = ResBlockSTM(mdim, mdim)
        self.RF3 = Refine(r3_ch, mdim)
        self.RF2 = Refine(r2_ch, mdim)
        self.pred = Conv(mdim, 3, 3, 1, 1)

    def forward(self, m4, r3, r2):
        m4 = self.ResMM(self.convFM(m4))
        m3 = self.RF3(r3, m4)
        m2 = self.RF2(r2, m3)
        p2 = self.pred(F.relu(m2))
        return resize_bilinear(p2, (p2.shape[-2] * 4, p2.shape[-1] * 4))


class KeyValue(nn.Module):
    """STM.py:166-174."""

    def __init__(self, in_ch: int, key_dim: int, val_dim: int):
        super().__init__()
        self.Key = Conv(in_ch, key_dim, 3, 1, 1)
        self.Value = Conv(in_ch, val_dim, 3, 1, 1)

    def forward(self, x):
        return self.Key(x), self.Value(x)


class STM(nn.Module):
    def __init__(self, hdim: int = -1, scale: int = 1, norm: str = "frozen_bn"):
        super().__init__()
        self.hdim = hdim
        self.scale = scale
        self.norm = norm
        self.key_dim = KEY_DIM // scale
        self.val_dim = VAL_DIM // scale
        w = 64 // scale
        blocks = (3, 4, 6) if scale == 1 else (1, 1, 1)
        self.Encoder_M = EncoderM(w, blocks, norm, hdim)
        self.Encoder_Q = _Encoder(w, blocks, norm)
        self.KV_M_r4 = KeyValue(16 * w, self.key_dim, self.val_dim)
        self.KV_Q_r4 = KeyValue(16 * w, self.key_dim, self.val_dim)
        self.Decoder = Decoder(2 * self.val_dim, 8 * w, 4 * w, mdim=256 // scale)

    def forward(self, method: str, *args, **kwargs):
        """`memorize` or `segment`, by name: a module call, through which
        torch.func.functional_call runs either on substituted weights."""
        if method not in ("memorize", "segment"):
            raise ValueError(f"STM has no method {method!r}")
        return getattr(self, method)(*args, **kwargs)

    def memorize(self, frame: torch.Tensor, unknown: torch.Tensor, fg: torch.Tensor,
                 alpha: Optional[torch.Tensor] = None,
                 hidden: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encode one past frame into (key, value).

        frame [B, H, W, 3] in [0, 1], H and W multiples of 16; unknown, fg
        (and alpha, for hdim > 0) [B, H, W]; hidden [B, H, W, hdim].
        Returns key [B, HW/256, Ck], value [B, HW/256, Cv], contiguous."""
        enc = self.Encoder_M
        f = _nchw(normalize_image(frame))
        x = enc.conv1_m(unknown[:, None]) + enc.conv1_o(fg[:, None])
        if self.hdim > 0:
            x = x + enc.conv1_a(alpha[:, None]) + enc.conv1_h(_nchw(hidden))
        x = x + enc.stem_conv(f)
        r4 = enc.stages(x)[0]
        k, v = self.KV_M_r4(r4)
        b = k.shape[0]
        return (_nhwc(k).reshape(b, -1, self.key_dim).contiguous(),
                _nhwc(v).reshape(b, -1, self.val_dim).contiguous())

    def segment(self, frame: torch.Tensor, mem_keys: torch.Tensor, mem_values: torch.Tensor,
                slot_mask: Optional[torch.Tensor] = None,
                memory_impl: Optional[str] = None) -> torch.Tensor:
        """Attend over the memory bank and decode 3-class logits.

        frame [B, H, W, 3]; mem_keys [B, T, HW16, Ck]; mem_values
        [B, T, HW16, Cv]; slot_mask [B, T] bool.  Returns logits [B, H, W, 3].
        memory_impl is passed to memory_read (None: the kernel on CUDA)."""
        f = _nchw(normalize_image(frame))
        r4, r3, r2, _ = self.Encoder_Q(f)
        k4, v4 = self.KV_Q_r4(r4)
        b, _, h, w = k4.shape
        q_k = _nhwc(k4).reshape(b, h * w, self.key_dim).contiguous()
        mem = memory_read(q_k, mem_keys, mem_values, slot_mask, impl=memory_impl)
        m4 = torch.cat([mem.reshape(b, h, w, self.val_dim).permute(0, 3, 1, 2), v4], dim=1)
        return _nhwc(self.Decoder(m4, r3, r2))
