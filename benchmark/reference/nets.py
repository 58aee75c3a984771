"""The benchmark's plain reference networks: OTVM's STM (models/trimap/
STM.py) and FBA (models/alpha/FBA/models.py) in plain PyTorch, NCHW
modules under the original state_dict names, so one seeded state loads
into them and into the program alike.

A frozen copy of the published architecture, written from the reference
repository's layer equations; it imports nothing of the program.  Every
convolution is a `QConv`: with `quant` set (precision.py) its input and
weight are rounded to a lower precision first, which is how the checks'
controls compute "the reference in the precision below".  The memory
read is the plain softmax attention, products accumulated in fp32.

Departures from the published code, none of which changes the function:
the dilated trunk, GroupNorm and weight standardization are written out
(layers_WS.py); resizes are F.interpolate with align_corners=False, as
the reference's; inputs and outputs of `memorize`, `segment` and `FBA`
are NHWC, as the program's.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
KEY_DIM, VAL_DIM = 128, 512
FEAT_DIM, DEC_DIM = 2048, 256
POOL_SCALES = (1, 2, 3, 6)
_NEG_INF = -1e30

class QConv(nn.Conv2d):
    """Conv2d whose operands, and its output's gradient, round as `quant`
    (precision.FP8) says when it is set."""

    quant = None

    def kernel(self) -> torch.Tensor:
        return self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel().to(x.dtype)
        if self.quant is not None:
            x, w = self.quant.operand(x), self.quant.operand(w)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x, w, bias, self.stride, self.padding, self.dilation)
        return y if self.quant is None else self.quant.output(y)


def conv(i: int, o: int, k: int, s: int = 1, p: int = 0, d: int = 1, bias: bool = True):
    return QConv(i, o, k, s, p, d, bias=bias)


class WSConv(QConv):
    """Weight standardization (layers_WS.py:13-23), in fp32."""

    def kernel(self) -> torch.Tensor:
        w = self.weight.float()
        w = w - w.mean(dim=(1, 2, 3), keepdim=True)
        var = (w * w).sum(dim=(1, 2, 3), keepdim=True) / max(w[0].numel() - 1, 1)
        return w / (torch.sqrt(var + 1e-12) + 1e-5)


def ws(i: int, o: int, k: int, s: int = 1, p: int = 0, d: int = 1, bias: bool = True):
    return WSConv(i, o, k, s, p, d, bias=bias)


def gn(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, c), c, eps=1e-5)


class FrozenBN(nn.BatchNorm2d):
    """torchvision's FrozenBatchNorm2d: always the running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight / torch.sqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * inv
        return x * inv.view(1, -1, 1, 1).to(x.dtype) + shift.view(1, -1, 1, 1).to(x.dtype)


def resize(x: torch.Tensor, hw) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(int(v) for v in hw), mode="bilinear",
                         align_corners=False)


def up2(x: torch.Tensor) -> torch.Tensor:
    return resize(x, (x.shape[-2] * 2, x.shape[-1] * 2))


def maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2, 1)


def normalize_image(x: torch.Tensor) -> torch.Tensor:
    """(img01 - imagenet mean) / std, NHWC."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


# ---------------------------------------------------------------------------
# STM: frozen-BN ResNet-50 trunks to layer3, key/value heads, decoder
# ---------------------------------------------------------------------------

class Bottleneck(nn.Module):
    def __init__(self, i: int, planes: int, stride: int = 1, down: bool = False):
        super().__init__()
        o = planes * 4
        self.conv1, self.bn1 = conv(i, planes, 1, bias=False), FrozenBN(planes)
        self.conv2, self.bn2 = conv(planes, planes, 3, stride, 1, bias=False), FrozenBN(planes)
        self.conv3, self.bn3 = conv(planes, o, 1, bias=False), FrozenBN(o)
        self.downsample = (nn.Sequential(conv(i, o, 1, stride, bias=False), FrozenBN(o))
                           if down else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


def _layer(i: int, planes: int, blocks: int, stride: int) -> nn.Sequential:
    return nn.Sequential(Bottleneck(i, planes, stride, True),
                         *[Bottleneck(planes * 4, planes) for _ in range(1, blocks)])


class Trunk(nn.Module):
    """conv1..layer3 (res2..res4) of ResNet-50, STM's names."""

    def __init__(self, w: int, blocks: Sequence[int]):
        super().__init__()
        self.conv1, self.bn1 = conv(3, w, 7, 2, 3, bias=False), FrozenBN(w)
        self.res2 = _layer(w, w, blocks[0], 1)
        self.res3 = _layer(4 * w, 2 * w, blocks[1], 2)
        self.res4 = _layer(8 * w, 4 * w, blocks[2], 2)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1))
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1))

    def stages(self, x):
        c1 = F.relu(self.bn1(x))
        r2 = self.res2(maxpool(c1))
        r3 = self.res3(r2)
        return self.res4(r3), r3, r2, c1


class EncoderM(Trunk):
    def __init__(self, w: int, blocks, hdim: int):
        super().__init__(w, blocks)
        self.conv1_m = conv(1, w, 7, 2, 3, bias=False)
        self.conv1_o = conv(1, w, 7, 2, 3, bias=False)
        if hdim > 0:
            self.conv1_a = conv(1, w, 7, 2, 3, bias=False)
            self.conv1_h = conv(hdim, w, 7, 2, 3, bias=False)


class ResBlock(nn.Module):
    def __init__(self, i: int, o: int):
        super().__init__()
        self.conv1, self.conv2 = conv(i, o, 3, 1, 1), conv(o, o, 3, 1, 1)
        self.downsample = conv(i, o, 3, 1, 1) if i != o else None

    def forward(self, x):
        r = self.conv2(F.relu(self.conv1(F.relu(x))))
        return (x if self.downsample is None else self.downsample(x)) + r


class Refine(nn.Module):
    def __init__(self, i: int, planes: int):
        super().__init__()
        self.convFS = conv(i, planes, 3, 1, 1)
        self.ResFS, self.ResMM = ResBlock(planes, planes), ResBlock(planes, planes)

    def forward(self, f, pm):
        return self.ResMM(self.ResFS(self.convFS(f)) + up2(pm))


class Decoder(nn.Module):
    def __init__(self, i: int, r3: int, r2: int, mdim: int):
        super().__init__()
        self.convFM, self.ResMM = conv(i, mdim, 3, 1, 1), ResBlock(mdim, mdim)
        self.RF3, self.RF2 = Refine(r3, mdim), Refine(r2, mdim)
        self.pred = conv(mdim, 3, 3, 1, 1)

    def forward(self, m4, r3, r2):
        m2 = self.RF2(r2, self.RF3(r3, self.ResMM(self.convFM(m4))))
        p2 = self.pred(F.relu(m2))
        return resize(p2, (p2.shape[-2] * 4, p2.shape[-1] * 4))


class KeyValue(nn.Module):
    def __init__(self, i: int, k: int, v: int):
        super().__init__()
        self.Key, self.Value = conv(i, k, 3, 1, 1), conv(i, v, 3, 1, 1)

    def forward(self, x):
        return self.Key(x), self.Value(x)


def memory_read(q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
                quant=None) -> torch.Tensor:
    """Softmax attention of q [B, HW, Ck] over the valid slots' keys
    [B, T, HW, Ck] and values [B, T, HW, Cv] -> [B, HW, Cv] in q's dtype;
    products accumulate in fp32."""
    b, t, hw, ck = keys.shape
    k = keys.reshape(b, t * hw, ck)
    v = values.reshape(b, t * hw, -1)
    if quant is not None:
        q, k, v = quant.operand(q), quant.operand(k), quant.operand(v)
    s = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) / math.sqrt(ck)
    p = torch.softmax(s, dim=-1)
    if quant is not None:
        p = quant.operand(p.to(q.dtype))
    out = torch.einsum("bqk,bkv->bqv", p.to(v.dtype).float(), v.float()).to(q.dtype)
    return out if quant is None else quant.output(out)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class STM(nn.Module):
    """hdim -1: the stage-1/2 trimap network; 16: the joint one, whose
    memory encoder also reads alpha and FBA's hidden state.  scale > 1:
    channels / scale and one block a stage (the CPU tests' size)."""

    def __init__(self, hdim: int = -1, scale: int = 1):
        super().__init__()
        self.hdim, self.scale = hdim, scale
        self.key_dim, self.val_dim = KEY_DIM // scale, VAL_DIM // scale
        w = 64 // scale
        blocks = (3, 4, 6) if scale == 1 else (1, 1, 1)
        self.Encoder_M = EncoderM(w, blocks, hdim)
        self.Encoder_Q = Trunk(w, blocks)
        self.KV_M_r4 = KeyValue(16 * w, self.key_dim, self.val_dim)
        self.KV_Q_r4 = KeyValue(16 * w, self.key_dim, self.val_dim)
        self.Decoder = Decoder(2 * self.val_dim, 8 * w, 4 * w, 256 // scale)
        self.quant = None
        self.read: Callable = memory_read

    def forward(self, method: str, *args, **kwargs):
        """`memorize` or `segment` by name, so a functional call can run
        either on substituted weights."""
        return getattr(self, method)(*args, **kwargs)

    def memorize(self, frame, unknown, fg, alpha=None, hidden=None):
        """frame [B, H, W, 3] in [0, 1]; unknown, fg, alpha [B, H, W];
        hidden [B, H, W, hdim] -> key [B, HW/256, Ck], value [B, HW/256, Cv]."""
        e = self.Encoder_M
        x = e.conv1_m(unknown[:, None]) + e.conv1_o(fg[:, None])
        if self.hdim > 0:
            x = x + e.conv1_a(alpha[:, None]) + e.conv1_h(_nchw(hidden))
        x = x + e.conv1(_nchw(normalize_image(frame)))
        k, v = self.KV_M_r4(e.stages(x)[0])
        b = k.shape[0]
        return (_nhwc(k).reshape(b, -1, self.key_dim), _nhwc(v).reshape(b, -1, self.val_dim))

    def segment(self, frame, keys, values):
        """frame [B, H, W, 3]; the valid slots' keys [B, T, HW16, Ck] and
        values [B, T, HW16, Cv] -> logits [B, H, W, 3]."""
        e = self.Encoder_Q
        r4, r3, r2, _ = e.stages(e.conv1(_nchw(normalize_image(frame))))
        k4, v4 = self.KV_Q_r4(r4)
        b, _, h, w = k4.shape
        q = _nhwc(k4).reshape(b, h * w, self.key_dim)
        mem = self.read(q, keys, values, self.quant)
        m4 = torch.cat([mem.reshape(b, h, w, self.val_dim).permute(0, 3, 1, 2), v4], dim=1)
        return _nhwc(self.Decoder(m4, r3, r2))


# ---------------------------------------------------------------------------
# FBA: dilated GN+WS ResNet-50 (output stride 8), PPM decoder, refinement
# ---------------------------------------------------------------------------

class BottleneckGN(nn.Module):
    def __init__(self, i: int, planes: int, stride: int = 1, down: bool = False, dil: int = 1):
        super().__init__()
        o = planes * 4
        self.conv1, self.bn1 = ws(i, planes, 1, bias=False), gn(planes)
        self.conv2, self.bn2 = ws(planes, planes, 3, stride, dil, dil, bias=False), gn(planes)
        self.conv3, self.bn3 = ws(planes, o, 1, bias=False), gn(o)
        self.downsample = nn.Sequential(ws(i, o, 1, stride, bias=False), gn(o)) if down else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


def _dilated(i: int, planes: int, blocks: int, first: int, rest: int, stride: int):
    return nn.Sequential(BottleneckGN(i, planes, stride, True, first),
                         *[BottleneckGN(planes * 4, planes, 1, dil=rest)
                           for _ in range(1, blocks)])


class EncoderGN(nn.Module):
    def __init__(self, w: int, blocks: Sequence[int]):
        super().__init__()
        self.conv1, self.bn1 = ws(11, w, 7, 2, 3, bias=False), gn(w)
        self.layer1 = _dilated(w, w, blocks[0], 1, 1, 1)
        self.layer2 = _dilated(4 * w, 2 * w, blocks[1], 1, 1, 2)
        self.layer3 = _dilated(8 * w, 4 * w, blocks[2], 1, 2, 1)
        self.layer4 = _dilated(16 * w, 8 * w, blocks[3], 2, 4, 1)

    def forward(self, x):
        c1 = F.relu(self.bn1(self.conv1(x)))
        l1 = self.layer1(maxpool(c1))
        l2 = self.layer2(l1)
        l3 = self.layer3(l2)
        return x, c1, l1, l2, l3, self.layer4(l3)


class AvgPool(nn.Module):
    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.size)


def _cgl(i: int, o: int, k: int):
    return [ws(i, o, k, 1, k // 2), gn(o), nn.LeakyReLU(0.01)]


def fba_fusion(alpha, img, fg, bg):
    """models.py:279-288, NCHW."""
    fg = alpha * img + (1 - alpha ** 2) * fg - alpha * (1 - alpha) * bg
    bg = (1 - alpha) * img + (2 * alpha - alpha ** 2) * bg - alpha * (1 - alpha) * fg
    fg, bg = torch.clamp(fg, 0, 1), torch.clamp(bg, 0, 1)
    la = 0.1
    alpha = (alpha * la + torch.sum((img - bg) * (fg - bg), 1, keepdim=True)) / (
        torch.sum((fg - bg) * (fg - bg), 1, keepdim=True) + la)
    return torch.clamp(alpha, 0, 1), fg, bg


def _head(x7, img):
    return torch.cat(fba_fusion(torch.clamp(x7[:, 0:1], 0, 1), img, torch.sigmoid(x7[:, 1:4]),
                                torch.sigmoid(x7[:, 4:7])), dim=1)


class FBADecoder(nn.Module):
    def __init__(self, feat: int, l1: int, c1: int, dec: int):
        super().__init__()
        self.ppm = nn.ModuleList([nn.Sequential(AvgPool(s), ws(feat, dec, 1), gn(dec),
                                                nn.LeakyReLU(0.01)) for s in POOL_SCALES])
        self.conv_up1 = nn.Sequential(*_cgl(feat + len(POOL_SCALES) * dec, dec, 3),
                                      *_cgl(dec, dec, 3))
        self.conv_up2 = nn.Sequential(*_cgl(dec + l1, dec, 3))
        self.conv_up3 = nn.Sequential(*_cgl(dec + c1, 64, 3))
        self.conv_up4 = nn.Sequential(conv(72, 32, 3, 1, 1), nn.LeakyReLU(0.01),
                                      conv(32, 16, 3, 1, 1), nn.LeakyReLU(0.01),
                                      conv(16, 7, 1))

    def forward(self, conv_out, img, tri2):
        c5 = conv_out[-1]
        x = self.conv_up1(torch.cat([c5] + [resize(b(c5), c5.shape[-2:]) for b in self.ppm], 1))
        x = self.conv_up2(torch.cat([up2(x), conv_out[-4]], 1))
        x = self.conv_up3(torch.cat([up2(x), conv_out[-5]], 1))
        x_dec = torch.cat([up2(x), conv_out[0][:, :3], img], 1)
        h = self.conv_up4[:4](torch.cat([x_dec, tri2], 1))
        return h, _head(self.conv_up4[4](h), img), x_dec


class BasicBlockGN(nn.Module):
    def __init__(self, p: int):
        super().__init__()
        self.conv1, self.bn1 = ws(p, p, 3, 1, 1, bias=False), gn(p)
        self.conv2, self.bn2 = ws(p, p, 3, 1, 1, bias=False), gn(p)

    def forward(self, x):
        return F.relu(self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x))))) + x)


class Refinement(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Sequential(*_cgl(73, 64, 3))
        self.layer1, self.layer2 = BasicBlockGN(64), BasicBlockGN(64)
        self.pred = nn.Sequential(conv(64, 32, 3, 1, 1), nn.LeakyReLU(0.01),
                                  conv(32, 16, 3, 1, 1), nn.LeakyReLU(0.01), conv(16, 10, 1))

    def forward(self, x_dec, img, tri2, alpha):
        x = self.layer2(self.layer1(self.conv1(torch.cat([x_dec, tri2, alpha], 1))))
        hid = self.pred[:4](x)
        out = self.pred[4](hid)
        return hid, _head(out[:, :7], img), out[:, 7:10]


class FBA(nn.Module):
    """forward(x11, img, tri2), NHWC -> (out7, hid16, refined7, trimap
    logits3), the last two None without refinement."""

    def __init__(self, refinement: bool = False, scale: int = 1):
        super().__init__()
        self.refinement = refinement
        w = 64 // scale
        self.encoder = EncoderGN(w, (3, 4, 6, 3) if scale == 1 else (1, 1, 1, 1))
        self.decoder = FBADecoder(32 * w, 4 * w, w, DEC_DIM // scale)
        if refinement:
            self.refine = Refinement()

    def forward(self, x, img, tri2):
        img, tri2 = _nchw(img), _nchw(tri2)
        conv_out = self.encoder(_nchw(x))
        hid, out, x_dec = self.decoder(conv_out, img, tri2)
        if not self.refinement:
            return _nhwc(out), _nhwc(hid), None, None
        hid, refined, logits = self.refine(x_dec, img, tri2, out[:, 0:1])
        return _nhwc(out), _nhwc(hid), _nhwc(refined), _nhwc(logits)


def build(network: str, scale: int = 1):
    """network 'joint' (stage 4: STM hdim 16 + FBA with refinement) or
    'trimap' (the stage-1 STM alone) -> {name: module}."""
    if network == "joint":
        return {"stm": STM(16, scale), "fba": FBA(True, scale)}
    if network == "trimap":
        return {"stm": STM(-1, scale)}
    raise ValueError(f"unknown network {network!r}")
