"""FBA matting network (alpha + foreground + background), counterpart of
otvm_tpu/models/fba.py.

Modules are NCHW and carry the original state_dict names
(models/alpha/FBA/models.py): encoder.*, decoder.ppm.{i}.{1,2},
decoder.conv_up{1..4}.*, refine.*.  `FBA.forward` takes and returns the
JAX package's NHWC arrays.  fba_fusion's order (B's update reads the updated
F; clamps before the alpha solve) is load-bearing and kept.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..nn.layers import Conv, GroupNorm32, WSConv
from ..nn.ops import resize_bilinear, upsample_x2
from ..nn.resnet_gn_ws import BasicBlockGN, ResNet50DilatedGNWS

FEAT_DIM = 2048
DEC_DIM = 256
POOL_SCALES = (1, 2, 3, 6)


def fba_fusion(alpha, img, F, B, dim: int = -1):
    """models.py:279-288; `dim` is the channel axis (-1 for NHWC)."""
    F = alpha * img + (1 - alpha ** 2) * F - alpha * (1 - alpha) * B
    B = (1 - alpha) * img + (2 * alpha - alpha ** 2) * B - alpha * (1 - alpha) * F
    F = torch.clamp(F, 0, 1)
    B = torch.clamp(B, 0, 1)
    la = 0.1
    alpha = (alpha * la + torch.sum((img - B) * (F - B), dim=dim, keepdim=True)) / (
        torch.sum((F - B) * (F - B), dim=dim, keepdim=True) + la)
    alpha = torch.clamp(alpha, 0, 1)
    return alpha, F, B


def _conv_gn_lrelu(in_ch: int, out_ch: int, kernel: int) -> nn.Sequential:
    """WSConv -> GN -> LeakyReLU; the Sequential indices are the reference's."""
    return nn.Sequential(WSConv(in_ch, out_ch, kernel, 1, kernel // 2), GroupNorm32(out_ch),
                         nn.LeakyReLU(0.01))


def _head(x7: torch.Tensor, img: torch.Tensor):
    """7-channel head -> fused (alpha, F, B), NCHW."""
    alpha = torch.clamp(x7[:, 0:1], 0, 1)
    F = torch.sigmoid(x7[:, 1:4])
    B = torch.sigmoid(x7[:, 4:7])
    return torch.cat(fba_fusion(alpha, img, F, B, dim=1), dim=1)


class FBADecoder(nn.Module):
    def __init__(self, feat_dim: int = FEAT_DIM, l1_ch: int = 256, c1_ch: int = 64,
                 dec_dim: int = DEC_DIM):
        super().__init__()
        # nn.AdaptiveAvgPool2d is ops.adaptive_avg_pool (torch's window rule)
        self.ppm = nn.ModuleList([
            nn.Sequential(nn.AdaptiveAvgPool2d(s), WSConv(feat_dim, dec_dim, 1, 1, 0),
                          GroupNorm32(dec_dim), nn.LeakyReLU(0.01))
            for s in POOL_SCALES])
        self.conv_up1 = nn.Sequential(
            *_conv_gn_lrelu(feat_dim + len(POOL_SCALES) * dec_dim, dec_dim, 3),
            *_conv_gn_lrelu(dec_dim, dec_dim, 3))
        self.conv_up2 = _conv_gn_lrelu(dec_dim + l1_ch, dec_dim, 3)
        self.conv_up3 = _conv_gn_lrelu(dec_dim + c1_ch, 64, 3)
        self.conv_up4 = nn.Sequential(
            Conv(64 + 3 + 3 + 2, 32, 3, 1, 1), nn.LeakyReLU(0.01),
            Conv(32, 16, 3, 1, 1), nn.LeakyReLU(0.01),
            Conv(16, 7, 1, 1, 0))

    def forward(self, conv_out, img, two_chan_trimap):
        """NCHW in and out.  Returns (hid16, output7, x_dec70)."""
        conv5 = conv_out[-1]
        hw = conv5.shape[-2:]
        ppm_out = [conv5]
        for branch in self.ppm:
            ppm_out.append(resize_bilinear(branch(conv5), hw))
        x = self.conv_up1(torch.cat(ppm_out, dim=1))
        x = self.conv_up2(torch.cat([upsample_x2(x), conv_out[-4]], dim=1))
        x = self.conv_up3(torch.cat([upsample_x2(x), conv_out[-5]], dim=1))
        x_dec = torch.cat([upsample_x2(x), conv_out[0][:, :3], img], dim=1)
        h = self.conv_up4[:4](torch.cat([x_dec, two_chan_trimap], dim=1))
        output = _head(self.conv_up4[4](h), img)
        return h, output, x_dec


class RefinementModule(nn.Module):
    """models.py:395-435: re-predicts the fused 7 channels and 3 trimap logits."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv_gn_lrelu(73, 64, 3)
        self.layer1 = BasicBlockGN(64)
        self.layer2 = BasicBlockGN(64)
        self.pred = nn.Sequential(
            Conv(64, 32, 3, 1, 1), nn.LeakyReLU(0.01),
            Conv(32, 16, 3, 1, 1), nn.LeakyReLU(0.01),
            Conv(16, 10, 1, 1, 0))

    def forward(self, x_dec, img, two_chan_trimap, pred_alpha):
        x = self.conv1(torch.cat([x_dec, two_chan_trimap, pred_alpha], dim=1))
        x = self.layer2(self.layer1(x))
        hid = self.pred[:4](x)
        output = self.pred[4](hid)
        return hid, _head(output[:, :7], img), output[:, 7:10]


class FBA(nn.Module):
    """MattingModule (models.py:21-45): encoder -> decoder -> optional refine.

    forward(x, img, two_chan_trimap), all NHWC:
      x [B, H, W, 11] (normalized image + 6 clicks + 2 soft trimap), H and W
      multiples of 8; img [B, H, W, 3] in [0, 1]; two_chan_trimap [B, H, W, 2].
    Returns NHWC (output7, hid16, refine_output7, refine_trimap3); the refine
    outputs are None without refinement (stages 1-2).
    """

    def __init__(self, refinement: bool = False, scale: int = 1):
        super().__init__()
        self.refinement = refinement
        self.scale = scale
        w = 64 // scale
        blocks = (3, 4, 6, 3) if scale == 1 else (1, 1, 1, 1)
        self.encoder = ResNet50DilatedGNWS(width=w, blocks=blocks)
        self.decoder = FBADecoder(feat_dim=32 * w, l1_ch=4 * w, c1_ch=w,
                                  dec_dim=DEC_DIM // scale)
        if refinement:
            self.refine = RefinementModule()

    def forward(self, x: torch.Tensor, img: torch.Tensor, two_chan_trimap: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
        nchw = lambda t: t.permute(0, 3, 1, 2)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        img, tri2 = nchw(img), nchw(two_chan_trimap)
        conv_out = self.encoder(nchw(x))
        hid, output, x_dec = self.decoder(conv_out, img, tri2)
        if not self.refinement:
            return nhwc(output), nhwc(hid), None, None
        hid, refined, trimap_logits = self.refine(x_dec, img, tri2, output[:, 0:1])
        return nhwc(output), nhwc(hid), nhwc(refined), nhwc(trimap_logits)
