"""Squared Euclidean distance transform (1+JFA jump flooding) and the
trimap "click" features, plain PyTorch.  Counterpart of otvm_tpu/nn/edt.py,
bit-exact with its `edt_sq_jfa`:

  * the same step schedule: 1 (pre-pass), 2^(n-1) ... 1, 1 (clean-up),
    n = ceil(log2(max(H, W, 2)));
  * the same neighbour order (dy, dx) in (-1, 0, 1)^2 without (0, 0), each
    source the packed seed code sy * W + sx (-1 = none) shifted by
    (dy, dx) * step.  JAX rolls and masks the wrapped-around sources to -1;
    here the code is padded with -1 once per step and the 8 shifts are
    slices of the padded map: the same candidates in fewer launches;
  * the same tie-break.  JAX takes a neighbour when its distance is strictly
    below the running best, in order, starting from the pixel's own code.
    That picks the first minimum of [own, n1, ..., n8], which is what
    `argmin` returns here over the 9 candidates stacked at once.
Distances are sums of squares of integers below 2^12, exact in fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_BIG = 1e12
_SIGMAS = (0.02 * 320.0, 0.08 * 320.0, 0.16 * 320.0)
_NEIGHBOURS = [(sy, sx) for sy in (-1, 0, 1) for sx in (-1, 0, 1) if (sy, sx) != (0, 0)]


def _step_schedule(h: int, w: int):
    n = max(int(math.ceil(math.log2(max(h, w, 2)))), 1)
    return [1] + [1 << (n - 1 - j) for j in range(n)] + [1]


def edt_sq_jfa(seeds: torch.Tensor) -> torch.Tensor:
    """Squared distance to the nearest True pixel.  seeds [N, H, W] bool ->
    [N, H, W] fp32; 1e12 everywhere for a map without seeds."""
    _, h, w = seeds.shape
    dev = seeds.device
    yy = torch.arange(h, dtype=torch.int32, device=dev).view(h, 1)
    xx = torch.arange(w, dtype=torch.int32, device=dev).view(1, w)
    code = torch.where(seeds, yy * w + xx, -1).to(torch.int32)

    def dist2(c):
        cy = torch.div(c, w, rounding_mode="floor")
        cx = c - cy * w
        dy = (yy - cy).float()
        dx = (xx - cx).float()
        return torch.where(c >= 0, dy * dy + dx * dx, _BIG)

    shifts = [(0, 0)] + _NEIGHBOURS
    for k in _step_schedule(h, w):
        padded = F.pad(code, (k, k, k, k), value=-1)
        # candidate (dy, dx): code[y - dy*k, x - dx*k], or -1 off the map
        cand = torch.stack([padded[:, k - dy * k:k - dy * k + h, k - dx * k:k - dx * k + w]
                            for dy, dx in shifts])                         # [9, N, H, W]
        pick = torch.argmin(dist2(cand), dim=0, keepdim=True)
        code = torch.gather(cand, 0, pick)[0]
    return dist2(code)


def trimap_clicks(trimap2: torch.Tensor) -> torch.Tensor:
    """utils/utils.py:25-39 on NHWC.  trimap2 [B, H, W, 2] binary (bg, fg)
    -> clicks [B, H, W, 6] = [bg s1, bg s2, bg s3, fg s1, fg s2, fg s3]."""
    b, h, w, _ = trimap2.shape
    seeds = (trimap2.permute(0, 3, 1, 2) > 0.5).reshape(b * 2, h, w)
    d2 = edt_sq_jfa(seeds).reshape(b, 2, h, w)
    feats = [torch.exp(-d2[:, k] / (2.0 * sigma * sigma))
             for k in range(2) for sigma in _SIGMAS]
    return torch.stack(feats, dim=-1)
