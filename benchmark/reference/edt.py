"""The trimap "click" features of the reference (utils/utils.py:25-39):
Gaussians of the distance to the nearest bg and fg pixel at three widths.
The distance is the 1+JFA jump-flooding transform the served model uses
(the same step schedule, neighbour order and tie-break), written plainly."""
from __future__ import annotations

import math

import torch

_BIG = 1e12
_FAR = -1e6
SIGMAS = (0.02 * 320.0, 0.08 * 320.0, 0.16 * 320.0)
_NEIGHBOURS = [(sy, sx) for sy in (-1, 0, 1) for sx in (-1, 0, 1) if (sy, sx) != (0, 0)]


def jfa_sq(seeds: torch.Tensor) -> torch.Tensor:
    """Squared distance to the nearest True pixel, [N, H, W] bool -> fp32;
    1e12 for a map without seeds.  Steps 1, 2^(n-1) .. 1, 1."""
    n, h, w = seeds.shape
    dev = seeds.device
    k = max(int(math.ceil(math.log2(max(h, w, 2)))), 1)
    steps = [1] + [1 << (k - 1 - j) for j in range(k)] + [1]
    pad = max(steps)
    yy = torch.arange(h, dtype=torch.float32, device=dev).view(h, 1).expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, w).expand(h, w)
    pos = torch.stack([yy, xx])[:, None]
    src = torch.full((2, n, h + 2 * pad, w + 2 * pad), _FAR, device=dev)
    dst = src.clone()
    inner = lambda m: m[:, :, pad:pad + h, pad:pad + w]
    inner(src).copy_(torch.where(seeds, pos, _FAR))
    best = (pos - inner(src)).square().sum(0)
    for step in steps:
        for dy, dx in _NEIGHBOURS:
            cand = src[:, :, pad - dy * step:pad - dy * step + h,
                       pad - dx * step:pad - dx * step + w]
            d = (pos - cand).square().sum(0)
            take = d < best
            best = torch.minimum(best, d)
            inner(dst).copy_(torch.where(take, cand, inner(src)))
            src, dst = dst, src
    return torch.where(inner(src)[0] == _FAR, _BIG, best)


def clicks(bg_fg: torch.Tensor) -> torch.Tensor:
    """bg_fg [B, H, W, 2] binary -> [B, H, W, 6]: bg at the three widths,
    then fg."""
    b, h, w, _ = bg_fg.shape
    d2 = jfa_sq((bg_fg.permute(0, 3, 1, 2) > 0.5).reshape(b * 2, h, w)).reshape(b, 2, h, w)
    return torch.stack([torch.exp(-d2[:, c] / (2.0 * s * s)) for c in range(2) for s in SIGMAS],
                       dim=-1)


def argmax3(x: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis, the first maximum winning ties."""
    best = x[..., 0]
    idx = torch.zeros(best.shape, dtype=torch.int64, device=x.device)
    for c in range(1, x.shape[-1]):
        take = x[..., c] > best
        best = torch.where(take, x[..., c], best)
        idx = torch.where(take, torch.full_like(idx, c), idx)
    return idx


def trimap_features(tri3: torch.Tensor):
    """Soft trimap [B, H, W, 3] -> (feats8 = clicks + soft bg, soft fg;
    the hard unknown mask [B, H, W, 1])."""
    am = argmax3(tri3)
    hard = torch.stack([am == 0, am == 2], dim=-1).float()
    feats = torch.cat([clicks(hard).to(tri3.dtype), tri3[..., 0:1], tri3[..., 2:3]], dim=-1)
    return feats, (am == 1).to(tri3.dtype)[..., None]
