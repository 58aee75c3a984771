"""Squared Euclidean distance transform (1+JFA jump flooding) and the
trimap "click" features, plain PyTorch.  Counterpart of otvm_tpu/nn/edt.py,
bit-exact with its `edt_sq_jfa`:

  * the same step schedule: 1 (pre-pass), 2^(n-1) ... 1, 1 (clean-up),
    n = ceil(log2(max(H, W, 2)));
  * the same neighbour order (dy, dx) in (-1, 0, 1)^2 without (0, 0), each
    read from the map that the pass's earlier neighbours have already
    updated: the source of (y, x) is the nearest seed found so far at
    (y - dy*step, x - dx*step), none off the map;
  * the same tie-break: a neighbour is taken only where its distance is
    strictly below the running best.
Each pixel carries its seed's (y, x) in fp32 on a map padded by the largest
step, so a neighbour's candidate is a slice of that map: no roll, no mask.
Two such maps take turns, one read and one written by each neighbour.  A
pixel without a seed carries (_FAR, _FAR), whose distance exceeds every
real one, so it never wins and a map without seeds stays without.
Distances are sums of squares of integers below 2^12, exact in fp32.

That is ~540 small ops for a 512x512 pair of maps, and eager mode spends
host time on each.  On a CUDA card the ops are captured once per input
shape into a CUDA graph and replayed: one launch from the host.
"""
from __future__ import annotations

import math

import torch

_BIG = 1e12
_FAR = -1e6             # the coordinates of "no seed": its distance is >= 2e12
_SIGMAS = (0.02 * 320.0, 0.08 * 320.0, 0.16 * 320.0)
_NEIGHBOURS = [(sy, sx) for sy in (-1, 0, 1) for sx in (-1, 0, 1) if (sy, sx) != (0, 0)]


def _step_schedule(h: int, w: int):
    n = max(int(math.ceil(math.log2(max(h, w, 2)))), 1)
    return [1] + [1 << (n - 1 - j) for j in range(n)] + [1]


_graphs = {}            # (device, N, H, W) -> (input, output, CUDAGraph)
_MAX_GRAPHS = 4         # each holds its maps: ~400 MB at 1088x1920


def edt_sq_jfa(seeds: torch.Tensor) -> torch.Tensor:
    """Squared distance to the nearest True pixel.  seeds [N, H, W] bool ->
    [N, H, W] fp32; 1e12 everywhere for a map without seeds."""
    if not seeds.is_cuda:
        return _jfa(seeds)
    key = (seeds.device, *seeds.shape)
    if key not in _graphs:
        if len(_graphs) == _MAX_GRAPHS:
            del _graphs[next(iter(_graphs))]            # the oldest shape
        with torch.cuda.device(seeds.device), torch.no_grad():
            static = seeds.clone()
            _jfa(static)                    # outside the capture: the lazy set-up
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = _jfa(static)
        _graphs[key] = (static, out, graph)
    static, out, graph = _graphs[key]
    static.copy_(seeds)
    graph.replay()
    return out.clone()


def _jfa(seeds: torch.Tensor) -> torch.Tensor:
    n, h, w = seeds.shape
    dev = seeds.device
    steps = _step_schedule(h, w)
    pad = max(steps)
    yy = torch.arange(h, dtype=torch.float32, device=dev).view(h, 1).expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, w).expand(h, w)
    pos = torch.stack([yy, xx])[:, None]                                   # [2, 1, H, W]
    near = [torch.full((2, n, h + 2 * pad, w + 2 * pad), _FAR, device=dev) for _ in range(2)]
    inner = lambda m: m[:, :, pad:pad + h, pad:pad + w]
    src, dst = near
    inner(src).copy_(torch.where(seeds, pos, _FAR))
    best = (pos - inner(src)).square().sum(0)
    for k in steps:
        for dy, dx in _NEIGHBOURS:
            cand = src[:, :, pad - dy * k:pad - dy * k + h, pad - dx * k:pad - dx * k + w]
            d = (pos - cand).square().sum(0)
            take = d < best
            torch.minimum(best, d, out=best)
            torch.where(take, cand, inner(src), out=inner(dst))
            src, dst = dst, src
    return torch.where(inner(src)[0] == _FAR, _BIG, best)


def trimap_clicks(trimap2: torch.Tensor) -> torch.Tensor:
    """utils/utils.py:25-39 on NHWC.  trimap2 [B, H, W, 2] binary (bg, fg)
    -> clicks [B, H, W, 6] = [bg s1, bg s2, bg s3, fg s1, fg s2, fg s3]."""
    b, h, w, _ = trimap2.shape
    seeds = (trimap2.permute(0, 3, 1, 2) > 0.5).reshape(b * 2, h, w)
    d2 = edt_sq_jfa(seeds).reshape(b, 2, h, w)
    feats = [torch.exp(-d2[:, k] / (2.0 * sigma * sigma))
             for k in range(2) for sigma in _SIGMAS]
    return torch.stack(feats, dim=-1)
