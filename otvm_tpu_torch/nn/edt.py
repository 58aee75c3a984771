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
shape into a CUDA graph and replayed: one launch from the host.  Inside
another capture (the serving step's, models/graphs.py) they run inline
and become part of that graph: no nested capture, no graph of their own.

`edt_sq_exact` is JAX's exact separable transform, bit for bit: a 1-D
distance along each row, then the column pass min over y' of
(y - y')^2 + g(y', x)^2.  JAX broadcasts that pass over [H, H', W] (512 MB
a map at 512x512); here it runs over blocks of y', the temporary capped at
EXACT_TEMP_BYTES.  A min is order-free, so the blocks change no bit.
"""
from __future__ import annotations

import math
from typing import Optional

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
    if not seeds.is_cuda or torch.cuda.is_current_stream_capturing():
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


_ROW_FAR = 1_000_000     # JAX's 1-D distance before the first seed of a row
EXACT_TEMP_BYTES = 64 << 20     # the column pass's temporary, at most


def edt_sq_exact(seeds: torch.Tensor, block: Optional[int] = None) -> torch.Tensor:
    """Exact squared distance to the nearest True pixel (JAX's
    `edt_sq_exact`).  seeds [N, H, W] bool -> [N, H, W] fp32; 1e12 for a
    map without seeds.  `block`: rows y' a step of the column pass (default:
    as many as EXACT_TEMP_BYTES holds)."""
    n, h, w = seeds.shape
    dev = seeds.device
    xs = torch.arange(w, device=dev)
    # JAX's scans from a carry of 1e6: +1 a pixel, 0 at a seed; integers, so
    # exact in fp32 (below 2^24)
    last = torch.where(seeds, xs, -1).cummax(dim=-1).values
    nxt = torch.where(seeds, xs, w).flip(-1).cummin(dim=-1).values.flip(-1)
    fwd = torch.where(last >= 0, xs - last, _ROW_FAR + 1 + xs)
    bwd = torch.where(nxt < w, nxt - xs, _ROW_FAR + w - xs)
    big = torch.full((), _BIG, dtype=torch.float32, device=dev)     # no host copy: capturable
    g = torch.minimum(fwd, bwd).float()
    g2 = torch.minimum(g * g, big)                                  # [N, H', W]
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    dy2 = (ys[:, None] - ys[None, :]) ** 2                          # [H, H']
    if block is None:
        block = max(1, EXACT_TEMP_BYTES // (4 * n * h * w))
    d = torch.full((n, h, w), math.inf, device=dev)
    for lo in range(0, h, block):
        hi = min(lo + block, h)
        part = (dy2[None, :, lo:hi, None] + g2[:, None, lo:hi, :]).amin(dim=2)
        torch.minimum(d, part, out=d)
    return torch.minimum(d, big)


def edt_sq(seeds: torch.Tensor, exact: bool = False) -> torch.Tensor:
    return edt_sq_exact(seeds) if exact else edt_sq_jfa(seeds)


def trimap_clicks(trimap2: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """utils/utils.py:25-39 on NHWC.  trimap2 [B, H, W, 2] binary (bg, fg)
    -> clicks [B, H, W, 6] = [bg s1, bg s2, bg s3, fg s1, fg s2, fg s3].
    exact: the exact EDT instead of the JFA."""
    b, h, w, _ = trimap2.shape
    seeds = (trimap2.permute(0, 3, 1, 2) > 0.5).reshape(b * 2, h, w)
    d2 = edt_sq(seeds, exact).reshape(b, 2, h, w)
    feats = [torch.exp(-d2[:, k] / (2.0 * sigma * sigma))
             for k in range(2) for sigma in _SIGMAS]
    return torch.stack(feats, dim=-1)
