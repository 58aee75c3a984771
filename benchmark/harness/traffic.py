"""The one generator of the benchmark's inputs, from a traffic file's
parameters and the run's seed.  The same seed gives the same inputs; every
seed gives the same sizes and the same amount of work.

Stream traffic: clips of `clip_frames` frames at height x width, each a
cycle of `distinct_frames` smooth frames (a coarse random grid, bilinearly
upsampled, in 8-bit steps, so the served 8-bit frames lose nothing), in an
order of the clip's own, and a first trimap from a smooth alpha (bg where
it is 0, fg where 1, unknown between).  Train traffic: `distinct_batches`
global batches in VM108Train's layout, 8-bit as the loader ships them:
smooth fg and bg, an alpha with solid regions and a soft band, its trimap
(the port's seeded_batches, tools/profile_train.py)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def _smooth(g: torch.Generator, n: int, c: int, h: int, w: int, grid, device) -> torch.Tensor:
    x = torch.rand(n, c, grid[0], grid[1], generator=g, device=device)
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


def trimap_of(alpha: torch.Tensor) -> torch.Tensor:
    """[N, 1, H, W] alpha -> [N, H, W, 3] one-hot trimap."""
    label = torch.where(alpha[:, 0] == 0, 0, torch.where(alpha[:, 0] == 1, 2, 1))
    return F.one_hot(label, 3).float()


class StreamTraffic:
    """Clip k: its frames (host float32 [H, W, 3] in [0, 1]) and first
    trimap (host one-hot [H, W, 3])."""

    def __init__(self, params: dict, seed: int, device):
        h, w, d = params["height"], params["width"], params["distinct_frames"]
        self.n = params["clip_frames"]
        grid = params.get("grid", [9, 16])
        g = torch.Generator(device=device).manual_seed(int(seed))
        u8 = torch.round(_smooth(g, d, 3, h, w, grid, device) * 255.0)
        self.frames = [f.permute(1, 2, 0).div(255.0).float().cpu().numpy() for f in u8]
        alpha = torch.clamp(3.0 * _smooth(g, params["distinct_trimaps"], 1, h, w, grid, device)
                            - 1.0, 0.0, 1.0)
        self.trimaps = [t.cpu().numpy() for t in trimap_of(alpha)]
        self.seed = int(seed)

    def clip(self, k: int):
        order = np.random.default_rng([self.seed, k]).permutation(len(self.frames))
        frames = [self.frames[order[i % len(order)]] for i in range(self.n)]
        return frames, self.trimaps[k % len(self.trimaps)]


def train_batches(params: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """`distinct_batches` global batches [B, S, H, W, C], 8-bit: fg, bg,
    alpha as uint8, the trimap as its uint8 label."""
    b, s = params["batch"], params["frames"]
    h, w = params["height"], params["width"]
    g = torch.Generator().manual_seed(int(seed))
    out = []
    for _ in range(params["distinct_batches"]):
        sm = lambda c: _smooth(g, b * s, c, h, w, (9, 9), "cpu")
        alpha = torch.clamp(3.0 * sm(1) - 1.0, 0.0, 1.0)
        label = trimap_of(alpha).argmax(-1).to(torch.uint8)
        u8 = lambda x: torch.round(x * 255.0).to(torch.uint8).permute(0, 2, 3, 1)
        shaped = lambda x: x.reshape(b, s, h, w, *x.shape[3:]).numpy()
        out.append({"fg": shaped(u8(sm(3))), "bg": shaped(u8(sm(3))),
                    "alpha": shaped(u8(alpha)), "tri": shaped(label)})
    return out
