"""Times the serving GroupNorm (kernels/group_norm.py) on one CUDA card at
the shapes of a stage-4 frame.

    python -m otvm_tpu_torch.tools.bench_group_norm [--dtype bfloat16|float32|both]
        [--height 1088 --width 1920] [--reps 20] [--sweep 4,8,16,32]
        [--out FILE]

A frozen FBA (GN-WS trunk with refinement) meets 66 group norms a frame;
`frame_shapes` lists their distinct shapes, each with the activation fused
after it and how often the frame meets it, from a forward on the meta
device.  For each shape: the kernels' device time (statistics and apply),
the plain version's (F.group_norm and the activation), F.group_norm's
alone (`library_ms`: torch's CUDA GroupNorm, a yardstick only), the bound
(3 x elements x dtype size over 3.35 TB/s: one read for the statistics,
one read and one write for the apply) and the kernels' norm-relative error
against F.group_norm in fp32 rounded once to the dtype; then each summed
over the frame.  --sweep times the kernels at other BLOCKS_PER_SM.
Device times: CUDA events around one call, the card held busy while the
host enqueues it, L2 flushed before each call (tools/kernel_check.py
device_ms).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import subprocess
from typing import Dict, List, Tuple

import torch

from ..kernels import group_norm as gn
from ..models.fba import FBA
from ..nn.layers import ServingGroupNorm, freeze_for_inference
from .kernel_check import device_ms, rel_err

PEAK_BYTES = 3.35e12            # H100 SXM HBM3


def frame_shapes(height: int, width: int) -> List[Tuple[Tuple[int, ...], str, int]]:
    """[(input shape, fused activation or None, norms of that kind a
    frame)] of a frozen stage-4 FBA's group norms on one height x width
    frame, the largest first (a forward on the meta device)."""
    with torch.device("meta"):
        fba = FBA(refinement=True)
    fba = freeze_for_inference(fba.eval().requires_grad_(False))
    seen: Dict[tuple, int] = collections.Counter()
    hook = lambda m, inputs, out: seen.update([(tuple(inputs[0].shape), m.act)])
    for m in fba.modules():
        if isinstance(m, ServingGroupNorm):
            m.register_forward_hook(hook)
    x = torch.empty(1, height, width, 11, device="meta")
    with torch.no_grad():
        fba(x, x[..., :3], x[..., -2:])
    return sorted(((s, a, n) for (s, a), n in seen.items()),
                  key=lambda r: (-math.prod(r[0]), str(r[1])))


def _inputs(shape, dtype, gen):
    c = shape[1]
    x = (3.0 + 2.0 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    w = (1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    b = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    return x, w, b


def reference(x, groups, w, b, act):
    """F.group_norm and the activation in fp32, rounded once to x's dtype."""
    return gn.group_norm_plain(x.float(), groups, w.float(), b.float(), 1e-5, act).to(x.dtype)


def bench(dtype: torch.dtype, shapes, reps: int, flush: torch.Tensor, sweep=()) -> Dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, total = [], collections.Counter()
    for shape, act, count in shapes:
        groups = min(32, shape[1])
        x, w, b = _inputs(shape, dtype, gen)
        kernel = lambda: gn.group_norm_cuda(x, groups, w, b, 1e-5, act)
        gn.launches = 0
        err = rel_err(kernel(), reference(x, groups, w, b, act))
        torch_err = rel_err(gn.group_norm_plain(x, groups, w, b, 1e-5, act),
                            reference(x, groups, w, b, act))
        row = {"shape": list(shape), "act": act, "count": count,
               "ms": device_ms(kernel, flush, reps),
               "plain_ms": device_ms(lambda: gn.group_norm_plain(x, groups, w, b, 1e-5, act),
                                     flush, reps),
               "library_ms": device_ms(lambda: torch.nn.functional.group_norm(x, groups, w, b),
                                       flush, reps),
               "bound_ms": 1e3 * 3 * x.numel() * x.element_size() / PEAK_BYTES,
               "rel_err": err, "plain_rel_err": torch_err,
               "chunks": gn.chunking(shape[0] * groups, x.numel() // (shape[0] * groups),
                                     dtype, torch.cuda.get_device_properties(0)
                                     .multi_processor_count)[1]}
        assert gn.launches >= 1, "the kernels did not run"
        default = gn.BLOCKS_PER_SM
        for blocks in sweep:
            gn.BLOCKS_PER_SM = blocks
            row[f"ms_at_{blocks}_blocks_per_sm"] = device_ms(kernel, flush, reps)
        gn.BLOCKS_PER_SM = default
        rows.append(row)
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            total[key] += count * row[key]
        for blocks in sweep:
            total[f"ms_at_{blocks}_blocks_per_sm"] += count * row[f"ms_at_{blocks}_blocks_per_sm"]
        print(f"  {str(dtype).split('.')[-1]} {tuple(shape)} {act or 'none'} x{count}: "
              + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                          for k, v in row.items() if k not in ("shape", "act", "count")),
              flush=True)
        del x, w, b
    return {"shapes": rows, "frame": dict(total), "norms": sum(r["count"] for r in rows)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32", "both"), default="both")
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", default="", help="BLOCKS_PER_SM values to time besides, e.g. 4,8,32")
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    gn.build()
    shapes = frame_shapes(args.height, args.width)
    sweep = [int(s) for s in args.sweep.split(",") if s]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out = {"card": card, "height": args.height, "width": args.width,
           "blocks_per_sm": gn.BLOCKS_PER_SM}
    dtypes = ("bfloat16", "float32") if args.dtype == "both" else (args.dtype,)
    for name in dtypes:
        out[name] = bench(getattr(torch, name), shapes, args.reps, flush, sweep)
        frame = out[name]["frame"]
        print(f"{name} frame ({out[name]['norms']} norms): "
              + ", ".join(f"{k} {v:.4g}" for k, v in frame.items()), flush=True)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
