"""Compares the memory read of two checkouts of the port on one CUDA card:
the output's bits and the device time.

    python -m otvm_tpu_torch.tools.compare_reads --other DIR [--out FILE]

DIR is another checkout's root (for instance the parent commit, unpacked
with `git archive` into a git-ignored directory).  Four turns, other /
this / this / other, each a process of its own with that checkout's
`otvm_tpu_torch` first on the path: the same seeded inputs at the stream's
and the training shapes go through its `memory_read_cuda`, at the split
count that checkout chooses and at forced split counts, each timed (CUDA
events, the card held busy while the host enqueues, L2 flushed before each
call).  Then: every forced-split output of this checkout against the
other's, bit for bit (where the two split and merge alike, the same
partition of the K/V tiles and the same merge order give the same bits),
and the chosen outputs likewise; this checkout's split count and cluster
size beside them (the other's its own printout gives); and the device
times of the turns side by side, chosen and forced.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

# b, hw, t, valid slots (None: no mask), forced split counts, label
CASES = [(1, 1024, 6, 5, (2, 3, 6, 8), "512p count 5"),
         (4, 400, 1, None, (3,), "train T=1"),
         (4, 400, 2, None, (3, 4), "train T=2"),
         (1, 8160, 3, 2, (), "1088x1920 count 2"),
         (1, 8160, 6, 5, (), "1088x1920 count 5 of 6")]
DTYPES = ("bfloat16", "float32")


def dump(path: str) -> None:
    """One turn: runs the reads of the `otvm_tpu_torch` found first on the
    path and saves {(dtype, label): {"ms", "chosen", "forced",
    "forced_ms"}}."""
    import torch

    from otvm_tpu_torch import set_fp32_numerics
    from otvm_tpu_torch.kernels import memory_attn as ma
    from otvm_tpu_torch.tools.kernel_check import device_ms

    set_fp32_numerics()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    package = os.path.dirname(os.path.dirname(os.path.abspath(ma.__file__)))
    result = {"source": os.path.dirname(package)}
    for dname in DTYPES:
        dt = getattr(torch, dname)
        for i, (b, hw, t, count, forced, label) in enumerate(CASES):
            gen = torch.Generator(device="cuda").manual_seed(100 + i)
            q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(dt)
                       for shape in ((b, hw, 128), (b, t, hw, 128), (b, t, hw, 512)))
            mask = None if count is None else torch.arange(t, device="cuda")[None] < count
            result[dname, label] = {
                "chosen": ma.memory_read_cuda(q, k, v, mask).cpu(),
                "forced": {s: ma.memory_read_cuda(q, k, v, mask, _splits=s).cpu() for s in forced},
                "ms": device_ms(lambda: ma.memory_read_cuda(q, k, v, mask), flush),
                "forced_ms": {s: device_ms(lambda: ma.memory_read_cuda(q, k, v, mask, _splits=s),
                                           flush) for s in forced}}
    torch.save(result, path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--out", default=None, help="also write the comparison to this JSON file")
    ap.add_argument("--dump", default=None, help=argparse.SUPPRESS)   # one turn, internal
    args = ap.parse_args()
    if args.dump:
        dump(args.dump)
        return 0
    import torch

    from otvm_tpu_torch.kernels import memory_attn as ma

    this = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    other = os.path.abspath(args.other)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; this {this}, other {other}")
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        for n, root in enumerate((other, this, this, other)):
            path = os.path.join(tmp, f"turn{n}.pt")
            env = {**os.environ, "PYTHONPATH": root}
            subprocess.run([sys.executable, os.path.abspath(__file__), "--other", other,
                            "--dump", path], env=env, cwd=root, check=True)
            turns.append((root, torch.load(path, weights_only=False)))
    mine, theirs = turns[1][1], turns[0][1]
    assert (mine["source"], theirs["source"]) == (this, other), "a turn imported another checkout"
    report = {"card": card, "cases": []}
    for dname in DTYPES:
        dt = getattr(torch, dname)
        table = ma.max_active_clusters(dt, 128, 512)
        for b, hw, t, _, forced, label in CASES:
            a, o = mine[dname, label], theirs[dname, label]
            same = {s: torch.equal(a["forced"][s], o["forced"][s]) for s in forced}
            diff = {s: (a["forced"][s].float() - o["forced"][s].float()).abs().max().item()
                    for s in forced}
            same["chosen"] = torch.equal(a["chosen"], o["chosen"])
            diff["chosen"] = (a["chosen"].float() - o["chosen"].float()).abs().max().item()
            geometry = {s: "x".join(map(str, ma.launch_geometry(b, hw, t, 512, dt, table,
                                                                _splits=s)[2:]))
                        for s in (None, *forced)}
            ms = [turn[dname, label]["ms"] for _, turn in turns]
            forced_ms = {s: [turn[dname, label]["forced_ms"][s] for _, turn in turns]
                         for s in forced}
            row = dict(dtype=dname, shape=label,
                       splits_x_blocks_this={str(s): g for s, g in geometry.items()},
                       bit_identical=same, max_abs_diff=diff, ms_other_this_this_other=ms,
                       forced_ms_other_this_this_other=forced_ms)
            report["cases"].append(row)
            fmt = lambda xs: " / ".join(f"{x:.5f}" for x in xs)
            print(f"{dname:8s} {label}: this splits x blocks {geometry}; "
                  f"bit-identical {same}; max|diff| {diff}; device ms other / this / this / "
                  f"other: chosen {fmt(ms)}; " +
                  "; ".join(f"splits {s} {fmt(x)}" for s, x in forced_ms.items()))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
