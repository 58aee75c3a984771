"""The errors that the kernel checks' tolerances (tools/kernel_check.py) must
separate, from the plain split arithmetic on the CPU.

    python -m otvm_tpu_torch.tools.tolerance_bands

For each shape and dtype: the sound error, `memory_read_partials_plain` (1
and 8 splits) merged by `combine_plain` against `memory_read_plain` (the
split kernel's arithmetic: p rounded against a running max); the control's,
the plain read on inputs rounded through a narrower type (`control`).  In
fp32 also the fp32 kernel's tensor-core arithmetic, emulated
(`memory_read_tf32_plain`): 3xTF32 (sound) and plain TF32 (what a kernel
that dropped the small terms would give).  1088x1920 takes 256 query rows
of its 8160, to keep the score matrix small.  Then the read's gradients
at the training shapes (B 4, HW 400, T 1 and 2, no mask): the autograd
Function's backward
(`memory_read_vjp_plain`) against autograd through the plain read (sound),
and autograd through the plain read on `control` inputs.
"""
from __future__ import annotations

import torch

from ..kernels import memory_attn as ma
from .kernel_check import control, plain_read_grads, rel_err

# b, hw, t, slot mask, query rows, label
CASES = [(1, 1024, 6, [1, 1, 1, 1, 1, 0], 1024, "512p count 5"),
         (1, 1024, 6, [0] * 6, 1024, "512p count 0"),
         (1, 1024, 6, [1, 0, 0, 0, 0, 0], 1024, "512p count 1"),
         (2, 70, 3, [[1, 0, 1], [0, 1, 1]], 70, "HW=70 per-row masks"),
         (1, 8160, 3, [1, 1, 0], 256, "1088x1920 count 2")]


def main():
    torch.manual_seed(0)
    for b, hw, t, rows, nq, label in CASES:
        m = torch.tensor(rows, dtype=torch.bool)
        m = m[None].expand(b, t) if m.dim() == 1 else m
        q = torch.randn(b, hw, 128)[:, :nq]
        k, v = torch.randn(b, t, hw, 128), torch.randn(b, t, hw, 512)
        for dt in (torch.float32, torch.bfloat16):
            qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
            want = ma.memory_read_plain(qq, kk, vv, m)
            sound = [rel_err(ma.combine_plain(*ma.memory_read_partials_plain(qq, kk, vv, m, s), dt),
                             want) for s in (1, 8)]
            ctl = rel_err(ma.memory_read_plain(control(qq), control(kk), control(vv), m), want)
            line = (f"{label:22s} {str(dt)[6:]:9s} read: sound {sound[0]:.3e} (1 split) "
                    f"{sound[1]:.3e} (8 splits), control {ctl:.3e}")
            if dt == torch.float32:
                tf32 = [rel_err(ma.memory_read_tf32_plain(qq, kk, vv, m, passes), want)
                        for passes in (3, 1)]
                line += f"; 3xTF32 {tf32[0]:.3e}, 1xTF32 {tf32[1]:.3e}"
            print(line)
    for t in (1, 2):
        q, k, v = torch.randn(4, 400, 128), torch.randn(4, t, 400, 128), torch.randn(4, t, 400, 512)
        g = torch.randn(4, 400, 512)
        for dt in (torch.float32, torch.bfloat16):
            qq, kk, vv, gg = q.to(dt), k.to(dt), v.to(dt), g.to(dt)
            want = plain_read_grads(qq, kk, vv, None, gg)
            sound = ma.memory_read_vjp_plain(qq, kk, vv, None, gg)
            ctl = plain_read_grads(control(qq), control(kk), control(vv), None, gg)
            fmt = lambda grads: ", ".join(f"{rel_err(a, b):.3e}" for a, b in zip(grads, want))
            print(f"{f'train T={t}':22s} {str(dt)[6:]:9s} read grads (dq, dk, dv): "
                  f"sound {fmt(sound)}; control {fmt(ctl)}")


if __name__ == "__main__":
    main()
