"""Holding a kernel to its plain version, and timing it, on a CUDA card.

`rel_err` and its tolerances are the comparison that chip_smoke.py and the
card tests make; `control` makes the lower-precision input that shows the
comparison can fail; `plain_read_grads` is what the read's gradients are
held to; `lockstep_check` and `lockstep_grad_check` hold every read of a
path to the plain read while it runs.  `device_ms` and `event_ms` are the
timers of chip_smoke.py and tools/bench_memory_read.py.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

# Tolerances of rel_err, each between the errors of sound and control
# results (tools/tolerance_bands.py; PERF.md).  Read, kernel vs plain: bf16
# rounds p and the output at different points in the two (sound ~3e-3);
# fp32 in 3xTF32 on the tensor cores differs by ~21-bit operands and
# summation order (sound ~1e-6; plain TF32 would give ~4e-4).  `control`
# inputs give 2.5e-2..4.8e-2 (bf16) and 2e-4..3.8e-4 (fp32).
READ_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# Read gradients, the autograd Function's (memory_read_vjp_plain) vs
# autograd through the plain read, at the training shapes: bf16 rounds the
# plain read's p (and so dp) mid-way (sound ~2.6e-3); fp32 differs by
# summation order (~4e-7).  `control` inputs give 3.8e-2..5.5e-2 (bf16)
# and 3e-4..4.3e-4 (fp32).
GRAD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# The control's narrower type: fp8 e4m3 for bf16, fp16 (TF32's mantissa)
# for fp32.
_NARROWER = {torch.bfloat16: torch.float8_e4m3fn, torch.float32: torch.float16}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in fp32 over the whole tensor: the error
    on the output's own scale, whatever its size."""
    want = want.float()
    return ((got.float() - want).norm() / want.norm()).item()


def control(x: torch.Tensor) -> torch.Tensor:
    """x rounded through the next narrower type, back in x's dtype."""
    return x.to(_NARROWER[x.dtype]).to(x.dtype)


def plain_read_grads(q_k, m_k, m_v, slot_mask, g):
    """(dq_k, dm_k, dm_v): autograd through memory_read_plain, with `g` as
    the output's gradient, on detached copies of the inputs."""
    from ..kernels.memory_attn import memory_read_plain

    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (q_k, m_k, m_v)]
        return torch.autograd.grad(memory_read_plain(*leaves, slot_mask), leaves, g)


@contextlib.contextmanager
def lockstep_check(dtype: Optional[torch.dtype] = None):
    """While active, every launch of the read kernel (memory_read_cuda) is
    also computed by the plain version on the same inputs and held to
    READ_TOL[dtype] (dtype None: each read to its own dtype's); yields the
    list of norm-relative errors per read.  The
    plain calls launch no kernel.  The host compares each read as it
    returns, which no CUDA graph can do: a read captured while the check
    is active raises, and so does a graph replay (models/graphs.py), so
    no read goes unchecked; run a graphed path with graphs=False to check
    it."""
    from ..kernels import memory_attn as ma

    launch, errs = ma.memory_read_cuda, []

    def checked(q, k, v, mask):
        tol = READ_TOL[dtype or q.dtype]
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("lockstep_check holds each read to the plain read on the host, "
                               "which a CUDA-graph capture cannot: run the path eagerly "
                               "(graphs=False, the eval CLI's --eager) to check it")
        out = launch(q, k, v, mask)
        want = ma.memory_read_plain(q, k, v, mask)
        errs.append(rel_err(out, want))
        assert errs[-1] <= tol, f"kernel != plain on the stream's read {len(errs) - 1}: " \
            f"rel err {errs[-1]:.3e} > {tol:g}"
        return out

    ma.memory_read_cuda = checked
    ma.host_checks += 1
    try:
        yield errs
    finally:
        ma.memory_read_cuda = launch
        ma.host_checks -= 1


@contextlib.contextmanager
def lockstep_grad_check(dtype: torch.dtype):
    """While active, every backward of the read (the autograd Function's
    memory_read_vjp_plain) is also computed by autograd through the plain
    read on the same inputs and held to GRAD_TOL[dtype]; yields the list of
    the largest of the three gradients' norm-relative errors per backward.
    A captured train step cannot be checked so: its step raises while this
    is active (train/graphs.py), as under lockstep_check."""
    from ..kernels import memory_attn as ma

    vjp, errs = ma.memory_read_vjp_plain, []
    tol = GRAD_TOL[dtype]

    def checked(q, k, v, mask, g):
        grads = vjp(q, k, v, mask, g)
        errs.append(max(rel_err(a, w) for a, w in zip(grads, plain_read_grads(q, k, v, mask, g))))
        assert errs[-1] <= tol, f"read backward != autograd through the plain read, backward " \
            f"{len(errs) - 1}: rel err {errs[-1]:.3e} > {tol:g}"
        return grads

    ma.memory_read_vjp_plain = checked
    ma.host_checks += 1
    try:
        yield errs
    finally:
        ma.memory_read_vjp_plain = vjp
        ma.host_checks -= 1


def device_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    """Median device time of one call, by CUDA events around each call.
    The card is kept busy (torch.cuda._sleep, ~1 ms) while the host
    enqueues the call, so the events time the device's work, not the
    host's.  `flush` (a tensor larger than L2) is rewritten before each
    call so the call finds the cache cold, as between frames of the
    stream."""
    return _median_ms(fn, flush, reps, hold=True)


def event_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    """As device_ms, without holding the card: where the host enqueues the
    call slower than the card runs it, the events time the host."""
    return _median_ms(fn, flush, reps, hold=False)


def _median_ms(fn, flush, reps, hold):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if hold:
            torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]
