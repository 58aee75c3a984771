"""Data parallelism across processes, counterpart of otvm_tpu/parallel/mesh.py.

The JAX package's data parallelism is a 1-D mesh over every device: the
batch is sharded on its 'data' axis, the train state replicated, and jit
inserts the gradient all-reduce, so every mean inside the jitted step is a
mean over the global batch.  Here each rank is one process on one device
(torchrun's env:// rendezvous, or `spawn`) holding its rows of the global
batch and a whole copy of the train state:

  * init_distributed: the process group from the environment, NCCL on
    CUDA and gloo on the CPU (or gloo on CUDA tensors, asked for by name);
  * all_reduce_gradients: after the backward pass, every rank's gradients
    averaged in flat buckets, so the optimizer sees the global batch's
    gradient.  It is two parts: a plan made on the host (plan_gradients:
    which parameters any rank holds a gradient for, agreed in one
    collective, and the buckets) and a device part that reads nothing back
    (reduce_gradients), which a CUDA graph of the train step holds
    (train/graphs.py keeps a plan per key: GradientPlans);
  * check_same_key: every rank about to capture the same step, checked in
    one collective (graphs whose collectives differ would wait for ever);
  * GlobalSum and batch_means: a mean over the global batch inside the
    loss, for the one term that is not linear in the batch (the exclusion
    loss's ratio of two means, train/losses.py);
  * all_reduce_mean, all_gather_rows, ranks_equal: log lines and checks;
  * spawn: N ranks on this host in fresh processes, the env:// variables set.

Why an explicit all-reduce and not DistributedDataParallel: GlobalSum's
collectives run inside the forward and backward passes (and again in the
recomputed forward under remat), and every rank must issue its collectives
in one order.  DDP's bucket hooks fire from the autograd engine while the
backward runs, interleaved with them; one bucketed all-reduce after the
backward keeps the order fixed, needs no buffer broadcast (a rank-0-only
forward such as the training image grid stays local), and treats a
parameter that no rank's loss reaches (the STM at joint stage 1) as the
1-process step does.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import socket
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device
from ..utils import trace

_RENDEZVOUS = ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
BUCKET_BYTES = 25 << 20     # DistributedDataParallel's default bucket


def init_distributed(device=None, backend: Optional[str] = None) -> torch.device:
    """Joins the process group that torchrun's environment describes
    (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and returns
    this rank's device: CUDA unless `device` says otherwise, card
    LOCAL_RANK (made current).  The backend is NCCL on CUDA and gloo on the
    CPU unless `backend` names one; with gloo, ranks may share cards (card
    LOCAL_RANK % the card count), with NCCL they may not.  Without
    WORLD_SIZE > 1 it joins nothing and returns resolve_device(device);
    WORLD_SIZE > 1 without the rest of the rendezvous raises."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = resolve_device(device)
    if world <= 1:
        return device
    missing = [k for k in _RENDEZVOUS if not os.environ.get(k)]
    if missing:
        raise RuntimeError(f"WORLD_SIZE={world} without {', '.join(missing)}: launch the ranks "
                           "with torchrun (or otvm_tpu_torch.parallel.dist.spawn)")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        local, cards = int(os.environ["LOCAL_RANK"]), torch.cuda.device_count()
        if local >= cards and backend == "nccl":
            raise RuntimeError(f"local rank {local} with {cards} card(s): NCCL takes one card a "
                               "rank (gloo, asked for by name, lets ranks share one)")
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                                world_size=world)
    return device


def process_index() -> int:
    """This process's rank (jax.process_index's counterpart); 0 alone."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks (jax.process_count's counterpart); 1 alone."""
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> Optional[str]:
    """The process group's backend ('nccl', 'gloo'); None alone."""
    return dist.get_backend() if dist.is_initialized() else None


def group_backend(group) -> str:
    """The backend of `group` ('nccl', 'gloo')."""
    return dist.get_backend(group)


def data_group():
    """The group of every rank where there are several, else None (one
    process: every reduction is local)."""
    return dist.group.WORLD if process_count() > 1 else None


def shutdown() -> None:
    """Leaves the process group, once every rank has reached this point."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


class GlobalSum(torch.autograd.Function):
    """x summed over the ranks of `group`.  Backward: the gradient summed
    over the ranks, since every rank's loss depends on every rank's x.
    Neither pass reads anything back to the host, so a CUDA graph of the
    train step holds both collectives (over NCCL)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def batch_means(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The mean of each tensor over the global batch: its elements on every
    rank of `group` (each rank holding a batch of the same shape), in one
    collective; with no group, each tensor's own mean.

    The gradient is the global mean loss's: rank r's loss reaches rank s's
    tensors through the sums, GlobalSum's backward hands each rank the sum
    over ranks of d loss_r / d sum, and all_reduce_gradients' mean over
    ranks then gives the gradient of (1/R) sum_r loss_r."""
    if group is None:
        return [t.mean() for t in tensors]
    sums = GlobalSum.apply(torch.stack([t.sum() for t in tensors]), group)
    world = dist.get_world_size(group)
    return [s / float(t.numel() * world) for s, t in zip(sums.unbind(), tensors)]


@dataclasses.dataclass(frozen=True)
class GradientPlan:
    """How a step's gradients are averaged over the ranks of `group`, made
    on the host once (`plan_gradients`) and then run on the device alone
    (`reduce_gradients`), so that a CUDA graph can hold that part."""
    group: object
    world: int
    held: Tuple[bool, ...]                  # per parameter: some rank has its gradient
    buckets: Tuple[Tuple[int, ...], ...]    # the held parameters' indices, a flat bucket each


def plan_gradients(params: Sequence[torch.nn.Parameter], group=None,
                   bucket_bytes: int = BUCKET_BYTES) -> GradientPlan:
    """The plan of this step's gradients (their .grad set by the backward
    pass): which parameters any rank holds a gradient for, agreed in one
    collective (its result read on the host), and the held ones cut, in
    order, into buckets of about `bucket_bytes` of one dtype."""
    params = list(params)
    held = torch.tensor([float(p.grad is not None) for p in params], device=params[0].device)
    dist.all_reduce(held, group=group)
    held = tuple(bool(n) for n in held.tolist())
    buckets, bucket, size = [], [], 0
    live = [i for i, h in enumerate(held) if h]
    for j, i in enumerate(live):
        bucket.append(i)
        size += params[i].numel() * params[i].element_size()
        if (j == len(live) - 1 or size >= bucket_bytes
                or params[live[j + 1]].dtype != params[i].dtype):
            buckets.append(tuple(bucket))
            bucket, size = [], 0
    return GradientPlan(group, dist.get_world_size(group), held, tuple(buckets))


def reduce_gradients(plan: GradientPlan, params: Sequence[torch.nn.Parameter]) -> None:
    """`plan`'s device part, which reads nothing back to the host: each
    held parameter's .grad (zeros where this rank has none) becomes the
    mean over the ranks, a bucket at a time (concatenated, all-reduced,
    divided by the world size, copied back); a parameter that no rank
    holds keeps .grad None.  A gradient on this rank that the plan says no
    rank holds raises: the plan no longer describes the step."""
    params = list(params)
    if len(params) != len(plan.held):
        raise RuntimeError(f"a gradient plan of {len(plan.held)} parameters for {len(params)}")
    for i, (p, held) in enumerate(zip(params, plan.held)):
        if held and p.grad is None:
            p.grad = torch.zeros_like(p)
        elif not held and p.grad is not None:
            raise RuntimeError(f"parameter {i} has a gradient that its gradient plan says no "
                               "rank holds: the step no longer matches the plan made for it")
    for bucket in plan.buckets:
        grads = [params[i].grad for i in bucket]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=plan.group)
        flat /= plan.world
        for g, piece in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(piece.view_as(g))


def all_reduce_gradients(params: Sequence[torch.nn.Parameter], group=None,
                         bucket_bytes: int = BUCKET_BYTES) -> None:
    """Each parameter's .grad becomes the mean over the ranks of `group`, in
    flat buckets of about `bucket_bytes`: this step's plan
    (`plan_gradients`), then its device part (`reduce_gradients`).  A
    gradient that some rank lacks counts there as zero (autograd leaves it
    None where the loss does not reach the parameter); one that every rank
    lacks stays None, as in one process (RAdam takes None as a zero
    gradient)."""
    params = list(params)
    if params:
        reduce_gradients(plan_gradients(params, group, bucket_bytes), params)


class GradientPlans:
    """Gradient plans kept by key: a key's first call makes its plan (one
    collective, read on the host), every later call runs the kept plan's
    device part alone, as a CUDA graph of the step replays it."""

    def __init__(self, bucket_bytes: int = BUCKET_BYTES):
        self.bucket_bytes = bucket_bytes
        self.plans: Dict[object, GradientPlan] = {}

    def __call__(self, key, params: Sequence[torch.nn.Parameter], group) -> GradientPlan:
        params = list(params)
        if key not in self.plans:
            self.plans[key] = plan_gradients(params, group, self.bucket_bytes)
        plan = self.plans[key]
        reduce_gradients(plan, params)
        return plan


def key_digest(key) -> int:
    """A digest of `key` (its repr) that is the same in every process (not
    Python's hash, which is salted per process)."""
    return int.from_bytes(hashlib.blake2b(repr(key).encode(), digest_size=7).digest(), "little")


def check_same_key(key, group, device) -> None:
    """Raises on every rank unless every rank of `group` passes an equal
    `key` (by key_digest, gathered in one collective): ranks that would
    capture or replay different steps would wait on each other's
    collectives for ever."""
    rows = all_gather_rows(torch.tensor([key_digest(key)], dtype=torch.int64, device=device),
                           group)[:, 0].tolist()
    if len(set(rows)) > 1:
        raise RuntimeError(f"the ranks' train steps differ in their keys (digests by rank "
                           f"{rows}; this rank's key {key!r}): every rank must take the same "
                           "step, with the same batch shapes, in the same order")


def all_reduce_mean(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The tensors averaged over the ranks (helpers.py:76-90's
    reduce_tensor), fp32, in one collective: for log lines, not every step.
    Alone: the tensors themselves, fp32."""
    tensors = [t.detach().float() for t in tensors]
    if group is None and process_count() == 1:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return [piece.view_as(t) for piece, t in zip(flat.split([t.numel() for t in tensors]),
                                                 tensors)]


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """[ranks, *x.shape]: every rank's x, by rank (through the host where
    the backend is gloo, which gathers CPU tensors)."""
    if group is None and process_count() == 1:
        return x[None]
    if dist.get_backend(group) != "nccl":
        x = x.cpu()
    x = x.contiguous()
    rows = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(rows, x, group=group)
    return torch.stack(rows)


_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def checksums(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """int64 [len(tensors)]: each tensor's bit patterns summed, so that two
    tensors with a bit apart differ."""
    return torch.stack([t.detach().contiguous().view(_INT_OF_SIZE[t.element_size()])
                        .to(torch.int64).sum() for t in tensors])


def ranks_equal(tensors: Sequence[torch.Tensor], group=None) -> bool:
    """Whether every rank holds the same bits in `tensors` (by checksums)."""
    rows = all_gather_rows(checksums(tensors), group)
    return bool((rows == rows[0]).all())


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, threads: int, tracing: bool, queue,
               fn: Callable, args):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(threads)
    if tracing:
        trace.enable()
    try:
        value = fn(*args)
        queue.put((rank, value, trace.take()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, timeout: Optional[float] = None) -> list:
    """Runs fn(*args) as `world` ranks on this host, each in a fresh
    process (spawned: a module-level fn, picklable args) with torchrun's
    variables set (RANK = LOCAL_RANK, WORLD_SIZE, MASTER_ADDR localhost, a
    free MASTER_PORT) and this process's CPU threads shared among them.
    fn joins the group itself (init_distributed).  Each rank records spans
    where this process has `trace.enable()` on (and under a profiler of its
    own); its records come back into this process's, tagged with its rank
    (utils/trace.py absorb).  Returns each rank's
    return value, by rank; a rank that raises makes this raise, and so do
    ranks still running after `timeout` seconds (None: no limit), which are
    ended first (a rank waiting on a collective that another rank never
    issues waits for ever)."""
    import torch.multiprocessing as mp

    queue = mp.get_context("spawn").SimpleQueue()
    threads = max(1, torch.get_num_threads() // world)
    context = mp.start_processes(_rank_main, args=(world, _free_port(), threads, trace.enabled(),
                                                   queue, fn, args),
                                 nprocs=world, join=False, start_method="spawn")
    results, t0 = {}, time.monotonic()

    def receive():
        rank, value, records = queue.get()
        results[rank] = value
        trace.absorb(rank, records)

    while True:
        while not queue.empty():
            receive()
        if context.join(timeout=1.0):
            break
        if timeout is not None and time.monotonic() - t0 > timeout:
            for proc in context.processes:
                if proc.is_alive():
                    proc.kill()
            for proc in context.processes:
                proc.join()
            raise TimeoutError(f"{world} ranks still running after {timeout:.0f} s (ranks done: "
                               f"{sorted(results)})")
    while not queue.empty():
        receive()
    return [results[r] for r in range(world)]
