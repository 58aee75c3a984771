"""The compiled serving steps: `eval_frame_step`, `trimap_eval_step` and
`alpha_predict` replayed from CUDA graphs, the port's counterparts of the
JAX package's jitted steps (otvm_tpu/models/otvm.py:158-176, 220, 239:
"per-frame streaming inference is ONE jitted step").

JAX traces a step once per static signature and dispatches each frame as
one executable.  Here a frame's step is captured once per key into a CUDA
graph, and each later frame with that key is one `replay()`: the ~1700
kernels of an eager stage-4 frame leave the host as one launch.

Keys.  JAX's static arguments make a bucket: the device, dtypes and
shapes, `max_memory_num`, `wire_u8_out`, `exact_edt`, `memorize_gt` (and
`memory_impl`) from the call; stage, arch, scale and the STM trunk are
fixed by the models a cache serves.  JAX traces the flags and the bank's
count; the port keeps them on the host (models/memory.py), where they
steer the step's Python branches, so they key the graphs of a bucket.
`FrameStepGraphs` keys by (count, memorize, last): a non-first frame's
count runs from 1 to max(max_memory_num, 1) and a last frame does not
memorize, so a bucket holds at most `max_graphs(max_memory_num)` = 3 *
max(max_memory_num, 1) graphs (15 at the protocol's 5; a 30-frame clip
memorizing every 10th frame meets 7).  `TrimapStepGraphs` keys by (count,
memorize): at most 2 * max(max_memory_num, 1).  `AlphaGraphs` holds one
graph a bucket.  A clip's first frame runs eagerly: it comes once a clip,
reads no memory, and a capture would cost more than it saves.

A key's first frame runs eagerly on the cache's own stream: the warm-up,
whose results are that frame's, and which makes every lazy thing the step
needs (the read's and the group norm's libraries, the read's cluster
table and L2 workspace, the normalization constants, cuDNN's plans).  Its
step is captured right after, and later frames with the key replay it.
So each read and each group norm is launched once per frame on either
path, and counted so (`memory_attn.record_launches` / `count_launches`,
and group_norm's).

Memory.  The graphs of a bucket share one memory pool, so memory stays
near one frame's peak.  A replay's outputs live in that pool: the next
replay of any graph of the bucket overwrites them, so the caller copies
them out first (the runner's device-to-host copy is enqueued before the
next step; `eval_chunk_step` clones them).  Inputs are static buffers
outside the pool: the tensors a step reads (`frame_buffer` is the frame's:
a caller may upload straight into it) and the bank (`bank`: a bank made
there needs no copy; any other bank of the same shape is copied in before
the step and back after it, ~16 MB at 512p in fp32: the two
graphs.bank_copy spans of utils/trace.py, beside graphs.replay).  The
first trimap is read only on first frames, which run eagerly (and by the
trimap step's memorize_gt, where it is an input).  A cache keeps at most
MAX_BUCKETS buckets; a new one evicts the least recently used, with its
graphs and pool.

Ordering.  Replays and first frames run on the caller's current stream,
warm-ups and captures on the cache's stream, each side waiting for the
other.  The captured L2-merged reads use the capture stream's workspace
(kernels/memory_attn.py), on which no eager read then overlaps a replay.

A failed capture or replay raises; nothing gives way to the eager step.
A replay while a lockstep check is active raises, as the check cannot see
replayed reads (tools/kernel_check.py).  CUDA only: on the CPU the eager
steps are the only ones.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import group_norm as gn
from ..kernels import memory_attn as ma
from ..utils import trace
from .fba import FBA
from .memory import MemoryBank
from .otvm import EvalOutput, alpha_predict, eval_frame_step, make_eval_bank, trimap_eval_step
from .stm import STM

# Buckets a cache keeps (shapes and settings at once): each holds its pool,
# about one frame's working set (~0.1-0.2 GB at 512p), and its graphs.
MAX_BUCKETS = 4
# a step's body on the static inputs and bank -> (outputs, the bank after)
Body = Callable[[List[torch.Tensor], Optional[MemoryBank]],
                Tuple[Tuple[torch.Tensor, ...], Optional[MemoryBank]]]


def max_graphs(max_memory_num: int) -> int:
    """The most graphs a bucket of `FrameStepGraphs` can hold: counts
    1..max(max_memory_num, 1), each with memorize, without it, and as a
    last frame."""
    return 3 * max(max_memory_num, 1)


@dataclasses.dataclass
class Launches:
    """The hand-written kernels a graph launches at each replay, as its
    capture recorded them."""
    reads: List[Tuple[int, int]]            # memory_attn.record_launches
    norms: List[int]                        # group_norm.record_launches


class GraphCache:
    """What the caches of CUDA graphs (these and train/graphs.py's) share:
    a capture stream of their own, made for a device on first use; warm-ups
    on it, ordered after the caller's stream's work and before its later
    work; captures on it into a given pool, with the reads and group norms
    they launch recorded (memory_attn.record_launches, group_norm's) and
    counted at each replay (count_launches); a replay under a lockstep check
    refused."""

    def __init__(self):
        self.stream: Optional[torch.cuda.Stream] = None
        self.captures = 0                   # graphs captured
        self.capture_s = 0.0                # seconds in the captures (warm-ups excluded)

    def _stream_on(self, device: torch.device) -> torch.cuda.Stream:
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        return self.stream

    def _warm_up(self, fn: Callable):
        """fn() eagerly on the capture stream."""
        current = torch.cuda.current_stream()
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def _capture(self, pool: tuple, fn: Callable):
        """fn() captured on the capture stream into `pool` -> (the graph,
        fn's outputs in the pool, the kernels it launches)."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with ma.record_launches() as reads, gn.record_launches() as norms, \
                torch.cuda.graph(graph, pool=pool, stream=self.stream):
            out = fn()
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        return graph, out, Launches(reads, norms)

    @staticmethod
    def _replay(graph: torch.cuda.CUDAGraph, launches: Launches) -> None:
        if ma.host_checks:
            raise RuntimeError("a lockstep check is active, and it cannot see the reads of a "
                               "graph replay: run with graphs=False to check")
        graph.replay()
        ma.count_launches(launches.reads)
        gn.count_launches(launches.norms)


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    outputs: Tuple[torch.Tensor, ...]
    count: Optional[int]                    # the bank's count after the step
    launches: Launches                      # the kernels it launches


@dataclasses.dataclass
class _Bucket:
    slots: tuple                            # the static inputs' keys
    bank_key: Optional[tuple]
    pool: tuple
    graphs: Dict[tuple, _Graph] = dataclasses.field(default_factory=dict)


class _StepGraphs(GraphCache):
    """The cache the steps share the workings of: buckets of graphs,
    static inputs and banks.  See the module's docstring."""

    def __init__(self, module: torch.nn.Module, scale: int):
        super().__init__()
        self.device = next(module.parameters()).device
        if self.device.type != "cuda":
            raise ValueError("CUDA graphs serve models on a CUDA card; on the CPU the eager "
                             "steps are the only ones")
        self.scale = scale
        self._stream_on(self.device)
        self._buckets: Dict[tuple, _Bucket] = collections.OrderedDict()
        self._inputs: Dict[tuple, torch.Tensor] = {}
        self._banks: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def graphs_per_bucket(self) -> List[int]:
        return [len(b.graphs) for b in self._buckets.values()]

    def frame_buffer(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """The static frame input of that shape and dtype (a frame already
        in it is not copied again)."""
        return self._input((0, tuple(shape), dtype))

    def bank(self, batch: int, height: int, width: int, max_memory_num: int = 5,
             dtype: torch.dtype = torch.float32) -> MemoryBank:
        """An empty bank whose tensors are the static bank of its shape:
        the step updates it in place with no copy.  One per shape: a second
        stream of that shape needs a bank of its own (make_eval_bank)."""
        shaped = make_eval_bank(batch, height, width, max_memory_num, dtype, self.scale,
                                device="meta")
        keys, values = self._static_bank((tuple(shaped.keys.shape), tuple(shaped.values.shape),
                                          dtype))
        return MemoryBank(keys, values, 0)

    def _input(self, slot: tuple) -> torch.Tensor:
        if slot not in self._inputs:
            self._inputs[slot] = torch.empty(slot[1], dtype=slot[2], device=self.device)
        return self._inputs[slot]

    def _static_bank(self, key: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
        if key not in self._banks:
            self._banks[key] = tuple(torch.zeros(shape, dtype=key[2], device=self.device)
                                     for shape in key[:2])
        return self._banks[key]

    def _bucket(self, key: tuple, slots: tuple, bank_key: Optional[tuple]) -> _Bucket:
        if key in self._buckets:
            self._buckets.move_to_end(key)
            return self._buckets[key]
        if len(self._buckets) == MAX_BUCKETS:
            _, old = self._buckets.popitem(last=False)      # the least recently used
            live = self._buckets.values()
            for slot in old.slots:
                if all(slot not in b.slots for b in live):
                    self._inputs.pop(slot, None)
            if all(b.bank_key != old.bank_key for b in live):
                self._banks.pop(old.bank_key, None)
        bucket = self._buckets[key] = _Bucket(slots, bank_key, torch.cuda.graph_pool_handle())
        return bucket

    def _serve(self, static_args: tuple, key: tuple, inputs: Sequence[torch.Tensor],
               bank: Optional[MemoryBank], body: Body
               ) -> Tuple[Tuple[torch.Tensor, ...], Optional[int]]:
        """One step: `inputs` into their static buffers and `bank` into the
        static bank (unless it is it), then `body` on them from the graph
        of `key` in the bucket of `static_args` and the shapes: captured at
        the key's first step, after an eager warm-up whose results are that
        step's.  Returns (outputs, the bank's count after)."""
        with torch.no_grad(), torch.cuda.device(self.device):
            slots = tuple((i, tuple(x.shape), x.dtype) for i, x in enumerate(inputs))
            bank_key = None if bank is None else (
                tuple(bank.keys.shape), tuple(bank.values.shape), bank.keys.dtype)
            bucket = self._bucket((static_args, slots, bank_key), slots, bank_key)
            statics = [self._input(slot) for slot in slots]
            for static, x in zip(statics, inputs):
                if static.data_ptr() != x.data_ptr():
                    static.copy_(x)
            static_bank, own = None, True
            if bank is not None:
                keys, values = self._static_bank(bank_key)
                own = keys.data_ptr() == bank.keys.data_ptr()
                if not own:
                    with trace.span("graphs.bank_copy"):
                        keys.copy_(bank.keys)
                        values.copy_(bank.values)
                static_bank = MemoryBank(keys, values, bank.count)
            entry = bucket.graphs.get(key)
            if entry is None:
                outputs, count = self._warm_up_and_capture(bucket, key, statics, static_bank,
                                                           body)
            else:
                with trace.span("graphs.replay"):
                    self._replay(entry.graph, entry.launches)
                outputs, count = entry.outputs, entry.count
            if not own:
                with trace.span("graphs.bank_copy"):
                    bank.keys.copy_(keys)
                    bank.values.copy_(values)
        return outputs, count

    def _warm_up_and_capture(self, bucket: _Bucket, key: tuple, statics: List[torch.Tensor],
                             static_bank: Optional[MemoryBank], body: Body):
        """The key's first step: eagerly on the capture stream (its results
        are this step's), then captured into the bucket's pool."""
        outputs, after = self._warm_up(lambda: body(statics, static_bank))
        # `static_bank` still holds the count the step starts from
        graph, (captured, _), launches = self._capture(
            bucket.pool, lambda: body(statics, static_bank))
        count = None if after is None else after.count
        bucket.graphs[key] = _Graph(graph, captured, count, launches)
        return outputs, count


class FrameStepGraphs(_StepGraphs):
    """`eval_frame_step` of (stm, fba), served from CUDA graphs: call it as
    `eval_frame_step` without the models.  The outputs of a replay are
    valid until the next call."""

    def __init__(self, stm: STM, fba: FBA):
        super().__init__(fba, stm.scale)
        self.stm, self.fba = stm, fba

    def __call__(self, bank: MemoryBank, frame01: torch.Tensor, first_trimap3: torch.Tensor,
                 first_frame: bool, memorize: bool, last_frame: bool, max_memory_num: int = 5,
                 wire_u8_out: bool = False, memory_impl: Optional[str] = None,
                 exact_edt: bool = False) -> EvalOutput:
        step = dict(max_memory_num=max_memory_num, wire_u8_out=wire_u8_out,
                    memory_impl=memory_impl, exact_edt=exact_edt)
        if first_frame:
            return eval_frame_step(self.stm, self.fba, bank, frame01, first_trimap3, True,
                                   memorize, last_frame, **step)
        memorize = bool(memorize) and not last_frame

        def body(statics, static_bank):
            out = eval_frame_step(self.stm, self.fba, static_bank, statics[0], first_trimap3,
                                  False, memorize, last_frame, **step)
            return (out.alpha, out.trimap), out.bank

        (alpha, trimap), count = self._serve(
            (first_trimap3.dtype, *sorted(step.items())),
            (bank.count, memorize, bool(last_frame)), [frame01], bank, body)
        return EvalOutput(MemoryBank(bank.keys, bank.values, count), alpha, trimap)


class TrimapStepGraphs(_StepGraphs):
    """`trimap_eval_step` of the stage-1 stm, served from CUDA graphs:
    call it as `trimap_eval_step` without the model.  The outputs of a
    replay are valid until the next call."""

    def __init__(self, stm: STM):
        super().__init__(stm, stm.scale)
        self.stm = stm

    def __call__(self, bank: MemoryBank, frame01: torch.Tensor, first_trimap3: torch.Tensor,
                 first_frame: bool, memorize: bool, max_memory_num: int = 5,
                 memorize_gt: bool = False) -> Tuple[MemoryBank, torch.Tensor]:
        if first_frame:
            return trimap_eval_step(self.stm, bank, frame01, first_trimap3, True, memorize,
                                    max_memory_num, memorize_gt)
        # with memorize_gt every frame memorizes the first trimap: an input
        inputs = [frame01, first_trimap3] if memorize_gt else [frame01]

        def body(statics, static_bank):
            tri = statics[1] if memorize_gt else first_trimap3
            after, pred = trimap_eval_step(self.stm, static_bank, statics[0], tri, False,
                                           memorize, max_memory_num, memorize_gt)
            return (pred,), after

        (pred,), count = self._serve((first_trimap3.dtype, max_memory_num, memorize_gt),
                                     (bank.count, bool(memorize)), inputs, bank, body)
        return MemoryBank(bank.keys, bank.values, count), pred


class AlphaGraphs(_StepGraphs):
    """`alpha_predict` of fba, served from CUDA graphs: call it as
    `alpha_predict` without the model.  The outputs of a replay are valid
    until the next call."""

    def __init__(self, fba: FBA):
        super().__init__(fba, fba.scale)
        self.fba = fba

    def __call__(self, frame01: torch.Tensor, trimap3: torch.Tensor, exact_edt: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        body = lambda statics, _: (alpha_predict(self.fba, *statics, exact_edt), None)
        return self._serve((exact_edt,), (), [frame01, trimap3], None, body)[0]
