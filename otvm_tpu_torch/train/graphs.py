"""The compiled train steps: `make_train_step`'s and
`make_trimap_s1_train_step`'s step replayed from a CUDA graph, the port's
counterpart of the JAX package's jitted `train_step`
(otvm_tpu/train/trainer.py:104-115, 149-170: decode, forward, gradient
and the RAdam update as one executable).

Eagerly a stage-4 step leaves the host as ~25k launches; here the whole
step (the wire batch's decode, trimap-s1's compositing, the forward and
loss, autograd's backward and RAdam's update) is captured once per key into
a CUDA graph, and each later step with that key is one `replay()`.  The
workings are models/graphs.py's (`GraphCache`, shared with the serving
steps): a capture stream of the cache's own, on which warm-ups and
captures run, the read's launches recorded at the capture
(`memory_attn.record_launches`) and counted at each replay
(`count_launches`); one memory pool for all the cache's graphs (one a
key; a Loader's batches, which drop the last partial one, make one key),
static inputs outside it.

Key: the step's own settings (kind and stage, compute dtype, remat), the
wire batch's names, shapes, strides and dtypes, the device, and a process
group's size and backend.  The static inputs take the batch's strides, as
the eager step's copy to the device does: a reduction over another layout
sums in another order.  A key's first call runs the step eagerly on the
capture stream: the warm-up,
whose results are that step's, and which makes every lazy thing the step
needs (the read's library, cluster table and the capture stream's L2
workspace, cuDNN's plans, the losses' constants, RAdam's moments).  Its
second call captures the step and replays it; each later call replays.
Capture follows torch's whole-network recipe: the gradients are set to
None before it, so the captured backward makes them in the pool, and each
replay writes them there again.  The graph keeps those tensors, and a
replay binds them back to the parameters' `.grad` (an eager step between
two replays sets new ones), so `.grad` after a step is that step's.

What a graph holds.  The addresses of the modules' parameters and
buffers, RAdam's moments and device step, the static inputs, the L2
workspace of the capture stream (never freed).  `optimizer.
load_state_dict`, `restore_train_state` and modules' `load_state_dict`
copy into those tensors, so a graph stays valid across them; a state whose
tensors were replaced (another state, `convert.radam_state_from_jax`, a
swapped module) raises at the next replay.

Host state.  RAdam's host count, `state.step` and the moments' allocation
are host work: done once per call outside the captured region (`prepare`
before, `advance` after), never by a capture.  The step's scalars come
from RAdam's device step (train/optim.py), so each replay takes its own
learning rate and step size.

Data parallelism (the JAX package's step over its data mesh, one
executable with jit's psums in it).  A state with an NCCL process group
replays on every rank one graph a step that holds the rank's collectives
too: GlobalSum's all-reduce in the forward and in the backward (the
exclusion loss's global-batch means) and the bucketed gradient all-reduce
after the backward (parallel/dist.py).  The gradients' host part, which
parameters any rank holds a gradient for, is a plan made by the key's
eager first step (one collective, read on the host) and kept per key
(`D.GradientPlans`); the graph holds its device part, which reads nothing
back.  That first step also makes NCCL's communicator before any capture.
Collectives in graphs pair up across ranks only if every rank captures and
replays the same keys in the same order: before a key's first step the
ranks compare digests of their keys in one collective, and a mismatch
raises on every rank (`D.check_same_key`).  Every collective is
synchronous (async_op=False), as in the eager step: NCCL's stream waits
for the work before it and the step's stream for NCCL's, so no collective
runs beside the fp32 reads' cooperative L2 merge, which needs its whole
grid on the card.  gloo's collectives run on the host and cannot be
captured: a state with a gloo group is refused (`refusal`).

Spans (utils/trace.py): train.upload (the static inputs' copy, which
waits for the stream), train.prepare (RAdam's host count, the check of the
tensors a graph holds), train.replay (the launch, the gradients bound
back), train.advance (the metrics' copies, RAdam's host state), inside
the trainer's train.step.

Metrics are copies out of the pool (the next replay overwrites it), so a
caller may keep them across steps.  A failed warm-up, capture or replay
raises; nothing gives way to the eager step.  A step under a lockstep
check raises (tools/kernel_check.py: its host comparison cannot see a
replay), as does a state with a gloo group or on the CPU.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from ..kernels import memory_attn as ma
from ..models.graphs import GraphCache, Launches
from ..parallel import dist as D
from ..utils import trace

# forward(state, the wire batch's tensors on the device) -> (loss, metrics)
Forward = Callable[[object, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    metrics: Dict[str, torch.Tensor]        # in the pool
    grads: List[Optional[torch.Tensor]]     # the parameters' gradients, in the pool
    launches: Launches                      # the kernels it launches
    held: tuple                             # the state's tensors it addresses (_held)


def refusal(state) -> Optional[str]:
    """Why the train step cannot run from a CUDA graph for `state`, or None."""
    if state.device.type != "cuda":
        return "CUDA graphs run on a CUDA card; on the CPU the eager step is the only one"
    if state.group is not None and D.group_backend(state.group) != "nccl":
        return (f"a state whose process group is {D.group_backend(state.group)} takes the eager "
                "step: gloo's collectives run on the host and cannot be captured in a CUDA "
                "graph (NCCL's can)")
    return None


def _held(state) -> tuple:
    """Identifies the tensors a graph of `state`'s step addresses."""
    opt = state.optimizer
    params = opt.param_groups[0]["params"]
    tensors = itertools.chain(state.stm.parameters(), state.stm.buffers(),
                              state.fba.parameters(), state.fba.buffers(), params,
                              (opt.state[p][k] for p in params for k in ("exp_avg", "exp_avg_sq")),
                              (opt.device_step,))
    return (id(state.stm), id(state.fba), id(opt), tuple(t.data_ptr() for t in tensors))


class TrainStepGraphs(GraphCache):
    """A train step served from CUDA graphs: `forward` and its loss's
    backward and RAdam update, captured per key.  `static` names the step's
    own settings (kind, stage, compute dtype, remat) in the key.  Call it
    as the train step: (state, batch) -> metrics.  See the module's
    docstring."""

    def __init__(self, forward: Forward, static: tuple):
        super().__init__()
        self.forward, self.static = forward, static
        self.pool = None
        # key -> its graph, or None after the warm-up
        self._graphs: Dict[tuple, Optional[_Graph]] = {}
        self._inputs: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self.plans = D.GradientPlans()      # a process group's gradient plan, per key

    def __call__(self, state, batch: Mapping) -> Dict[str, torch.Tensor]:
        why = refusal(state)
        if why:
            raise ValueError(why)
        if ma.host_checks:
            raise RuntimeError("a lockstep check is active, and it cannot see the reads of a "
                               "captured train step: use graphs=False to check")
        device, group = state.device, state.group
        host = {k: torch.as_tensor(v) for k, v in batch.items()}
        ranks = None if group is None else (dist.get_world_size(group), D.group_backend(group))
        shared = (self.static, ranks, tuple((k, tuple(x.shape), x.stride(), x.dtype)
                                            for k, x in sorted(host.items())))
        key = (device, shared)
        with torch.cuda.device(device):
            if self.pool is None:
                self._stream_on(device)
                self.pool = torch.cuda.graph_pool_handle()
            with trace.span("train.upload"):
                statics = self._statics(key, host, device)
            opt = state.optimizer
            warm = key not in self._graphs
            with trace.span("train.prepare"):
                opt.prepare()
                entry = self._graphs.get(key)
                if entry is not None and entry.held != _held(state):
                    raise RuntimeError(
                        "the train state's modules, parameters, RAdam moments or step count are "
                        "not the tensors its CUDA graph was captured with (a replaced module or "
                        "optimizer state, convert.radam_state_from_jax, another state): make a "
                        "new train step for this state")
            if warm:
                if group is not None:       # before the key's first collective
                    D.check_same_key(shared, group, device)
                metrics = self._warm_up(lambda: self._first(state, statics, key))
                for x in metrics.values():
                    x.record_stream(torch.cuda.current_stream())
                self._graphs[key] = None
            else:
                if entry is None:
                    entry = self._graphs[key] = self._captured(state, statics, key)
                with trace.span("train.replay"):
                    self._replay(entry.graph, entry.launches)
                    for p, g in zip(opt.param_groups[0]["params"], entry.grads):
                        p.grad = g
            with trace.span("train.advance"):
                if not warm:
                    metrics = {k: v.clone() for k, v in entry.metrics.items()}
                opt.advance()
        state.step += 1
        return metrics

    def _statics(self, key: tuple, host: Dict[str, torch.Tensor], device
                 ) -> Dict[str, torch.Tensor]:
        """The key's static inputs (outside the pool), holding `host`."""
        if key not in self._inputs:
            # the layout the eager step's copy would have (x.to(device) keeps
            # the strides of a dense tensor): the ops, and their bits, follow it
            self._inputs[key] = {k: torch.empty_like(x, device=device) for k, x in host.items()}
        statics = self._inputs[key]
        for k, x in host.items():
            statics[k].copy_(x)
        return statics

    def _device_step(self, state, statics: Dict[str, torch.Tensor], key: tuple
                     ) -> Dict[str, torch.Tensor]:
        """What a graph holds: forward, backward, with a process group the
        gradients' mean over the ranks (the key's plan: made by the eager
        first step, its device part alone in the graph), RAdam's device
        work."""
        loss, metrics = self.forward(state, dict(statics))
        loss.backward()
        if state.group is not None:
            self.plans(key, state.optimizer.param_groups[0]["params"], state.group)
        state.optimizer.update()
        return {k: v.detach() for k, v in metrics.items()}

    def _first(self, state, statics, key: tuple) -> Dict[str, torch.Tensor]:
        """The key's first step, eager (run on the capture stream)."""
        state.optimizer.zero_grad(set_to_none=True)
        return self._device_step(state, statics, key)

    def _captured(self, state, statics, key: tuple) -> _Graph:
        """The key's step captured into the pool (run by the replay that
        follows)."""
        state.optimizer.zero_grad(set_to_none=True)
        graph, metrics, launches = self._capture(self.pool,
                                                 lambda: self._device_step(state, statics, key))
        grads = [p.grad for p in state.optimizer.param_groups[0]["params"]]
        return _Graph(graph, metrics, grads, launches, _held(state))
