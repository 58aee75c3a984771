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
wire batch's names, shapes, strides and dtypes, and the device.  The
static inputs take the batch's strides, as the eager step's copy to the
device does: a reduction over another layout sums in another order.  A
key's first call runs the step eagerly on the capture stream: the warm-up,
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

Metrics are copies out of the pool (the next replay overwrites it), so a
caller may keep them across steps.  A failed warm-up, capture or replay
raises; nothing gives way to the eager step.  A step under a lockstep
check raises (tools/kernel_check.py: its host comparison cannot see a
replay), as does a state with a process group (the gradient all-reduce
reads the host) or on the CPU.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from ..kernels import memory_attn as ma
from ..models.graphs import GraphCache

# forward(state, the wire batch's tensors on the device) -> (loss, metrics)
Forward = Callable[[object, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    metrics: Dict[str, torch.Tensor]        # in the pool
    grads: List[Optional[torch.Tensor]]     # the parameters' gradients, in the pool
    reads: List[Tuple[int, int]]            # the reads it launches (record_launches)
    held: tuple                             # the state's tensors it addresses (_held)


def refusal(state) -> Optional[str]:
    """Why the train step cannot run from a CUDA graph for `state`, or None."""
    if state.device.type != "cuda":
        return "CUDA graphs run on a CUDA card; on the CPU the eager step is the only one"
    if state.group is not None:
        return ("a state with a process group takes the eager step: its gradient all-reduce "
                "reads the host and gloo cannot be captured")
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

    def __call__(self, state, batch: Mapping) -> Dict[str, torch.Tensor]:
        why = refusal(state)
        if why:
            raise ValueError(why)
        if ma.host_checks:
            raise RuntimeError("a lockstep check is active, and it cannot see the reads of a "
                               "captured train step: use graphs=False to check")
        device = state.device
        host = {k: torch.as_tensor(v) for k, v in batch.items()}
        key = (self.static, device, tuple((k, tuple(x.shape), x.stride(), x.dtype)
                                          for k, x in sorted(host.items())))
        with torch.cuda.device(device):
            if self.pool is None:
                self._stream_on(device)
                self.pool = torch.cuda.graph_pool_handle()
            statics = self._statics(key, host, device)
            opt = state.optimizer
            opt.prepare()
            if key not in self._graphs:
                metrics = self._warm_up(lambda: self._first(state, statics))
                for x in metrics.values():
                    x.record_stream(torch.cuda.current_stream())
                self._graphs[key] = None
            else:
                entry = self._graphs[key]
                if entry is None:
                    entry = self._graphs[key] = self._captured(state, statics)
                elif entry.held != _held(state):
                    raise RuntimeError(
                        "the train state's modules, parameters, RAdam moments or step count are "
                        "not the tensors its CUDA graph was captured with (a replaced module or "
                        "optimizer state, convert.radam_state_from_jax, another state): make a "
                        "new train step for this state")
                self._replay(entry.graph, entry.reads)
                for p, g in zip(opt.param_groups[0]["params"], entry.grads):
                    p.grad = g
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

    def _device_step(self, state, statics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """What a graph holds: forward, backward, RAdam's device work."""
        loss, metrics = self.forward(state, dict(statics))
        loss.backward()
        state.optimizer.update()
        return {k: v.detach() for k, v in metrics.items()}

    def _first(self, state, statics) -> Dict[str, torch.Tensor]:
        """The key's first step, eager (run on the capture stream)."""
        state.optimizer.zero_grad(set_to_none=True)
        return self._device_step(state, statics)

    def _captured(self, state, statics) -> _Graph:
        """The key's step captured into the pool (run by the replay that
        follows)."""
        state.optimizer.zero_grad(set_to_none=True)
        graph, metrics, reads = self._capture(self.pool,
                                              lambda: self._device_step(state, statics))
        grads = [p.grad for p in state.optimizer.param_groups[0]["params"]]
        return _Graph(graph, metrics, grads, reads, _held(state))
