"""A trainer's step as CUDA graphs, one per batch shape.

Port-only: the JAX package compiles its step with ``jit``, while PyTorch's
eager step pays the host once per op (~280 kernels in a flagship D-LSTM
step at batch 8 on the fused train route, ``ops/cuda/fused_train.py``, and
~2,400 on the grid route, each ~20-40 us of host time against ~2 us of
device time).
``StepGraphs`` follows the "whole network capture" pattern of PyTorch's
CUDA graphs notes:

- a step's key is its batch's shapes and dtypes, its ``start_length`` and
  which of the goals and slot mask are None (``step_key``);
- the first ``WARM_CALLS`` calls with a new key run eagerly, on a side
  stream: real optimizer steps on real batches, which make Adam's lazy
  state, cuBLAS's handles and workspaces and the kernels' shared-memory
  opt-in before anything is captured;
- the next call captures the step (forward, backward, clip, Adam) into a
  ``torch.cuda.CUDAGraph`` with a private memory pool of its own, reading
  static input buffers and writing a static loss; capturing runs nothing,
  so the graph is then replayed once for that batch;
- every later call copies its batch into the static buffers, replays the
  graph and returns a clone of the static loss: callers keep an epoch's
  losses, which must not all alias the last one.

A replay changes tensors behind autograd's back: the leaves' version
counters are bumped after it, so that a cache keyed on them (the fused
step's packed weights, ``ops/cuda/fused_step.packed_weights``) sees the
update.  The port's launch counters count launches the card ran: a capture
runs the kernels' wrappers but launches nothing, and a replay launches the
kernels without running their wrappers, so the capture's counts are taken
back out and added again on every replay.  A restored optimizer state
(``load_state_dict`` replaces the moments and the tensor learning rate the
graphs read) drops every graph; the next calls warm up and capture again.

The optimizer a graph holds is ``capturable_optimizer``'s: Adam with
``capturable=True`` (its step count and bias correction on the device) and
a 0-dim learning rate on the device, which ``common.set_lr`` fills in place.
A trainer on the card takes it on a mesh too, where its step stays eager,
so that ranks step as one process does: its bias correction, in f32 on the
card, moves a run's leaves off those of Adam's host-side correction
(``chip_smoke.py`` phase 6b prints by how much).  Which trainer replays
graphs is ``takes_graphs``: one on a CUDA device in one process.  On the
CPU there is nothing to capture, and on a mesh a gloo collective cannot be
captured, so those steps stay eager.
"""

import warnings
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.autograd.graph import increment_version

from ..ops.cuda import fused_step, fused_train

WARM_CALLS = 3  # eager calls of a key before its capture

# the launch counters of the port's kernels: (wrapper, attribute)
COUNTERS = ((fused_step.fused_dlstm_step, "launches"),
            (fused_step.directional_grid, "launches"),
            (fused_step.directional_grid, "bf16_launches"),
            *((kernel, "launches") for kernel in fused_train.KERNELS))


def takes_graphs(device: torch.device, mesh) -> bool:
    """Whether a trainer on ``device`` and ``mesh`` (None: one process)
    replays its step as CUDA graphs."""
    return torch.device(device).type == "cuda" and mesh is None


def capturable_optimizer(leaves: Sequence[torch.Tensor], lr: float = 1e-3,
                         weight_decay: float = 1e-4) -> torch.optim.Adam:
    """``common.make_optimizer``'s Adam in a form a graph can hold: the step
    count and bias correction on the device (``capturable``), the learning
    rate a 0-dim tensor on the leaves' device."""
    leaves = list(leaves)
    rate = torch.full((), lr, dtype=torch.float32, device=leaves[0].device)
    return torch.optim.Adam(leaves, lr=rate, weight_decay=weight_decay, capturable=True)


def step_key(batch: Sequence[Optional[torch.Tensor]], start_length: int) -> Tuple:
    """The graph key of a step: each batch tensor's shape and dtype (None
    where absent) and ``start_length``."""
    return (tuple(None if x is None else (tuple(x.shape), x.dtype) for x in batch),
            int(start_length))


def read_counters() -> Tuple[int, ...]:
    return tuple(getattr(fn, attr) for fn, attr in COUNTERS)


def add_counters(counts: Sequence[int]) -> None:
    for (fn, attr), n in zip(COUNTERS, counts):
        setattr(fn, attr, getattr(fn, attr) + n)


class CudaGraph:
    """One captured step: a ``torch.cuda.CUDAGraph`` captured on ``stream``
    in a private memory pool of its own."""

    def __init__(self, stream):
        self.graph = torch.cuda.CUDAGraph()
        self.stream = stream

    def capture(self, fn: Callable):
        with torch.cuda.graph(self.graph, stream=self.stream):
            return fn()

    def replay(self) -> None:
        self.graph.replay()


class Captured(NamedTuple):
    graph: object  # CudaGraph, or a stand-in with capture() and replay()
    inputs: Tuple[Optional[torch.Tensor], ...]  # the static batch buffers
    loss: torch.Tensor  # the static loss
    counts: Tuple[int, ...]  # launches one replay makes, by ``COUNTERS``


class StepGraphs:
    """The per-key graphs of one trainer's step (module docstring).

    ``optimizer``: the trainer's, whose params a replay updates and whose
    state, once restored, drops the graphs.  ``new_graph``: a graph's
    maker; None captures ``CudaGraph`` on a side stream of the optimizer's
    device, anything else (a stand-in for the CPU tests) runs the eager
    calls on the current stream."""

    def __init__(self, optimizer: torch.optim.Optimizer, new_graph=None):
        self.optimizer = optimizer
        self.leaves = [p for group in optimizer.param_groups for p in group["params"]]
        self.stream = None
        if new_graph is None:
            self.stream = torch.cuda.Stream(device=self.leaves[0].device)
            new_graph = lambda: CudaGraph(self.stream)  # noqa: E731
        self.new_graph = new_graph
        self.warm: Dict[Tuple, int] = {}  # eager calls made, by key
        self.graphs: Dict[Tuple, Captured] = {}
        self._state = optimizer.state

    def step(self, fn: Callable, batch: Sequence[Optional[torch.Tensor]],
             start_length: int) -> torch.Tensor:
        """``fn(*batch, start_length)``, one optimizer step returning its
        loss: eager for a key's first ``WARM_CALLS`` calls, then a replay of
        its graph.  Returns the loss, a tensor of its own."""
        if self.optimizer.state is not self._state:  # restored: the graphs hold stale tensors
            self.warm.clear()
            self.graphs.clear()
            self._state = self.optimizer.state
        key = step_key(batch, start_length)
        captured = self.graphs.get(key)
        if captured is None:
            if self.warm.get(key, 0) < WARM_CALLS:
                self.warm[key] = self.warm.get(key, 0) + 1
                return self._eager(fn, batch, start_length)
            captured = self.graphs[key] = self._capture(fn, batch, start_length)
        return self._replay(captured, batch)

    def _eager(self, fn, batch, start_length):
        with warnings.catch_warnings():
            # capturable Adam warns once when it steps outside a capture
            warnings.filterwarnings("ignore", message=".*capturable=True.*")
            if self.stream is None:
                return fn(*batch, start_length)
            main = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                loss = fn(*batch, start_length)
            main.wait_stream(self.stream)
        loss.record_stream(main)  # made on the side stream, read on the main one
        return loss

    def _capture(self, fn, batch, start_length) -> Captured:
        inputs = tuple(None if x is None else x.clone() for x in batch)
        graph = self.new_graph()
        before = read_counters()
        loss = graph.capture(lambda: fn(*inputs, start_length))
        counts = tuple(after - b for after, b in zip(read_counters(), before))
        add_counters([-n for n in counts])  # the capture launched nothing
        return Captured(graph, inputs, loss, counts)

    def _replay(self, captured: Captured, batch) -> torch.Tensor:
        for buffer, x in zip(captured.inputs, batch):
            if buffer is not None:
                buffer.copy_(x)
        captured.graph.replay()
        increment_version(self.leaves)
        add_counters(captured.counts)
        return captured.loss.clone()
