"""Capturing a serving step as a CUDA graph, for both engines.

The reference compiles each step shape once with ``jax.jit``; the port
captures the step's body once per shape as a ``torch.cuda.CUDAGraph``
and replays it.  The body reads only buffers its owner keeps for its
life (inputs, state, params) and no host value, so a replay recomputes
it on the inputs of the moment.  The kernels' launch counters
(``repro_torch.kernels.counters``) count neither the warm-up nor the
capture; the owner adds the capture's launches at each replay.
"""
from __future__ import annotations

import gc
from typing import Any, Callable, NamedTuple, Tuple

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import counters


class Captured(NamedTuple):
    graph: Any                  # torch.cuda.CUDAGraph
    out: Any                    # the body's outputs, which each replay overwrites
    launches: Tuple[int, ...]   # the kernel launches one replay makes (counters.since)
    graph_bytes: int            # what the capture added to the graphs' memory pool


def capture(body: Callable[[], Any], device: torch.device, pool, what: str) -> Captured:
    """Capture ``body()`` as a CUDA graph on the memory pool ``pool``,
    after one warm-up on a side stream (the kernels' builds, cuBLAS's
    handles, the allocator's blocks: the warm-up runs the body, so its
    owner makes that harmless).  The garbage collector is off during the
    capture: freeing another engine's graph there (a reference cycle
    through a logit tap, say) is a CUDA call the capture does not permit,
    and it invalidates the capture.  A failure raises, naming ``what``."""
    before = counters.read()
    try:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        counters.write(before)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool):
                out = body()
        finally:
            if collecting:
                gc.enable()
        launches = counters.since(before)
    except RuntimeError as e:
        raise RuntimeError(f"capturing {what} as a CUDA graph failed: {e}") from e
    finally:
        counters.write(before)
    return Captured(graph, out, launches, torch.cuda.memory_reserved(device) - reserved)


class GraphForm:
    """One static step form: ``body()`` over buffers its owner keeps for
    its life (its input buffer ``inputs``, the state it updates, the
    params), a variant of the reference's jit cache.  After
    :meth:`capture` (on the card) a run is a replay of the captured graph,
    whose outputs ``out`` it overwrites; else a run calls the body
    eagerly."""

    def __init__(self, body: Callable[[], Any], what: str, inputs: torch.Tensor):
        self.body, self.what, self.inputs = body, what, inputs
        self.graph = None
        self.out = None
        self.launches: Tuple[int, ...] = ()
        self.graph_bytes = 0

    def capture(self, device: torch.device, pool) -> None:
        self.graph, self.out, self.launches, self.graph_bytes = capture(
            self.body, device, pool, self.what)

    def run(self, inputs: torch.Tensor):
        """``inputs`` copied into the input buffer, then the body's outputs:
        the replay's (the launch counters add the capture's launches), or
        an eager call's."""
        self.inputs.copy_(inputs)
        if self.graph is None:
            return self.body()
        self.graph.replay()
        counters.add(self.launches)
        return self.out


def copy_state(dst, src) -> None:
    """Copy a step's new state ``src`` into the persistent ``dst`` (the
    same tree of tensors), skipping a leaf the step wrote in place (the
    same tensor): the KV caches, zamba's Mamba2 states; a new length and
    xLSTM's new states are copied."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if d is not s:
            d.copy_(s)


def zero_state(state) -> None:
    """Every tensor of ``state`` set to 0 in place: a fresh ``init_state``."""
    for t in tree_leaves(state):
        t.zero_()
