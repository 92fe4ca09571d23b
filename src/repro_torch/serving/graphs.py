"""Capturing a step as a CUDA graph: both serving engines' steps, the
model drafter's forward and the train step.

The reference compiles each step shape once with ``jax.jit``; the port
captures the step's body once per shape as a ``torch.cuda.CUDAGraph``
and replays it.  The body reads only buffers its owner keeps for its
life (inputs, state, params) and no host value, so a replay recomputes
it on the inputs of the moment.  The kernels' launch counters
(``repro_torch.kernels.counters``) count neither the warm-up nor the
capture; the owner adds the capture's launches at each replay.  Where
the warm-up is a real step (a train step's updates its state), it is
counted, and its outputs are the step's.
"""
from __future__ import annotations

import gc
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import counters


class Captured(NamedTuple):
    graph: Any                  # torch.cuda.CUDAGraph
    out: Any                    # the body's outputs, which each replay overwrites
    launches: Tuple[int, ...]   # the kernel launches one replay makes (counters.since)
    graph_bytes: int            # what the capture added to the graphs' memory pool
    warm: Any = None            # the warm-up's outputs, where it was a real step


def capture(body: Callable[[], Any], device: torch.device, pool, what: str,
            real_warm_up: bool = False) -> Captured:
    """Capture ``body()`` as a CUDA graph on the memory pool ``pool``
    (None: a pool of the graph's own), after one warm-up on a side stream
    (the kernels' builds, cuBLAS's handles, the allocator's blocks: the
    warm-up runs the body, so its owner makes that harmless, or, with
    ``real_warm_up``, makes it the step it is: its launches stay counted
    and its outputs are ``warm``).  The garbage collector is off during
    the capture: freeing another engine's graph there (a reference cycle
    through a logit tap, say) is a CUDA call the capture does not permit,
    and it invalidates the capture.  A failure raises, naming ``what``."""
    before = counters.read()
    warm_launches: Tuple[int, ...] = ()
    try:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warm = body()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        if real_warm_up:
            warm_launches = counters.since(before)
        else:
            warm = None
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
        counters.add(warm_launches)
    return Captured(graph, out, launches, torch.cuda.memory_reserved(device) - reserved, warm)


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

    def capture(self, device: torch.device, pool, real_warm_up: bool = False):
        """Capture the body (``capture``); returns the warm-up's outputs
        where ``real_warm_up`` makes it a step, else None."""
        c = capture(self.body, device, pool, self.what, real_warm_up)
        self.graph, self.out, self.launches, self.graph_bytes = c[:4]
        return c.warm

    def run(self, inputs: Optional[torch.Tensor] = None):
        """``inputs`` copied into the input buffer (asynchronously from a
        pinned host buffer, which the caller then leaves alone until the
        copy is done; None: the owner filled it), then the body's outputs:
        the replay's (the launch counters add the capture's launches), or
        an eager call's."""
        if inputs is not None:
            self.inputs.copy_(inputs, non_blocking=True)
        if self.graph is None:
            return self.body()
        self.graph.replay()
        counters.add(self.launches)
        return self.out


class Staging:
    """A step's named inputs (``fields``: name -> (shape, dtype)) in one
    byte buffer twice: on the host (pinned on the card), where :meth:`put`
    writes them, and on the device, where the step reads them
    (``buffers``) and which :meth:`send` fills with one asynchronous copy.
    A ``put`` first waits for the last ``send`` to have read the host
    buffer, so a host running ahead of the card never overwrites inputs
    still to be copied."""

    def __init__(self, fields: Dict[str, Tuple[Sequence[int], torch.dtype]], device):
        device = torch.device(device)
        layout, n = {}, 0
        for k, (shape, dtype) in fields.items():
            size = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            layout[k] = (n, size, tuple(shape), dtype)
            n += -(-size // 16) * 16                      # every field 16-byte aligned
        cuda = device.type == "cuda"
        self.host = torch.zeros(n, dtype=torch.uint8, pin_memory=cuda)
        self.dev = torch.zeros(n, dtype=torch.uint8, device=device)

        def views(buf):
            return {k: buf[o:o + size].view(dtype).view(shape)
                    for k, (o, size, shape, dtype) in layout.items()}

        self.fields = {k: v.numpy() for k, v in views(self.host).items()}
        self.buffers = views(self.dev)
        self._sent = torch.cuda.Event() if cuda else None
        self._pending = False

    def put(self, values: Dict[str, Any]) -> None:
        """Write ``values`` (name -> array or number of the field's shape)
        into the host buffer."""
        if self._pending:
            self._sent.synchronize()
            self._pending = False
        for k, v in values.items():
            dst = self.fields[k]
            v = np.asarray(v)
            if v.shape != dst.shape:
                raise ValueError(f"staged {k!r} of shape {v.shape}, the buffer's is {dst.shape}")
            np.copyto(dst, v.astype(dst.dtype, copy=False))

    def send(self) -> None:
        """Copy the host buffer into the device buffer."""
        self.dev.copy_(self.host, non_blocking=True)
        if self._sent is not None:
            self._sent.record()
            self._pending = True


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
