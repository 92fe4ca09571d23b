"""What a ``meta`` trace of the program holds and runs: the peak bytes of
the live tensors, and the aten ops it ran (the counterpart of the
reference's ``hlo.op_histogram``, which reads them from compiled HLO).

:class:`MetaTrace` is a ``TorchDispatchMode``: every tensor an op returns
is counted at its storage's size from the op that made it until the last
tensor on that storage dies (a ``weakref.finalize`` on the storage, which
PyTorch keeps alive as long as any tensor views it), so views, in-place
ops and aliases count once.  Tensors made before the trace (parameters,
optimizer state, the batch) are counted from :meth:`MetaTrace.track`.  The
peak is the largest sum of live storages at any op's return: the bytes a
rank's caching allocator would have to hold at once, without its
rounding and fragmentation.  On ``meta`` tensors nothing is allocated and
nothing computed, so a trace of a 1 T-parameter step runs on a laptop.
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class MetaTrace(TorchDispatchMode):
    """Live and peak bytes of the tensors the trace holds, and a count of
    the aten ops it ran."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.ops: Counter = Counter()
        self._seen: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        weakref.finalize(st, self._free, key)

    def track(self, tree) -> "MetaTrace":
        """Count the tensors of ``tree`` (made before the trace) as live."""
        for leaf in tree_flatten(tree)[0]:
            if isinstance(leaf, torch.Tensor):
                self._add(leaf)
        self.peak = max(self.peak, self.live)
        return self

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops[func.overloadpacket.__name__] += 1
        for leaf in tree_flatten(out)[0]:
            if isinstance(leaf, torch.Tensor):
                self._add(leaf)
        self.peak = max(self.peak, self.live)
        return out

    def op_histogram(self, top: int = 25) -> Dict[str, int]:
        """The ``top`` most frequent aten ops and their counts."""
        return dict(self.ops.most_common(top))
