"""Drafter contract for speculative decoding
(``repro.serving.speculative.base``).

A drafter proposes cheap continuation tokens for decode slots; the engine
verifies all of them in one step (``repro_torch.serving.continuous``) and
the acceptance rule (``speculative.accept``) keeps the output correct
whatever the drafter proposes.  The contract is host-side and batched:

* :meth:`Drafter.propose` receives one :class:`DraftItem` per speculating
  decode slot: the slot id, the slot's whole known context (prompt and
  every generated token, including the newest sample, not yet written to
  the KV cache), and the slot's draft budget (``gamma`` clamped to the
  request's remaining generation budget, so draft KV writes never pass
  ``total_len - 1`` and the admission-time block reservation covers them).
* It returns one int32 array per item, of length ``<= max_tokens``
  (shorter, even empty, means less speculation for that slot this step).
* Proposals are deterministic draft tokens: acceptance treats the draft
  distribution as a point mass, which keeps rejection sampling exact for
  any drafter.

Drafters may keep params, but no per-request state: the context arrives
fresh every call, so slot reuse and rollback cannot desynchronize one.
"""
from __future__ import annotations

import dataclasses
from typing import List, Protocol, runtime_checkable

import numpy as np


@dataclasses.dataclass(frozen=True)
class DraftItem:
    """One speculating slot's view for a drafter."""

    slot: int               # decode slot id
    context: np.ndarray     # (L,) int32: prompt + all generated tokens
    max_tokens: int         # draft budget for this slot this step (>= 1)


@runtime_checkable
class Drafter(Protocol):
    name: str

    def propose(self, items: List[DraftItem]) -> List[np.ndarray]:
        """Return up to ``item.max_tokens`` int32 draft tokens per item."""
        ...
