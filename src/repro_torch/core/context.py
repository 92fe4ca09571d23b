"""``MoEContext``: per-call side information threaded to MoE layers
(``repro.core.context``).  All fields are optional; ``MoEContext()`` is a
valid "know nothing" context."""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class MoEContext:
    token_ids: Optional[torch.Tensor] = None   # (B, S) int32; -1 = no identity
    positions: Optional[torch.Tensor] = None   # (B, S) absolute positions
    rng: Optional[torch.Generator] = None
    step: Optional[Union[int, torch.Tensor]] = None  # a captured train step's: 0-dim, on the device
    is_training: bool = False

    def replace(self, **kw) -> "MoEContext":
        return dataclasses.replace(self, **kw)

    def with_tokens(self, token_ids, positions, prefix_len: int = 0) -> "MoEContext":
        if token_ids is not None and prefix_len:
            pad = torch.full((token_ids.shape[0], prefix_len), -1,
                             dtype=token_ids.dtype, device=token_ids.device)
            token_ids = torch.cat([pad, token_ids], dim=1)
        return dataclasses.replace(self, token_ids=token_ids, positions=positions)

    def grouped(self, G: int, T: int) -> "MoEContext":
        """Reshape (B, S) fields to the router's (G, T) group layout."""
        def regroup(a):
            return None if a is None else a.reshape(G, T)

        return dataclasses.replace(self, token_ids=regroup(self.token_ids),
                                   positions=regroup(self.positions))
