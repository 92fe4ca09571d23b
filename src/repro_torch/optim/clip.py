"""Global-norm gradient clipping (``repro.optim.clip``)."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


def global_norm(grads: Dict[str, torch.Tensor],
                sum_squares: Optional[Callable[[Dict[str, torch.Tensor]], torch.Tensor]] = None
                ) -> torch.Tensor:
    """sqrt of the sum over leaves, in the order given, of each leaf's sum
    of squares in f32.  On a mesh, where a leaf is a rank's block,
    ``sum_squares(grads)`` gives the whole gradient's sum of squares."""
    if sum_squares is not None:
        return torch.sqrt(sum_squares(grads))
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        sum_squares: Optional[Callable] = None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    norm = global_norm(grads, sum_squares)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, norm
