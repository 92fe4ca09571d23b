"""Train state (``repro.train.state``)."""
from __future__ import annotations

from typing import Any, NamedTuple


class TrainState(NamedTuple):
    params: Any                 # nested param tree; its leaves are the f32 masters
    opt_state: Any
    step: int
    error_feedback: Any = None  # int8-compression residual, f32, keyed by flat path


def init_train_state(params, optimizer, grad_compression: str = "none",
                     layout=None) -> TrainState:
    """``params`` is a training tree (``init_params(..., train=True)`` or
    ``from_jax_params(..., train=True)``; on a mesh, a rank's blocks of
    it); its leaves become autograd leaves.  The optimizer state and, under
    ``int8`` compression, the zero error-feedback residual are keyed by the
    flat parameter paths; with ``layout`` (a mesh rank's ``MeshLayout``)
    the optimizer state is of the rank's ZeRO-1 blocks."""
    import torch

    from repro_torch.nn import flat_params

    flat = flat_params(params)
    for p in flat.values():
        p.requires_grad_(True)
    ef = None
    if grad_compression == "int8":
        ef = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in flat.items()}
    if layout is not None:
        with torch.no_grad():
            flat = {k: layout.zero_block(k, p.detach()) for k, p in flat.items()}
    return TrainState(params, optimizer.init(flat), 0, ef)
