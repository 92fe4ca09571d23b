"""Train state (``repro.train.state``)."""
from __future__ import annotations

from typing import Any, NamedTuple


class TrainState(NamedTuple):
    params: Any                 # nested param tree; its leaves are the f32 masters
    opt_state: Any
    step: int
    error_feedback: Any = None  # int8-compression residual (compression not ported)


def init_train_state(params, optimizer, grad_compression: str = "none") -> TrainState:
    """``params`` is a training tree (``init_params(..., train=True)`` or
    ``from_jax_params(..., train=True)``); its leaves become autograd
    leaves.  The optimizer state is keyed by the flat parameter paths."""
    from repro_torch.nn import flat_params

    if grad_compression != "none":
        raise NotImplementedError(f"grad_compression {grad_compression!r} is not ported")
    flat = flat_params(params)
    for p in flat.values():
        p.requires_grad_(True)
    return TrainState(params, optimizer.init(flat), 0, None)
