"""Optimizer interface (``repro.optim.api``): a pair of functions over the
flat parameter dict,

  init(params) -> state
  update(grads, state, params, step, shards=None) -> (updates, new_state)
  scalars(step) -> the update's per-step numbers, f32 on the host

with the updates *added* to the params by the trainer.  ``step`` is the
step's number, or ``scalars(step)`` already on the leaves' device: a
captured train step reads them from a buffer its owner fills before each
replay, where a Python number would be frozen into the graph.  On a mesh the
leaves are a rank's blocks and ``shards`` (path -> ``sharding.Blocks``)
lets an optimizer that reduces over a leaf (Adafactor) sum over the
whole of it.  The port's
optimizers update their state tensors in place and return the same
objects (the reference's jit donates the old state, so nothing reads it
again)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]
    scalars: Callable[[int], np.ndarray]


def device_scalars(scalars: Callable[[int], np.ndarray], step: Union[int, torch.Tensor],
                   device: torch.device) -> torch.Tensor:
    """``step``'s per-step numbers on ``device``: ``step`` itself where it
    is them already (a tensor on ``device``), else ``scalars(step)``
    computed on the host and copied there."""
    if isinstance(step, torch.Tensor):
        if step.device != device:
            raise ValueError(f"the step's numbers are on {step.device}, the leaves on {device}")
        return step
    return torch.from_numpy(scalars(step)).to(device)


def make_optimizer(tc: TrainConfig, schedule: Callable[[int], float]) -> Optimizer:
    if tc.optimizer == "adamw":
        from repro_torch.optim.adamw import adamw

        return adamw(schedule, weight_decay=tc.weight_decay)
    if tc.optimizer == "adafactor":
        from repro_torch.optim.adafactor import adafactor

        return adafactor(schedule)
    raise ValueError(f"unknown optimizer {tc.optimizer!r}")
