"""Optimizer interface (``repro.optim.api``): a pair of functions over the
flat parameter dict,

  init(params) -> state
  update(grads, state, params, step, shards=None) -> (updates, new_state)

with the updates *added* to the params by the trainer.  On a mesh the
leaves are a rank's blocks and ``shards`` (path -> ``sharding.Blocks``)
lets an optimizer that reduces over a leaf (Adafactor) sum over the
whole of it.  The port's
optimizers update their state tensors in place and return the same
objects (the reference's jit donates the old state, so nothing reads it
again)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import TrainConfig


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def make_optimizer(tc: TrainConfig, schedule: Callable[[int], float]) -> Optimizer:
    if tc.optimizer == "adamw":
        from repro_torch.optim.adamw import adamw

        return adamw(schedule, weight_decay=tc.weight_decay)
    if tc.optimizer == "adafactor":
        from repro_torch.optim.adafactor import adafactor

        return adafactor(schedule)
    raise ValueError(f"unknown optimizer {tc.optimizer!r}")
