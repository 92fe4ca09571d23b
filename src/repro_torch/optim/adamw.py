"""AdamW with decoupled weight decay (``repro.optim.adamw``), written out
over the parameter dict so the arithmetic is the reference's: bias
correction on both moments, ``eps`` outside the square root, and the
decay inside the update, ``u = -lr * (mhat / (sqrt(nhat) + eps) + wd * p)``.
(``torch.optim.AdamW`` decays the parameter before the step instead.)"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.optim.api import Optimizer, device_scalars


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """A correctly rounded f32 sqrt, in place, as the reference's.  On the
    card ``sqrt_`` is one; PyTorch's vectorized CPU sqrt is not (it moves
    about 0.6 % of f32 inputs by an ulp), so there the root is taken in
    f64, whose rounding to f32 is then the correctly rounded f32 root."""
    if x.device.type == "cpu":
        return x.copy_(x.double().sqrt_())
    return x.sqrt_()


def adamw(schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    def init(params: Dict[str, torch.Tensor]):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return {"mu": {k: zeros(p) for k, p in params.items()},
                "nu": {k: zeros(p) for k, p in params.items()}}

    def scalars(step: int) -> np.ndarray:
        """The update's per-step numbers, on the host in f32 as the
        reference computes them: -lr and the two bias corrections."""
        step1 = np.float32(step + 1)
        lr = float(schedule(step + 1))
        return np.array([-lr, np.float32(1) - np.float32(b1) ** step1,
                         np.float32(1) - np.float32(b2) ** step1], np.float32)

    @torch.no_grad()
    def update(grads, state, params, step, shards=None):
        # elementwise: a mesh rank's blocks update as the whole leaves
        # would, so ``shards`` (see ``optim.api``) is not read.  ``step``:
        # the step's number, or its ``scalars`` on the leaves' device (a
        # captured step's buffer).  The bias corrections are divided by
        # truly, as the reference's mu / c1: PyTorch on the card multiplies
        # by the reciprocal when the divisor is a Python number, so every
        # per-step number is a 0-dim tensor on the leaves' device
        per_device = {}
        updates = {}
        for k, g in grads.items():
            mu, nu, p = state["mu"][k], state["nu"][k], params[k]
            if mu.device not in per_device:
                per_device[mu.device] = device_scalars(scalars, step, mu.device).unbind()
            neg_lr, c1_t, c2_t = per_device[mu.device]
            g32 = g.float()
            mu.mul_(b1).add_(g32 * (1 - b1))
            nu.mul_(b2).add_(g32.square() * (1 - b2))
            denom = _sqrt(nu / c2_t).add_(eps)
            u = (mu / c1_t).div_(denom).add_(p.float() * weight_decay).mul_(neg_lr)
            updates[k] = u.to(p.dtype)
        return updates, state

    return Optimizer(init, update, scalars)
