"""AdamW with decoupled weight decay (``repro.optim.adamw``), written out
over the parameter dict so the arithmetic is the reference's: bias
correction on both moments, ``eps`` outside the square root, and the
decay inside the update, ``u = -lr * (mhat / (sqrt(nhat) + eps) + wd * p)``.
(``torch.optim.AdamW`` decays the parameter before the step instead.)"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.optim.api import Optimizer


def adamw(schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    def init(params: Dict[str, torch.Tensor]):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return {"mu": {k: zeros(p) for k, p in params.items()},
                "nu": {k: zeros(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step: int):
        step1 = np.float32(step + 1)
        lr = float(schedule(step + 1))
        # the bias corrections in f32, as the reference computes them
        c1 = float(np.float32(1) - np.float32(b1) ** step1)
        c2 = float(np.float32(1) - np.float32(b2) ** step1)
        updates = {}
        for k, g in grads.items():
            mu, nu, p = state["mu"][k], state["nu"][k], params[k]
            g32 = g.float()
            mu.mul_(b1).add_(g32 * (1 - b1))
            nu.mul_(b2).add_(g32.square() * (1 - b2))
            denom = (nu / c2).sqrt_().add_(eps)
            u = (mu / c1).div_(denom).add_(p.float() * weight_decay).mul_(-lr)
            updates[k] = u.to(p.dtype)
        return updates, state

    return Optimizer(init, update)
