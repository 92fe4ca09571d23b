"""Adafactor (Shazeer & Stern 2018), the reference's
(``repro.optim.adafactor``): second moments factored into row and column
means for every leaf of two or more dims (a stacked expert tensor
(..., E, M, I) per expert, over its last two axes), decay
``beta2 = 1 - t^-0.8``, update clipping at RMS 1.0, and the step scaled by
the parameter's RMS.  The paper fitted its 1T model's optimizer state
with it, at lr 5e-3.

State: ``{"v": {<flat path>: {"vr", "vc"} | {"v"}}}``, f32, updated in
place; ``checkpoint.leaves`` gives its leaves the reference's keys
(``.opt_state['v']['embed']['table']['vc']``).

On a mesh a leaf is a rank's block (``shards``, path ->
:class:`~repro_torch.distributed.sharding.Blocks`): the row and column
means, the mean of the row statistics and the update and parameter RMS
are sums over the whole leaf, all-reduced over the axes that cut the
summed dims, divided by the whole leaf's counts; the factored statistics
are the blocks of the whole leaf's.

Numerics follow AdamW's rules (``optim/adamw.py``): every mean is a sum
divided by a 0-dim tensor on the leaf's device (PyTorch on the card
multiplies by the reciprocal of a Python number), and the square roots
are correctly rounded on the CPU as well (``adamw._sqrt``).  Sums are
taken in PyTorch's order, not XLA's, so the update agrees with the
reference's to rounding, not bit for bit.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.optim.adamw import _sqrt
from repro_torch.optim.api import Optimizer, device_scalars


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor(schedule, eps1: float = 1e-30, eps2: float = 1e-3,
              clip_threshold: float = 1.0, decay_pow: float = 0.8,
              multiply_by_parameter_scale: bool = True) -> Optimizer:
    def init(params: Dict[str, torch.Tensor]):
        def one(p):
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}

        return {"v": {k: one(p) for k, p in params.items()}}

    def scalars(step: int) -> np.ndarray:
        """The update's per-step numbers in f32, as the reference computes
        them: beta2, 1 - beta2 and the learning rate."""
        t = np.float32(step + 1)
        beta2 = np.float32(1) - t ** np.float32(-decay_pow)
        return np.array([beta2, np.float32(1) - beta2, np.float32(schedule(step + 1))],
                        np.float32)

    @torch.no_grad()
    def update(grads, state, params, step, shards=None):
        # ``step``: the step's number, or its ``scalars`` on the leaves'
        # device (a captured step's buffer); each a 0-dim tensor there
        per_device = {}
        consts: Dict[torch.device, Dict[str, torch.Tensor]] = {}

        def const(device, name, value):
            d = consts.setdefault(device, {})
            if name not in d:
                d[name] = torch.full((), value, dtype=torch.float32, device=device)
            return d[name]

        def mean(x, dim=None, keepdim=False, blocks=None):
            if blocks is None:
                n = x.numel() if dim is None else x.shape[dim]
                s = x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)
            else:
                s, n = blocks.sum(x, dim, keepdim)
            return s / const(x.device, f"n{n}", n)

        updates = {}
        for k, g in grads.items():
            v, p = state["v"][k], params[k]
            blk = None if shards is None else shards[k]
            dev = p.device
            if dev not in per_device:
                per_device[dev] = device_scalars(scalars, step, dev).unbind()
            beta2, one_m, lr = per_device[dev]
            g32 = g.float()
            g2 = g32.square().add_(eps1)
            if _factored(p.shape):
                vr, vc = v["vr"], v["vc"]
                vr.mul_(beta2).add_(mean(g2, -1, blocks=blk) * one_m)
                vc.mul_(beta2).add_(mean(g2, -2, blocks=blk) * one_m)
                # v_hat = vr vc / mean_row(vr)
                denom = mean(vr, -1, keepdim=True,
                             blocks=None if blk is None else blk.without(-1)).clamp_min_(eps1)
                vhat = (vr[..., None] * vc[..., None, :]).div_(denom[..., None])
            else:
                vhat = v["v"]
                vhat.mul_(beta2).add_(g2 * one_m)
            u = g32 / _sqrt(vhat + eps1)
            rms_u = _sqrt(mean(u.square(), blocks=blk).add_(eps1))
            u = u / (rms_u / const(dev, "clip", clip_threshold)).clamp_min_(1.0)
            scale = lr
            if multiply_by_parameter_scale:
                p_rms = _sqrt(mean(p.float().square(), blocks=blk))
                scale = scale * p_rms.clamp_min_(eps2)
            updates[k] = ((-scale) * u).to(p.dtype)
        return updates, state

    return Optimizer(init, update, scalars)
