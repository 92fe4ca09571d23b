"""The grouped expert FFN shared by the capacity dispatchers
(``repro.core.dispatch.base.expert_ffn``).

A dispatcher executes a :class:`~repro_torch.core.routers.base.RoutingPlan`:
it moves tokens into per-expert buffers, runs each expert's FFN, and
combines the gate-weighted results back into token order.  The plan is
computed once, outside the dispatcher, so every backend executes the same
assignment.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation


def expert_ffn(params, dispatched: torch.Tensor, cfg: ModelConfig,
               use_kernel: bool = False) -> torch.Tensor:
    """dispatched: (E, X, M) -> (E, X, M) through each expert's FFN.

    ``use_kernel`` selects the grouped-FFN kernel
    (:func:`repro_torch.kernels.moe_ffn.moe_ffn`); the default is the
    einsum form in the activation dtype, as the reference's.  Weights are
    cast to the activation dtype here, at use, as the reference casts
    them (a no-op for the serving tree, which stores them so).
    """
    dt = cfg.activation_dtype
    up_w = params["up"].to(dt)
    down_w = params["down"].to(dt)
    gate_w = params["gate"].to(dt) if "gate" in params else None
    if use_kernel:
        from repro_torch.kernels.moe_ffn import moe_ffn

        return moe_ffn(dispatched, up_w, gate_w, down_w, cfg.ffn_activation)
    h = torch.einsum("exm,emi->exi", dispatched, up_w)
    if gate_w is not None:
        g = torch.einsum("exm,emi->exi", dispatched, gate_w)
        h = activation("swiglu" if cfg.ffn_activation == "swiglu" else "geglu", g, h)
    else:
        h = activation("gelu" if cfg.ffn_activation == "gelu" else "relu", h)
    return torch.einsum("exi,eim->exm", h, down_w)
