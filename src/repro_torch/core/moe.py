"""The MoE FFN layer (``repro.core.moe``): route once through the router
registry, execute the plan through the dispatcher registry, and report
the same ``aux`` keys as the reference."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.dispatch import get_dispatcher
from repro_torch.core.metrics import gate_entropy
from repro_torch.core.routing import route


def group_tokens(x: torch.Tensor, m: MoEConfig) -> Tuple[torch.Tensor, int]:
    """(B,S,M) -> (G,T,M), G the largest divisor of B*S <= B*S/group_size."""
    B, S, M = x.shape
    total = B * S
    g = _largest_divisor_leq(total, max(total // m.group_size, 1))
    return x.reshape(g, total // g, M), g


def _largest_divisor_leq(n: int, k: int) -> int:
    k = min(max(k, 1), n)
    for g in range(k, 0, -1):
        if n % g == 0:
            return g
    return 1


def moe_ffn_apply(params, x: torch.Tensor, cfg: ModelConfig,
                  ctx: Optional[MoEContext] = None) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, M) -> (y, aux) with losses and load metrics."""
    m = cfg.moe
    B, S, M = x.shape
    xg, G = group_tokens(x, m)
    T = xg.shape[1]
    gctx = ctx.grouped(G, T) if ctx is not None else None
    router_w = params.get("router")
    if router_w is not None:
        router_w = router_w.float()
    plan = route(xg, router_w, m, m.capacity(T), ctx=gctx)
    y = get_dispatcher(m.impl)(params, xg, plan, cfg, ctx=gctx)
    y = y.reshape(B, S, M).to(x.dtype)
    aux = {
        "moe_aux_loss": plan.aux_loss,
        "moe_z_loss": plan.z_loss,
        "moe_cv": plan.metrics["cv"],
        "moe_dropped_fraction": plan.metrics["dropped_fraction"],
        "moe_expert_tokens": plan.metrics["expert_loads"].float(),
        "moe_gate_entropy": gate_entropy(plan.gate, plan.valid),
        "moe_routed_choices": plan.metrics.get(
            "routed_choices",
            torch.tensor(float(plan.expert_index.numel()), device=x.device)),
    }
    return y, aux
