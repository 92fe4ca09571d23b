"""GShard/Switch sequential top-k routing (``repro.core.routers.topk``):
k passes, each the argmax over the not-yet-chosen experts.  ``argmax``
returns the first maximum in both frameworks, so ties break alike."""
from __future__ import annotations

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.routers import base, register_router
from repro_torch.core.routers.base import RoutingPlan


def topk_logits(x32: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(G,T,M) x (M,E) -> (G,T,E)."""
    return torch.einsum("gtm,me->gte", x32, w.float())


def topk_plan(logits: torch.Tensor, cfg: MoEConfig, capacity: int,
              combine_dtype=torch.float32) -> RoutingPlan:
    G, T, E = logits.shape
    raw_gates = torch.softmax(logits, dim=-1)
    remaining = raw_gates
    count = torch.zeros(G, E, dtype=torch.float32, device=logits.device)
    experts, slots, gates = [], [], []
    first_mask = None
    for _ in range(cfg.top_k):
        idx = remaining.argmax(dim=-1)                       # (G,T)
        mask = base.one_hot_f32(idx, E)                      # (G,T,E)
        if first_mask is None:
            first_mask = mask
        gates.append((raw_gates * mask).sum(dim=-1))
        pos, count = base.slot_positions(mask, count, token_axis=1)
        experts.append(idx.to(torch.int32))
        slots.append(pos.to(torch.int32))
        remaining = remaining * (1.0 - mask)

    expert_index = torch.stack(experts, dim=-1)
    slot_index = torch.stack(slots, dim=-1)
    gate = torch.stack(gates, dim=-1)
    valid = slot_index < capacity
    if cfg.normalize_gates:
        gate = base.normalize_gates(gate, valid)
    density = first_mask.mean(dim=1)
    density_proxy = raw_gates.mean(dim=1)
    aux = base.aux_loss(density, density_proxy, E, cfg.aux_loss_coef)
    zl = base.z_loss(logits, cfg.router_z_loss_coef)
    metrics = base.index_load_metrics(expert_index, valid, E, G * T * cfg.top_k)
    return RoutingPlan(expert_index, slot_index, gate, valid, E, capacity,
                       aux, zl, metrics, combine_dtype)


@register_router
class TopKRouter(base.Router):
    name = "topk"

    def plan(self, x32, w, m: MoEConfig, capacity: int,
             combine_dtype=torch.float32, ctx=None) -> RoutingPlan:
        return topk_plan(topk_logits(x32, w), m, capacity, combine_dtype)
