"""M6-T k top-1 expert prototyping (``repro.core.routers.prototype``,
Eq. 3 / Fig. 8): E experts split into Z prototypes of F = E/Z, each
routing its own top-k' (paper: k' = 1) in parallel.  Global expert ids
follow the Fig. 8 reshape, ``z * F + f``, and choices are ordered
prototype-major, so prototype z's picks sit at ``[z*k':(z+1)*k']``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.routers import base, register_router
from repro_torch.core.routers.base import RoutingPlan


def prototype_logits(x32: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(G,T,M) x (M,Z,F) -> (G,Z,T,F)  (Fig. 8: 'dTZM,MZF->dZTF')."""
    return torch.einsum("gtm,mzf->gztf", x32, w.float())


def prototype_plan(logits: torch.Tensor, cfg: MoEConfig, capacity: int,
                   combine_dtype=torch.float32) -> RoutingPlan:
    G, Z, T, F = logits.shape
    kp = cfg.prototype_top_k
    raw_gates = torch.softmax(logits, dim=-1)                # (G,Z,T,F)
    remaining = raw_gates
    count = torch.zeros(G, Z, F, dtype=torch.float32, device=logits.device)
    proto_base = (torch.arange(Z, dtype=torch.int32, device=logits.device) * F)[None, :, None]
    experts, slots, gates = [], [], []
    first_mask = None
    for _ in range(kp):
        idx = remaining.argmax(dim=-1)                       # (G,Z,T)
        mask = base.one_hot_f32(idx, F)                      # (G,Z,T,F)
        if first_mask is None:
            first_mask = mask
        gates.append((raw_gates * mask).sum(dim=-1))
        pos, count = base.slot_positions(mask, count, token_axis=2)
        experts.append(idx.to(torch.int32) + proto_base)
        slots.append(pos.to(torch.int32))
        remaining = remaining * (1.0 - mask)

    def stack(xs):   # kp x (G,Z,T) -> (G,T,Z*kp), prototype-major
        return torch.stack(xs, dim=-1).permute(0, 2, 1, 3).reshape(G, T, Z * kp)

    expert_index, slot_index, gate = stack(experts), stack(slots), stack(gates)
    valid = slot_index < capacity
    if cfg.normalize_gates:
        gate = base.normalize_gates(gate, valid)
    # aux loss per prototype over its F experts (Fig. 8: F^2 scaling)
    density = first_mask.mean(dim=2)                         # (G,Z,F)
    density_proxy = raw_gates.mean(dim=2)
    aux = base.aux_loss(density, density_proxy, F, cfg.aux_loss_coef)
    zl = base.z_loss(logits, cfg.router_z_loss_coef)
    metrics = base.index_load_metrics(expert_index, valid, Z * F, G * T * Z * kp)
    return RoutingPlan(expert_index, slot_index, gate, valid, Z * F, capacity,
                       aux, zl, metrics, combine_dtype)


@register_router
class PrototypeRouter(base.Router):
    name = "prototype"

    def weight_shape(self, m: MoEConfig, d_model: int):
        return (d_model, m.num_prototypes, m.experts_per_prototype)   # Fig. 8

    def plan(self, x32, w, m: MoEConfig, capacity: int,
             combine_dtype=torch.float32, ctx=None) -> RoutingPlan:
        return prototype_plan(prototype_logits(x32, w), m, capacity, combine_dtype)
