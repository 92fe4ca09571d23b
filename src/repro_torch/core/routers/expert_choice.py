"""Expert-choice routing (``repro.core.routers.expert_choice``; Zhou et
al., 2022): each expert picks its top-``c_eff`` tokens by the per-token
softmax over experts, so every expert buffer is full and balance holds by
construction.  A token may be picked by 0..E experts, so the index view
has K = E columns (column e: did expert e pick the token, at which slot),
and the plan carries the slot-major view the gather dispatch reads.

Ties: the reference's ``jax.lax.top_k`` puts the lower token index first
on equal scores, and the selection's order is the slot order.
``torch.topk`` promises no order on a tie, so the port takes the first
``c_eff`` of a *stable* descending sort, which keeps the lower index
first too.

As in the reference, selecting over the token axis makes a token's
routing depend on the other tokens of its group, future ones included.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.routers import base, register_router
from repro_torch.core.routers.base import RoutingPlan
from repro_torch.core.routers.topk import topk_logits


def expert_choice_plan(logits: torch.Tensor, cfg: MoEConfig, capacity: int,
                       combine_dtype=torch.float32) -> RoutingPlan:
    """Expert-choice gating from precomputed (G, T, E) logits."""
    G, T, E = logits.shape
    dev = logits.device
    c_eff = min(capacity, T)            # an expert cannot pick more tokens than exist
    scores = torch.softmax(logits, dim=-1)                   # (G, T, E)

    # each expert's top-c_eff tokens, (G, E, c_eff), lower index first on ties
    order = torch.sort(scores.transpose(1, 2), dim=-1, descending=True, stable=True).indices
    sel_tok = order[..., :c_eff].contiguous()       # (the sort keeps the transposed layout)

    # the selection inverted into a per-(token, expert) slot map
    c = torch.arange(c_eff, dtype=torch.int32, device=dev).expand(G, E, c_eff)
    slot_of = torch.full((G, E, T), -1, dtype=torch.int32, device=dev)
    slot_of = slot_of.scatter(2, sel_tok, c).transpose(1, 2)  # (G, T, E)

    valid = slot_of >= 0
    expert_index = torch.arange(E, dtype=torch.int32, device=dev).expand(G, T, E).contiguous()
    slot_index = torch.where(valid, slot_of, torch.full_like(slot_of, capacity))
    gate = scores
    if cfg.normalize_gates:
        gate = base.normalize_gates(gate, valid)

    # the slot-major view: the selection IS (token, gate) per (e, c)
    gate_m = torch.where(valid, gate, torch.zeros_like(gate))
    gate_at_slot = gate_m.transpose(1, 2).gather(2, sel_tok)

    zl = base.z_loss(logits, cfg.router_z_loss_coef)
    # balance is structural (every expert holds c_eff tokens); "dropped"
    # reports the tokens no expert picked
    routed = valid.any(dim=-1).float().sum()
    metrics = {
        "cv": torch.zeros((), dtype=torch.float32, device=dev),
        "dropped_fraction": base.dropped_fraction(routed, G * T),
        "expert_loads": torch.full((E,), float(G * c_eff), dtype=torch.float32, device=dev),
        "routed_choices": torch.full((), float(G * T), dtype=torch.float32, device=dev),
    }
    return RoutingPlan(expert_index, slot_index.contiguous(), gate, valid.contiguous(), E,
                       capacity, torch.zeros((), dtype=torch.float32, device=dev), zl,
                       metrics, combine_dtype, token_at_slot=sel_tok.to(torch.int32),
                       gate_at_slot=gate_at_slot)


@register_router
class ExpertChoiceRouter(base.Router):
    name = "expert_choice"

    def plan(self, x32, w, m: MoEConfig, capacity: int,
             combine_dtype=torch.float32, ctx=None) -> RoutingPlan:
        return expert_choice_plan(topk_logits(x32, w), m, capacity, combine_dtype)
