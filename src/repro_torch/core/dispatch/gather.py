"""Index-view dispatch (``repro.core.dispatch.gather``): flat slot-id
scatter and gather, no dense ``(G, T, E, C)`` tensors.

Each token choice ``(g, t, j)`` owns slot ``e*C + c`` of group g's flat
buffer; overflowed choices go to a sentinel row ``E*C`` that is sliced
off.  The same slot ids drive the gather back, weighted by the gates.
Plans that carry the slot-major view (expert-choice routing, where K
would be E) are dispatched from it instead: a gather by slot in, a
scatter-add by token out.

The ``pallas`` dispatcher reuses this dispatch and swaps the expert FFN
for the grouped-FFN kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.dispatch import register_dispatcher
from repro_torch.core.dispatch.base import expert_ffn
from repro_torch.core.routers.base import RoutingPlan


def flat_slot_ids(plan: RoutingPlan) -> torch.Tensor:
    """(G, T*K) flat slot id per choice; invalid choices -> sentinel E*C."""
    n_slots = plan.num_experts * plan.capacity
    flat = plan.expert_index.long() * plan.capacity + plan.slot_index.long()
    flat = torch.where(plan.valid, flat, torch.full_like(flat, n_slots))
    G, T, K = plan.expert_index.shape
    return flat.reshape(G, T * K)


def gather_dispatch(params, xg: torch.Tensor, plan: RoutingPlan,
                    cfg: ModelConfig, use_kernel: bool = False) -> torch.Tensor:
    if plan.token_at_slot is not None:
        return _slot_major_dispatch(params, xg, plan, cfg, use_kernel)
    dt = cfg.activation_dtype
    G, T, K = plan.expert_index.shape
    E, C = plan.num_experts, plan.capacity
    M = xg.shape[-1]
    n_slots = E * C
    flat_slot = flat_slot_ids(plan)                            # (G, T*K)

    # dispatch: scatter each choice's token vector into its slot.  The
    # reference adds (`.at[].add`); valid (e, c) targets are unique, so a
    # plain write (no sort, unlike index_put_'s accumulate on the card)
    # places the same single token per slot.  Only the sentinel row sees
    # repeated writes, and it is sliced off.
    gi = torch.arange(G, device=xg.device)[:, None].expand(G, T * K)
    tok = torch.arange(T, device=xg.device).repeat_interleave(K)
    buf = torch.zeros((G, n_slots + 1, M), dtype=dt, device=xg.device)
    buf = buf.index_put((gi, flat_slot), xg[:, tok, :].to(dt))
    buf = buf[:, :n_slots].reshape(G, E, C, M).transpose(0, 1)   # (E,G,C,M)
    out = expert_ffn(params, buf.reshape(E, G * C, M), cfg, use_kernel)
    out = out.reshape(E, G, C, M).transpose(0, 1).reshape(G, n_slots, M)

    # combine: gather each choice's slot back and weight by its gate;
    # invalid choices carry gate 0, so clipping their slot is harmless
    idx = torch.clamp(flat_slot, max=n_slots - 1)
    picked = out.gather(1, idx[..., None].expand(G, T * K, M))
    gates = plan.masked_gate.to(dt).reshape(G, T * K)
    return (picked * gates[..., None]).reshape(G, T, K, M).sum(dim=2)


def _slot_major_dispatch(params, xg: torch.Tensor, plan: RoutingPlan, cfg: ModelConfig,
                         use_kernel: bool = False) -> torch.Tensor:
    """Slot-major twin of :func:`gather_dispatch`: each (expert, slot) names
    its token, so dispatch is a gather and combine a scatter-*add* over
    tokens (expert choice can pick a token up to E times, so the
    token-choice path's plain write would lose terms).  Empty slots (token
    -1) carry gate 0 and zeroed rows."""
    dt = cfg.activation_dtype
    G, T, M = xg.shape
    E = plan.num_experts
    Cs = plan.token_at_slot.shape[-1]
    tok = plan.token_at_slot                                   # (G, E, Cs)
    filled = tok >= 0
    tok_safe = torch.clamp(tok, 0, T - 1).long().reshape(G, E * Cs)
    buf = xg.gather(1, tok_safe[..., None].expand(G, E * Cs, M)).reshape(G, E, Cs, M)
    buf = torch.where(filled[..., None], buf, torch.zeros_like(buf)).to(dt)
    buf = buf.transpose(0, 1).reshape(E, G * Cs, M).contiguous()   # (E, G*Cs, M)
    out = expert_ffn(params, buf, cfg, use_kernel)
    out = out.reshape(E, G, Cs, M).transpose(0, 1)             # (G, E, Cs, M)
    gates = torch.where(filled, plan.gate_at_slot, torch.zeros_like(plan.gate_at_slot)).to(dt)
    vals = (out * gates[..., None]).reshape(G * E * Cs, M)
    rows = (torch.arange(G, device=xg.device)[:, None] * T + tok_safe).reshape(-1)
    y = torch.zeros((G * T, M), dtype=dt, device=xg.device).index_add(0, rows, vals)
    return y.reshape(G, T, M)


@register_dispatcher
class GatherDispatcher:
    name = "gather"

    def __call__(self, params, xg, plan: RoutingPlan, cfg: ModelConfig,
                 ctx: Optional[MoEContext] = None) -> torch.Tensor:
        return gather_dispatch(params, xg, plan, cfg, use_kernel=False)
