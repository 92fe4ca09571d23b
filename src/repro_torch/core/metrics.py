"""MoE load-balance metrics (``repro.core.metrics``)."""
from __future__ import annotations

import numpy as np
import torch


def dropped_fraction(expert_loads: torch.Tensor, total_slots: int) -> torch.Tensor:
    """dropped/total, so a zero-drop plan reports exactly 0.0."""
    kept = expert_loads.sum()
    return torch.clamp(float(total_slots) - kept, min=0.0) / float(total_slots)


def gate_entropy(gate: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean per-token entropy (nats) of the kept, renormalised gates."""
    g = torch.where(valid, gate, torch.zeros_like(gate))
    tot = g.sum(dim=-1, keepdim=True)
    p = g / torch.clamp(tot, min=1e-9)
    plogp = p * torch.log(torch.clamp(p, min=1e-9))
    ent = -torch.where(p > 0, plogp, torch.zeros_like(p)).sum(dim=-1)
    return ent.mean()


def empty_aux(num_experts: int = 0, device=None) -> dict:
    """The aux dict a dense layer contributes (shape-uniform with an MoE
    layer's, so per-layer stacking works)."""
    def zero(shape=()):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"moe_aux_loss": zero(), "moe_z_loss": zero(), "moe_cv": zero(),
            "moe_dropped_fraction": zero(), "moe_expert_tokens": zero((num_experts,)),
            "moe_gate_entropy": zero(), "moe_routed_choices": zero()}


def load_entropy(expert_loads) -> float:
    """Entropy (nats) of the normalised expert-load distribution."""
    loads = np.asarray(expert_loads, np.float64)
    tot = loads.sum()
    if tot <= 0:
        return 0.0
    p = loads / tot
    p = p[p > 0]
    return float(-(p * np.log(p)).sum())
