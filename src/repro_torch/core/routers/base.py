"""The ``RoutingPlan`` index view, its dense ``combine`` view and its
ragged (sorted, block-padded) execution layout, as in
``repro.core.routers.base``.

A plan holds, for every token, K expert choices as four ``(G, T, K)``
tensors: ``expert_index``, ``slot_index`` (position in the expert's
capacity buffer), ``gate`` and ``valid``.  :meth:`RoutingPlan.ragged`
builds the :class:`RaggedView` the dropless dispatcher consumes: valid
choices sorted expert-major, each expert's segment padded to a multiple
of ``block_rows``.  The layout is part of the contract with the reference
(tests compare every integer field bit for bit), so the construction
follows ``_ragged_index_view`` step for step: a *stable* argsort, the
``R + 1`` parking row for invalid choices, and ``searchsorted(right)``
for the block -> expert map, clipped to ``E - 1`` for trailing blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.metrics import dropped_fraction


@dataclasses.dataclass(frozen=True)
class RaggedView:
    sort_order: torch.Tensor      # (G, R) int32 flat choice index t*K+k; -1 = empty
    token: torch.Tensor           # (G, R) int32 source token; -1 = empty
    gate: torch.Tensor            # (G, R) f32; 0 on empty rows
    expert_offsets: torch.Tensor  # (G, E+1) int32 block-aligned segment starts
    block_expert: torch.Tensor    # (G, R // block_rows) int32 expert per row block
    num_experts: int
    block_rows: int


@dataclasses.dataclass(frozen=True)
class RoutingPlan:
    expert_index: torch.Tensor    # (G, T, K) int32
    slot_index: torch.Tensor      # (G, T, K) int32
    gate: torch.Tensor            # (G, T, K) f32
    valid: torch.Tensor           # (G, T, K) bool
    num_experts: int
    capacity: int
    aux_loss: torch.Tensor
    z_loss: torch.Tensor
    metrics: dict
    combine_dtype: torch.dtype = torch.float32

    @property
    def masked_gate(self) -> torch.Tensor:
        return torch.where(self.valid, self.gate, torch.zeros_like(self.gate))

    @property
    def combine(self) -> torch.Tensor:
        """Dense (G, T, E, C) combine view: gate * one_hot(e) * one_hot(c),
        scattered from the index view; only the einsum path builds it."""
        G, T, K = self.expert_index.shape
        E, C = self.num_experts, self.capacity
        dev = self.expert_index.device
        g = torch.arange(G, device=dev)[:, None, None].expand(G, T, K)
        t = torch.arange(T, device=dev)[None, :, None].expand(G, T, K)
        e = torch.clamp(self.expert_index, 0, E - 1).long()
        # overflowed choices land on a sentinel column that is sliced away
        c = torch.where(self.valid, self.slot_index,
                        torch.full_like(self.slot_index, C)).long()
        values = self.masked_gate.to(self.combine_dtype)
        dense = torch.zeros((G, T, E, C + 1), dtype=values.dtype, device=dev)
        # The reference adds (`.at[].add`); a token's K choices name distinct
        # experts, so every (g, t, e, c) target is written at most once
        # outside the sentinel column, and a plain write gives the same view.
        return dense.index_put((g, t, e, c), values)[..., :C]

    def ragged(self, block_rows: int = 128) -> RaggedView:
        return self._ragged_index_view(block_rows)

    def _ragged_index_view(self, bx: int) -> RaggedView:
        G, T, K = self.expert_index.shape
        E = self.num_experts
        n = T * K
        dev = self.expert_index.device
        R = -(-(n + E * (bx - 1)) // bx) * bx
        i32 = torch.int32

        e = torch.where(self.valid, self.expert_index,
                        torch.full_like(self.expert_index, E)).reshape(G, n).long()
        g = self.masked_gate.float().reshape(G, n)
        order = torch.argsort(e, dim=1, stable=True)            # invalid last
        e_sorted = e.gather(1, order)
        counts = torch.zeros(G, E + 1, dtype=torch.long, device=dev)
        counts.scatter_add_(1, e, torch.ones_like(e))
        counts = counts[:, :E]
        padded = -(-counts // bx) * bx
        zero = torch.zeros(G, 1, dtype=torch.long, device=dev)
        offsets = torch.cat([zero, padded.cumsum(1)], dim=1)     # (G, E+1)
        starts = torch.cat([zero, counts.cumsum(1)], dim=1)
        seg = torch.clamp(e_sorted, max=E - 1)
        ar = torch.arange(n, device=dev).expand(G, n)
        dest = offsets.gather(1, seg) + (ar - starts.gather(1, seg))
        dest = torch.where(e_sorted < E, dest, torch.full_like(dest, R))  # park

        def park(values, fill, dtype):
            buf = torch.full((G, R + 1), fill, dtype=dtype, device=dev)
            return buf.scatter_(1, dest, values.to(dtype))[:, :R]

        sort_order = park(order, -1, i32)
        token = park(order // K, -1, i32)
        gate = park(g.gather(1, order), 0.0, torch.float32)
        starts_b = (torch.arange(R // bx, device=dev) * bx).expand(G, R // bx).contiguous()
        block_expert = torch.clamp(
            torch.searchsorted(offsets, starts_b, right=True) - 1, 0, E - 1).to(i32)
        return RaggedView(sort_order, token, gate, offsets.to(i32), block_expert, E, bx)


# ---------------------------------------------------------------------------
# Shared router math
# ---------------------------------------------------------------------------

def one_hot_f32(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(x.long(), n).float()


def slot_positions(mask: torch.Tensor, count: torch.Tensor, token_axis: int):
    """Position of each selected token inside its expert's buffer.
    Returns (pos, new_count)."""
    pos_in_expert = mask.cumsum(dim=token_axis) - mask + count.unsqueeze(token_axis)
    pos = (pos_in_expert * mask).sum(dim=-1)
    return pos, count + mask.sum(dim=token_axis)


def aux_loss(density, density_proxy, n: int, coef: float) -> torch.Tensor:
    return (density * density_proxy).mean() * float(n) * float(n) * coef


def z_loss(logits: torch.Tensor, coef: float) -> torch.Tensor:
    if coef == 0.0:
        return torch.zeros((), dtype=torch.float32, device=logits.device)
    return coef * torch.logsumexp(logits, dim=-1).square().mean()


def normalize_gates(gate: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    kept = torch.where(valid, gate, torch.zeros_like(gate))
    return kept / torch.clamp(kept.sum(dim=-1, keepdim=True), min=1e-9)


def index_load_metrics(expert_index, valid, num_experts: int, total_slots: int) -> dict:
    """c_v, dropped fraction and per-expert loads straight from the index
    view.  The loads are integer counts, so the atomic ``index_add_`` on
    the card sums them exactly in any order."""
    flat_e = torch.clamp(expert_index, 0, num_experts - 1).reshape(-1).long()
    flat_v = valid.reshape(-1).float()
    loads = torch.zeros(num_experts, dtype=torch.float32,
                        device=expert_index.device).index_add_(0, flat_e, flat_v)
    cv = loads.std(correction=0) / (loads.mean() + 1e-9)
    return {"cv": cv,
            "dropped_fraction": dropped_fraction(loads, total_slots),
            "expert_loads": loads,
            "routed_choices": torch.tensor(float(total_slots), dtype=torch.float32,
                                           device=expert_index.device)}


class Router:
    """A routing strategy: parameter shape + plan construction."""

    name: str = "abstract"

    def plan(self, x32: torch.Tensor, w: Optional[torch.Tensor], m, capacity: int,
             combine_dtype=torch.float32, ctx=None) -> RoutingPlan:
        raise NotImplementedError
