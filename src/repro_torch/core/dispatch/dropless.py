"""Capacity-free dropless dispatch, single device
(``repro.core.dispatch.dropless.dropless_dispatch``):

1. take the plan's :class:`~repro_torch.core.routers.base.RaggedView`;
2. gather the sorted token rows (padding rows read token 0);
3. run the expert FFN as one ragged grouped GEMM
   (:func:`repro_torch.kernels.moe_dropless.ragged_ffn`);
4. combine by gate-weighted scatter-add back into token order.

The combine is ``index_put_(accumulate=True)`` in the activation dtype,
as the reference's ``.at[gi, tok].add``.  On the card PyTorch sorts the
indices and sums each token's terms in its own order, not the
reference's; at top-1 each token row gets exactly one nonzero term
(padding rows add gate-0 products into token 0), so the result does not
depend on that order.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.dispatch import register_dispatcher
from repro_torch.core.routers.base import RoutingPlan
from repro_torch.kernels.moe_dropless import ops as dropless_ops
from repro_torch.kernels.moe_dropless.ops import pick_block_rows


def plan_block_rows(plan: RoutingPlan, max_block: int = 128) -> int:
    """Row-block granularity for the plan's ragged view: scales down with
    the choice count so segment padding never dwarfs real rows."""
    n = plan.expert_index.shape[1] * plan.expert_index.shape[2]
    return pick_block_rows(n, plan.num_experts, max_block)


def dropless_dispatch(params, xg: torch.Tensor, plan: RoutingPlan,
                      cfg: ModelConfig, block_rows: int = 0) -> torch.Tensor:
    dt = cfg.activation_dtype
    G, T, M = xg.shape
    block_rows = block_rows or plan_block_rows(plan)
    rag = plan.ragged(block_rows)
    R = rag.token.shape[1]

    tok = torch.clamp(rag.token, min=0).long()                   # -1 -> row 0
    xs = xg.gather(1, tok[..., None].expand(G, R, M)).to(dt)
    out = dropless_ops.ragged_ffn(
        xs.reshape(G * R, M), rag.block_expert.reshape(-1).contiguous(),
        params["up"].to(dt), params["gate"].to(dt) if "gate" in params else None,
        params["down"].to(dt), cfg.ffn_activation, block_x=block_rows)
    vals = out.reshape(G, R, M) * rag.gate[..., None].to(dt)
    gi = torch.arange(G, device=xg.device)[:, None].expand(G, R)
    y = torch.zeros((G, T, M), dtype=dt, device=xg.device)
    return y.index_put_((gi, tok), vals, accumulate=True)


@register_dispatcher
class DroplessDispatcher:
    name = "dropless"
    supports_dropless = True
    max_block_rows = 128

    def __call__(self, params, xg, plan: RoutingPlan, cfg: ModelConfig,
                 ctx: Optional[MoEContext] = None) -> torch.Tensor:
        return dropless_dispatch(params, xg, plan, cfg,
                                 block_rows=plan_block_rows(plan, self.max_block_rows))
