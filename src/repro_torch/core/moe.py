"""The MoE FFN layer (``repro.core.moe``): route once through the router
registry, execute the plan through the dispatcher registry, and report
the same ``aux`` keys as the reference.

On a training mesh whose rank holds its own rows of the batch
(``Rules.batch_sharded``), the groups are the reference's, formed over the
*global* batch as GSPMD forms them: where the global group count G splits
over the data axes, a rank's rows are whole groups and its own grouping is
that slice; where it does not (G = 1, or groups straddling ranks), the
rank all-gathers the tokens over the data axes, routes and dispatches all
G groups (capacity is per group) and keeps its rows of the output.  Each
rank's aux and z losses are scaled by 1/|DP| so that the ranks' losses
sum to the global mean's, and the load metrics (c_v, the dropped
fraction, the expert loads) are the global ones.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.dispatch import get_dispatcher
from repro_torch.core.dispatch.mesh import EXPERT_PARALLEL, expert_mesh_plan, gathered_experts
from repro_torch.core.metrics import gate_entropy
from repro_torch.core.routing import route
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import data_parallel


def group_tokens(x: torch.Tensor, m: MoEConfig) -> Tuple[torch.Tensor, int]:
    """(B,S,M) -> (G,T,M), G the largest divisor of B*S <= B*S/group_size."""
    B, S, M = x.shape
    total = B * S
    g = group_count(total, m)
    return x.reshape(g, total // g, M), g


def group_count(total: int, m: MoEConfig) -> int:
    return _largest_divisor_leq(total, max(total // m.group_size, 1))


def _largest_divisor_leq(n: int, k: int) -> int:
    k = min(max(k, 1), n)
    for g in range(k, 0, -1):
        if n % g == 0:
            return g
    return 1


def straddles(total: int, m: MoEConfig) -> bool:
    """Whether the global groups of a data-sharded batch (``total`` rows a
    rank) straddle the data ranks (G does not divide over them).  A rank's
    own grouping is the global one's slice otherwise: the largest divisor
    of the global count at most its target, divided by |DP|, is the
    largest of the rank's count at most its own."""
    dp = data_parallel()
    return dp is not None and group_count(total * dp[1], m) % dp[1] != 0


def mesh_aux(plan, gathered: bool) -> dict:
    """The plan's losses and load metrics as a data-sharded rank reports
    them (see the module doc), or as they are off such a mesh."""
    dp = data_parallel()
    loads = plan.metrics["expert_loads"]
    routed = plan.metrics.get("routed_choices")
    if routed is None:
        routed = torch.full((), float(plan.expert_index.numel()), dtype=torch.float32,
                            device=loads.device)
    aux = {"moe_aux_loss": plan.aux_loss, "moe_z_loss": plan.z_loss,
           "moe_cv": plan.metrics["cv"],
           "moe_dropped_fraction": plan.metrics["dropped_fraction"],
           "moe_expert_tokens": loads.float(), "moe_routed_choices": routed}
    if dp is None:
        return aux
    group, nd, _ = dp
    aux["moe_aux_loss"] = plan.aux_loss / nd
    aux["moe_z_loss"] = plan.z_loss / nd
    if not gathered:                        # the loads of every rank's groups
        both = collectives.all_reduce(torch.cat([loads.detach().float(), routed.reshape(1)]),
                                      group)
        loads, routed = both[:-1], both[-1]
        aux["moe_cv"] = loads.std(correction=0) / (loads.mean() + 1e-9)
        aux["moe_dropped_fraction"] = torch.clamp(routed - loads.sum(), min=0.0) / routed
        aux.update(moe_expert_tokens=loads, moe_routed_choices=routed)
    return aux


def moe_ffn_apply(params, x: torch.Tensor, cfg: ModelConfig,
                  ctx: Optional[MoEContext] = None) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, M) -> (y, aux) with losses and load metrics."""
    m = cfg.moe
    B, S, M = x.shape
    gathered = straddles(B * S, m)
    rows = x
    if gathered:                            # every data rank's tokens, in global order
        group, nd, d = data_parallel()
        rows = collectives.all_gather(x, group, dim=0, grad="sum")
        if ctx is not None:
            ctx = ctx.replace(**{f: None if getattr(ctx, f) is None else
                                 collectives.all_gather(getattr(ctx, f), group, dim=0)
                                 for f in ("token_ids", "positions")})
    xg, G = group_tokens(rows, m)
    T = xg.shape[1]
    gctx = ctx.grouped(G, T) if ctx is not None else None
    router_w = params.get("router")
    if router_w is not None:
        router_w = router_w.float()
    plan = route(xg, router_w, m, m.capacity(T), ctx=gctx)
    dispatcher = get_dispatcher(m.impl)
    if m.impl not in EXPERT_PARALLEL or expert_mesh_plan(plan, G) is None:
        # a backend that reads every expert, or a plan the mesh cannot
        # split: gather the layer's experts (a no-op off a mesh)
        params = gathered_experts(params, cfg.activation_dtype)
    y = dispatcher(params, xg, plan, cfg, ctx=gctx)
    y = y.reshape(rows.shape).to(x.dtype)
    if gathered:
        y = y[d * B:(d + 1) * B]
    aux = mesh_aux(plan, gathered)
    aux["moe_gate_entropy"] = gate_entropy(plan.gate, plan.valid)
    return y, aux
