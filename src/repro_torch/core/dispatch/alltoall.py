"""Explicit expert-parallel dispatch over ``all_to_all``
(``repro.core.dispatch.alltoall``).

Under a mesh whose expert axis shards the experts (the active
:class:`~repro_torch.distributed.sharding.Rules` place them there: the
serving mesh's ``expert`` axis, the training mesh's ``model``), each rank
holds experts ``[e * E / ne, (e + 1) * E / ne)`` of every expert leaf and
the routed groups split over the joint axis of ``mesh.joint_axes`` (on the
serving mesh every rank, data and expert axes jointly: rank r takes groups
``[r * G / (nd * ne), (r + 1) * G / (nd * ne))``; on the training mesh the
expert axis over a data rank's own groups):

1. each rank scatters its groups' token choices into a full ``(E, rows,
   M)`` buffer by the plan's flat slot ids;
2. an ``all_to_all`` over the expert axis gives each rank its own experts'
   rows from every peer of its expert group;
3. the expert FFN runs on the rank's experts (``expert_ffn``'s einsum, as
   the reference's does between its exchanges);
4. a second ``all_to_all`` returns the rows, each rank combines its groups'
   tokens (a gate-weighted gather, or a scatter-add for slot-major plans),
   and an all-gather over the joint axis hands every rank all G groups: the
   port's ranks hold their rows replicated, where the reference's
   ``shard_map`` output stays sharded for GSPMD.

Both exchanges are differentiable (the backward of each is the inverse
exchange), so the dispatch trains.

The plan is computed once, outside the dispatcher, so capacity semantics
are every other backend's.  Without a placed mesh (no rules, experts not
sharded, or G not divisible by the mesh: ``mesh.expert_mesh_plan``) the
dispatch is ``gather``'s, over the experts that ``moe_ffn_apply`` gathered
whole.  Dropless plans go to ``dropless_dispatch``, which runs the ragged
expert-parallel exchange (``dropless.ragged_ep_dispatch``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.dispatch import register_dispatcher
from repro_torch.core.dispatch.base import expert_ffn
from repro_torch.core.dispatch.dropless import dropless_dispatch, plan_block_rows
from repro_torch.core.dispatch.gather import flat_slot_ids, gather_dispatch
from repro_torch.core.dispatch.mesh import expert_mesh_plan, joint_axes, joint_rank
from repro_torch.core.routers.base import RoutingPlan
from repro_torch.distributed import collectives

def _exchange_ffn(params, buf: torch.Tensor, cfg: ModelConfig, group) -> torch.Tensor:
    """(E, rows, M) local buffer -> all_to_all -> the rank's experts' FFN
    -> all_to_all back; rows per expert grow ne-fold in between."""
    recv = collectives.all_to_all(buf, group, split_axis=0, concat_axis=1)   # (E/ne, ne*rows, M)
    out = expert_ffn(params, recv.contiguous(), cfg)
    return collectives.all_to_all(out, group, split_axis=1, concat_axis=0)   # (E, rows, M)


def alltoall_dispatch(params, xg: torch.Tensor, plan: RoutingPlan,
                      cfg: ModelConfig) -> torch.Tensor:
    G, T, M = xg.shape
    placed = expert_mesh_plan(plan, G)
    if placed is None:
        return gather_dispatch(params, xg, plan, cfg)
    mesh, e_ax, _ = placed
    joint = joint_axes(placed)
    n = math.prod(mesh.shape[a] for a in joint)
    Gl = G // n
    r = joint_rank(mesh, joint)
    rows = slice(r * Gl, (r + 1) * Gl)
    group, joint_group = mesh.group(e_ax), mesh.axes_group(joint)
    dt = cfg.activation_dtype
    E = plan.num_experts
    xl = collectives.scatter_to(xg, joint_group)
    dev = xg.device
    if plan.token_at_slot is not None:
        # slot-major plans (expert choice): dispatch a gather by token_at_slot,
        # combine a scatter-add over tokens
        tok = plan.token_at_slot[rows]                          # (Gl, E, Cs)
        Cs = tok.shape[-1]
        filled = tok >= 0
        tok_safe = torch.clamp(tok, 0, T - 1).long().reshape(Gl, E * Cs)
        buf = xl.gather(1, tok_safe[..., None].expand(Gl, E * Cs, M)).reshape(Gl, E, Cs, M)
        buf = torch.where(filled[..., None], buf, torch.zeros_like(buf)).to(dt)
        buf = buf.transpose(0, 1).reshape(E, Gl * Cs, M)
        out = _exchange_ffn(params, buf, cfg, group)
        out = out.reshape(E, Gl, Cs, M).transpose(0, 1)         # (Gl, E, Cs, M)
        gate = collectives.scatter_to(plan.gate_at_slot, joint_group)
        g = torch.where(filled, gate, torch.zeros_like(gate)).to(dt)
        vals = (out * g[..., None]).reshape(Gl * E * Cs, M)
        at = (torch.arange(Gl, device=dev)[:, None] * T + tok_safe).reshape(-1)
        y = torch.zeros((Gl * T, M), dtype=dt, device=dev).index_add(0, at, vals)
        y = y.reshape(Gl, T, M)
    else:
        C = plan.capacity
        K = plan.expert_index.shape[2]
        n_slots = E * C
        flat_slot = flat_slot_ids(plan)[rows]                   # (Gl, T*K)
        gi = torch.arange(Gl, device=dev)[:, None].expand(Gl, T * K)
        tok = torch.arange(T, device=dev).repeat_interleave(K)
        buf = torch.zeros((Gl, n_slots + 1, M), dtype=dt, device=dev)
        buf = buf.index_put((gi, flat_slot), xl[:, tok, :].to(dt))
        buf = buf[:, :n_slots].reshape(Gl, E, C, M).transpose(0, 1).reshape(E, Gl * C, M)
        out = _exchange_ffn(params, buf, cfg, group)
        out = out.reshape(E, Gl, C, M).transpose(0, 1).reshape(Gl, n_slots, M)
        idx = torch.clamp(flat_slot, max=n_slots - 1)
        picked = out.gather(1, idx[..., None].expand(Gl, T * K, M))
        gates = collectives.scatter_to(plan.masked_gate, joint_group).to(dt).reshape(Gl, T * K)
        y = (picked * gates[..., None]).reshape(Gl, T, K, M).sum(dim=2)
    return collectives.all_gather(y, joint_group, dim=0, grad="slice")


@register_dispatcher
class AllToAllDispatcher:
    name = "alltoall"
    # dropless plans run the ragged machinery (explicit EP over a placed
    # mesh, the single-device dropless dispatch otherwise), never the (E, C)
    # exchange above
    supports_dropless = True

    def __call__(self, params, xg, plan: RoutingPlan, cfg: ModelConfig,
                 ctx: Optional[MoEContext] = None) -> torch.Tensor:
        if cfg.moe.dropless:
            return dropless_dispatch(params, xg, plan, cfg, block_rows=plan_block_rows(plan))
        return alltoall_dispatch(params, xg, plan, cfg)
