"""Capacity-free dropless dispatch, single device
(``repro.core.dispatch.dropless.dropless_dispatch``):

1. take the plan's :class:`~repro_torch.core.routers.base.RaggedView`;
2. gather the sorted token rows (padding rows read token 0);
3. run the expert FFN as one ragged grouped GEMM
   (:func:`repro_torch.kernels.moe_dropless.ragged_ffn`) over the live
   blocks only: the view's ``token`` is the kernel's liveness (a block with
   no routed row is dead and comes out 0), and the tile width comes from
   the plan's static sizes (:func:`plan_tile_rows`);
4. combine back into token order
   (:func:`repro_torch.kernels.moe_dropless.combine.ragged_combine`).

The combine computes the reference's ``.at[gi, tok].add(out * gate)``
as a gather-sum: :func:`combine_rows` inverts the view's ``sort_order``
(its valid ids are unique) into each token's (G, T, K) map of routed
rows, and the kernel sums each token's terms (each the activation-dtype
product, as the reference's ``vals``) in f32 in the order of its choices,
rounding once.  At top-1 a token has one term, so the result is the
reference's bit for bit; with more choices only the order and precision
of the sum differ.  Padding rows are never read: the reference adds
their gate-0 products into token 0, which only a NaN there would show.

Expert parallelism: under a mesh that shards the experts and splits the
groups (``mesh.expert_mesh_plan``; the serving mesh's joint axis or the
training mesh's expert axis, as ``alltoall.py`` sets out),
:func:`ragged_ep_dispatch` ships each expert shard its own experts' sorted
row segments over ``all_to_all`` and runs the ragged FFN kernel on them
with local expert ids.  A segment fills the front of its ``R``-row slot
(:func:`shard_slots`); the expert ids shipped beside the rows are -1 on a
slot's padding (:func:`slot_expert_ids`), and the receiving rank hands
them to the kernel as its liveness, so the padding that fills most of a
slot is skipped without another exchange.  Where the experts are sharded
but the groups do not split over the mesh, ``moe_ffn_apply`` has gathered
the layer's experts whole and the single-device dispatch runs, as the
reference's GSPMD computes the unsharded one.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.dispatch import register_dispatcher
from repro_torch.core.dispatch.mesh import expert_mesh_plan, joint_axes, joint_rank
from repro_torch.core.routers.base import RoutingPlan
from repro_torch.distributed import collectives
from repro_torch.kernels.moe_dropless import ops as dropless_ops
from repro_torch.kernels.moe_dropless.combine import ragged_combine
from repro_torch.kernels.moe_dropless.ops import pick_block_rows, ragged_tile_rows
from repro_torch.kernels.moe_dropless.ref import index_row_map, slot_row_map


def plan_block_rows(plan: RoutingPlan, max_block: int = 128) -> int:
    """Row-block granularity for the plan's ragged view: scales down with
    the choice count so segment padding never dwarfs real rows."""
    if plan.token_at_slot is not None:
        n = plan.token_at_slot.shape[1] * plan.token_at_slot.shape[2]
    else:
        n = plan.expert_index.shape[1] * plan.expert_index.shape[2]
    return pick_block_rows(n, plan.num_experts, max_block)


def choice_tile_rows(choices: int, num_experts: int, block_rows: int, gated: bool,
                     groups: int = 1, slots: Optional[int] = None) -> int:
    """The ragged FFN's tile width for ``groups`` routing groups in one
    launch, from static sizes: a tile covers a slot-major expert's
    ``slots`` a group, or twice the rows an expert takes on average when a
    group routes ``choices`` choices (so that most experts are one tile:
    an expert's weights are read once a tile, its rows gathered from every
    group)."""
    rows = groups * slots if slots is not None else 2 * groups * choices / num_experts
    return ragged_tile_rows(rows, block_rows, gated)


def plan_tile_rows(plan: RoutingPlan, block_rows: int, gated: bool, groups: int = 0) -> int:
    """``choice_tile_rows`` for ``groups`` of this plan's groups (default
    all)."""
    G, T, K = plan.expert_index.shape
    slots = plan.token_at_slot.shape[2] if plan.token_at_slot is not None else None
    return choice_tile_rows(T * K, plan.num_experts, block_rows, gated, groups or G, slots)


def combine_rows(plan: RoutingPlan, sort_order: torch.Tensor,
                 groups: slice = slice(None)) -> torch.Tensor:
    """The combine's (G, T, K) int32 row map of the plan's ragged view
    (``sort_order``, of the plan's groups ``groups``): the ragged row of
    each token's choice, -1 where it is not routed.  A slot-major view's
    ids are looked up through the plan's index view."""
    _, T, K = plan.expert_index.shape
    if plan.token_at_slot is None:
        return index_row_map(sort_order, T, K)
    return slot_row_map(sort_order, plan.expert_index[groups], plan.slot_index[groups],
                        plan.valid[groups], plan.token_at_slot.shape[2], plan.num_experts)


def shard_slots(offsets: torch.Tensor, epl: int, R: int):
    """How ``ragged_ep_dispatch`` packs a group's rows for the ``ne``
    expert shards: shard ``s``'s segment ``[offsets[s * epl], offsets[(s +
    1) * epl])`` fills the front of an ``R``-row slot.  offsets: (Gl, E +
    1) block-aligned segment starts.  Returns (src, valid), each (Gl, ne,
    R): the sorted row a slot row holds (``R``, the zero pad row, past the
    segment) and whether it holds one (``j < seglen``, a prefix of whole
    blocks)."""
    offd = offsets[:, ::epl]                                    # (Gl, ne + 1)
    start, seglen = offd[:, :-1], offd[:, 1:] - offd[:, :-1]
    j = torch.arange(R, device=offsets.device)
    valid = j < seglen[:, :, None]
    src = torch.where(valid, start[:, :, None] + j, torch.full_like(valid, R, dtype=offd.dtype))
    return src, valid


def slot_expert_ids(e_row: torch.Tensor, src: torch.Tensor, valid: torch.Tensor,
                    epl: int) -> torch.Tensor:
    """The expert ids shipped beside the packed rows: a slot row's local
    expert id (its global id less its shard's first), -1 on the padding.
    The receiving rank's kernel reads the -1 as its liveness (a block with
    no id >= 0 is dead) and a block's first id as its expert.  e_row:
    (Gl, R) global expert of each sorted row."""
    Gl, ne, R = src.shape
    epad = torch.cat([e_row, torch.zeros((Gl, 1), dtype=e_row.dtype, device=e_row.device)], dim=1)
    e_src = epad.gather(1, src.reshape(Gl, ne * R)).reshape(Gl, ne, R)
    dest = torch.arange(ne, device=src.device)[None, :, None]
    return torch.where(valid, e_src - dest * epl, torch.full_like(e_src, -1))


def ragged_ep_dispatch(params, xg: torch.Tensor, plan: RoutingPlan, cfg: ModelConfig,
                       block_rows: int, placed) -> torch.Tensor:
    """Explicit expert parallelism over the ragged layout
    (``repro.core.dispatch.dropless.ragged_ep_dispatch``).

    The :class:`~repro_torch.core.routers.base.RaggedView` is expert-major
    with block-aligned segments, so the rows bound for expert shard ``s``
    (experts ``[s * E / ne, (s + 1) * E / ne)``) are one block-aligned range
    ``[offsets[s * E / ne], offsets[(s + 1) * E / ne])`` of a group.  This
    rank takes its groups of the joint (data, expert) axis, packs each
    group's ne ranges into an ``(ne, R)`` row budget (padding parked on a
    zero row), ships them with one ``all_to_all`` over the expert axis
    (with each block's local expert id), runs the ragged FFN on its own
    experts, sends the rows back, unpacks them to the single-device layout,
    combines them (``ragged_combine`` over this rank's groups' row map) and
    all-gathers its groups over the mesh.  Whole row blocks move, so every
    FFN block holds the rows it holds in the single-device layout."""
    mesh, e_ax, _ = placed
    ne = mesh.shape[e_ax]
    joint = joint_axes(placed)
    E = plan.num_experts
    epl = E // ne
    dt = cfg.activation_dtype
    G, _, M = xg.shape
    bx = block_rows
    Gl = G // math.prod(mesh.shape[a] for a in joint)
    rows = slice(joint_rank(mesh, joint) * Gl, (joint_rank(mesh, joint) + 1) * Gl)
    rag = plan.ragged(bx)
    R = rag.token.shape[1]
    dev = xg.device
    group, joint_group = mesh.group(e_ax), mesh.axes_group(joint)

    token, gate = rag.token[rows], collectives.scatter_to(rag.gate, joint_group)
    offsets, bexp = rag.expert_offsets[rows].long(), rag.block_expert[rows].long()
    toks = torch.clamp(token, min=0).long()                     # -1 -> row 0
    xl = collectives.scatter_to(xg, joint_group)
    xs = xl.gather(1, toks[..., None].expand(Gl, R, M)).to(dt)
    e_row = bexp.repeat_interleave(bx, dim=1)                   # (Gl, R) global ids
    srcp, valid = shard_slots(offsets, epl, R)                  # parked on the pad row
    gi = torch.arange(Gl, device=dev)[:, None, None].expand(Gl, ne, R)
    xpad = torch.cat([xs, torch.zeros((Gl, 1, M), dtype=dt, device=dev)], dim=1)
    buf = xpad[gi, srcp]                                        # (Gl, ne, R, M)
    ebuf = slot_expert_ids(e_row, srcp, valid, epl)             # local ids, -1 on padding
    # ship: the leading axis is the destination expert shard, then the source
    recv = collectives.all_to_all(buf.transpose(0, 1), group, split_axis=0, concat_axis=0)
    erecv = collectives.all_to_all(ebuf.transpose(0, 1), group, split_axis=0, concat_axis=0)
    out = dropless_ops.ragged_ffn(
        recv.reshape(ne * Gl * R, M), erecv.reshape(-1, bx)[:, 0].to(torch.int32).contiguous(),
        params["up"].to(dt), params["gate"].to(dt) if "gate" in params else None,
        params["down"].to(dt), cfg.ffn_activation, block_x=bx,
        live=erecv.reshape(ne * Gl, R), tile=plan_tile_rows(plan, bx, "gate" in params, ne * Gl))
    back = collectives.all_to_all(out.reshape(ne, Gl, R, M), group, split_axis=0,
                                  concat_axis=0).transpose(0, 1)   # (Gl, ne, R, M)
    back = torch.where(valid[..., None], back, torch.zeros_like(back))
    # valid sources are distinct; the parked pad row only ever takes zeros
    res = torch.zeros((Gl, R + 1, M), dtype=dt, device=dev).index_put_((gi, srcp), back)[:, :R]
    y = ragged_combine(res, gate, combine_rows(plan, rag.sort_order[rows], rows))
    return collectives.all_gather(y, joint_group, dim=0, grad="slice")


def dropless_dispatch(params, xg: torch.Tensor, plan: RoutingPlan,
                      cfg: ModelConfig, block_rows: int = 0) -> torch.Tensor:
    dt = cfg.activation_dtype
    G, _, M = xg.shape
    block_rows = block_rows or plan_block_rows(plan)
    placed = expert_mesh_plan(plan, G)
    if placed is not None:
        return ragged_ep_dispatch(params, xg, plan, cfg, block_rows, placed)
    rag = plan.ragged(block_rows)
    R = rag.token.shape[1]

    tok = torch.clamp(rag.token, min=0).long()                   # -1 -> row 0
    xs = xg.gather(1, tok[..., None].expand(G, R, M)).to(dt)
    out = dropless_ops.ragged_ffn(
        xs.reshape(G * R, M), rag.block_expert.reshape(-1).contiguous(),
        params["up"].to(dt), params["gate"].to(dt) if "gate" in params else None,
        params["down"].to(dt), cfg.ffn_activation, block_x=block_rows, live=rag.token,
        tile=plan_tile_rows(plan, block_rows, "gate" in params))
    return ragged_combine(out.reshape(G, R, M), rag.gate, combine_rows(plan, rag.sort_order))


@register_dispatcher
class DroplessDispatcher:
    name = "dropless"
    supports_dropless = True
    max_block_rows = 128

    def __call__(self, params, xg, plan: RoutingPlan, cfg: ModelConfig,
                 ctx: Optional[MoEContext] = None) -> torch.Tensor:
        return dropless_dispatch(params, xg, plan, cfg,
                                 block_rows=plan_block_rows(plan, self.max_block_rows))
