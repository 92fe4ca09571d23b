"""Where an MoE layer's experts sit on a mesh, for the dispatchers and
``core.moe.moe_ffn_apply``.

Under a mesh whose active :class:`~repro_torch.distributed.sharding.Rules`
shard the experts over an axis, a rank holds experts ``[e * E / ne,
(e + 1) * E / ne)`` of every expert leaf.  :func:`expert_mesh_plan` is the
reference's placement test (``repro.core.dispatch.alltoall._expert_mesh_plan``):
the dispatchers in :data:`EXPERT_PARALLEL` run explicit expert parallelism
when it places the plan.  Every other case, a backend that reads all the
experts or a plan whose groups do not split over the mesh, computes the
single-device dispatch over the layer's experts gathered whole
(:func:`gathered_experts`), as the reference's GSPMD computes the unsharded
one; ``moe_ffn_apply`` makes that choice once a layer.

The groups split over a *joint* axis (:func:`joint_axes`): on the
serving mesh, whose ranks all hold the whole batch, the data and expert
axes jointly (the reference's ``shard_map`` layout); on a training mesh,
whose data ranks hold their own groups (``Rules.batch_sharded``), the
expert axis alone.  A rank's groups enter the exchange through
``collectives.scatter_to`` and its combined output leaves through an
all-gather over the joint axis, whose backward keeps the rank's own
groups' gradient: the groups were the same on every rank of the joint
axis, and so is what is computed from the gathered output.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from repro_torch.core.routers.base import RoutingPlan
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import active_rules

EXPERT_LEAVES = ("up", "gate", "down")
# the backends that run on a rank's own experts when the plan is placed
EXPERT_PARALLEL = ("alltoall", "dropless")


def expert_mesh_plan(plan: RoutingPlan, G: int) -> Optional[Tuple]:
    """(mesh, expert_axis, group_axes) when explicit EP can run, else None."""
    rules = active_rules()
    if rules is None:
        return None
    e_ax = rules.params.get("expert")
    if e_ax is None or isinstance(e_ax, tuple):
        return None
    mesh = rules.mesh
    ne = mesh.shape[e_ax]
    if ne <= 1 or plan.num_experts % ne != 0:
        return None
    dp = rules.acts.get("groups")
    dp_axes = () if dp is None else (dp if isinstance(dp, tuple) else (dp,))
    dp_axes = tuple(a for a in dp_axes if a != e_ax)
    if rules.batch_sharded:
        # a training rank's groups are already its data rank's: they split
        # over the expert axis alone
        dp_axes = ()
    nd = math.prod(mesh.shape[a] for a in dp_axes)
    if G % (nd * ne) != 0:
        return None
    return mesh, e_ax, dp_axes


def joint_axes(placed) -> Tuple[str, ...]:
    """The axes the groups split over, of :func:`expert_mesh_plan`'s
    result."""
    _, e_ax, dp_axes = placed
    return (*dp_axes, e_ax)


def joint_rank(mesh, axes: Tuple[str, ...]) -> int:
    """This rank's index on the joint axis ``axes`` (row-major)."""
    r = 0
    for a in axes:
        r = r * mesh.shape[a] + mesh.coord[a]
    return r


def gathered_experts(params, dtype=None):
    """``params`` with the expert leaves whole: all-gathered over the expert
    axis when the active rules shard them, and over the axis that shards
    each expert's mlp dim where the experts do not divide over the mesh
    (granite's 40 over 16: the rules then shard ``d_ff`` instead) — a
    transient of the layer's expert bytes — else as they are.  ``dtype``:
    the dtype the expert FFN casts them to at use, cast before the gather
    (the same values; a training tree's f32 masters move in half the
    bytes).  Every rank of those axes then computes the same dispatch, so
    the gather's backward keeps each rank its own block's gradient
    (``grad="slice"``), not a sum over ranks."""
    rules = active_rules()
    if rules is None:
        return params
    e_ax, mlp_ax = rules.params.get("expert"), rules.params.get("mlp")
    gathers = []                            # (axis, {leaf: dim})
    if e_ax is not None and rules.mesh.shape[e_ax] > 1:
        gathers.append((e_ax, {k: 0 for k in EXPERT_LEAVES}))
    elif mlp_ax is not None and not isinstance(mlp_ax, tuple) and rules.mesh.shape[mlp_ax] > 1 \
            and "up" in params and params["up"].shape[-1] != rules.cfg.d_ff:
        gathers.append((mlp_ax, {"up": -1, "gate": -1, "down": -2}))
    if not gathers:
        return params
    out = dict(params)
    for k in EXPERT_LEAVES:
        if k in params and dtype is not None:
            out[k] = params[k].to(dtype)
    for axis, dims in gathers:
        group = rules.mesh.group(axis)
        for k, dim in dims.items():
            if k in out:
                out[k] = collectives.all_gather(out[k], group, dim=dim, grad="slice")
    return out
