"""Logical-axis sharding rules (``repro.distributed.sharding``), as pure
functions over axis names and sizes.

Parameters carry *logical* axis names ("embed", "mlp", "heads", "expert",
"layers", ...; ``ParamShape.axes`` in :mod:`repro_torch.nn.spec`).  A
:class:`Rules` object maps them to mesh axes for a (config, mesh) pair,
falling back to replication where a dimension does not divide over the
mesh axis (granite's 40 experts on a 16-way axis), exactly as the
reference's :func:`make_rules` does.  A *mesh* here is anything with
``axis_names`` and a ``shape`` mapping of axis to size:
:class:`MeshShape`, or :class:`repro_torch.launch.mesh.Mesh`, which also
carries the rank's coordinate and process groups.

The reference hands its specs to GSPMD.  PyTorch has no GSPMD: a mesh rank
runs one process and holds its own slices, which :func:`shard_params` cuts
(and :func:`placement` cuts as ``init_params`` draws each leaf), and the
code that needs another rank's slice asks for it through
:mod:`repro_torch.distributed.collectives`.  So :func:`shard`, the
reference's activation constraint, is a no-op here.  A partition spec is a
tuple of mesh axes per dim (``None``: replicated), trailing ``None``s
dropped, as ``tuple(jax.sharding.PartitionSpec(...))`` reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
PSpec = Tuple[MeshAxes, ...]

_ctx = threading.local()


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, all that the rules read of it."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


class Rules:
    """Logical -> mesh axis maps for parameters and activations, with the
    config they were made for (the port's :func:`shard_params` reads its
    param tree)."""

    def __init__(self, mesh, params: Mapping[str, MeshAxes], acts: Mapping[str, MeshAxes],
                 cfg=None):
        self.mesh = mesh
        self.params = dict(params)
        self.acts = dict(acts)
        self.cfg = cfg


def _size(mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def make_rules(cfg, mesh, *, expert_axis: Optional[str] = None) -> Rules:
    """Rules for a ModelConfig on a mesh (the reference's, line for line).
    Mesh axes: optional "pod" (extra DP), "data" (DP), "model" (TP/EP), and
    ``expert_axis`` where experts shard over an axis of their own (the
    serving mesh's "expert")."""
    axes = mesh.axis_names
    dp: MeshAxes = ("pod", "data") if "pod" in axes else ("data",)
    tp = "model" if "model" in axes else None
    if expert_axis == "dp":
        # pure data parallelism: fold the model axis into DP
        dp = dp + (tp,) if tp else dp
        tp = None
        expert_axis = None
    model_size = mesh.shape[tp] if tp else 1

    def div(n: int, ax: MeshAxes) -> MeshAxes:
        if ax is None:
            return None
        return ax if n % _size(mesh, ax) == 0 else None

    m = cfg.moe
    e_ax = expert_axis or (m.expert_axis if m.num_experts else "model")
    hd = cfg.resolved_head_dim
    params = {
        "embed": dp if cfg.fsdp and cfg.d_model % _size(mesh, dp) == 0 else None,
        "mlp": div(cfg.d_ff, tp) if cfg.d_ff else tp,
        "heads": div(cfg.num_heads * hd, tp),
        "kv_heads": div(cfg.num_kv_heads * hd, tp) if cfg.num_kv_heads % model_size == 0 else None,
        "vocab": tp,
        "expert": div(m.num_experts, e_ax) if m.num_experts else None,
        "layers": None,
        "ssm_inner": div(cfg.ssm_expand * cfg.d_model, tp) if cfg.ssm_state else None,
    }
    # experts that cannot shard keep TP on the per-expert mlp dim instead
    if m.num_experts and params["expert"] is None:
        params["mlp"] = div(cfg.d_ff, tp)
    elif m.num_experts:
        params["mlp"] = None if e_ax == tp else div(cfg.d_ff, tp)
    acts = {
        "batch": dp, "groups": dp, "seq": None, "embed": None, "mlp": params["mlp"],
        "heads": params["heads"], "kv_heads": params["kv_heads"],
        "vocab": params["vocab"], "expert": params["expert"], "cache_seq": None,
    }
    return Rules(mesh, params, acts, cfg=cfg)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = getattr(_ctx, "rules", None)
    _ctx.rules = rules
    try:
        yield rules
    finally:
        _ctx.rules = prev


def active_rules() -> Optional[Rules]:
    return getattr(_ctx, "rules", None)


def logical_to_pspec(logical_axes: Sequence[Optional[str]], table: Mapping[str, MeshAxes],
                     shape: Optional[Sequence[int]] = None, mesh=None) -> PSpec:
    """Mesh axes per dim: a logical axis maps through ``table`` unless its
    mesh axes are already used by an earlier dim or (given ``shape`` and
    ``mesh``) its size does not divide over them."""
    spec = []
    used = set()
    for i, name in enumerate(logical_axes):
        ax = table.get(name) if name is not None else None
        if ax is not None:
            flat = ax if isinstance(ax, tuple) else (ax,)
            if any(a in used for a in flat):
                ax = None
            elif shape is not None and mesh is not None and shape[i] % _size(mesh, flat):
                ax = None
            if ax is not None:
                used.update(flat)
        spec.append(ax)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The reference's activation sharding constraint: a no-op in the port,
    which has no GSPMD to hand it to (a rank computes what it holds)."""
    return x


def _map_shapes(fn, shapes, path=()):
    from repro_torch.nn.spec import ParamShape

    if isinstance(shapes, ParamShape):
        return fn(path, shapes)
    if isinstance(shapes, list):
        return [_map_shapes(fn, v, path + (i,)) for i, v in enumerate(shapes)]
    return {k: _map_shapes(fn, v, path + (k,)) for k, v in shapes.items()}


def _leaf_pspec(path, s, rules: Rules) -> PSpec:
    if s.axes is None:
        raise NotImplementedError(
            f"{'/'.join(map(str, path))}: this family's param tree carries no logical "
            f"axes (only the decoder-LM tree is placed on a mesh)")
    return logical_to_pspec(s.axes, rules.params, s.shape, rules.mesh)


def param_pspecs(shape_tree, rules: Rules):
    """ParamShape tree -> partition spec tree under ``rules.params``."""
    return _map_shapes(lambda p, s: _leaf_pspec(p, s, rules), shape_tree)


def _slice(t: torch.Tensor, spec: PSpec, mesh, coord: Mapping[str, int]) -> torch.Tensor:
    out = t
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        flat = ax if isinstance(ax, tuple) else (ax,)
        idx = 0
        for a in flat:                      # row-major over the named axes
            idx = idx * mesh.shape[a] + coord[a]
        n = _size(mesh, flat)
        chunk = t.shape[dim] // n
        out = out.narrow(dim, idx * chunk, chunk)
    # a copy, so that the whole leaf's storage can go
    return out if out is t else out.clone(memory_format=torch.contiguous_format)


def placement(rules: Rules, coord: Mapping[str, int], keep: Sequence[str] = ()) -> Callable:
    """``place(path, shape, leaf)`` for ``init_params``: the rank at
    ``coord`` ({axis: index}) keeps its slice of ``leaf``; a leaf whose last
    key is in ``keep`` stays whole."""
    def place(path, s, leaf):
        if path and path[-1] in keep:
            return leaf
        return _slice(leaf, _leaf_pspec(path, s, rules), rules.mesh, coord)

    return place


def shard_params(params, rules: Rules, coord: Mapping[str, int], keep: Sequence[str] = ()):
    """The rank at ``coord``'s slice of every leaf of ``params`` (the tree
    of ``rules.cfg``, as ``nn.spec.from_jax_params`` and ``init_params``
    build it), each leaf cut by its partition spec; ``keep`` as
    :func:`placement`'s."""
    from repro_torch.nn.spec import model_shapes

    place = placement(rules, coord, keep)

    def one(path, s):
        node = params
        for k in path:
            node = node[k]
        return place(path, s, node)

    return _map_shapes(one, model_shapes(rules.cfg))


def check_placed(params, rules: Rules, keep: Sequence[str] = ()) -> None:
    """Raise unless every leaf of ``params`` has the shape of a rank's
    placement under ``rules`` (:func:`shard_params`'s, ``keep`` whole)."""
    from repro_torch.nn.spec import model_shapes

    def one(path, s):
        node = params
        for k in path:
            node = node[k]
        want = list(s.shape)
        if not (path and path[-1] in keep):
            for dim, ax in enumerate(_leaf_pspec(path, s, rules)):
                if ax is not None:
                    want[dim] //= _size(rules.mesh, ax)
        if tuple(node.shape) != tuple(want):
            raise ValueError(f"{'/'.join(map(str, path))}: shape {tuple(node.shape)}, a mesh "
                             f"rank's placement is {tuple(want)} (shard_params)")

    _map_shapes(one, model_shapes(rules.cfg))
