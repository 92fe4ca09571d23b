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
:mod:`repro_torch.distributed.collectives` (FSDP's blocks through
:func:`fsdp_gather`, at each use, in every family's forward).  So
:func:`shard`, the
reference's activation constraint, is a no-op here; the model code asks
:func:`tensor_parallel` and :func:`data_parallel` whether the active rules
give it a block of a param axis or a rank's rows of the batch.  A
partition spec is a tuple of mesh axes per dim (``None``: replicated),
trailing ``None``s dropped, as ``tuple(jax.sharding.PartitionSpec(...))``
reads; a :class:`Sharding` is the reference's ``NamedSharding`` (the
trees of :func:`param_shardings` and :func:`activation_shardings`), and
:class:`Blocks` sums a leaf over the ranks that hold its blocks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import types
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.distributed import collectives

MeshAxes = Union[None, str, Tuple[str, ...]]
PSpec = Tuple[MeshAxes, ...]

# Process-wide, not thread-local as the reference's: the autograd engine
# runs a CUDA backward, and with it the remat recompute of a forward, on a
# thread of its own, which must see the rules that forward ran under.
_ctx = types.SimpleNamespace(rules=None)


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
    param tree).  ``batch_sharded``: a rank's activations are its own rows
    of the batch (the training mesh: each data rank draws its rows of the
    global batch); otherwise every rank holds the whole batch (the serving
    mesh, whose dispatch splits the groups itself)."""

    def __init__(self, mesh, params: Mapping[str, MeshAxes], acts: Mapping[str, MeshAxes],
                 cfg=None, batch_sharded: bool = False):
        self.mesh = mesh
        self.params = dict(params)
        self.acts = dict(acts)
        self.cfg = cfg
        self.batch_sharded = batch_sharded
        self.fsdp = None            # fsdp_dims' result, made at its first call


def _size(mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def make_rules(cfg, mesh, *, expert_axis: Optional[str] = None,
               batch_sharded: bool = False) -> Rules:
    """Rules for a ModelConfig on a mesh (the reference's, line for line).
    Mesh axes: optional "pod" (extra DP), "data" (DP), "model" (TP/EP), and
    ``expert_axis`` where experts shard over an axis of their own (the
    serving mesh's "expert").  ``batch_sharded`` as :class:`Rules`'."""
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
    return Rules(mesh, params, acts, cfg=cfg, batch_sharded=batch_sharded)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a training mesh: "pod" (where there is
    one) and "data"."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = _ctx.rules
    _ctx.rules = rules
    try:
        yield rules
    finally:
        _ctx.rules = prev


def active_rules() -> Optional[Rules]:
    return _ctx.rules


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


def tensor_parallel(logical: str):
    """(process group, size, index) of the mesh axis over which the active
    rules shard the param axis ``logical`` (the model axis of a training
    mesh: heads, kv heads, vocab, a dense FFN's mlp), or None where no
    rules are active, the axis is unsharded, or its size is 1."""
    rules = active_rules()
    if rules is None:
        return None
    ax = rules.params.get(logical)
    if ax is None or isinstance(ax, tuple) or rules.mesh.shape[ax] == 1:
        return None
    return rules.mesh.group(ax), rules.mesh.shape[ax], rules.mesh.coord[ax]


def data_parallel():
    """(process group, size, index) of the data axis over which a rank's
    activations are its own rows (``Rules.batch_sharded``), or None where
    no such rules are active or the data axes have one rank."""
    rules = active_rules()
    if rules is None or not rules.batch_sharded:
        return None
    mesh = rules.mesh
    axes = dp_axes(mesh)
    n = math.prod(mesh.shape[a] for a in axes)
    if n == 1:
        return None
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coord[a]
    return mesh.axes_group(axes), n, idx


def fsdp_dims(rules: Rules) -> Dict[str, Tuple[int, int]]:
    """FSDP (``cfg.fsdp``: the "embed" dim over the data axes): the flat
    path of each leaf of the rules' param tree whose placement shards a dim
    over the data axes, that dim and its whole size; empty where the data
    axes have one rank or no leaf is so placed."""
    if rules.fsdp is None:
        rules.fsdp = {}
        dp = set(dp_axes(rules.mesh))
        if rules.cfg is not None and _size(rules.mesh, tuple(dp)) > 1:
            from repro_torch.nn.spec import flat_params, model_shapes

            for k, s in flat_params(model_shapes(rules.cfg, train=True)).items():
                spec = logical_to_pspec(s.axes, rules.params, s.shape, rules.mesh)
                dim = next((i for i, e in enumerate(spec) if dp & set(_axes(e))), None)
                if dim is not None:
                    rules.fsdp[k] = (dim, s.shape[dim])
    return rules.fsdp


def fsdp_gather(tree, prefix: str = "", lead: int = 0):
    """``tree``, a subtree of the params at flat path ``prefix`` (with
    ``lead`` leading dims of its leaves unbound, a stacked layer's), with
    every FSDP block of the active rules all-gathered whole over the data
    axes (``grad="sum"``: the backward reduce-scatters its gradient).  A
    leaf held whole (the router) stays as it is, and so does everything
    where no rules are active or FSDP is off.  Called at each use of the
    parameters, inside the remat region, so that the recompute gathers
    again and no whole leaf outlives its layer."""
    rules = active_rules()
    dims = fsdp_dims(rules) if rules is not None else {}
    if not dims:
        return tree
    group = rules.mesh.axes_group(dp_axes(rules.mesh))

    def walk(node, path):
        if isinstance(node, Mapping):
            return {k: walk(v, f"{path}{k}/") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}{i}/") for i, v in enumerate(node)]
        if path[:-1] not in dims or not isinstance(node, torch.Tensor):
            return node
        dim, whole = dims[path[:-1]]
        if node.shape[dim - lead] == whole:
            return node                             # held whole (the router)
        return collectives.all_gather(node, group, dim=dim - lead, grad="sum")

    return walk(tree, prefix)


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
        raise ValueError(f"{'/'.join(map(str, path))}: a param leaf without logical axes")
    return logical_to_pspec(s.axes, rules.params, s.shape, rules.mesh)


# Leaves whose contiguous block of a sharded dim is not what a rank
# computes with, held whole on every rank (as the router is), the rank
# reading its own columns at use: Mamba2's conv runs over the x, B and C
# channels, and a rank needs its x channels and all of B and C (a block of
# zamba2-7b's 7296 conv channels does not line up with a block of its 7168
# x channels); the sLSTM FFN's up projection is the columns of u then of
# the gate, which a rank needs pairwise (``models.xlstm``).
HELD_WHOLE = {"zamba": ("conv_w", "conv_b"), "xlstm": ("ffn_up",)}


def _placed_pspec(path, s, rules: Rules, keep: Sequence[str]) -> PSpec:
    """A leaf's spec as a mesh rank holds it: :func:`_leaf_pspec`, or
    whole for a last key in ``keep`` or in the family's ``HELD_WHOLE``."""
    whole = tuple(keep) + HELD_WHOLE.get(getattr(rules.cfg, "family", None), ())
    return () if path and path[-1] in whole else _leaf_pspec(path, s, rules)


def param_pspecs(shape_tree, rules: Rules):
    """ParamShape tree -> partition spec tree under ``rules.params``."""
    return _map_shapes(lambda p, s: _leaf_pspec(p, s, rules), shape_tree)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's placement on a mesh (the reference's ``NamedSharding``):
    the mesh and one entry of mesh axes a dim."""

    mesh: object
    spec: PSpec

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        for dim, ax in enumerate(self.spec):
            out[dim] //= _size(self.mesh, ax)
        return tuple(out)

    def slice(self, t: torch.Tensor, coord: Mapping[str, int]) -> torch.Tensor:
        """The rank at ``coord``'s block of the whole leaf ``t``."""
        return _slice(t, self.spec, self.mesh, coord)

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's block ``t`` (all-gathered over
        each sharded dim's axes; the mesh must have process groups)."""
        for dim, ax in enumerate(self.spec):
            if ax is None:
                continue
            for a in reversed(ax if isinstance(ax, tuple) else (ax,)):   # minor axis first
                t = collectives.all_gather(t.detach(), self.mesh.group(a), dim=dim)
        return t


class Blocks:
    """A rank's block of a leaf placed by ``spec`` on ``mesh``: sums over
    the whole leaf from the block (the mesh must have process groups)."""

    def __init__(self, mesh, spec: PSpec, ndim: int):
        self.mesh = mesh
        self.spec = tuple(spec) + (None,) * (ndim - len(spec))

    def sum(self, x: torch.Tensor, dim: Optional[int] = None, keepdim: bool = False):
        """(the whole leaf's sum over ``dim``, or over all of it, as this
        rank's block of the result; the number of elements summed)."""
        dims = range(x.dim()) if dim is None else (dim % x.dim(),)
        axes = tuple(a for d in dims for a in _axes(self.spec[d]))
        n = x.numel() if dim is None else x.shape[dim]
        n *= math.prod(self.mesh.shape[a] for a in axes)
        out = x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)
        axes = tuple(a for a in axes if self.mesh.shape[a] > 1)
        if axes:
            out = collectives.all_reduce(out, self.mesh.axes_group(axes))
        return out, n

    def without(self, dim: int) -> "Blocks":
        """The blocks of a reduction over ``dim`` (keepdim or not: the
        reduced dim is whole)."""
        spec = list(self.spec)
        del spec[dim]
        return Blocks(self.mesh, tuple(spec), len(spec))


def _axes(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def param_shardings(shape_tree, rules: Rules, keep: Sequence[str] = ()):
    """ParamShape tree -> :class:`Sharding` tree: the placement that
    :func:`shard_params` cuts (a leaf whose last key is in ``keep`` or in
    ``HELD_WHOLE`` whole)."""
    def one(path, s):
        return Sharding(rules.mesh, _placed_pspec(path, s, rules, keep))

    return _map_shapes(one, shape_tree)


def activation_shardings(tree, cfg, global_batch: int, seq_len: int, rules: Rules):
    """Heuristic placements for decode-state / batch trees (the
    reference's, line for line): per leaf (anything with ``.shape``), the
    first dim equal to ``global_batch`` shards over DP; a dim matching a
    known head count (kv heads, q heads, ssm heads) shards over the model
    axis; if no head dim shards, a 3+-dim leaf's ``seq_len`` dim takes the
    model axis (a sequence-sharded KV cache); if no batch dim shards, the
    ``seq_len`` dim takes DP.  Divisibility is always checked; fallback is
    replication.  Returns the tree of :class:`Sharding`."""
    mesh = rules.mesh
    dp = dp_axes(mesh)
    tp = "model" if "model" in mesh.axis_names else None
    dp_size = _size(mesh, dp)
    tp_size = mesh.shape[tp] if tp else 1
    hd = cfg.resolved_head_dim
    head_like = {cfg.num_kv_heads, cfg.num_heads, cfg.ssm_heads or -1,
                 cfg.num_kv_heads * hd, cfg.num_heads * hd}
    dp_entry = dp if len(dp) > 1 else dp[0]

    def one(leaf):
        shape = getattr(leaf, "shape", None)
        if shape is None or len(shape) == 0:
            return Sharding(mesh, ())
        entries = [None] * len(shape)
        batch_done = False
        for i, d in enumerate(shape):
            if not batch_done and d == global_batch and d % dp_size == 0 and d > 1:
                entries[i] = dp_entry
                batch_done = True
                break
        tp_done = False
        for i, d in enumerate(shape):
            if entries[i] is None and tp and not tp_done and d in head_like and d % tp_size == 0:
                entries[i] = tp
                tp_done = True
        if not tp_done and tp and len(shape) >= 3:
            for i, d in enumerate(shape):
                if entries[i] is None and d == seq_len and d % tp_size == 0 and d > 1:
                    entries[i] = tp
                    tp_done = True
                    break
        if not batch_done:
            for i, d in enumerate(shape):
                if entries[i] is None and d == seq_len and d % dp_size == 0 and d > 1:
                    entries[i] = dp_entry
                    break
        while entries and entries[-1] is None:
            entries.pop()
        return Sharding(mesh, tuple(entries))

    def walk(t):
        if isinstance(t, Mapping):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)) and not hasattr(t, "shape"):
            return type(t)(walk(v) for v in t)
        return one(t)

    return walk(tree)


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
    key is in ``keep`` (or in ``HELD_WHOLE``) stays whole."""
    def place(path, s, leaf):
        return _slice(leaf, _placed_pspec(path, s, rules, keep), rules.mesh, coord)

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
        for dim, ax in enumerate(_placed_pspec(path, s, rules, keep)):
            if ax is not None:
                want[dim] //= _size(rules.mesh, ax)
        if tuple(node.shape) != tuple(want):
            raise ValueError(f"{'/'.join(map(str, path))}: shape {tuple(node.shape)}, a mesh "
                             f"rank's placement is {tuple(want)} (shard_params)")

    _map_shapes(one, model_shapes(rules.cfg))
