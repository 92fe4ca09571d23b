"""The collectives of the port's mesh paths, over ``torch.distributed``.

:func:`all_to_all` is ``jax.lax.all_to_all`` in its tiled form (split
``split_axis`` into one chunk a rank, send chunk i to rank i, concatenate
what arrives along ``concat_axis`` in rank order); :func:`all_gather`
concatenates every rank's tensor along a dim, in rank order;
:func:`all_reduce` sums (or takes the max) over the ranks;
:func:`reduce_scatter` is an all-reduce whose result each rank keeps only
its chunk of (gloo has no reduce-scatter: the sum is the same).  Over a
group of one rank each returns its input and runs nothing.

Each is differentiable, because the training mesh differentiates through
them (the reference's GSPMD writes the transposes itself):

* ``all_to_all``'s backward is the inverse exchange;
* ``all_gather``'s backward depends on who consumes the result:
  ``grad="slice"`` (every rank computes the same thing from the gathered
  tensor, so its gradient is already whole on every rank: the rank keeps
  its chunk) or ``grad="sum"`` (the ranks consume it differently: the
  chunk's gradient is the sum over ranks, a reduce-scatter; FSDP's
  gather of a parameter at its use);
* ``all_reduce``'s (sum) backward is the identity (the result feeds the
  same computation on every rank);
* :func:`copy_to` is the identity whose backward all-reduces (the input of
  a region that each rank computes a part of), and :func:`scatter_to`
  keeps the rank's chunk and all-gathers in the backward.

Each function counts its calls that ran a collective in ``.launches``,
forward and backward alike (beside the kernels' ``launches``: a test or
``chip_smoke.py`` asserts that expert parallelism really engaged from
``all_to_all.launches``, the port's counterpart of the reference's jaxpr
check ``"all_to_all" in str(jx)``), the host seconds they took in
``.seconds``, and their wire bytes in ``.bytes``, by the mesh axis of the
group (:func:`name_group`; ``"group"`` for a group no mesh named).  Under
gloo a CUDA tensor is staged through host memory, so those seconds are
the copies and the exchange.

Under :func:`scope` a call is also counted in ``.scoped`` by (the
scope's name, the mesh axis), and so is each collective its backward
runs, under the scope its forward ran in: one layer's collectives,
forward, remat recompute and backward, apart from the step's others
(``core.moe_attention`` counts its own so).

The bytes follow the reference's HLO parser (``repro.distributed.hlo``):
an all-reduce counts twice its operand (a ring: reduce-scatter then
all-gather), an all-gather the gathered size, a reduce-scatter its input,
an all-to-all its operand; each call once.  :func:`collective_bytes` sums
them in the reference's shape.  On ``meta`` tensors under the ``fake``
process group (the dry run) every call is counted as it would run, and
nothing moves.
"""
from __future__ import annotations

import contextlib
import time
import types
from collections import defaultdict
from typing import Dict, Optional

import torch
import torch.distributed as dist

# the mesh axis (or joint axes) each process group spans, for the byte counts
_GROUP_NAMES: Dict[object, str] = {}
# the name of the scope the collectives run in (process-wide, as the rules
# are: a CUDA backward runs on an autograd thread of its own)
_scope = types.SimpleNamespace(name=None)


def name_group(group, axis: str) -> None:
    """Count the bytes of collectives over ``group`` under ``axis``."""
    _GROUP_NAMES[group] = axis


def forget_groups() -> None:
    """Drop every named group: the names hold the groups themselves, so
    without this a gloo group and its threads outlive
    ``destroy_process_group`` until the interpreter's own teardown."""
    _GROUP_NAMES.clear()


@contextlib.contextmanager
def scope(name: Optional[str]):
    """Count the collectives run inside, and those of their backward, in
    ``.scoped[name, axis]`` too."""
    prev, _scope.name = _scope.name, name
    try:
        yield
    finally:
        _scope.name = prev


def _size(group) -> int:
    return dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_group_rank(group, dist.get_rank()) if group is not None else dist.get_rank()


def _count(fn, t0: float, group, wire: float, result: float) -> None:
    """One call of ``fn`` over ``group``: ``wire`` bytes by the module
    doc's convention, ``result`` the bytes of its result (the HLO's)."""
    axis = _GROUP_NAMES.get(group, "group")
    fn.launches += 1
    fn.seconds += time.perf_counter() - t0
    fn.bytes[axis] += wire
    fn.result_bytes += result
    if _scope.name is not None:
        fn.scoped[_scope.name, axis] += 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _exchange(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    n = _size(group)
    t0 = time.perf_counter()
    S = x.shape[split_axis]
    if S % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    send = x.movedim(split_axis, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    chunks = recv.reshape(n, S // n, *send.shape[1:]).unbind(0)
    out = torch.cat([c.movedim(0, split_axis) for c in chunks], dim=concat_axis)
    _count(all_to_all, t0, group, _nbytes(x), _nbytes(x))
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args, ctx.scope = (group, split_axis, concat_axis), _scope.name
        return _exchange(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        with scope(ctx.scope):
            return _exchange(g, group, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all over ``group`` (n ranks): ``x.shape[split_axis]``
    must divide by n; the result's ``split_axis`` shrinks n-fold and its
    ``concat_axis`` grows n-fold (both the same axis: the shape is kept)."""
    if _size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    t0 = time.perf_counter()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=dim)
    _count(all_gather, t0, group, _nbytes(out), _nbytes(out))
    return out


def _chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    c = x.shape[dim] // n
    return x.narrow(dim, _rank(group) * c, c)


def _reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    t0 = time.perf_counter()
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    _count(all_reduce, t0, group, 2 * _nbytes(out), _nbytes(out))
    return out


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum over ``group``: an
    all-reduce whose chunk the rank keeps (gloo has no reduce-scatter; the
    sum is the same), counted as the reduce-scatter it stands for."""
    t0 = time.perf_counter()
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, group=group)
    out = _chunk(out, group, dim).contiguous()
    _count(reduce_scatter, t0, group, _nbytes(x), _nbytes(out))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, grad):
        ctx.args, ctx.scope = (group, dim, grad), _scope.name
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, grad = ctx.args
        if grad == "sum":
            with scope(ctx.scope):
                return _reduce_scatter(g, group, dim), None, None, None
        return _chunk(g, group, dim).contiguous(), None, None, None


def all_gather(x: torch.Tensor, group, dim: int = 0, grad: str = "slice") -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order; the
    backward as the module doc says (``grad`` "slice" or "sum")."""
    if _size(group) == 1:
        return x
    if grad not in ("slice", "sum"):
        raise ValueError(f"all_gather: grad {grad!r}, expected 'slice' or 'sum'")
    return _AllGather.apply(x, group, dim, grad)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (``op="sum"``, differentiable: the backward is the identity)
    or the elementwise max (``op="max"``, no gradient) over ``group``."""
    if _size(group) == 1:
        return x
    if op == "max":
        return _reduce(x.detach(), group, dist.ReduceOp.MAX)
    if op != "sum":
        raise ValueError(f"all_reduce: op {op!r}, expected 'sum' or 'max'")
    return _AllReduce.apply(x, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.scope = group, _scope.name
        return x

    @staticmethod
    def backward(ctx, g):
        with scope(ctx.scope):
            return _reduce(g, ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """The identity, whose backward sums the gradient over ``group``."""
    if _size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args, ctx.scope = (group, dim), _scope.name
        return _chunk(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        with scope(ctx.scope):
            return _gather(g, group, dim), None, None


def scatter_to(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` (``x`` the same on every
    rank); the backward all-gathers the chunks' gradients."""
    if _size(group) == 1:
        return x
    return _ScatterTo.apply(x, group, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's chunk of the sum of every rank's ``x`` (no gradient)."""
    if _size(group) == 1:
        return x
    return _reduce_scatter(x, group, dim)


def agree_max(value: float, group, device) -> float:
    """The largest of the ranks' ``value``s, on every rank: how the ranks of
    a serving mesh agree on the step clock, so that they admit alike.  Host
    bookkeeping, not counted."""
    if _size(group) == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


COUNTED = (all_to_all, all_gather, all_reduce, reduce_scatter)
# the reference HLO parser's name of each kind
KINDS = {"all_to_all": "all-to-all", "all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter"}


def reset_counters() -> None:
    for fn in COUNTED:
        fn.launches = 0
        fn.seconds = 0.0
        fn.bytes = defaultdict(float)
        fn.result_bytes = 0.0
        fn.scoped = defaultdict(int)


reset_counters()


def collective_bytes() -> Dict[str, float]:
    """The counters since :func:`reset_counters` in the shape of the
    reference's ``hlo.collective_bytes``: each kind's result bytes, the
    wire bytes of them all under ``"total"``, the calls under ``"count"``
    and each kind's under ``"n_<kind>"``."""
    out: Dict[str, float] = {}
    for fn in COUNTED:
        if fn.launches:
            out[KINDS[fn.__name__]] = float(fn.result_bytes)
            out[f"n_{KINDS[fn.__name__]}"] = float(fn.launches)
    out["total"] = float(sum(sum(fn.bytes.values()) for fn in COUNTED))
    out["count"] = float(sum(fn.launches for fn in COUNTED))
    return out


def bytes_by_axis() -> Dict[str, float]:
    """The wire bytes since :func:`reset_counters`, summed by mesh axis."""
    out: Dict[str, float] = defaultdict(float)
    for fn in COUNTED:
        for axis, b in fn.bytes.items():
            out[axis] += b
    return dict(out)


def scoped(name: str) -> Dict[str, Dict[str, int]]:
    """The launches counted under :func:`scope` ``name`` since
    :func:`reset_counters`, by kind (the HLO parser's name) and mesh axis."""
    out: Dict[str, Dict[str, int]] = {}
    for fn in COUNTED:
        for (s, axis), n in fn.scoped.items():
            if s == name:
                out.setdefault(KINDS[fn.__name__], {})[axis] = n
    return out
