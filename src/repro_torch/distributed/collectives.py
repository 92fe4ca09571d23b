"""The collectives of the port's mesh paths, over ``torch.distributed``.

:func:`all_to_all` is ``jax.lax.all_to_all`` in its tiled form (split
``split_axis`` into one chunk a rank, send chunk i to rank i, concatenate
what arrives along ``concat_axis`` in rank order); :func:`all_gather`
concatenates every rank's tensor along a dim, in rank order.  Over a
group of one rank each returns its input and runs nothing.

Each function counts its calls that ran a collective in ``.launches``
(beside the kernels' ``launches``: a test or ``chip_smoke.py`` asserts
that expert parallelism really engaged from ``all_to_all.launches``, the
port's counterpart of the reference's jaxpr check ``"all_to_all" in
str(jx)``) and the host seconds they took in ``.seconds``.  Under gloo a
CUDA tensor is staged through host memory, so those seconds are the
copies and the exchange.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all over ``group`` (n ranks): ``x.shape[split_axis]``
    must divide by n; the result's ``split_axis`` shrinks n-fold and its
    ``concat_axis`` grows n-fold (both the same axis: the shape is kept)."""
    n = _size(group)
    if n == 1:
        return x
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
    all_to_all.launches += 1
    all_to_all.seconds += time.perf_counter() - t0
    return out


all_to_all.launches = 0
all_to_all.seconds = 0.0


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    n = _size(group)
    if n == 1:
        return x
    t0 = time.perf_counter()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=dim)
    all_gather.launches += 1
    all_gather.seconds += time.perf_counter() - t0
    return out


all_gather.launches = 0
all_gather.seconds = 0.0


def agree_max(value: float, group, device) -> float:
    """The largest of the ranks' ``value``s, on every rank: how the ranks of
    a serving mesh agree on the step clock, so that they admit alike.  Host
    bookkeeping, not counted."""
    if _size(group) == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def reset_counters() -> None:
    for fn in (all_to_all, all_gather):
        fn.launches = 0
        fn.seconds = 0.0
