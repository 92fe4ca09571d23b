"""Where a training rank's leaves sit on a ("data", "model") mesh, and the
collectives the mesh train step writes out where the reference leaves them
to GSPMD (``repro.launch.train`` under pjit).

A rank holds, for every parameter, its block under the reference's
partition specs (``distributed.sharding.param_shardings``: experts, heads,
kv heads and the vocab over "model" where they divide; the router whole on
every rank, as the serving mesh keeps it), replicated over the data axes.
Its gradient after the backward is that block's, for the rank's rows of
the batch; :meth:`MeshLayout.reduce_grads` sums it over the data axes
(each rank's loss is its part of the global mean, ``train.losses``).
ZeRO-1 (``optim.zero``): the optimizer state of a parameter is the
rank's block of the state under ``zero1_spec`` (the parameter's spec with
the data axes on its first free divisible dim); the rank updates that
block of the parameter (:meth:`MeshLayout.zero_block`) and all-gathers the
updated blocks over the data axes (:meth:`MeshLayout.gather_update`).
Clipping takes the whole gradient's norm (:meth:`MeshLayout.sum_squares`)
and int8 compression the whole leaf's maximum
(:meth:`MeshLayout.global_max`).  Under FSDP (``cfg.fsdp``: the "embed"
dim over the data axes) a leaf so placed is the rank's block of the data
axes too: the model code gathers it at each use
(``sharding.fsdp_gather``), its gradient arrives as the rank's block of
the sum (a reduce-scatter), which :meth:`MeshLayout.reduce_grads` does not
sum again, and ZeRO-1 leaves it as it is (its data axes are taken).  On a
mesh of one rank every collective
is skipped and the step is the single-device one, bit for bit
(:meth:`MeshLayout.single` is that layout, without a process group).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (
    Blocks,
    MeshShape,
    Rules,
    Sharding,
    dp_axes,
    fsdp_dims,
    make_rules,
    param_shardings,
)
from repro_torch.nn import flat_params, model_shapes
from repro_torch.optim.zero import zero1_spec
from repro_torch.train.state import TrainState

BUCKET_ELEMS = 1 << 26          # a gradient all-reduce moves at most 256 MB of f32 at a time


def _uses(spec, axes) -> bool:
    return any(a in axes for e in spec if e is not None
               for a in (e if isinstance(e, tuple) else (e,)))


class MeshLayout:
    """The placement of a training rank's parameters, gradients and
    optimizer state under ``rules`` (``make_rules(cfg, mesh,
    batch_sharded=True)``); ``keep``: the param keys held whole."""

    def __init__(self, cfg, rules: Rules, keep: Sequence[str] = ("router",)):
        mesh = rules.mesh
        self.cfg, self.rules, self.mesh, self.keep = cfg, rules, mesh, tuple(keep)
        shapes = model_shapes(cfg, train=True)
        self.shape = {k: tuple(s.shape) for k, s in flat_params(shapes).items()}
        self.spec = {k: s.spec for k, s in
                     flat_params(param_shardings(shapes, rules, self.keep)).items()}
        self.zspec = {k: zero1_spec(self.spec[k], self.shape[k], mesh) for k in self.spec}
        dp = dp_axes(mesh)
        self.nd = math.prod(mesh.shape[a] for a in dp)
        self.d, self.dp_group = 0, None
        if self.nd > 1:
            for a in dp:
                self.d = self.d * mesh.shape[a] + mesh.coord[a]
            self.dp_group = mesh.axes_group(dp)
        self.tp_axes = tuple(a for a in mesh.axis_names if a not in dp and mesh.shape[a] > 1)
        # FSDP's leaves: the rank's block of the data axes too (gathered at
        # each use by the model code, their gradient reduce-scattered there)
        self.fsdp = {k: d for k, (d, _) in fsdp_dims(rules).items()
                     if self.nd > 1 and _uses(self.spec[k], dp)}      # the router: whole
        self.zdim = {}
        for k, zs in self.zspec.items():
            zs = tuple(zs) + (None,) * (len(self.shape[k]) - len(zs))
            sp = tuple(self.spec[k]) + (None,) * (len(zs) - len(self.spec[k]))
            self.zdim[k] = next((i for i, (a, b) in enumerate(zip(sp, zs)) if a != b), None)

    @classmethod
    def single(cls, cfg) -> "MeshLayout":
        """One device's layout: a ("data", "model") mesh of one rank, which
        needs no process group."""
        return cls(cfg, make_rules(cfg, MeshShape(("data", "model"), (1, 1)),
                                   batch_sharded=True))

    @property
    def world(self) -> int:
        return math.prod(self.mesh.sizes)

    # -- the batch ------------------------------------------------------------

    def local_batch(self, batch: Mapping[str, torch.Tensor], microbatches: int = 1) -> Dict:
        """The rank's rows of the global batch: of each microbatch, its data
        rank's share, so that its microbatch i is its share of the global
        microbatch i."""
        if self.nd == 1:
            return dict(batch)
        out = {}
        for k, v in batch.items():
            B = v.shape[0]
            if B % (microbatches * self.nd):
                raise ValueError(f"a batch of {B} rows does not split into {microbatches} "
                                 f"microbatches over {self.nd} data ranks")
            b = B // (microbatches * self.nd)
            rows = v.reshape(microbatches, self.nd, b, *v.shape[1:])[:, self.d]
            out[k] = rows.reshape(microbatches * b, *v.shape[1:])
        return out

    # -- gradients --------------------------------------------------------------

    @torch.no_grad()
    def reduce_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The gradients summed over the data axes, in f32 buckets (an FSDP
        leaf's is already its block of the sum)."""
        if self.dp_group is None:
            return grads
        out, bucket, size = {k: grads[k] for k in self.fsdp}, [], 0

        def flush():
            flat = torch.cat([grads[k].float().reshape(-1) for k in bucket])
            flat = collectives.all_reduce(flat, self.dp_group)
            at = 0
            for k in bucket:
                n = grads[k].numel()
                out[k] = flat[at:at + n].view(grads[k].shape).to(grads[k].dtype)
                at += n

        for k, g in grads.items():
            if k in self.fsdp:
                continue
            if bucket and size + g.numel() > BUCKET_ELEMS:
                flush()
                bucket, size = [], 0
            bucket.append(k)
            size += g.numel()
        if bucket:
            flush()
        return {k: out[k] for k in grads}

    def _tp_group(self, k: str):
        axes = tuple(a for a in self.tp_axes if _uses(self.spec[k], (a,)))
        return self.mesh.axes_group(axes) if axes else None

    def _data_whole(self, k: str, g: torch.Tensor) -> torch.Tensor:
        """An FSDP leaf's gradient block gathered over the data axes (its
        model block), any other as it is."""
        if k not in self.fsdp:
            return g
        return collectives.all_gather(g.detach(), self.dp_group, dim=self.fsdp[k])

    def sum_squares(self):
        """``clip.global_norm``'s hook: the whole gradient's sum of squares
        from the blocks (a leaf sharded over the model axis contributes the
        all-reduced sum of its blocks'; an FSDP leaf's blocks are gathered
        over the data axes first, so that each leaf's sum is taken in the
        order a replicated leaf's is, bit for bit), or None where no leaf
        is sharded (the single-device sum)."""
        tp = any(self._tp_group(k) is not None for k in self.spec)
        if not tp and not self.fsdp:
            return None

        def total(grads):
            def sq(k, g):                   # one whole FSDP gradient at a time
                return self._data_whole(k, g).float().square().sum()

            whole = [sq(k, g) for k, g in grads.items() if self._tp_group(k) is None]
            parts = [sq(k, g) for k, g in grads.items() if self._tp_group(k) is not None]
            if not parts:
                return sum(whole)
            group = self.mesh.axes_group(self.tp_axes)
            return sum(whole) + collectives.all_reduce(torch.stack(parts).sum(), group)

        return total

    def global_max(self):
        """``compress_grads``' hook: a sharded leaf's maximum all-reduced
        over the axes that shard it (the data axes too for an FSDP leaf),
        or None where no leaf is sharded."""
        if not self.fsdp and not any(self._tp_group(k) is not None for k in self.spec):
            return None

        def hook(k):
            axes = tuple(a for a in self.tp_axes if _uses(self.spec[k], (a,)))
            if k in self.fsdp:
                axes = axes + dp_axes(self.mesh)
            if not axes:
                return None
            group = self.mesh.axes_group(axes)
            return lambda amax: collectives.all_reduce(amax, group, op="max")

        return hook

    # -- ZeRO-1 -----------------------------------------------------------------

    def zero_block(self, k: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's ZeRO-1 block (a view) of a model-block tensor of ``k``."""
        dim = self.zdim[k]
        if dim is None or self.nd == 1:
            return t
        c = t.shape[dim] // self.nd
        return t.narrow(dim, self.d * c, c)

    def shards(self) -> Optional[Dict[str, Blocks]]:
        """Adafactor's hook: each leaf's blocks under its ZeRO-1 spec, or
        None on a mesh of one rank."""
        if self.world == 1:
            return None
        return {k: Blocks(self.mesh, self.zspec[k], len(self.shape[k])) for k in self.zspec}

    @torch.no_grad()
    def gather_update(self, k: str, p: torch.Tensor) -> None:
        """All-gather the data ranks' updated blocks of ``p`` in place."""
        dim = self.zdim[k]
        if dim is None or self.nd == 1:
            return
        p.copy_(collectives.all_gather(self.zero_block(k, p).contiguous(), self.dp_group,
                                       dim=dim))

    # -- placement of a state's leaves (checkpoints) ----------------------------

    def state_shardings(self, state: TrainState) -> TrainState:
        """A TrainState of the same structure whose tensor leaves are their
        :class:`Sharding` (the parameters' and error feedback's by spec, the
        optimizer state's by ZeRO-1 spec, Adafactor's factors by its
        projection onto their dims)."""
        mesh = self.mesh

        def zfull(k):
            n = len(self.shape[k])
            return tuple(self.zspec[k]) + (None,) * (n - len(self.zspec[k]))

        def opt_leaf(k, leaf, name=None):
            zs = zfull(k)
            if name == "vr":
                zs = zs[:-1]
            elif name == "vc":
                zs = zs[:-2] + zs[-1:]
            return Sharding(mesh, tuple(zs))

        def opt(sub):
            out = {}
            for k, leaf in sub.items():
                if isinstance(leaf, Mapping):
                    out[k] = {n: opt_leaf(k, t, n) for n, t in leaf.items()}
                else:
                    out[k] = opt_leaf(k, leaf)
            return out

        params = _map_flat(state.params, lambda k: Sharding(mesh, tuple(self.spec[k])))
        ef = None if state.error_feedback is None else {
            k: Sharding(mesh, self.spec[k]) for k in state.error_feedback}
        return TrainState(params, {n: opt(s) for n, s in state.opt_state.items()},
                          state.step, ef)

    def checkpoint_view(self, state: TrainState) -> _Placed:
        """``Checkpointer``'s ``placed`` for ``state``."""
        from repro_torch.checkpoint.checkpointer import leaves

        return _Placed(dict(leaves(self.state_shardings(state))), self.mesh.coord)


class _Placed:
    """A checkpoint's view of a mesh rank's leaves, by reference key."""

    def __init__(self, shardings: Dict, coord):
        self.shardings, self.coord = shardings, coord

    def whole(self, key: str, leaf):
        s = self.shardings.get(key)
        return s.whole(leaf) if isinstance(s, Sharding) else leaf

    def local(self, key: str, value):
        s = self.shardings.get(key)
        return s.slice(value, self.coord) if isinstance(s, Sharding) else value


def _map_flat(tree, fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(its flat path)``."""
    if isinstance(tree, list):
        return [_map_flat(v, fn, f"{prefix}{i}/") for i, v in enumerate(tree)]
    if isinstance(tree, Mapping):
        return {k: _map_flat(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1])
