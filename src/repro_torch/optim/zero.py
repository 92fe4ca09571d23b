"""ZeRO-1: shard the optimizer state over the data-parallel axes
(``repro.optim.zero``), as pure functions over a mesh's axis names and
sizes (:class:`~repro_torch.distributed.sharding.MeshShape` or a
:class:`~repro_torch.launch.mesh.Mesh`).

The reference declares the layout and lets GSPMD compute the update
sharded over DP and all-gather the applied updates.  The port's mesh
trainer (``repro_torch.train.trainer``) does that itself: each data rank
updates its block of every leaf, the block :func:`zero1_spec` adds to the
parameter's own placement, and all-gathers the updated parameters, so a
rank keeps 1/|DP| of the state of each leaf with a free divisible dim.
The numbers are those of unsharded state; only memory changes.

The optimizer states are the port's: ``{"mu": {path: t}, "nu": {path:
t}}`` (AdamW) and ``{"v": {path: {"vr", "vc"} | {"v"}}}`` (Adafactor),
keyed by the flat parameter paths of ``nn.flat_params``.
"""
from __future__ import annotations

from typing import Mapping, Sequence

from repro_torch.distributed.sharding import PSpec, Rules, Sharding, dp_axes


def extend_spec(spec: PSpec, shape: Sequence[int], mesh, dp: Sequence[str]) -> PSpec:
    """Add the DP axes to the first replicated, divisible dim of ``shape``
    (the reference's ``_extend_spec``)."""
    used = set()
    for entry in spec:
        if entry is None:
            continue
        used.update(entry if isinstance(entry, tuple) else (entry,))
    dp = tuple(a for a in dp if a not in used)
    if not dp:
        return tuple(spec)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, e in enumerate(entries):
        if e is None and shape[i] > 0 and shape[i] % dp_size == 0:
            entries[i] = dp if len(dp) > 1 else dp[0]
            break
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def zero1_spec(spec: PSpec, shape: Sequence[int], mesh) -> PSpec:
    """A parameter's optimizer-state placement: its own spec, extended
    with the mesh's DP axes (what ``zero1_shardings`` gives its AdamW
    moments)."""
    return extend_spec(spec, shape, mesh, dp_axes(mesh))


def zero1_shardings(opt_state_shapes, param_pspecs: Mapping[str, PSpec], rules: Rules):
    """:class:`Sharding` tree for an optimizer state (the reference's).

    ``opt_state_shapes``: the optimizer's state, or a tree of the same
    structure whose leaves have ``.shape``; ``param_pspecs``: the flat
    parameter paths' partition specs.  State leaves that mirror a parameter
    keep its spec (a reduced-rank factor, Adafactor's vr / vc, keeps it
    where the spec has no more entries than the factor has dims, else
    falls back to replication); every leaf then gets DP on a free divisible
    dim (the ZeRO-1 cut)."""
    mesh = rules.mesh
    dp = dp_axes(mesh)

    def leafwise(tree, spec):
        if isinstance(tree, Mapping):
            return {k: leafwise(v, spec) for k, v in tree.items()}
        shape = tuple(tree.shape)
        use = spec if len(spec) <= len(shape) else ()
        return Sharding(mesh, extend_spec(use, shape, mesh, dp))

    def build(sub):
        if isinstance(sub, Mapping) and set(sub) == set(param_pspecs):
            return {k: leafwise(v, param_pspecs[k]) for k, v in sub.items()}
        return leafwise(sub, ())

    if isinstance(opt_state_shapes, Mapping):
        return {k: build(v) for k, v in opt_state_shapes.items()}
    return build(opt_state_shapes)
