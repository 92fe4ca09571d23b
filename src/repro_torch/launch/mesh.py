"""Device meshes on ``torch.distributed`` (``repro.launch.mesh``).

The reference runs one process over a mesh of devices (``shard_map``).
The port runs one process per mesh device: each rank holds a coordinate on
the mesh, a process group per axis and its own device.  A :class:`Mesh`
lays the world's ranks out row-major over its axes: for the serving mesh
``("data", "expert")`` that is data-major and expert-minor, the order of
the reference's joint ``P(("data", "expert"))`` axis, so the world group
is the joint axis and rank r is its r-th device.

Backends: NCCL for CUDA when each rank has a card of its own, gloo for
CPU tensors.  Ranks that share a card (NCCL refuses two ranks on one
device) must ask for gloo, whose collectives stage CUDA tensors through
host memory; :func:`make_serve_mesh` raises rather than choose it for
them.  Every process group gets a timeout (:data:`TIMEOUT`), so a rank
that never arrives fails the collective instead of hanging it.

:func:`spawn` runs a function in ``world`` fresh processes joined into one
process group through a ``file://`` rendezvous (no fixed port): the CPU
tests' gloo ranks and ``chip_smoke.py``'s ranks that share the card.
:func:`make_debug_mesh` is the train CLI's ("data", "model") mesh;
:func:`make_production_mesh` the reference's pod meshes, ("data",
"model") of 16 x 16 or ("pod", "data", "model") of 2 x 16 x 16, "pod"
being more data parallelism, scaled down by ``REPRO_MESH_SINGLE`` /
``REPRO_MESH_MULTI`` (e.g. ``2,4``) as the reference's.
"""
from __future__ import annotations

import datetime
import gc
import math
import os
import pickle
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives

TIMEOUT = datetime.timedelta(seconds=60)
SERVE_AXES = ("data", "expert")


class Mesh:
    """This rank's view of a mesh over the world's ranks: ``axis_names``,
    ``shape`` ({axis: size}), ``coord`` ({axis: this rank's index}), a
    process group per axis (:meth:`group`), the world group (the joint
    axis, :attr:`world`) and the rank's device, over a
    ``torch.distributed.device_mesh.DeviceMesh`` (a host one under gloo:
    its device type only picks the groups' backend)."""

    def __init__(self, axis_names: Tuple[str, ...], sizes: Tuple[int, ...], device,
                 backend: str):
        from torch.distributed.device_mesh import init_device_mesh

        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(n) for n in sizes)
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:     # "cuda" -> "cuda:<current>"
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.backend = backend
        self.rank = dist.get_rank()
        self.world = dist.group.WORLD
        # gloo over ranks that share a card: the DeviceMesh is the host's
        kind = "cuda" if backend == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(kind, self.sizes, mesh_dim_names=self.axis_names)
        coord, r = {}, self.rank
        for name, n in zip(reversed(self.axis_names), reversed(self.sizes)):
            coord[name] = r % n
            r //= n
        self.coord = {a: coord[a] for a in self.axis_names}
        self._joint = {}
        for a in self.axis_names:
            collectives.name_group(self.group(a), a)
        collectives.name_group(self.world, "+".join(self.axis_names))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def axes_group(self, axes):
        """The process group of the joint axis ``axes`` (row-major in the
        mesh's axis order): one axis's, the world for all of them, else made
        at the first call, which every rank must make at the same point (as
        every rank runs the same program); ``torch.distributed`` orders a
        group by global rank, which is that row-major order."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if len(axes) == 1:
            return self.group(axes[0])
        if axes == self.axis_names:
            return self.world
        if axes not in self._joint:
            rest = [a for a in self.axis_names if a not in axes]
            ranks = {}
            for r in range(math.prod(self.sizes)):
                c, q = {}, r
                for name, n in zip(reversed(self.axis_names), reversed(self.sizes)):
                    c[name], q = q % n, q // n
                ranks.setdefault(tuple(c[a] for a in rest), []).append(r)
            self._joint[axes], _ = dist.new_subgroups_by_enumeration(
                list(ranks.values()), timeout=TIMEOUT)
            collectives.name_group(self._joint[axes], "+".join(axes))
        return self._joint[axes]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coord}, {self.device}, "
                f"{self.backend})")


def _init(world: int, backend: str) -> None:
    """Join the default process group: from ``torch.distributed.run``'s
    environment, or, for a mesh of one rank with no such environment, a
    one-rank group through a ``file://`` rendezvous of its own."""
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=TIMEOUT)
        return
    if world != 1:
        raise RuntimeError(
            f"a mesh of {world} ranks needs a process group: run under "
            f"torch.distributed.run, or spawn the ranks (repro_torch.launch.mesh.spawn)")
    init = "file://" + os.path.join(tempfile.mkdtemp(prefix="mesh-"), "init")
    dist.init_process_group(backend, init_method=init, world_size=1, rank=0, timeout=TIMEOUT)


def _shares_card(world: int) -> bool:
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return local > torch.cuda.device_count()


def make_mesh(axes: Sequence[Tuple[str, int]], device, backend: Optional[str] = None) -> Mesh:
    """A :class:`Mesh` over ``axes`` (``((name, size), ...)``), whose sizes
    must multiply to the world size, with this rank on ``device``.  Joins
    the default process group if the process has not (``backend``: NCCL on
    CUDA, gloo on the CPU; ranks that share a card must pass gloo)."""
    names = tuple(a for a, _ in axes)
    sizes = tuple(int(n) for _, n in axes)
    need = math.prod(sizes)
    device = torch.device(device)
    if backend is None:
        if dist.is_initialized():
            backend = dist.get_backend()
        elif device.type == "cuda":
            if _shares_card(need):
                raise RuntimeError(
                    f"{need} ranks share {torch.cuda.device_count()} card(s): NCCL refuses "
                    f"two ranks on one device; pass backend='gloo' (--mesh-backend gloo)")
            backend = "nccl"
        else:
            backend = "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend needs CUDA devices, not {device}")
    if not dist.is_initialized():
        _init(need, backend)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group's backend is {dist.get_backend()}, not {backend}")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"mesh {tuple(axes)!r} needs {need} ranks, the world has {world}")
    return Mesh(names, sizes, device, backend)


def make_serve_mesh(spec, device, backend: Optional[str] = None) -> Mesh:
    """The mesh of ``ServeConfig.mesh`` (``(("data", D), ("expert", E))``)."""
    names = tuple(a for a, _ in spec)
    if names != SERVE_AXES:
        raise ValueError(f"a serving mesh has axes {SERVE_AXES}, got {names}")
    return make_mesh(spec, device, backend)


def make_debug_mesh(data: int = 1, model: int = 1, device="cuda",
                    backend: Optional[str] = None) -> Mesh:
    """A small ``("data", "model")`` mesh over this process's world, on
    the card unless ``device`` says otherwise."""
    return make_mesh((("data", data), ("model", model)), device, backend)


def production_mesh_axes(*, multi_pod: bool = False) -> Tuple[Tuple[str, int], ...]:
    """The production mesh's ((axis, size), ...): the reference's pod
    shapes, or the scale-down of ``REPRO_MESH_MULTI`` / ``REPRO_MESH_SINGLE``
    (comma-separated sizes, one an axis)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    env = os.environ.get("REPRO_MESH_MULTI" if multi_pod else "REPRO_MESH_SINGLE")
    if env:
        shape = tuple(int(x) for x in env.split(","))
        if len(shape) != len(axes):
            raise ValueError(f"mesh sizes {shape} for axes {axes}")
    return tuple(zip(axes, shape))


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         backend: Optional[str] = None) -> Mesh:
    """The production mesh (:func:`production_mesh_axes`) over this
    process's world."""
    return make_mesh(production_mesh_axes(multi_pod=multi_pod), device, backend)


def rank_device(device: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for
    ``cuda`` (ranks beyond the cards share them), else ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", 0))
        return torch.device("cuda", local % torch.cuda.device_count())
    return device


# ---------------------------------------------------------------------------
# Ranks as spawned processes
# ---------------------------------------------------------------------------

def _entry(rank: int, fn: Callable, world: int, backend: str, init_file: str, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method="file://" + init_file, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    # a rank that raises leaves the group as it is: tearing it down under
    # peers still inside a collective aborts the process before its
    # traceback reaches the parent
    out = fn(rank, world, *args)
    with open(f"{init_file}.{rank}.out", "wb") as fh:
        pickle.dump(out, fh)
    teardown()


def teardown() -> None:
    """Leave the process group and free every group now, on this thread:
    after a barrier (no rank tears the group down under a peer's last
    collective), ``destroy_process_group``, then the port's own references
    to the mesh's groups dropped and collected, so that each gloo group's
    worker and transport threads are joined here.  Left to the
    interpreter's teardown, a group still holding a joinable thread aborts
    the process (``terminate called without an active exception``)."""
    dist.barrier()
    dist.destroy_process_group()
    collectives.forget_groups()
    gc.collect()


def spawn(fn: Callable, world: int, *, backend: str = "gloo", init_file: str,
          args: tuple = (), timeout: float = 300.0) -> List:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes (one
    torch thread each) joined into one process group of ``backend`` through
    ``file://{init_file}`` (a path that does not exist yet, in a directory
    of the caller's).  ``fn`` must be importable by name.  Returns each
    rank's return value, in rank order.  Raises if any rank raises or exits
    nonzero (the others are then terminated), or if they have not all
    finished within ``timeout`` seconds (then all are killed)."""
    import torch.multiprocessing as mp

    if os.path.exists(init_file):
        raise ValueError(f"spawn: rendezvous file {init_file} exists")
    ctx = mp.start_processes(_entry, args=(fn, world, backend, init_file, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"spawn: {world} ranks of {fn.__name__} still running "
                                   f"after {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for rank in range(world):
        with open(f"{init_file}.{rank}.out", "rb") as fh:
            out.append(pickle.load(fh))
    return out
