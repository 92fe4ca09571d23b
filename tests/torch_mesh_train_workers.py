"""Rank bodies of the mesh training tests (``test_torch_mesh_train.py``).

Each runs in a process that ``repro_torch.launch.mesh.spawn`` started and
joined into a gloo group, one torch thread a rank, on the CPU; it imports
the port only (the tests compute the reference's results in the parent
and compare there).  Every body returns plain data: numpy arrays, ints,
floats and lists.
"""
import numpy as np
import torch

from repro_torch.distributed import collectives


class SecondStepLR:
    """The tests' learning-rate schedule, for the reference's optimizers and
    the port's (a traced count or an int): 0 at the first update, ``lr``
    from the second.  Adam's first update is g / (|g| + eps) elementwise,
    which turns the last bits of a gradient near 0 into +-lr; the second
    divides by the RMS of two steps' gradients."""

    def __init__(self, lr):
        self.lr = lr

    def __call__(self, count):
        return self.lr * (count >= 2)


def _routes(store):
    """Record the expert index of every routing call of a forward (not of
    a remat recompute, which runs inside the backward)."""
    from unittest import mock

    from repro_torch.core import moe

    real = moe.route

    def route(*a, **kw):
        plan = real(*a, **kw)
        if torch._C._current_autograd_node() is None:
            store.append(plan.expert_index.numpy().copy())
        return plan

    return mock.patch.object(moe, "route", route)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _whole(layout, state):
    """Every leaf of ``state`` whole, by reference key (numpy)."""
    from repro_torch.checkpoint.checkpointer import leaves

    placed = layout.checkpoint_view(state)
    return {k: np.array(placed.whole(k, v).detach().numpy()) if torch.is_tensor(v) else v
            for k, v in leaves(state)}


def train_one(mesh, cfg, tc, params, batches):
    """``len(batches)`` mesh train steps from the whole ``params``: (the
    losses, grad norms, per-step routes of the rank's groups, the
    all_to_all launches a step, the whole final state, the layout and
    state)."""
    from repro_torch.distributed.sharding import make_rules, shard_params
    from repro_torch.optim import make_optimizer
    from repro_torch.train.layout import MeshLayout
    from repro_torch.train.state import init_train_state
    from repro_torch.train.trainer import make_train_step

    rules = make_rules(cfg, mesh, batch_sharded=True)
    layout = MeshLayout(cfg, rules)
    placed = shard_params(_clone(params), rules, mesh.coord, keep=layout.keep)
    opt = make_optimizer(tc, SecondStepLR(tc.learning_rate))
    state = init_train_state(placed, opt, tc.grad_compression, layout)
    step = make_train_step(cfg, tc, opt, layout)
    losses, norms, routes, a2a = [], [], [], []
    for b in batches:
        got = []
        before = collectives.all_to_all.launches
        with _routes(got):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        a2a.append(collectives.all_to_all.launches - before)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        routes.append(got)
    return dict(losses=losses, grad_norms=norms, routes=routes, a2a=a2a,
                whole=_whole(layout, state)), layout, state


def cli_moe_attention(argv):
    """The train CLI's ``main(argv)`` on Fig. 4's MoE attention (through
    ``launch.train.build``'s config: neither package has a flag for it):
    the logged losses."""
    from unittest import mock

    from repro_torch.launch import train as train_mod

    real = train_mod.build
    with mock.patch.object(train_mod, "build",
                           lambda args: real(args).replace_moe(moe_attention=True)):
        return [m["loss"] for m in train_mod.main(argv)]


def train_body(rank, world, meshes, cases, ckpt_dir, psum_inputs, cli_argv=None):
    """For each mesh ``(data, model)`` (or ``(pod, data, model)``) and each case ``(name, cfg, tc,
    params (port tensors, whole), batches (numpy))``: :func:`train_one`.
    Then the checkpoint round trip: case 0 trained on the first mesh is
    saved to ``ckpt_dir`` (rank 0 writes), restored on the second mesh
    into a fresh state, and returned whole.  Then ``compressed_psum`` and
    ``reduce_scatter`` of ``psum_inputs[rank]`` over the world; last, the
    train CLI on ``cli_argv`` (:func:`cli_moe_attention`).  Returns
    ({(mesh, name): result}, the restore's leaves, the compressed sum, the
    rank's chunk of the sum, the CLI's losses)."""
    from repro_torch.optim.compression import compressed_psum

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train.layout import MeshLayout  # noqa: F401

    from repro_torch.launch.mesh import make_mesh

    out, saved = {}, None
    for shape in meshes:
        if len(shape) == 3:                 # a production mesh: ("pod", "data", "model")
            mesh = make_mesh(tuple(zip(("pod", "data", "model"), shape)), "cpu")
        else:
            mesh = make_debug_mesh(*shape, device="cpu")
        for name, cfg, tc, params, batches, on in cases:
            if shape not in on:
                continue
            res, layout, state = train_one(mesh, cfg, tc, params, batches)
            out[shape, name] = res
            if saved is None and ckpt_dir is not None:
                ck = Checkpointer(ckpt_dir, writer=rank == 0)
                ck.save(len(batches), state, layout.checkpoint_view(state))
                torch.distributed.barrier()
                saved = (name, cfg, tc, params)
    restored = None
    if saved is not None and len(meshes) > 1:
        from repro_torch.distributed.sharding import make_rules, shard_params
        from repro_torch.optim import make_optimizer
        from repro_torch.train.state import init_train_state

        name, cfg, tc, params = saved
        mesh = make_debug_mesh(*meshes[1], device="cpu")
        layout = MeshLayout(cfg, make_rules(cfg, mesh, batch_sharded=True))
        opt = make_optimizer(tc, SecondStepLR(tc.learning_rate))
        fresh = shard_params(_clone(params), layout.rules, mesh.coord, keep=layout.keep)
        state = init_train_state(fresh, opt, tc.grad_compression, layout)
        ck = Checkpointer(ckpt_dir, writer=False)
        state = ck.restore(ck.latest_step(), state, layout.checkpoint_view(state))
        restored = _whole(layout, state)
    x, world_group = torch.from_numpy(psum_inputs[rank]), torch.distributed.group.WORLD
    psum = compressed_psum(x, world_group)
    chunk = collectives.reduce_scatter(x, world_group).numpy()
    cli = cli_moe_attention(cli_argv) if cli_argv is not None else None
    return out, restored, psum.numpy(), chunk, cli
