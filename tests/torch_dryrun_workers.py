"""Rank bodies of ``test_torch_dryrun.py``, run by
``repro_torch.launch.mesh.spawn`` in gloo processes on the CPU."""
import torch


def collective_body(rank, world):
    """On a (2, 2) ("data", "model") mesh: one all_gather over "data", one
    all_reduce over "model", one all_to_all over the world, one
    reduce_scatter over "data" and one all_gather with ``grad="sum"``
    differentiated over "model" (an all-gather forward, a reduce-scatter
    backward).  Returns the counters."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(2, 2, device="cpu")
    C.reset_counters()
    C.all_gather(torch.ones(3, 5), mesh.group("data"))                       # f32
    C.all_reduce(torch.ones(7, dtype=torch.bfloat16), mesh.group("model"))
    C.all_to_all(torch.ones(8, 6), mesh.world, 0, 0)
    C.reduce_scatter(torch.ones(4, 10, dtype=torch.float64), mesh.group("data"), dim=0)
    x = torch.ones(2, 3, requires_grad=True)
    C.all_gather(x, mesh.group("model"), dim=0, grad="sum").sum().backward()
    return {"bytes": {fn.__name__: dict(fn.bytes) for fn in C.COUNTED},
            "launches": {fn.__name__: fn.launches for fn in C.COUNTED},
            "summary": C.collective_bytes(), "by_axis": C.bytes_by_axis()}


def train_step_body(rank, world, cfg, shape_seq, batch):
    """One mesh train step of ``cfg`` on a (2, 2) gloo mesh, as the dry
    run's train cell builds it (AdamW, one microbatch, ZeRO-1): rank 0's
    collective counters, and its parameter and optimizer-state bytes."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import make_rules, placement
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.nn import init_params
    from repro_torch.optim import make_optimizer, warmup_constant
    from repro_torch.train.layout import MeshLayout
    from repro_torch.train.state import init_train_state
    from repro_torch.train.trainer import make_train_step

    mesh = make_debug_mesh(2, 2, device="cpu")
    rules = make_rules(cfg, mesh, batch_sharded=True)
    layout = MeshLayout(cfg, rules)
    tc = TrainConfig()
    opt = make_optimizer(tc, warmup_constant(tc.learning_rate, tc.warmup_steps))
    params = init_params(cfg, device="cpu", train=True,
                         place=placement(rules, mesh.coord, layout.keep))
    state = init_train_state(params, opt, tc.grad_compression, layout)
    step = make_train_step(cfg, tc, opt, layout)
    C.reset_counters()
    step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    nbytes = lambda tree: sum(t.numel() * t.element_size()          # noqa: E731
                              for t in _leaves(tree))
    return {"launches": {fn.__name__: fn.launches for fn in C.COUNTED},
            "bytes": {fn.__name__: dict(fn.bytes) for fn in C.COUNTED},
            "param_bytes": nbytes(state.params), "opt_state_bytes": nbytes(state.opt_state)}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree
