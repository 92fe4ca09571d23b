"""Rank bodies of the MoE-attention mesh tests
(``test_torch_mesh_moe_attention.py``), run by
``repro_torch.launch.mesh.spawn`` in gloo processes on the CPU; they
import the port only and return plain data (numpy arrays, floats, ints,
lists)."""
import torch

import torch_mesh_train_workers as MW
from torch_fsdp_workers import _gathered


def attention_forward(mesh, cfg, params, inputs):
    """Layer 0's ``moe_attention_apply`` under ("data", "model") rules with
    the batch sharded: the rank's rows of ``inputs`` (x, positions, token
    ids), its blocks of the training tree ``params``.  Returns (the output
    with the data ranks' rows gathered, the aux, the layer's collectives
    by kind and axis)."""
    from repro_torch.core.context import MoEContext
    from repro_torch.core.moe_attention import SCOPE, moe_attention_apply
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import make_rules, shard_params, use_rules

    rules = make_rules(cfg, mesh, batch_sharded=True)
    local = shard_params(params, rules, mesh.coord, keep=("router",))
    attn = {k: v[0] for k, v in local["blocks"]["attn"].items()}
    rows = inputs["x"].shape[0] // mesh.shape["data"]
    mine = slice(mesh.coord["data"] * rows, (mesh.coord["data"] + 1) * rows)
    x, pos, tok = (torch.from_numpy(inputs[k][mine]) for k in ("x", "positions", "tokens"))
    collectives.reset_counters()
    with use_rules(rules), torch.no_grad():
        y, aux = moe_attention_apply(attn, x, cfg, positions=pos,
                                     ctx=MoEContext().with_tokens(tok, pos))
    return (_gathered(y, mesh, "data", 0).numpy(), {k: float(v) for k, v in aux.items()},
            collectives.scoped(SCOPE))


def moe_attention_body(rank, world, meshes, forward_cases, train_cases, family_cases,
                       gathered_cases):
    """For each mesh ``(data, model)``: each forward case ``(name, cfg,
    training params, inputs, meshes)`` (:func:`attention_forward`); each
    train case ``(name, cfg, tc, params, batches, meshes)`` (two mesh train
    steps, ``torch_mesh_train_workers.train_one``, with the MoE-attention
    layers' collectives a step); each family case ``(arch, cfg, tc, params,
    batches, meshes)`` trained without and with ``cfg.fsdp``; each gathered
    case ``(name, cfg, serving params, inputs, decode steps, meshes)``
    (``torch_mesh_families_workers.serve_logits``).  Returns {(kind, mesh,
    name): results}."""
    from torch_mesh_families_workers import serve_logits

    from repro_torch.core.moe_attention import SCOPE
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.nn import flat_params

    out = {}
    for shape in meshes:
        mesh = make_debug_mesh(*shape, device="cpu")
        for name, cfg, params, inputs, on in forward_cases:
            if shape in on:
                out["forward", shape, name] = attention_forward(mesh, cfg, params, inputs)
        for name, cfg, tc, params, batches, on in train_cases:
            if shape not in on:
                continue
            collectives.reset_counters()
            res, layout, state = MW.train_one(mesh, cfg, tc, params, batches)
            flat = flat_params(state.params)
            res.update(scoped=collectives.scoped(SCOPE),
                       local_shapes={k: tuple(v.shape) for k, v in flat.items()},
                       halved=sum(state.opt_state["mu"][k].numel() * layout.nd == p.numel()
                                  for k, p in flat.items() if layout.zdim[k] is not None),
                       zeroed=sum(d is not None for d in layout.zdim.values()))
            out["train", shape, name] = res
        for arch, cfg, tc, params, batches, on in family_cases:
            if shape not in on:
                continue
            base, _, _ = MW.train_one(mesh, cfg, tc, params, batches)
            fsdp, layout, _ = MW.train_one(mesh, cfg.replace(fsdp=True), tc, params, batches)
            out["fsdp", shape, arch] = dict(base=base, fsdp=fsdp, fsdp_leaves=sorted(layout.fsdp))
        for name, cfg, serve, inputs, steps, on in gathered_cases:
            if shape in on:
                out["gathered", shape, name] = serve_logits(mesh, cfg, serve, inputs, steps)[0]
    return out
