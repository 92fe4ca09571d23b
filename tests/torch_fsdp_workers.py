"""Rank bodies of the FSDP and tensor-parallel serving tests
(``test_torch_fsdp.py``), run by ``repro_torch.launch.mesh.spawn`` in
gloo processes on the CPU; they import the port only and return plain
data (numpy arrays, floats, lists)."""
import numpy as np
import torch

import torch_mesh_train_workers as MW


def _gathered(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    torch.distributed.all_gather(parts, x.contiguous(), group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def serve_tp(mesh, cfg, params, tokens, steps: int):
    """Prefill ``tokens`` (B, S) and decode ``steps`` fixed tokens on the
    mesh under ("data", "model") rules: each data rank its rows, each model
    rank its heads, kv heads, experts and vocab columns.  Returns the
    logits of the prefill and of every decode step, whole (rows gathered
    over "data", vocab columns over "model"), and the cache's kv heads a
    rank."""
    from repro_torch.distributed.sharding import make_rules, shard_params, use_rules
    from repro_torch.models import transformer as TF

    rules = make_rules(cfg, mesh, batch_sharded=True)
    local = shard_params(params, rules, mesh.coord, keep=("router",))
    B = tokens.shape[0]
    rows = B // mesh.shape["data"]
    mine = torch.from_numpy(tokens[mesh.coord["data"] * rows:(mesh.coord["data"] + 1) * rows])
    out = []
    with use_rules(rules), torch.inference_mode():
        logits, caches, _ = TF.prefill_apply(local, mine, cfg, max_len=tokens.shape[1] + steps)
        out.append(logits)
        for i in range(steps):
            tok = ((mine[:, -1:] + i + 1) % cfg.vocab_size).to(mine.dtype)
            logits, caches = TF.decode_apply(local, tok, caches, cfg)
            out.append(logits)
        whole = [_gathered(_gathered(x, mesh, "model", 2), mesh, "data", 0).numpy()
                 for x in out]
    return whole, int(caches.k.shape[3])


def fsdp_body(rank, world, cfg, tc, params, serve_params, batches, ckpt_dir, tokens, heads):
    """On the (2, 2) mesh: ``batches`` steps of ZeRO-1 and of FSDP
    (``cfg.fsdp``) from the whole training tree ``params``; the FSDP run's
    state saved to ``ckpt_dir`` (rank 0 writes); then tensor-parallel
    prefill and decode of ``tokens`` over ``serve_params``; then, for each
    case of ``heads`` ((name, cfg, training params, serving params,
    batches): head layouts the model axis cuts otherwise), its steps and
    its prefill and decode.  Returns the runs' results (``train_one``'s),
    the FSDP run's layout facts and collective counters, and the serving
    logits."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.nn import flat_params

    mesh = make_debug_mesh(2, 2, device="cpu")
    zero, _, _ = MW.train_one(mesh, cfg, tc, params, batches)
    collectives.reset_counters()
    fsdp, layout, state = MW.train_one(mesh, cfg.replace(fsdp=True), tc, params, batches)
    counts = {fn.__name__: fn.launches for fn in collectives.COUNTED}
    local = {k: tuple(p.shape) for k, p in flat_params(state.params).items()}
    Checkpointer(ckpt_dir, writer=rank == 0).save(len(batches), state,
                                                  layout.checkpoint_view(state))
    torch.distributed.barrier()
    logits, kv_heads = serve_tp(mesh, cfg, serve_params, tokens, steps=3)
    cases = {}
    for name, hcfg, hparams, hserve, hbatches in heads:
        run, _, _ = MW.train_one(mesh, hcfg, tc, hparams, hbatches)
        cases[name] = dict(train=run, serve=serve_tp(mesh, hcfg, hserve, tokens, steps=3))
    return dict(zero=zero, fsdp=fsdp, fsdp_leaves=sorted(layout.fsdp), local_shapes=local,
                counts=counts, logits=logits, kv_heads=kv_heads, coord=mesh.coord,
                heads=cases)
