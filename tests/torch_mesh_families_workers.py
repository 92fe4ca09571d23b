"""Rank bodies of the tensor-parallel family tests
(``test_torch_mesh_families.py``), run by ``repro_torch.launch.mesh.spawn``
in gloo processes on the CPU; they import the port only and return plain
data (numpy arrays, floats, lists)."""
import torch

import torch_mesh_train_workers as MW
from torch_fsdp_workers import _gathered


def _whole_logits(x, mesh):
    """A rank's logits (its rows, its vocab columns) whole, as numpy."""
    return _gathered(_gathered(x, mesh, "model", x.dim() - 1), mesh, "data", 0).numpy()


def serve_logits(mesh, cfg, serve, inputs, steps: int):
    """Under ("data", "model") rules with the batch sharded (a data rank's
    rows, a model rank's heads, channels and vocab columns): the forward's
    logits over the inputs' tokens, then ``steps`` one-token decode steps
    of the prompt's first tokens from a fresh state (encdec: the memory's
    ``init_state``); every output whole.  Returns (outputs, the state's
    head counts a rank)."""
    from repro_torch.distributed.sharding import make_rules, shard_params, use_rules
    from repro_torch.models import encdec as ED
    from repro_torch.models.registry import get_family

    rules = make_rules(cfg, mesh, batch_sharded=True)
    local = shard_params(serve, rules, mesh.coord, keep=("router",))
    fam = get_family(cfg)
    toks = inputs["tokens"]
    rows = toks.shape[0] // mesh.shape["data"]
    mine = slice(mesh.coord["data"] * rows, (mesh.coord["data"] + 1) * rows)
    batch = {k: torch.from_numpy(v[mine]) for k, v in inputs.items()}
    out, heads = [], {}
    with use_rules(rules), torch.inference_mode():
        out.append(_whole_logits(fam.forward(local, batch, cfg)[0], mesh))
        if cfg.family == "encdec":
            memory = ED.encode(local, batch["frames"], cfg)
            out.append(_gathered(memory, mesh, "data", 0).numpy())
            state = ED.init_state(local, memory, cfg, max_len=steps)
            heads = {"self": state.self_cache.k.shape[3], "cross": state.cross_k.shape[3]}
        else:
            state = fam.init_state(cfg, rows, steps, device="cpu")
            if cfg.family == "zamba":
                heads = {"attn": state.attn.k.shape[3], "ssm": state.mamba.h.shape[2],
                         "conv": state.mamba.conv.shape[-1]}
        for i in range(steps):
            logits, state = fam.decode(local, batch["tokens"][:, i:i + 1], state, cfg)
            out.append(_whole_logits(logits, mesh))
    return out, heads


def _vocab_argmax(logits, mesh, vocab: int):
    whole = _gathered(logits[:, -1].float(), mesh, "model", 1)
    return whole[:, :vocab].argmax(dim=-1)


def greedy_tokens(mesh, cfg, serve, inputs, gen: int, max_len: int):
    """Greedy tokens under the serving rules (``make_rules(cfg, mesh)``:
    every rank the whole batch): the static engine's ``generate`` with
    ``rules`` over the prompt; for encdec, which no engine serves,
    ``encode``, ``init_state`` and ``decode_step`` under the rules, the
    prompt fed a token a step, then argmax over the gathered vocab."""
    from repro_torch.distributed.sharding import make_rules, shard_params, use_rules
    from repro_torch.models import encdec as ED
    from repro_torch.serving.engine import ServingEngine

    rules = make_rules(cfg, mesh)
    local = shard_params(serve, rules, mesh.coord, keep=("router",))
    prompts = inputs["tokens"]
    if cfg.family != "encdec":
        toks, _ = ServingEngine(cfg, local, max_len, rules=rules).generate(prompts, gen)
        return toks
    S = prompts.shape[1]
    with use_rules(rules), torch.inference_mode():
        memory = ED.encode(local, torch.from_numpy(inputs["frames"]), cfg)
        state = ED.init_state(local, memory, cfg, max_len)
        tok, out = None, []
        for i in range(S + gen - 1):
            feed = torch.from_numpy(prompts[:, i:i + 1]) if i < S else tok[:, None]
            logits, state = ED.decode_step(local, feed, state, cfg)
            if i >= S - 1:
                tok = _vocab_argmax(logits, mesh, cfg.vocab_size)
                out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32).numpy()


def families_body(rank, world, meshes, cases, ckpt_dir):
    """For each mesh ``(data, model)`` and each case ``(arch, cfg, tc,
    training params, serving params, serving inputs, batches, (decode
    steps, generated tokens, max_len))``: :func:`serve_logits`,
    :func:`greedy_tokens` and two mesh train steps
    (``torch_mesh_train_workers.train_one``); on the last mesh each case's
    final state is saved to ``{ckpt_dir}/{arch}`` (rank 0 writes whole
    leaves).  Returns {(mesh, arch): results}."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.nn import flat_params

    out = {}
    for shape in meshes:
        mesh = make_debug_mesh(*shape, device="cpu")
        for arch, cfg, tc, params, serve, inputs, batches, (steps, gen, max_len) in cases:
            logits, heads = serve_logits(mesh, cfg, serve, inputs, steps)
            tokens = greedy_tokens(mesh, cfg, serve, inputs, gen, max_len)
            train, layout, state = MW.train_one(mesh, cfg, tc, params, batches)
            local = {k: tuple(v.shape) for k, v in flat_params(state.params).items()}
            out[shape, arch] = dict(logits=logits, heads=heads, tokens=tokens, train=train,
                                    local_shapes=local, coord=dict(mesh.coord))
            if shape == meshes[-1]:
                Checkpointer(f"{ckpt_dir}/{arch}", writer=rank == 0).save(
                    len(batches), state, layout.checkpoint_view(state))
                torch.distributed.barrier()
    return out

