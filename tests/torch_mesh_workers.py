"""Rank bodies of the mesh tests (``test_torch_mesh*.py``).

Each runs in a process that ``repro_torch.launch.mesh.spawn`` started and
joined into a gloo group, one torch thread a rank, on the CPU; it imports
the port only (the tests compute the reference's results in the parent
and compare there).  Every body returns plain data: numpy arrays, ints and
lists.
"""
import numpy as np
import torch

from repro_torch.distributed import collectives


def _mesh(spec):
    from repro_torch.launch.mesh import make_serve_mesh

    return make_serve_mesh(spec, "cpu")


def _expert_slice(mesh, E: int) -> slice:
    ne, e = mesh.shape["expert"], mesh.coord["expert"]
    return slice(e * E // ne, (e + 1) * E // ne)


def dispatch_body(rank, world, spec, cases):
    """Each case: (name, cfg, params {up, down, router?: numpy, full},
    xg numpy (G, T, M), kind "dropless" | "alltoall").  The rank keeps its
    experts of up/down and routes with the whole router, then dispatches
    under the mesh's rules, with the experts gathered whole where the mesh
    does not place the plan (as ``moe_ffn_apply`` does).  Returns {name: (y, all_to_all launches, the
    rank's expert count)}."""
    from repro_torch.core.dispatch.alltoall import alltoall_dispatch
    from repro_torch.core.dispatch.dropless import dropless_dispatch
    from repro_torch.core.dispatch.mesh import expert_mesh_plan, gathered_experts
    from repro_torch.core.routing import route
    from repro_torch.distributed.sharding import make_rules, use_rules

    mesh = _mesh(spec)
    out = {}
    for name, cfg, params, xg, kind in cases:
        m = cfg.moe
        rules = make_rules(cfg, mesh, expert_axis="expert")
        sl = _expert_slice(mesh, m.num_experts)
        local = {k: torch.from_numpy(v[sl] if k != "router" else v).clone()
                 for k, v in params.items()}
        x = torch.from_numpy(xg)
        w = local.get("router")
        plan = route(x, None if w is None else w.float(), m, m.capacity(x.shape[1]))
        before = collectives.all_to_all.launches
        with use_rules(rules):
            fn = dropless_dispatch if kind == "dropless" else alltoall_dispatch
            held = local if expert_mesh_plan(plan, x.shape[0]) else gathered_experts(local)
            y = fn(held, x, plan, cfg)
        out[name] = (y.numpy(), collectives.all_to_all.launches - before,
                     int(local["up"].shape[0]))
    return out


def attention_body(rank, world, spec, cases):
    """Each case: (name, dict of numpy operands: q, k, v (N rows),
    k_pool/v_pool (D, P, Hkv, bs, hd) per-shard pools, k_scales/v_scales
    (D, P, Hkv) or None, wb, wo, tables (shard-local ids), lengths;
    policy name or None).  The rank attends its rows over its shard's
    pool.  Returns {name: (out, its pools after the write, its scales)}."""
    from repro_torch.kernels.decode_attention import (
        sharded_paged_update_attention,
        sharded_quantized_paged_update_attention,
    )
    from repro_torch.quant.policy import get_kv_quant

    mesh = _mesh(spec)
    d = mesh.coord["data"]
    out = {}
    for name, a, policy in cases:
        t = {k: torch.from_numpy(np.array(v)) for k, v in a.items() if v is not None}
        kp, vp = t["k_pool"][d].clone(), t["v_pool"][d].clone()
        rows = (t["q"], t["k"], t["v"])
        ids = (t["wb"], t["wo"], t["tables"], t["lengths"])
        if policy is None:
            o, kp, vp = sharded_paged_update_attention(*rows, kp, vp, *ids, mesh=mesh)
            out[name] = (o.numpy(), kp.numpy(), vp.numpy(), None, None)
        else:
            ks, vs = t["k_scales"][d].clone(), t["v_scales"][d].clone()
            o, kp, vp, ks, vs = sharded_quantized_paged_update_attention(
                *rows, kp, vp, ks, vs, *ids, policy=get_kv_quant(policy), mesh=mesh)
            out[name] = (o.numpy(), kp.numpy(), vp.numpy(), ks.numpy(), vs.numpy())
    return out


def engine_body(rank, world, spec, runs):
    """Each run: (name, cfg, full port params (CPU tensors), serve kwargs,
    prompts, num_tokens).  The rank serves the batch on the mesh with
    ``check_invariants=True`` (conservation after every step, every rank's
    sampled tokens all-gathered and compared).  Returns {name: (tokens,
    the all_to_all launches of every step as (kind, count), pool rows,
    shard_blocks, the rank's experts of a layer or 0)}."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.distributed.sharding import make_rules, shard_params
    from repro_torch.serving.continuous import ContinuousEngine

    mesh = _mesh(spec)
    out = {}
    for name, cfg, params, serve_kw, prompts, num_tokens in runs:
        rules = make_rules(cfg, mesh, expert_axis="expert")
        placed = shard_params(params, rules, mesh.coord, keep=("router",))
        eng = ContinuousEngine(cfg, placed, ServeConfig(mesh=spec, **serve_kw), device="cpu",
                               check_invariants=True, mesh=mesh)
        steps = []
        real_step = eng._paged_host_step

        def counted(clock_ms, real_step=real_step, steps=steps, eng=eng):
            kind = "mixed" if eng.scheduler.prefilling is not None else "decode"
            before = collectives.all_to_all.launches
            done = real_step(clock_ms)
            steps.append((kind, collectives.all_to_all.launches - before))
            return done

        eng._paged_host_step = counted
        toks, _ = eng.generate(prompts, num_tokens)
        if serve_kw.get("prefix_cache"):       # a second serve hits the cache
            again, _ = eng.generate(prompts, num_tokens)
            np.testing.assert_array_equal(again, toks)
        eng.cache.check_conservation()
        experts = 0
        if cfg.moe.num_experts:
            experts = int(placed["blocks"]["ffn"]["up"].shape[1])
        out[name] = (toks, steps, int(eng.cache.k_pool.shape[1]), eng.cache.shard_blocks,
                     experts)
    return out


def cli_body(rank, world, argv):
    """The serve CLI on this rank (``--mesh`` in ``argv``): returns the
    rank's {uid: tokens} and the run's stats."""
    from unittest import mock

    from repro_torch.launch import serve

    got = {}
    real_run = serve.ContinuousEngine.run

    def run(self, requests, on_finish=None):
        out, stats = real_run(self, requests, on_finish=on_finish)
        got.update(out)
        return out, stats

    with mock.patch.object(serve.ContinuousEngine, "run", run):
        stats = serve.main(argv)
    return got, dict(stats)
