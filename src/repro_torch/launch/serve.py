"""Serving entry point (``repro.launch.serve``): static lockstep batching
(the default) or continuous batching, on the card.

  # the reference's default: one static lockstep batch of 4 prompts
  PYTHONPATH=src python -m repro_torch.launch.serve --arch m6-base

  # the static engine over a 16-request trace, FCFS groups of --batch
  PYTHONPATH=src python -m repro_torch.launch.serve --arch m6-base \\
      --engine static --batch 8 --requests 16

  # the m6-base continuous serving path: 16 synthetic requests, dropless MoE
  PYTHONPATH=src python -m repro_torch.launch.serve --arch m6-base \\
      --engine continuous --moe-impl dropless --capacity-factor none --requests 16

  # one batch at smoke size on the CPU (plain PyTorch versions of the kernels);
  # --max-len stays within the smoke config's 64 learned positions
  PYTHONPATH=src python -m repro_torch.launch.serve --arch m6-base --smoke \\
      --engine continuous --moe-impl dropless --capacity-factor none \\
      --batch 3 --prompt-len 10 --gen 8 --max-len 32 --device cpu

  # int8 KV pools with prefix caching over a multi-tenant trace
  PYTHONPATH=src python -m repro_torch.launch.serve --arch m6-base \\
      --engine continuous --moe-impl dropless --capacity-factor none \\
      --kv-quant int8 --prefix-cache --trace-kind multitenant --requests 16

  # speculative decoding (ngram drafter, 4 drafts a step), then sampling at
  # temperature 0.8 with it
  PYTHONPATH=src python -m repro_torch.launch.serve --arch m6-base \\
      --engine continuous --moe-impl dropless --capacity-factor none \\
      --spec-drafter ngram --spec-gamma 4 --requests 16 [--temperature 0.8]

  # SLO scheduling over bursty mixed-priority traffic: strict priority
  # classes, preemption with KV swap to a 56-block host pool (add
  # --slo-shed to shed requests whose deadline is provably unmeetable)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch m6-base \\
      --engine continuous --moe-impl dropless --capacity-factor none \\
      --trace-kind priority --sched-policy priority_strict --slo-preempt \\
      --host-blocks 56 --requests 32

  # granite-moe-3b-a800m at full width: 32 layers, top-8 of 40 swiglu
  # experts, GQA groups of 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \
      --engine continuous --moe-impl dropless --capacity-factor none --requests 16

  # xlstm-125m in recurrent slots (the continuous engine), or by the static
  # engine, which feeds each prompt token by token
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
      --engine continuous --requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
      --engine static --requests 16

  # zamba2-7b at full width and depth (81 Mamba2 layers, 14 applications of
  # the shared attention, whose every step is the dense decode kernel at
  # head_dim 224), by the static engine, which feeds each prompt token by
  # token; the continuous engine refuses zamba, as the reference's does
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
      --engine static --requests 16

  # on a (data 2, expert 2) mesh, one process a rank: slots and KV pools
  # over data, the experts over expert (ragged expert-parallel all_to_all);
  # --mesh-backend gloo when the four ranks share one card (NCCL refuses
  # two ranks on a device), nccl (the default on CUDA) when each has its own
  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch m6-base --engine continuous --moe-impl dropless --capacity-factor none \
      --requests 16 --mesh data=2,expert=2 --mesh-backend gloo

Every --arch the reference lists resolves.  No engine serves the encdec
family (seamless-m4t-large-v2), as in the reference: ``--engine static``
fails at the family's ``init_state`` (its decode state needs the encoder's
memory: ``repro_torch.models.encdec``), ``--engine continuous`` refuses
the family, each with the reference's message.  For xlstm-125m the continuous engine refuses what needs the paged
KV cache (speculation, prefix caching, --kv-quant, --slo-preempt), as the
reference's does.
The flags are the reference's, and --mesh-backend.  As in the reference,
the static engine takes no --mesh, --spec-drafter, --trace-out,
--metrics-out or --profile-dir, and the continuous engine refuses --mesh
with speculation or SLO scheduling.  On a mesh every rank serves the same
trace (its rank's device is ``cuda:{LOCAL_RANK % device_count}``); rank 0
alone prints and writes the trace, metrics and profile.
``--profile-dir`` writes a ``torch.profiler`` Chrome trace of the serve
run (CPU and, on the card, CUDA activity) there as ``trace.json``.
Weights are random, drawn from a ``torch.Generator`` seeded by ``--seed``,
unless ``--ckpt-dir`` names checkpoints in the reference's format: then the
latest one's params are served (a train checkpoint's ``.params`` leaves or
a bare-params checkpoint's, cast to the serving tree's storage dtypes).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import time

import numpy as np

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import KV_QUANTS, ServeConfig, SLOConfig, SpecConfig
from repro_torch.configs.registry import ALL_IDS, get_config, get_smoke_config
from repro_torch.core.dispatch import available_dispatchers
from repro_torch.kernels import build
from repro_torch.nn import init_params
from repro_torch.obs.profile import device_trace
from repro_torch.serving.continuous import ContinuousEngine, check_mesh_support
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import available_policies
from repro_torch.serving.speculative import available_drafters
from repro_torch.serving.trace import (
    latency_line,
    load_trace,
    run_trace_static,
    slo_class_line,
    static_max_len,
    synthetic_multitenant,
    synthetic_priority,
    synthetic_trace,
)


def parse_capacity_factor(value: str):
    """'none' => dropless (capacity_factor=None); otherwise a float gamma."""
    return None if value.lower() in ("none", "dropless", "inf") else float(value)


def parse_mesh(text: str):
    """'data=2,expert=4' or bare '2,4' -> ServeConfig.mesh tuples (the
    reference's parser)."""
    sizes = {}
    parts = [p.strip() for p in text.split(",") if p.strip()]
    if all("=" in p for p in parts):
        for p in parts:
            name, _, n = p.partition("=")
            sizes[name.strip()] = int(n)
    else:
        if len(parts) > 2:
            raise SystemExit(f"--mesh {text!r}: at most data,expert sizes")
        for name, n in zip(("data", "expert"), parts):
            sizes[name] = int(n)
    unknown = set(sizes) - {"data", "expert"}
    if unknown:
        raise SystemExit(
            f"--mesh {text!r}: unknown axes {sorted(unknown)} "
            "(serving meshes have axes data, expert)")
    return (("data", sizes.get("data", 1)), ("expert", sizes.get("expert", 1)))


def _write_obs(engine, args) -> None:
    if engine.mesh is not None and engine.mesh.rank != 0:
        return
    if args.trace_out:
        if args.trace_out.endswith(".jsonl"):
            engine.obs.tracer.write_jsonl(args.trace_out)
        else:
            engine.obs.tracer.write_chrome_trace(args.trace_out)
        print(f"trace -> {args.trace_out} ({len(engine.obs.tracer.events())} events, "
              f"{engine.obs.tracer.dropped_events} dropped)")
    if args.metrics_out:
        engine.obs.write_metrics_jsonl(args.metrics_out)
        print(f"metrics -> {args.metrics_out}")


def draft_setup(args, params):
    """(SpecConfig or None, draft_model or None) from the --spec-* flags.
    ``--spec-draft-ckpt`` restores the draft model's params from the latest
    checkpoint there (random, from ``--seed`` + 1, if it holds none)."""
    if args.spec_drafter is None:
        return None, None
    spec = SpecConfig(drafter=args.spec_drafter, gamma=args.spec_gamma, draft=args.spec_draft)
    if not args.spec_draft_ckpt:
        return spec, None
    if args.spec_drafter != "model":
        raise SystemExit("--spec-draft-ckpt needs --spec-drafter model")
    if args.spec_draft is None:
        raise SystemExit("--spec-draft-ckpt needs --spec-draft")
    dcfg = get_smoke_config(args.spec_draft) if args.smoke else get_config(args.spec_draft)
    device = params["embed"]["table"].device
    dparams = init_params(dcfg, seed=args.seed + 1, device=device)
    restored, step = Checkpointer(args.spec_draft_ckpt).restore_params_latest(dparams)
    if restored is not None:
        dparams = restored
        print(f"restored draft params from checkpoint step {step}")
    return spec, (dcfg, dparams)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="m6-base", choices=ALL_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", default="static", choices=["static", "continuous"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--requests", type=int, default=0)
    ap.add_argument("--qps", type=float, default=50.0)
    ap.add_argument("--trace-kind", default="mixed",
                    choices=["mixed", "multitenant", "priority"],
                    help="synthetic trace: mixed lengths, multi-tenant shared "
                         "system prompts (the workload --prefix-cache targets), or "
                         "bursty mixed-priority overload with deadlines (the workload "
                         "--slo-preempt and the slo policies target)")
    ap.add_argument("--tenants", type=int, default=4,
                    help="multitenant/priority trace: distinct system prompts")
    ap.add_argument("--system-prompt-len", type=int, default=48,
                    help="multitenant trace: shared system-prompt length")
    ap.add_argument("--burst-qps", type=float, default=None,
                    help="priority trace: arrival rate during bursts (default 4x --qps)")
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--kv-block", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--mesh", default=None,
                    help="serving mesh (continuous engine): 'data=2,expert=4' (or bare "
                         "'2,4'); one process a rank, under torch.distributed.run")
    ap.add_argument("--mesh-backend", default=None, choices=[None, "nccl", "gloo"],
                    help="the mesh's process-group backend (default nccl on CUDA, gloo "
                         "on the CPU); gloo when ranks share a card")
    ap.add_argument("--sched-policy", default="fcfs", choices=available_policies(),
                    help="admission policy")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-addressed block-level prefix caching: admission "
                         "binds cached prompt-prefix blocks")
    ap.add_argument("--slo-preempt", action="store_true",
                    help="SLO-aware preemption: a higher-priority arrival evicts a "
                         "running lower-priority request, whose KV blocks swap to a "
                         "host pool for a later restore")
    ap.add_argument("--slo-shed", action="store_true",
                    help="deadline-aware shedding: reject a queued request once its "
                         "deadline is provably unmeetable at the measured decode rate")
    ap.add_argument("--host-blocks", type=int, default=None,
                    help="host swap pool size in KV blocks (default: the device pool's)")
    ap.add_argument("--kv-quant", default="none", choices=KV_QUANTS,
                    help="KV pools: none (activation dtype), int8 or fp8 codes "
                         "with per-(block, head) absmax scales")
    ap.add_argument("--spec-drafter", default=None, choices=[None, *available_drafters()],
                    help="enable speculative decoding with this drafter")
    ap.add_argument("--spec-gamma", type=int, default=4,
                    help="max draft tokens per slot per verify step")
    ap.add_argument("--spec-draft", default=None, choices=[None, *ALL_IDS],
                    help="draft model config id for --spec-drafter model (smoke-sized; "
                         "must share the target vocab)")
    ap.add_argument("--spec-draft-ckpt", default=None,
                    help="checkpoint dir of the draft model's params (params-only restore; "
                         "without it the draft model is random)")
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, *available_dispatchers()])
    ap.add_argument("--capacity-factor", default=None,
                    help="gamma, or 'none' for dropless serving")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--metrics-every", type=int, default=50)
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the serve run into this "
                         "directory as trace.json (continuous engine only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch versions)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.engine == "static":
        for flag, value in (("--mesh", args.mesh), ("--spec-drafter", args.spec_drafter),
                            ("--trace-out", args.trace_out),
                            ("--metrics-out", args.metrics_out),
                            ("--profile-dir", args.profile_dir)):
            if value is not None:
                raise SystemExit(f"{flag} needs --engine continuous")
    mesh_spec = None if args.mesh is None else parse_mesh(args.mesh)

    obs = None
    if args.trace_out or args.metrics_out or args.profile_dir:
        from repro_torch.obs import Observability

        obs = Observability(tracing=args.trace_out is not None)
        if args.metrics_out:
            obs.metrics_every = max(args.metrics_every, 1)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.moe_impl and cfg.moe.num_experts:
        cfg = cfg.replace_moe(impl=args.moe_impl)
    if args.capacity_factor is not None and cfg.moe.num_experts:
        cfg = cfg.replace_moe(capacity_factor=parse_capacity_factor(args.capacity_factor))
    if mesh_spec is not None:
        return _serve_on_mesh(args, cfg, mesh_spec, obs)
    params = init_params(cfg, seed=args.seed, device=args.device)
    return _serve(args, cfg, params, obs)


def _slo(args):
    return (SLOConfig(preemption=args.slo_preempt, host_blocks=args.host_blocks,
                      shed=args.slo_shed)
            if args.slo_preempt or args.slo_shed else None)


def _serve_on_mesh(args, cfg, mesh_spec, obs):
    """The continuous engine on a serving mesh, this process one rank: the
    reference's refusals first, then the mesh, then this rank's placement
    of the params (drawn leaf by leaf, or cut from the checkpoint)."""
    from repro_torch.distributed.sharding import make_rules, placement, shard_params
    from repro_torch.launch.mesh import make_serve_mesh, rank_device

    spec = (None if args.spec_drafter is None
            else SpecConfig(drafter=args.spec_drafter, gamma=args.spec_gamma))
    check_mesh_support(cfg, ServeConfig(max_slots=args.max_slots, mesh=mesh_spec, spec=spec,
                                        slo=_slo(args)))
    device = rank_device(args.device)
    mesh = make_serve_mesh(mesh_spec, device, args.mesh_backend)
    rules = make_rules(cfg, mesh, expert_axis="expert")
    keep = ("router",)
    if args.ckpt_dir:
        # the checkpoint holds whole leaves: restore them on the host, then
        # keep this rank's slices
        template = init_params(cfg, seed=args.seed, device="cpu")
        restored, step = Checkpointer(args.ckpt_dir).restore_params_latest(template)
        full = template if restored is None else restored
        params = _to_device(shard_params(full, rules, mesh.coord, keep), device)
        if restored is not None:
            print(f"restored params-only from checkpoint step {step}")
    else:
        params = init_params(cfg, seed=args.seed, device=device,
                             place=placement(rules, mesh.coord, keep))
    quiet = contextlib.redirect_stdout(io.StringIO()) if mesh.rank else contextlib.nullcontext()
    with quiet:
        return _serve(args, cfg, params, obs, mesh=mesh)


def _to_device(tree, device):
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _serve(args, cfg, params, obs, mesh=None):
    mesh_spec = None if mesh is None else tuple(mesh.shape.items())
    device = args.device if mesh is None else mesh.device
    # rank 0 alone profiles
    profile_dir = args.profile_dir if mesh is None or mesh.rank == 0 else None
    if args.ckpt_dir and mesh is None:
        # params-only restore: no optimizer state, no TrainState; the
        # Checkpointer reads the params of a train checkpoint (or a
        # bare-params one) into the serving tree
        restored, step = Checkpointer(args.ckpt_dir).restore_params_latest(params)
        if restored is not None:
            params = restored
            print(f"restored params-only from checkpoint step {step}")
    spec, draft_model = draft_setup(args, params)
    if params["embed"]["table"].is_cuda:
        # build the kernels now (all nvcc at once), not inside the first
        # served step, where the build time would land in every latency
        t0 = time.perf_counter()
        build.build()
        print(f"kernels built in {time.perf_counter() - t0:.1f}s")

    if args.trace is None and args.requests <= 0:
        # one uniform batch of synthetic prompts
        max_len = args.prompt_len + args.gen + 1
        prompts = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
        if args.engine == "static":
            engine = ServingEngine(cfg, params, max_len=max_len)
            toks, stats = engine.generate(prompts, args.gen, temperature=args.temperature,
                                          seed=args.seed)
            print("generated:", toks[:, :16])
            print({k: round(float(v), 4) for k, v in stats.items()})
            return stats
        serve = ServeConfig(max_slots=args.max_slots, kv_block_size=args.kv_block,
                            prefill_chunk=args.prefill_chunk,
                            max_len=max(args.max_len, max_len),
                            spec=spec, sched_policy=args.sched_policy,
                            kv_quant=args.kv_quant, mesh=mesh_spec)
        engine = ContinuousEngine(cfg, params, serve, temperature=args.temperature,
                                  seed=args.seed, device=device,
                                  draft_model=draft_model, obs=obs, mesh=mesh)
        with device_trace(profile_dir, device):
            toks, stats = engine.generate(prompts, args.gen)
        _write_obs(engine, args)
        print("generated:", toks[:, :16])
        print({k: round(float(v), 4) for k, v in stats.items()})
        return stats

    if args.trace is not None:
        requests = load_trace(args.trace, cfg.vocab_size, seed=args.seed)
    elif args.trace_kind == "multitenant":
        requests = synthetic_multitenant(args.requests, cfg.vocab_size, seed=args.seed,
                                         qps=args.qps, num_tenants=args.tenants,
                                         system_prompt_len=args.system_prompt_len)
    elif args.trace_kind == "priority":
        requests = synthetic_priority(
            args.requests, cfg.vocab_size, seed=args.seed, qps=args.qps,
            burst_qps=args.burst_qps, num_tenants=args.tenants,
            system_prompt_len=args.system_prompt_len if args.prefix_cache else 0)
    else:
        requests = synthetic_trace(args.requests, cfg.vocab_size, seed=args.seed,
                                   qps=args.qps)
    longest = max(r.total_len for r in requests)
    print(f"serving {len(requests)} requests "
          f"({'trace ' + args.trace if args.trace else 'synthetic ' + args.trace_kind}), "
          f"engine={args.engine}")
    if args.engine == "static":
        engine = ServingEngine(cfg, params, max_len=static_max_len(requests))
        _, stats = run_trace_static(engine, requests, args.batch,
                                    temperature=args.temperature, seed=args.seed)
        print(latency_line(stats))
        return stats
    serve = ServeConfig(max_slots=args.max_slots, kv_block_size=args.kv_block,
                        prefill_chunk=args.prefill_chunk,
                        max_len=max(args.max_len, longest),
                        spec=spec, sched_policy=args.sched_policy,
                        prefix_cache=args.prefix_cache, slo=_slo(args), kv_quant=args.kv_quant,
                        mesh=mesh_spec)
    engine = ContinuousEngine(cfg, params, serve, temperature=args.temperature,
                              seed=args.seed, device=device, draft_model=draft_model,
                              obs=obs, mesh=mesh)

    def stream(st):
        print(f"  req {st.request.uid}: {len(st.generated)} tokens, "
              f"latency {st.latency_ms():.0f}ms, first {st.generated[:8]}")

    with device_trace(profile_dir, device):
        _, stats = engine.run(requests, on_finish=stream)
    _write_obs(engine, args)
    if spec is not None:
        print(f"speculative[{spec.drafter}]: acceptance {stats['acceptance_rate']:.2f}, "
              f"{stats['spec_tokens_per_step']:.2f} tokens/verify-step")
    if args.prefix_cache:
        cs = engine.cache.stats
        print(f"prefix cache: {stats['cached_tokens']:.0f}/{stats['prompt_tokens']:.0f} "
              f"prompt tokens cached ({stats['cached_token_ratio']:.0%}), "
              f"{cs['bound_blocks']} blocks bound shared, {cs['published_blocks']} "
              f"published, {cs['cow_copies']} COW copies, {cs['evicted_blocks']} evicted")
    line = slo_class_line(stats)
    if line:
        print(line)
    print(latency_line(stats))
    return stats


if __name__ == "__main__":
    main()
