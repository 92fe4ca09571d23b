"""Serving entry point (``repro.launch.serve``), continuous batching on the card.

  # the m6-base serving path: 16 synthetic requests, dropless MoE
  PYTHONPATH=src python -m repro_torch.launch.serve --arch m6-base \\
      --engine continuous --moe-impl dropless --capacity-factor none --requests 16

  # one batch at smoke size on the CPU (plain PyTorch versions of the kernels);
  # --max-len stays within the smoke config's 64 learned positions
  PYTHONPATH=src python -m repro_torch.launch.serve --arch m6-base --smoke \\
      --engine continuous --moe-impl dropless --capacity-factor none \\
      --batch 3 --prompt-len 10 --gen 8 --max-len 32 --device cpu

The flags are the reference's.  Those whose feature is not ported (the
static engine, sampling temperature, speculative decoding, meshes, prefix
caching, SLO scheduling, quantized KV, checkpoint loading, the device
profiler, the multitenant/priority traces) raise NotImplementedError.
Weights are random, drawn from a ``torch.Generator`` seeded by ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import KV_QUANTS, ServeConfig
from repro_torch.configs.registry import ALL_IDS, get_config, get_smoke_config
from repro_torch.core.dispatch import UNPORTED, available_dispatchers
from repro_torch.kernels import build
from repro_torch.nn import init_params
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.scheduler import available_policies
from repro_torch.serving.trace import latency_line, load_trace, synthetic_trace


def parse_capacity_factor(value: str):
    """'none' => dropless (capacity_factor=None); otherwise a float gamma."""
    return None if value.lower() in ("none", "dropless", "inf") else float(value)


def _unported(args) -> list:
    """Flags set to something this port does not implement."""
    checks = [
        (args.engine == "static", "--engine static"),
        (args.temperature > 0, "--temperature > 0"),
        (args.trace_kind != "mixed", f"--trace-kind {args.trace_kind}"),
        (args.mesh is not None, "--mesh"),
        (args.prefix_cache, "--prefix-cache"),
        (args.slo_preempt or args.slo_shed or args.host_blocks is not None,
         "--slo-preempt/--slo-shed/--host-blocks"),
        (args.kv_quant != "none", f"--kv-quant {args.kv_quant}"),
        (args.spec_drafter is not None or args.spec_draft is not None
         or args.spec_draft_ckpt is not None, "--spec-*"),
        (args.ckpt_dir is not None, "--ckpt-dir"),
        (args.profile_dir is not None, "--profile-dir"),
    ]
    return [flag for cond, flag in checks if cond]


def _write_obs(engine, args) -> None:
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
                    choices=["mixed", "multitenant", "priority"])
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--system-prompt-len", type=int, default=48)
    ap.add_argument("--burst-qps", type=float, default=None)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--kv-block", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--sched-policy", default="fcfs", choices=available_policies())
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--slo-preempt", action="store_true")
    ap.add_argument("--slo-shed", action="store_true")
    ap.add_argument("--host-blocks", type=int, default=None)
    ap.add_argument("--kv-quant", default="none", choices=KV_QUANTS)
    ap.add_argument("--spec-drafter", default=None)
    ap.add_argument("--spec-gamma", type=int, default=4)
    ap.add_argument("--spec-draft", default=None)
    ap.add_argument("--spec-draft-ckpt", default=None)
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, *available_dispatchers(), *UNPORTED])
    ap.add_argument("--capacity-factor", default=None,
                    help="gamma, or 'none' for dropless serving")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--metrics-every", type=int, default=50)
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch versions)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    bad = _unported(args)
    if bad:
        raise NotImplementedError("not ported: " + ", ".join(bad))

    obs = None
    if args.trace_out or args.metrics_out:
        from repro_torch.obs import Observability

        obs = Observability(tracing=args.trace_out is not None)
        if args.metrics_out:
            obs.metrics_every = max(args.metrics_every, 1)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.moe_impl and cfg.moe.num_experts:
        cfg = cfg.replace_moe(impl=args.moe_impl)
    if args.capacity_factor is not None and cfg.moe.num_experts:
        cfg = cfg.replace_moe(capacity_factor=parse_capacity_factor(args.capacity_factor))
    params = init_params(cfg, seed=args.seed, device=args.device)
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
        serve = ServeConfig(max_slots=args.max_slots, kv_block_size=args.kv_block,
                            prefill_chunk=args.prefill_chunk,
                            max_len=max(args.max_len, max_len),
                            sched_policy=args.sched_policy)
        engine = ContinuousEngine(cfg, params, serve, device=args.device, obs=obs)
        toks, stats = engine.generate(prompts, args.gen)
        _write_obs(engine, args)
        print("generated:", toks[:, :16])
        print({k: round(float(v), 4) for k, v in stats.items()})
        return stats

    if args.trace is not None:
        requests = load_trace(args.trace, cfg.vocab_size, seed=args.seed)
    else:
        requests = synthetic_trace(args.requests, cfg.vocab_size, seed=args.seed,
                                   qps=args.qps)
    longest = max(r.total_len for r in requests)
    print(f"serving {len(requests)} requests "
          f"({'trace ' + args.trace if args.trace else 'synthetic mixed'}), "
          f"engine={args.engine}")
    serve = ServeConfig(max_slots=args.max_slots, kv_block_size=args.kv_block,
                        prefill_chunk=args.prefill_chunk,
                        max_len=max(args.max_len, longest),
                        sched_policy=args.sched_policy)
    engine = ContinuousEngine(cfg, params, serve, device=args.device, obs=obs)

    def stream(st):
        print(f"  req {st.request.uid}: {len(st.generated)} tokens, "
              f"latency {st.latency_ms():.0f}ms, first {st.generated[:8]}")

    _, stats = engine.run(requests, on_finish=stream)
    _write_obs(engine, args)
    print(latency_line(stats))
    return stats


if __name__ == "__main__":
    main()
