"""Training entry point (``repro.launch.train``) on one card.

  # m6-base at full width, top-1 with capacity 1.25, the grouped-FFN kernel
  PYTHONPATH=src python -m repro_torch.launch.train --arch m6-base \\
      --moe-impl pallas --steps 8 --batch 8 --seq 144

  # the paper's 4 top-1 expert prototyping
  PYTHONPATH=src python -m repro_torch.launch.train --arch m6-base \\
      --moe-impl pallas --steps 8 --batch 8 --seq 144 --routing prototype --k 4

  # smoke size on the CPU (the kernels' plain PyTorch versions run)
  PYTHONPATH=src python -m repro_torch.launch.train --arch m6-base --smoke \\
      --moe-impl pallas --steps 4 --batch 4 --seq 36 --device cpu

The flags are the reference's.  Those whose feature is not ported raise
NotImplementedError: --ckpt-dir (and so restarts: --max-restarts), --data
or --model above 1, --grad-compression other than none, --optimizer
adafactor (m6-1t's default), --profile-dir, and routers or dispatchers
the port does not register.  Weights are random, drawn from a
``torch.Generator`` seeded by ``--seed``; the data is the reference's
synthetic pipeline, so both packages read the same batches.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import ALL_IDS, get_config, get_smoke_config
from repro_torch.core import dispatch, routers
from repro_torch.data.pipeline import make_pipeline
from repro_torch.kernels import build as kernel_build
from repro_torch.launch.serve import parse_capacity_factor
from repro_torch.nn import init_params
from repro_torch.obs import Observability
from repro_torch.optim import make_optimizer, warmup_constant
from repro_torch.train.state import init_train_state
from repro_torch.train.trainer import make_train_step


def build(args):
    """The model config the flags ask for (``repro.launch.train.build``)."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.routing and cfg.moe.num_experts:
        if args.routing == "prototype":
            cfg = cfg.replace_moe(routing="prototype", num_prototypes=args.k)
        else:  # any other registry key routes k-way via top_k
            cfg = cfg.replace_moe(routing=args.routing, top_k=args.k)
    if args.capacity:
        cfg = cfg.replace_moe(capacity_mode=args.capacity)
    if args.moe_impl and cfg.moe.num_experts:
        cfg = cfg.replace_moe(impl=args.moe_impl)
    if args.capacity_factor is not None and cfg.moe.num_experts:
        cfg = cfg.replace_moe(capacity_factor=parse_capacity_factor(args.capacity_factor))
    if args.aux_loss_coef is not None:
        cfg = cfg.replace_moe(aux_loss_coef=args.aux_loss_coef)
    return cfg


def _unported(args, cfg, optimizer: str) -> list:
    """Flags set to something this port does not implement."""
    checks = [
        (args.ckpt_dir is not None, "--ckpt-dir"),
        (args.max_restarts is not None, "--max-restarts"),
        (args.data > 1 or args.model > 1, "--data/--model > 1"),
        (args.grad_compression != "none", f"--grad-compression {args.grad_compression}"),
        (optimizer == "adafactor", "--optimizer adafactor"),
        (args.profile_dir is not None, "--profile-dir"),
        (cfg.moe.num_experts > 0 and cfg.moe.routing in routers.UNPORTED,
         f"--routing {cfg.moe.routing}"),
        (cfg.moe.num_experts > 0 and cfg.moe.impl in dispatch.UNPORTED,
         f"--moe-impl {cfg.moe.impl}"),
    ]
    return [flag for cond, flag in checks if cond]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="m6-base", choices=ALL_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--optimizer", default=None, choices=[None, "adamw", "adafactor"])
    ap.add_argument("--routing", default=None,
                    choices=[None, *routers.available_routers(), *routers.UNPORTED])
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--capacity", default=None, choices=[None, "k", "one"])
    ap.add_argument("--capacity-factor", default=None,
                    help="gamma, or 'none' for dropless (needs --moe-impl dropless)")
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, *dispatch.available_dispatchers(), *dispatch.UNPORTED])
    ap.add_argument("--aux-loss-coef", type=float, default=None)
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--data", default=1, type=int, help="data mesh axis")
    ap.add_argument("--model", default=1, type=int, help="model mesh axis")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-restarts", type=int, default=None)
    ap.add_argument("--trace-out", default=None,
                    help="write per-train-step spans here: Chrome-trace JSON "
                         "(Perfetto), or span JSONL for .jsonl paths")
    ap.add_argument("--metrics-out", default=None,
                    help="write registry snapshots (one row per logged step) as "
                         "metrics JSONL")
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch versions)")
    return ap


def setup(args):
    """(cfg, tc, train_step, state, pipeline) as ``main`` builds them."""
    cfg = build(args)
    optimizer = args.optimizer or ("adafactor" if cfg.name == "m6-1t" else "adamw")
    bad = _unported(args, cfg, optimizer)
    if bad:
        raise NotImplementedError("not ported: " + ", ".join(bad))
    tc = TrainConfig(
        optimizer=optimizer,
        learning_rate=args.lr or (5e-3 if optimizer == "adafactor" else 8e-5),
        grad_compression=args.grad_compression,
        microbatches=args.microbatches,
        warmup_steps=min(500, args.steps // 4 + 1),
    )
    opt = make_optimizer(tc, warmup_constant(tc.learning_rate, tc.warmup_steps))
    step_fn = make_train_step(cfg, tc, opt)
    params = init_params(cfg, seed=args.seed, device=args.device, train=True)
    state = init_train_state(params, opt, tc.grad_compression)
    pipeline = make_pipeline(cfg, args.batch, args.seq, seed=args.seed)
    return cfg, tc, step_fn, state, pipeline


def device_batch(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg, tc, step_fn, state, pipeline = setup(args)
    if torch.device(args.device).type == "cuda":
        # build the kernels now (all nvcc at once), not inside the first step
        t0 = time.perf_counter()
        kernel_build.build()
        print(f"kernels built in {time.perf_counter() - t0:.1f}s")

    obs = Observability(tracing=args.trace_out is not None)
    if args.metrics_out:
        obs.metrics_every = max(args.log_every, 1)
    reg = obs.metrics
    t_tokens = args.batch * args.seq
    logs = []
    for step in range(args.steps):
        t0 = time.time()
        batch = device_batch(pipeline.batch_at(step), args.device)
        with obs.tracer.span("train_step", cat="train", step=step, tokens=t_tokens):
            state, metrics = step_fn(state, batch)
        reg.counter("train_steps_total").inc()
        reg.counter("train_tokens_total").inc(t_tokens)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v.float().mean()) for k, v in metrics.items()}
            dt = time.time() - t0
            m.update(step=step, step_time_s=round(dt, 3), tokens_per_s=round(t_tokens / dt, 1))
            logs.append(m)
            for key in ("loss", "ce", "moe_cv", "moe_dropped_fraction",
                        "moe_aux_loss", "moe_z_loss"):
                if key in m:
                    reg.gauge(f"train_{key}").set(m[key])
            reg.gauge("train_tokens_per_s").set(m["tokens_per_s"])
            reg.histogram("train_step_ms").observe(dt * 1e3)
            if args.metrics_out:
                obs.metrics_row(step=step)
            print(f"step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                  f"cv {m.get('moe_cv', 0):.3f} drop {m.get('moe_dropped_fraction', 0):.3f} "
                  f"({m['tokens_per_s']:.0f} tok/s)", flush=True)

    if args.trace_out:
        if args.trace_out.endswith(".jsonl"):
            obs.tracer.write_jsonl(args.trace_out)
        else:
            obs.tracer.write_chrome_trace(args.trace_out)
    if args.metrics_out:
        obs.write_metrics_jsonl(args.metrics_out)
    if args.log_file:
        with open(args.log_file, "w") as f:
            json.dump(logs, f, indent=1)
    return logs


if __name__ == "__main__":
    main()
