"""Training entry point (``repro.launch.train``), on one card or a mesh.

  # m6-base at full width, top-1 with capacity 1.25, the grouped-FFN kernel
  PYTHONPATH=src python -m repro_torch.launch.train --arch m6-base \\
      --moe-impl pallas --steps 8 --batch 8 --seq 144

  # the paper's 4 top-1 expert prototyping
  PYTHONPATH=src python -m repro_torch.launch.train --arch m6-base \\
      --moe-impl pallas --steps 8 --batch 8 --seq 144 --routing prototype --k 4

  # smoke size on the CPU (the kernels' plain PyTorch versions run), with a
  # checkpoint every 2 steps; run again with the same --ckpt-dir to resume
  PYTHONPATH=src python -m repro_torch.launch.train --arch m6-base --smoke \\
      --moe-impl pallas --steps 4 --batch 4 --seq 36 --device cpu \\
      --ckpt-dir /tmp/ckpt --ckpt-every 2

  # granite-moe-3b-a800m at full width (2 layers in chip_smoke.py), the
  # paper's 8 top-1 prototyping, Adafactor, chunked attention at seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-3b-a800m \
      --moe-impl pallas --optimizer adafactor --routing prototype --k 8 \
      --steps 4 --batch 4 --seq 2048

  # xlstm-125m at full width: the chunked mLSTM form (1024 > 2 x 256) and
  # the sLSTM loop over time
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
      --steps 2 --batch 4 --seq 1024

  # zamba2-7b at smoke size on the CPU: the chunked SSD scan and the shared
  # attention.  At full width its 81 layers' f32 masters, gradients and
  # AdamW moments (~110 GB) exceed one card; chip_smoke.py trains it at 7
  # layers by editing ``build``'s config (the CLI has no depth flag)
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b --smoke \
      --steps 2 --batch 2 --seq 40 --device cpu

  # seamless-m4t-large-v2 (encdec) at full width and depth: frames of
  # --seq positions in, --seq target tokens out (the reference's pipeline)
  PYTHONPATH=src python -m repro_torch.launch.train --arch seamless-m4t-large-v2 \
      --steps 2 --batch 4 --seq 256

  # m6-base on a (data 2, model 2) mesh: one process a rank, experts,
  # heads and the vocab sharded over "model", the batch over "data",
  # ZeRO-1 optimizer state; four ranks on one card share it over gloo
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch m6-base --data 2 --model 2 \
      --moe-impl alltoall --batch 16 --seq 256 --steps 3 --mesh-backend gloo

  # the same at smoke size, four gloo ranks on the CPU
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch m6-base --smoke --data 2 --model 2 \
      --moe-impl alltoall --batch 8 --seq 32 --steps 2 --device cpu

Every --arch the reference lists trains.  MoE attention and mixed
dense/MoE stacks have no flag, as in the reference: a config that sets ``moe.moe_attention`` or
``moe_layer_period`` trains through ``run`` like any other.
The flags are the reference's, and ``--mesh-backend``.  ``--data D
--model M`` trains on a ("data", "model") mesh of D x M ranks, one process
a rank (under ``torch.distributed.run``; ``launch.mesh.spawn`` for tests),
as the reference's pjit step does (``train.trainer``, ``train.layout``):
each rank on ``cuda:{LOCAL_RANK % cards}``, NCCL where each has a card of
its own, gloo (``--mesh-backend gloo``) where ranks share one; rank 0
alone prints and writes the checkpoints, the logs and the traces.
``--mesh-backend`` alone runs the (1, 1) mesh in this process (a world-1
group), whose step is the single-device one bit for bit.  A config with
``fsdp`` set (no flag, as in the reference: the dry run sets it) trains
with the "embed" dim of every tree over the data axes.  Every tree trains
on a model axis: the xLSTM, zamba and encdec trees
(``--arch zamba2-7b --data 2 --model 2``: the Mamba2 blocks' heads, the
shared block's heads and FFN, the attention heads of encdec, the sLSTM
FFN and every vocab over "model"), and MoE attention's experts (Fig. 4's
config, through ``build``: no flag, as in the reference), whose groups
may straddle the data ranks, as the MoE FFN's may.
``--moe-impl alltoall`` without a mesh trains, as the reference's does,
as ``gather``.
``--routing`` takes all four of the reference's routers
(topk, prototype, expert_choice, hash); ``--optimizer`` adamw or
adafactor (m6-1t's default); ``--grad-compression`` none, bf16 or int8
(with error feedback); ``--profile-dir`` writes a ``torch.profiler``
Chrome trace of the train loop there (``trace.json``).  On one device the
step is ``train.trainer.TrainForm``: on the card it is captured as a CUDA
graph at the loop's first step, which runs eagerly as the capture's
warm-up, and replayed from the next step on (``--no-graphs``: every step
eager); a restarted loop captures again on its new state.  A mesh rank's
step runs eagerly.  Weights are random,
drawn from a ``torch.Generator`` seeded by ``--seed``; the data is the
reference's synthetic pipeline, so both packages read the same batches.

Checkpoints (``--ckpt-dir``) are the reference's format
(``repro_torch.checkpoint``), written asynchronously every
``--ckpt-every`` steps and once at the end; a run starts from the latest
one, and a step that raises restarts the loop from it, at most
``--max-restarts`` times (``repro_torch.distributed.fault``).  A
checkpoint is named by the steps it holds (its ``.step`` leaf), and the
loop resumes at that leaf's step, so a resumed run takes the batches an
unbroken one takes.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import ALL_IDS, get_config, get_smoke_config
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import dispatch, routers
from repro_torch.data.pipeline import make_pipeline
from repro_torch.distributed.fault import StepWatchdog, run_with_restarts
from repro_torch.kernels import build as kernel_build
from repro_torch.launch.serve import parse_capacity_factor
from repro_torch.nn import init_params
from repro_torch.obs import Observability
from repro_torch.obs.profile import device_trace
from repro_torch.optim import make_optimizer, warmup_constant
from repro_torch.train.state import TrainState, init_train_state
from repro_torch.train.trainer import TrainForm, make_train_step


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


def on_mesh(args) -> bool:
    """Whether the flags ask for a training mesh."""
    return (args.data * args.model > 1 or args.mesh_backend is not None
            or "WORLD_SIZE" in os.environ)


def make_layout(args):
    """The ``MeshLayout`` of the flags' training mesh: the default process
    group joined (``torch.distributed.run``'s environment, or a world-1
    group for the (1, 1) mesh), this rank's device, the rules with the
    batch sharded over "data"."""
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_debug_mesh, rank_device
    from repro_torch.train.layout import MeshLayout

    cfg = build(args)
    device = rank_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = make_debug_mesh(args.data, args.model, device, args.mesh_backend)
    return MeshLayout(cfg, make_rules(cfg, mesh, batch_sharded=True))


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
                    choices=[None, *routers.available_routers()])
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--capacity", default=None, choices=[None, "k", "one"])
    ap.add_argument("--capacity-factor", default=None,
                    help="gamma, or 'none' for dropless (needs --moe-impl dropless)")
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, *dispatch.available_dispatchers()])
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
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--trace-out", default=None,
                    help="write per-train-step spans here: Chrome-trace JSON "
                         "(Perfetto), or span JSONL for .jsonl paths")
    ap.add_argument("--metrics-out", default=None,
                    help="write registry snapshots (one row per logged step) as "
                         "metrics JSONL")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the train loop (CPU and, on "
                         "the card, CUDA activity) into this directory as trace.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch versions)")
    ap.add_argument("--graphs", default=True, action=argparse.BooleanOptionalAction,
                    help="on one card, capture the train step as a CUDA graph at step 0 "
                         "(which runs eagerly as the capture's warm-up) and replay it "
                         "from step 1 on (default); --no-graphs runs every step eagerly")
    ap.add_argument("--mesh-backend", default=None, choices=[None, "nccl", "gloo"],
                    help="the training mesh's torch.distributed backend (default: NCCL on "
                         "CUDA, gloo on the CPU; ranks that share a card need gloo)")
    return ap


def parts(args, layout=None):
    """(cfg, tc, optimizer, train_step, pipeline) as ``main`` builds them
    (``layout``: a mesh rank's, from :func:`make_layout`)."""
    cfg = build(args)
    tc = TrainConfig(
        optimizer=args.optimizer or ("adafactor" if cfg.name == "m6-1t" else "adamw"),
        # from the flag, not the resolved optimizer, as the reference: m6-1t's
        # default Adafactor runs at 8e-5 unless --optimizer names it
        learning_rate=args.lr or (5e-3 if args.optimizer == "adafactor" else 8e-5),
        grad_compression=args.grad_compression,
        microbatches=args.microbatches,
        warmup_steps=min(500, args.steps // 4 + 1),
    )
    opt = make_optimizer(tc, warmup_constant(tc.learning_rate, tc.warmup_steps))
    step_fn = make_train_step(cfg, tc, opt, layout)
    pipeline = make_pipeline(cfg, args.batch, args.seq, seed=args.seed)
    return cfg, tc, opt, step_fn, pipeline


def setup(args, layout=None):
    """(cfg, tc, train_step, state, pipeline) as ``main`` builds them, the
    state the seed's (a mesh rank's blocks of it, with ``layout``)."""
    cfg, tc, opt, step_fn, pipeline = parts(args, layout)
    return cfg, tc, step_fn, fresh_state(cfg, tc, opt, args, layout), pipeline


def fresh_state(cfg, tc, opt, args, layout=None):
    """The initial train state: the seed's params (the training tree) and
    a zero optimizer state; on a mesh, the rank's blocks of them, each leaf
    drawn whole and cut (the values of the single-device tree)."""
    if layout is None:
        params = init_params(cfg, seed=args.seed, device=args.device, train=True)
        return init_train_state(params, opt, tc.grad_compression)
    from repro_torch.distributed.sharding import placement

    place = placement(layout.rules, layout.mesh.coord, keep=layout.keep)
    params = init_params(cfg, seed=args.seed, device=layout.mesh.device, train=True, place=place)
    return init_train_state(params, opt, tc.grad_compression, layout)


def device_batch(batch, device):
    """A host batch as new tensors on ``device`` (the mesh step's input;
    one device stages its batches in the train form's buffers)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def run(args, on_step: Optional[Callable[[int, TrainState], None]] = None):
    """Train as the flags say; returns (the logged steps, the final state).
    ``on_step(step, state)`` is called before each step with the state that
    step starts from (a test's probe and fault injection: an exception
    there fails the loop as a failing step would)."""
    layout = make_layout(args) if on_mesh(args) else None
    cfg, tc, opt, step_fn, pipeline = parts(args, layout)
    device = args.device if layout is None else layout.mesh.device
    lead = layout is None or layout.mesh.rank == 0      # prints and writes
    if torch.device(device).type == "cuda":
        # build the kernels now (all nvcc at once), not inside the first step
        t0 = time.perf_counter()
        kernel_build.build()
        if lead:
            print(f"kernels built in {time.perf_counter() - t0:.1f}s")

    obs = Observability(tracing=args.trace_out is not None)
    if args.metrics_out:
        obs.metrics_every = max(args.log_every, 1)
    ckpt = Checkpointer(args.ckpt_dir, writer=lead) if args.ckpt_dir else None
    watchdog = StepWatchdog()
    t_tokens = args.batch * args.seq
    logs = []
    held = {}                                       # the final state

    def resume_step():
        if ckpt is None:
            return 0
        # a failure after save_async returned leaves that checkpoint's files
        # being written; its snapshot was whole, so let the write finish
        ckpt.wait()
        if layout is not None:              # rank 0's writes are done for every rank
            torch.distributed.barrier(layout.mesh.world)
        latest = ckpt.latest_step()
        return 0 if latest is None else latest

    def loop(start: int) -> int:
        # every attempt starts from a new state (a failed one may be half
        # updated), which a checkpoint then overwrites leaf for leaf
        st = fresh_state(cfg, tc, opt, args, layout)
        placed = None if layout is None else layout.checkpoint_view(st)
        if ckpt is not None and start > 0:
            st = ckpt.restore(start, st, placed)
        # one device: the step as a form over the attempt's state (captured
        # at its first step on the card, with --graphs); a mesh rank: eager
        form = None if layout is not None else TrainForm(cfg, tc, opt, st, graphs=args.graphs)
        reg = obs.metrics
        for step in range(st.step, args.steps):
            if on_step is not None:
                on_step(step, st)
            t0 = time.time()
            with obs.tracer.span("train_step", cat="train", step=step, tokens=t_tokens):
                if form is not None:
                    st, metrics = form(st, pipeline.batch_at(step))
                else:
                    st, metrics = step_fn(st, device_batch(pipeline.batch_at(step), device))
            reg.counter("train_steps_total").inc()
            reg.counter("train_tokens_total").inc(t_tokens)
            if step % args.log_every == 0 or step == args.steps - 1:
                m = {k: float(v.float().mean()) for k, v in metrics.items()}
                dt = time.time() - t0
                watchdog.observe(dt)
                m.update(step=step, step_time_s=round(dt, 3),
                         tokens_per_s=round(t_tokens / dt, 1))
                logs.append(m)
                for key in ("loss", "ce", "moe_cv", "moe_dropped_fraction",
                            "moe_aux_loss", "moe_z_loss"):
                    if key in m:
                        reg.gauge(f"train_{key}").set(m[key])
                reg.gauge("train_tokens_per_s").set(m["tokens_per_s"])
                reg.histogram("train_step_ms").observe(dt * 1e3)
                if args.metrics_out:
                    obs.metrics_row(step=step)
                if lead:
                    print(f"step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                          f"cv {m.get('moe_cv', 0):.3f} drop "
                          f"{m.get('moe_dropped_fraction', 0):.3f} "
                          f"({m['tokens_per_s']:.0f} tok/s)", flush=True)
            # named by the steps it holds: resuming at its .step is exact
            if ckpt is not None and st.step < args.steps and st.step % args.ckpt_every == 0:
                ckpt.save_async(st.step, st, placed)
        if ckpt is not None:
            ckpt.wait()
            ckpt.save(args.steps, st, placed)
        held["state"] = st
        return args.steps

    with device_trace(args.profile_dir if lead else None, device):
        run_with_restarts(loop, resume_step, max_restarts=args.max_restarts)

    if not lead:
        return logs, held["state"]
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
    return logs, held["state"]


def main(argv=None):
    logs, _ = run(build_parser().parse_args(argv))
    return logs


if __name__ == "__main__":
    main()
