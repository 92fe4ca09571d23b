"""Multi-pod dry run (``repro.launch.dryrun``): trace every (arch x shape x
mesh) cell of the production mesh on the ``meta`` device, as rank 0 of a
``fake`` process group of the mesh's world, on the CPU and with no card.

The reference lowers and compiles each cell for 512 virtual devices and
reads XLA's memory and cost analyses.  The port has no compiler to ask: it
runs the program itself, eagerly, on ``meta`` tensors (shapes and dtypes,
no storage, nothing computed), as one rank of the mesh.  Each cell joins a
``torch.distributed`` group of the ``fake`` backend (every collective
returns at once; ``launch.mesh.production_mesh_axes``: 16 x 16, or
2 x 16 x 16, scaled down by ``REPRO_MESH_SINGLE`` / ``REPRO_MESH_MULTI``),
builds the mesh on ``meta`` as rank 0, places the params (``nn.abstract``)
by the rules, and runs the real program: the mesh train step
(``train.trainer.make_train_step`` with the rank's ``MeshLayout``), or the
family's ``prefill`` / ``decode``, under the reference's rules, its FSDP
switch, its optimizer choice (Adafactor above 3e11 parameters) and its
microbatching.  It records:

* the peak bytes of the rank's live tensors (``distributed.meta_trace``)
  and the parameter and optimizer-state bytes the rank holds;
* the collectives' launches and bytes by kind and by mesh axis
  (``distributed.collectives``), and the MoE-attention layers' own
  launches (``collectives.scoped``), the trace's aten ops, and the FLOPs
  ``FlopCounterMode`` counts (``distributed.costs.counted_flops``);
* the roofline of the analytic models (``distributed.costs``) against
  the H100's datasheet peaks (``distributed.roofline``).

Every number is analytic or a ``meta`` count against datasheet peaks, not
a measurement.  A cell that raises is recorded with ``status: "error"`` and
its reason, as the reference records one.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both \\
      --out experiments/torch/dryrun.json
  REPRO_MESH_SINGLE=2,4 PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch m6-base --shape train_4k --mesh single --out /tmp/dryrun.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.configs.registry import ALL_IDS, ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, shapes_for
from repro_torch.core import moe_attention
from repro_torch.distributed import collectives
from repro_torch.distributed.costs import bytes_for, counted_flops, flops_for
from repro_torch.distributed.meta_trace import MetaTrace
from repro_torch.distributed.roofline import (
    Roofline,
    axis_bandwidth,
    effective_bandwidth,
    model_flops_forward,
    model_flops_train,
)
from repro_torch.distributed.sharding import (
    _size,
    dp_axes,
    make_rules,
    placement,
    use_rules,
)
from repro_torch.launch.mesh import make_mesh, production_mesh_axes
from repro_torch.models.registry import get_family
from repro_torch.nn import abstract, count_params, flat_params, model_shapes
from repro_torch.optim import make_optimizer, warmup_constant
from repro_torch.train.layout import MeshLayout
from repro_torch.train.state import init_train_state
from repro_torch.train.trainer import make_train_step

HBM_BYTES = 80e9            # an H100's device memory


def active_param_count(cfg: ModelConfig) -> float:
    """Parameters touched per token: non-expert + experts * k / E (the
    router's axes lead with "embed", so it counts whole)."""
    total = count_params(cfg)
    if cfg.moe.num_experts == 0:
        return float(total)
    expert = 0
    for s in flat_params(model_shapes(cfg)).values():
        axes = s.axes or ()
        if axes and axes[0] == "layers":
            axes = axes[1:]
        if axes and axes[0] == "expert":
            expert += math.prod(s.shape)
    frac = cfg.moe.active_k / cfg.moe.num_experts
    return float(total - expert + expert * frac)


def _auto_microbatches(cfg: ModelConfig, shape: ShapeConfig, rules) -> int:
    """Gradient accumulation so that the per-layer saved activations fit
    (the reference's): tokens / device / microbatch * d * 2 B * L <= ~2.5 GB,
    a power of two dividing the per-device batch."""
    dp = _size(rules.mesh, rules.acts.get("batch"))
    tokens_per_dev = shape.tokens / dp
    budget = 2.5e9
    # the recurrent families hold chunk-scan residuals beyond the d_model
    # carry; weight their activation footprint accordingly
    family_factor = {"xlstm": 16.0, "zamba": 2.0}.get(cfg.family, 1.0)
    need = (tokens_per_dev * cfg.d_model * 2.0 * max(cfg.num_layers, 1)
            * family_factor / budget)
    mb = 1
    while mb < need and mb < 32 and (shape.global_batch // dp) % (mb * 2) == 0:
        mb *= 2
    return mb


def fake_world(world: int) -> None:
    """Join (or rejoin at another size) a ``fake`` process group of
    ``world`` ranks as rank 0: collectives return at once, moving nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_flatten

    seen, n = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor) and t.untyped_storage()._cdata not in seen:
            seen.add(t.untyped_storage()._cdata)
            n += t.untyped_storage().nbytes()
    return n


def _local_rows(batch: Dict, shape: ShapeConfig, mesh) -> Dict:
    """The rank's rows of a batch whose leaves lead with the global batch
    (the data axes row-major, as ``MeshLayout.local_batch`` takes them)."""
    dp = dp_axes(mesh)
    n, d = _size(mesh, dp), 0
    for a in dp:
        d = d * mesh.shape[a] + mesh.coord[a]
    rows = shape.global_batch // n
    return {k: v.narrow(0, d * rows, rows).clone() for k, v in batch.items()}


def _rows_sharded(shape: ShapeConfig, mesh) -> bool:
    dp = _size(mesh, dp_axes(mesh))
    return shape.global_batch > 1 and shape.global_batch % dp == 0


def _train_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, expert_axis):
    rules = make_rules(cfg, mesh, expert_axis=expert_axis, batch_sharded=True)
    n_total = count_params(cfg)
    tp = mesh.shape.get("model", 1)
    if rules.params.get("mlp") is None and rules.params.get("expert") is None \
            and rules.params.get("heads") is None:
        tp = 1  # pure DP: params replicated without FSDP
    # FSDP when replicated params and grads (~2 x the param bytes) exceed 6 GB a device
    wb = 2.0 if cfg.param_dtype == "bfloat16" else 4.0
    if n_total * 2 * wb / tp > 6e9 and not cfg.fsdp:
        cfg = cfg.replace(fsdp=True)
        rules = make_rules(cfg, mesh, expert_axis=expert_axis, batch_sharded=True)
    tc = TrainConfig(optimizer="adafactor" if n_total > 3e11 else "adamw",
                     microbatches=_auto_microbatches(cfg, shape, rules),
                     grad_compression=os.environ.get("REPRO_GRAD_COMPRESSION", "none"))
    opt = make_optimizer(tc, warmup_constant(tc.learning_rate, tc.warmup_steps))
    layout = MeshLayout(cfg, rules)
    params = abstract(cfg, train=True, place=placement(rules, mesh.coord, layout.keep))
    state = init_train_state(params, opt, tc.grad_compression, layout)
    batch = get_family(cfg).input_specs(cfg, shape)
    step = make_train_step(cfg, tc, opt, layout)
    held = {"param_bytes_per_device": _nbytes(state.params),
            "opt_state_bytes_per_device": _nbytes(state.opt_state)}
    info = {"fsdp": cfg.fsdp, "optimizer": tc.optimizer, "microbatches": tc.microbatches}
    return cfg, (lambda: step(state, batch)), (state, batch), held, info, \
        model_flops_train(active_param_count(cfg), shape.tokens)


def _serve_params(cfg: ModelConfig, rules, coord):
    """The serving tree's rank blocks, the router whole (as a mesh rank
    keeps it)."""
    return abstract(cfg, place=placement(rules, coord, keep=("router",)))


def _prefill_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, expert_axis):
    sharded = _rows_sharded(shape, mesh)
    rules = make_rules(cfg, mesh, expert_axis=expert_axis, batch_sharded=sharded)
    fam = get_family(cfg)
    params = _serve_params(cfg, rules, mesh.coord)
    batch = fam.input_specs(cfg, shape)
    if sharded:
        batch = _local_rows(batch, shape, mesh)
    if fam.prefill is not None:
        def run():
            with use_rules(rules), torch.inference_mode():
                return fam.prefill(params, batch, cfg, max_len=shape.seq_len)
    else:
        def run():
            with use_rules(rules), torch.inference_mode():
                return fam.forward(params, batch, cfg)
    held = {"param_bytes_per_device": _nbytes(params), "opt_state_bytes_per_device": 0}
    return cfg, run, (params, batch), held, {}, \
        model_flops_forward(active_param_count(cfg), shape.tokens)


def _decode_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, expert_axis):
    sharded = _rows_sharded(shape, mesh)
    rules = make_rules(cfg, mesh, expert_axis=expert_axis, batch_sharded=sharded)
    fam = get_family(cfg)
    params = _serve_params(cfg, rules, mesh.coord)
    rows = shape.global_batch // _size(mesh, dp_axes(mesh)) if sharded else shape.global_batch
    with use_rules(rules):            # the state holds the rank's rows and kv heads
        spec = fam.decode_input_specs(cfg, dataclasses.replace(shape, global_batch=rows))

    def run():
        with use_rules(rules), torch.inference_mode():
            return fam.decode(params, spec["tokens"], spec["state"], cfg)

    held = {"param_bytes_per_device": _nbytes(params), "opt_state_bytes_per_device": 0,
            "state_bytes_per_device": _nbytes(spec["state"])}
    return cfg, run, (params, spec), held, {}, \
        model_flops_forward(active_param_count(cfg), shape.global_batch)


def _bandwidths(axes) -> Dict[str, float]:
    """Each counted axis name's link rate (a joint axis at its slowest)."""
    out = {"group": axis_bandwidth(axes, axes[0][0])}
    names = [a for a, _ in axes]
    for i in range(len(names)):
        for j in range(i + 1, len(names) + 1):
            joint = names[i:j]
            out["+".join(joint)] = min(axis_bandwidth(axes, a) for a in joint)
    return out


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, axes, *, expert_axis=None,
               save_ops: Optional[str] = None) -> Dict:
    """Trace one cell as rank 0 of the mesh ``axes`` (((name, size), ...))
    and return its record (see the module doc)."""
    world = math.prod(n for _, n in axes)
    fake_world(world)
    mesh = make_mesh(axes, "meta", "fake")
    build = {"train": _train_cell, "prefill": _prefill_cell}.get(shape.kind, _decode_cell)
    t0 = time.perf_counter()
    cfg, run, inputs, held, info, mf = build(cfg, shape, mesh, expert_axis)
    collectives.reset_counters()
    trace = MetaTrace()
    with trace:
        trace.track(inputs)
        arguments = trace.live
        flops = counted_flops(run)
    trace_s = time.perf_counter() - t0
    coll = collectives.collective_bytes()
    by_axis = collectives.bytes_by_axis()
    coll["by_axis"] = by_axis
    coll["launches"] = {collectives.KINDS[fn.__name__]: fn.launches
                        for fn in collectives.COUNTED}
    coll["bytes"] = {collectives.KINDS[fn.__name__]: dict(fn.bytes)
                     for fn in collectives.COUNTED}
    coll["moe_attention"] = collectives.scoped(moe_attention.SCOPE)
    n_params = count_params(cfg)
    rl = Roofline(flops=flops_for(cfg, shape), bytes_accessed=bytes_for(cfg, shape, n_params),
                  collective_bytes=coll["total"] * world, chips=world, model_flops=mf,
                  collective_bw=effective_bandwidth(by_axis, _bandwidths(axes)))
    if save_ops:
        with open(save_ops, "w") as fh:
            json.dump(dict(trace.ops.most_common()), fh, indent=1)
    return {
        "status": "ok",
        "chips": world,
        "trace_s": round(trace_s, 1),
        "memory": {
            "argument_bytes_per_device": arguments,
            "temp_bytes_per_device": trace.peak - arguments,
            "peak_bytes_per_device": trace.peak,
            "fits_80gb": trace.peak < HBM_BYTES,
            **held,
        },
        "collectives": coll,
        "roofline": rl.to_dict(),
        # FlopCounterMode over rank 0's trace, every loop unrolled; the ranks run alike
        "counted": {"flops": flops, "flops_all_ranks": flops * world},
        "n_params": n_params,
        "n_active_params": active_param_count(cfg),
        "op_histogram": trace.op_histogram(),
        **info,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, moe_impl: Optional[str] = None,
             save_hlo: Optional[str] = None, remat: Optional[bool] = None,
             expert_axis: Optional[str] = None, group_size: Optional[int] = None) -> Dict:
    cfg = get_config(arch)
    if os.environ.get("REPRO_PARAM_DTYPE"):
        cfg = cfg.replace(param_dtype=os.environ["REPRO_PARAM_DTYPE"])
    if moe_impl and cfg.moe.num_experts:
        cfg = cfg.replace_moe(impl=moe_impl)
    if group_size and cfg.moe.num_experts:
        cfg = cfg.replace_moe(group_size=group_size)
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    shape = SHAPES[shape_name]
    extra = {}
    if cfg.pos_embed == "learned" and cfg.max_seq_len < shape.seq_len:
        # m6's learned positions end at 256: the table grows to the shape's length
        extra["max_seq_len_raised_from"] = cfg.max_seq_len
        cfg = cfg.replace(max_seq_len=shape.seq_len)
    axes = production_mesh_axes(multi_pod=multi_pod)
    res = trace_cell(cfg, shape, axes, expert_axis=expert_axis, save_ops=save_hlo)
    return {"arch": arch, "shape": shape_name, "mesh": "x".join(str(n) for _, n in axes),
            **res, **extra}


def cells(arch_filter: str, shape_filter: str, mesh_filter: str):
    archs = ARCH_IDS if arch_filter == "all" else [arch_filter]
    for arch in archs:
        for shape in shapes_for(get_config(arch)):
            if shape_filter != "all" and shape.name != shape_filter:
                continue
            if mesh_filter in ("single", "both"):
                yield arch, shape.name, False
            if mesh_filter in ("multi", "both"):
                yield arch, shape.name, True


def main(argv=None):
    from repro_torch.core.dispatch import available_dispatchers

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", choices=["all"] + ALL_IDS)
    ap.add_argument("--shape", default="all", choices=["all"] + list(SHAPES))
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--moe-impl", default=None, choices=[None, *available_dispatchers()])
    ap.add_argument("--expert-axis", default=None)
    ap.add_argument("--group-size", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default="experiments/torch/dryrun.json")
    ap.add_argument("--save-hlo", default=None,
                    help="write the trace's aten ops and their counts here (JSON)")
    ap.add_argument("--tag", default=None, help="suffix results key (perf experiments)")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for arch, shape_name, multi in cells(args.arch, args.shape, args.mesh):
        key = f"{arch}|{shape_name}|{'multi' if multi else 'single'}"
        if args.tag:
            key += f"|{args.tag}"
        print(f"=== {key} ===", flush=True)
        try:
            res = run_cell(arch, shape_name, multi, moe_impl=args.moe_impl,
                           save_hlo=args.save_hlo, expert_axis=args.expert_axis,
                           group_size=args.group_size,
                           remat=False if args.no_remat else None)
            rl = res["roofline"]
            print(f"  trace {res['trace_s']}s | mem/dev "
                  f"{res['memory']['peak_bytes_per_device'] / 1e9:.2f}GB | "
                  f"t_comp {rl['t_compute'] * 1e3:.2f}ms t_mem {rl['t_memory'] * 1e3:.2f}ms "
                  f"t_coll {rl['t_collective'] * 1e3:.2f}ms -> {rl['dominant']}", flush=True)
        except Exception as e:  # noqa: BLE001 — record the failure
            mesh = "x".join(str(n) for _, n in production_mesh_axes(multi_pod=multi))
            res = {"arch": arch, "shape": shape_name, "mesh": mesh,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"  FAILED: {res['error']}", flush=True)
        results[key] = res
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
