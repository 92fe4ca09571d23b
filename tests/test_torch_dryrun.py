"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, and the
collective byte counter it reads (``distributed.collectives``).

A dry run joins a process-wide ``fake`` process group, so every dry run
here runs in a subprocess of its own, one a cell.  Smoke m6 and qwen3-8b on the scaled-down
production meshes (``REPRO_MESH_SINGLE=2,4``, ``REPRO_MESH_MULTI=2,2,2``)
must trace their train, prefill and decode cells, and so must smoke
xLSTM, zamba and encdec, whose trees are tensor-parallel too; a rank's
parameter and optimizer-state bytes must equal an independent sum over
the placements; a MoE-attention cell on a model axis must trace, its
layers' collectives as its form predicts.  On a 2 x 2 gloo world the counter's bytes
of each kind must equal sizes computed by hand (the reference HLO
parser's conventions), and a real train step's collectives on that world
must equal the dry run's of the same cell, launch for launch and byte for
byte.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_dryrun_workers as DW
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_pipeline
from repro_torch.distributed.sharding import MeshShape, make_rules, param_shardings
from repro_torch.launch.mesh import spawn
from repro_torch.nn import flat_params, model_shapes
from repro_torch.optim.zero import zero1_spec
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# smoke configs: positions to 64 (m6 learned), batches that split over 4 data ranks
SHAPES = {"train": (64, 8), "prefill": (32, 8), "decode": (48, 8)}

CELLS = """
import json, sys
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.dryrun import trace_cell
from repro_torch.launch.mesh import production_mesh_axes
arch, multi, shapes = sys.argv[1], sys.argv[2] == "multi", json.loads(sys.argv[3])
cfg = get_smoke_config(arch).replace_moe(impl="alltoall") if arch == "m6-base" else \\
    get_smoke_config(arch)
out = {}
for kind, (seq, batch) in shapes.items():
    out[kind] = trace_cell(cfg, ShapeConfig(kind, seq, batch, kind),
                           production_mesh_axes(multi_pod=multi))
print(json.dumps(out))
"""


def _run(args, env_extra, code=CELLS):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", **env_extra)
    out = subprocess.run([sys.executable, "-c", code, *args], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


MESHES = {"single": ({"REPRO_MESH_SINGLE": "2,4"}, (("data", 2), ("model", 4))),
          "multi": ({"REPRO_MESH_MULTI": "2,2,2"}, (("pod", 2), ("data", 2), ("model", 2)))}


ARCHS = ["m6-base", "qwen3-8b", "xlstm-125m", "zamba2-7b", "seamless-m4t-large-v2"]


def _cfg(arch):
    cfg = get_smoke_config(arch)
    return cfg.replace_moe(impl="alltoall") if arch == "m6-base" else cfg


@pytest.fixture(scope="module")
def cells():
    """{(arch, mesh): {kind: record}}, each cell traced in a process of its own."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = [(arch, mesh, kind) for arch in ARCHS for mesh in MESHES for kind in SHAPES]
    with ThreadPoolExecutor(4) as pool:
        futs = {job: pool.submit(_run, [job[0], job[1], json.dumps({job[2]: SHAPES[job[2]]})],
                                 MESHES[job[1]][0]) for job in jobs}
        out = {}
        for (arch, mesh, kind), f in futs.items():
            out.setdefault((arch, mesh), {}).update(f.result())
        return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cells_trace_ok(cells, arch, mesh):
    res = cells[arch, mesh]
    world = math.prod(n for _, n in MESHES[mesh][1])
    for kind in SHAPES:
        r = res[kind]
        assert r["status"] == "ok" and r["chips"] == world, kind
        m = r["memory"]
        assert 0 < m["argument_bytes_per_device"] <= m["peak_bytes_per_device"], kind
        assert m["fits_80gb"] and r["counted"]["flops"] > 0, kind
        assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
        # tensor parallelism over "model": every step sums over it
        assert r["collectives"]["launches"]["all-reduce"] > 0, kind
        assert r["collectives"]["total"] > 0 and "model" in r["collectives"]["by_axis"], kind
    assert res["train"]["optimizer"] == "adamw" and res["train"]["microbatches"] == 1


def _placed_bytes(cfg, axes, train):
    """An independent sum: each leaf's local shape under its placement (and
    under ZeRO-1 for AdamW's two f32 moments)."""
    mesh = MeshShape(tuple(a for a, _ in axes), tuple(n for _, n in axes))
    rules = make_rules(cfg, mesh, batch_sharded=True)
    shapes = flat_params(model_shapes(cfg, train=train))
    specs = flat_params(param_shardings(model_shapes(cfg, train=train), rules, keep=("router",)))
    params = opt = 0
    for k, s in shapes.items():
        item = 2 if s.dtype == "bfloat16" else 4
        params += math.prod(specs[k].local_shape(s.shape)) * item
        z = zero1_spec(specs[k].spec, s.shape, mesh)
        local = list(s.shape)
        for d, e in enumerate(z):
            if e is not None:
                for a in (e if isinstance(e, tuple) else (e,)):
                    local[d] //= mesh.shape[a]
        opt += 2 * 4 * math.prod(local)
    return params, opt


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_bytes_equal_placements(cells, arch, mesh):
    cfg, axes = _cfg(arch), MESHES[mesh][1]
    params, opt = _placed_bytes(cfg, axes, train=True)
    train = cells[arch, mesh]["train"]["memory"]
    assert train["param_bytes_per_device"] == params
    assert train["opt_state_bytes_per_device"] == opt
    serve, _ = _placed_bytes(cfg, axes, train=False)
    for kind in ("prefill", "decode"):
        assert cells[arch, mesh][kind]["memory"]["param_bytes_per_device"] == serve


def test_xlstm_on_a_model_axis_is_a_recorded_error():
    """What the dry run recorded as an error before traces: the xLSTM tree
    on a model axis (``test_cells_trace_ok``), and MoE attention on (data
    2, model 4), its experts split over "model" (2 of 8 a rank) and its 9
    global groups (8 x 36 positions) straddling the data ranks.  Its layers' collectives are
    counted as the form predicts, a layer and microbatch: 7 all-reduces
    over "model" (2 forward, 2 in the remat recompute, 3 in the backward),
    6 all-gathers over "data" (the rows, the positions, the attention
    output's rows; forward and recompute) and 2 reduce-scatters (their
    backward)."""
    code = """
import json
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.dryrun import trace_cell
cfg = get_smoke_config("m6-base").replace_moe(moe_attention=True)
rec = trace_cell(cfg, ShapeConfig("train", 36, 8, "train"), (("data", 2), ("model", 4)))
print(json.dumps({k: rec[k] for k in ("status", "collectives", "microbatches")}))
"""
    rec = _run([], {}, code)
    assert rec["status"] == "ok", rec
    n = get_smoke_config("m6-base").num_layers * rec["microbatches"]
    assert rec["collectives"]["moe_attention"] == {
        "all-reduce": {"model": 7 * n}, "all-gather": {"data": 6 * n},
        "reduce-scatter": {"data": 2 * n}}
    assert rec["collectives"]["bytes"]["all-reduce"]["model"] > 0


def test_collective_bytes_by_hand(tmp_path):
    """all-gather: the gathered size; all-reduce: twice its operand; all-to-
    all: its operand; reduce-scatter: its input; each call once (the
    differentiated gather: an all-gather forward, a reduce-scatter
    backward).  Bytes by the mesh axis of the group."""
    r = spawn(DW.collective_body, 4, init_file=str(tmp_path / "init"), timeout=120)[0]
    assert r["launches"] == {"all_to_all": 1, "all_gather": 2, "all_reduce": 1,
                             "reduce_scatter": 2}
    assert r["bytes"]["all_gather"] == {"data": 2 * 3 * 5 * 4, "model": 2 * 2 * 3 * 4}
    assert r["bytes"]["all_reduce"] == {"model": 2 * 7 * 2}
    assert r["bytes"]["all_to_all"] == {"data+model": 8 * 6 * 4}
    assert r["bytes"]["reduce_scatter"] == {"data": 4 * 10 * 8, "model": 4 * 3 * 4}
    s = r["summary"]
    assert s["all-gather"] == 2 * 3 * 5 * 4 + 4 * 3 * 4      # result bytes
    assert s["all-reduce"] == 7 * 2
    assert s["reduce-scatter"] == 2 * 10 * 8 + 2 * 3 * 4
    assert s["all-to-all"] == 8 * 6 * 4
    assert s["total"] == sum(sum(v.values()) for v in r["bytes"].values())
    assert s["count"] == 6 and s["n_all-gather"] == 2
    assert r["by_axis"] == {"data": 120 + 320, "model": 48 + 28 + 48, "data+model": 192}


def test_dry_run_collectives_equal_a_real_step(tmp_path):
    """Smoke m6 (``alltoall``) trained one step at 8 x 64 on a (2, 2) gloo
    world: rank 0's collective launches and bytes by kind and axis, and
    its parameter and AdamW-state bytes, equal the dry run's of the same
    cell traced on ``meta`` as rank 0 of a ``fake`` (2, 2) world."""
    cfg = _cfg("m6-base")
    seq, batch = SHAPES["train"]
    data = make_pipeline(cfg, batch, seq, seed=0).batch_at(0)
    real = spawn(DW.train_step_body, 4, init_file=str(tmp_path / "init"), timeout=180,
                 args=(cfg, seq, data))[0]
    code = CELLS.replace("production_mesh_axes(multi_pod=multi)",
                         "(('data', 2), ('model', 2))")
    dry = _run(["m6-base", "single", json.dumps({"train": [seq, batch]})], {}, code)["train"]
    names = {"all_to_all": "all-to-all", "all_gather": "all-gather",
             "all_reduce": "all-reduce", "reduce_scatter": "reduce-scatter"}
    assert {names[k]: v for k, v in real["launches"].items()} == dry["collectives"]["launches"]
    for k, v in real["bytes"].items():
        if v:
            assert dry["collectives"][names[k]] > 0
    axes = {}
    for v in real["bytes"].values():
        for a, b in v.items():
            axes[a] = axes.get(a, 0) + b
    assert axes == dry["collectives"]["by_axis"]
    assert sum(axes.values()) == dry["collectives"]["total"]
    assert real["param_bytes"] == dry["memory"]["param_bytes_per_device"]
    assert real["opt_state_bytes"] == dry["memory"]["opt_state_bytes_per_device"]
