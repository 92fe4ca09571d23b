"""The port's continuous engine on gloo ranks against the JAX reference's
single-device engine, on the CPU, and the serve CLI on a mesh.

Mirrors ``tests/test_mesh_serving.py`` (``TestMeshParity``,
``TestMeshStructure``, ``test_mesh_parity_in_subprocess``): greedy tokens
of the mesh engine identical to the reference's single-device engine and
to the port's, for a dense model at 2 x 4 and 8 x 1, dropless top-2 under
top-k and hash routing at 2 x 4 and 1 x 8, 12 requests over 8 slots and
prefix caching at 2 x 4, every rank with ``check_invariants=True``
(conservation after every step, the ranks' sampled tokens all-gathered and
compared).  Structure: no rank's pool holds more than ``shard_blocks + 1``
rows or more than ``E / ne`` experts, and the expert-parallel all_to_all ran
at every decode and mixed step on 2 x 4 (at the decode steps only on 1 x 8,
whose 12-row mixed step does not split over 8 ranks and gathers the
experts instead).  Each mesh shape is spawned once (a module fixture).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_workers as W
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.models.registry import get_family
from repro.nn import init as jinit
from repro.serving.continuous import ContinuousEngine as JEngine
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.launch.mesh import spawn
from repro_torch.nn import from_jax_params
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from torch_threads import one_torch_thread  # noqa: F401

SPAWN_TIMEOUT = 300
MESHES = {"2x4": (("data", 2), ("expert", 4)),
          "8x1": (("data", 8), ("expert", 1)),
          "1x8": (("data", 1), ("expert", 8))}
# what each mesh serves (the reference's TestMeshParity cells)
RUNS = {"2x4": ["dense", "topk", "hash", "reuse", "prefix"],
        "8x1": ["dense"],
        "1x8": ["topk", "hash"]}


def _cfgs(routing=None):
    base = dict(name="t", family="decoder_lm", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=128, max_seq_len=128, dtype="float32")
    if routing is None:
        return JModelConfig(**base), TModelConfig(**base)
    base["d_ff"] = 96
    moe = dict(num_experts=8, routing=routing, top_k=2, group_size=1, impl="dropless",
               capacity_factor=None)
    return JModelConfig(**base, moe=JMoEConfig(**moe)), TModelConfig(**base, moe=TMoEConfig(**moe))


def _serve_kw(**kw):
    base = dict(max_slots=8, kv_block_size=4, prefill_chunk=4, max_len=32)
    base.update(kw)
    return base


def _prompts(B=6, S=9, seed=1):
    return np.random.default_rng(seed).integers(0, 128, (B, S)).astype(np.int32)


def _prefix_prompts():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 128, 12)
    return np.concatenate([np.tile(base[None], (6, 1)), rng.integers(0, 128, (6, 4))],
                          axis=1).astype(np.int32)


def _case(name):
    """(jcfg, tcfg, prompts, num_tokens, serve kwargs) of a run."""
    routing = {"topk": "topk", "hash": "hash"}.get(name)
    jcfg, tcfg = _cfgs(routing)
    if name == "reuse":
        return jcfg, tcfg, _prompts(B=12, seed=2), 6, {}
    if name == "prefix":
        return jcfg, tcfg, _prefix_prompts(), 8, dict(prefix_cache=True)
    return jcfg, tcfg, _prompts(), 10, {}


@pytest.fixture(scope="module")
def references():
    """Each run's tokens from the reference's single-device engine, checked
    equal to the port's single-device engine, and the port's params."""
    out = {}
    for name in ("dense", "topk", "hash", "reuse", "prefix"):
        jcfg, tcfg, prompts, n, kw = _case(name)
        jp = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
        tp = from_jax_params(jax.device_get(jp), tcfg, device="cpu")
        want, _ = JEngine(jcfg, jp, JServeConfig(**_serve_kw(**kw)),
                          check_invariants=True).generate(jnp.asarray(prompts), n)
        single, _ = TEngine(tcfg, tp, TServeConfig(**_serve_kw(**kw)), device="cpu",
                            check_invariants=True).generate(prompts, n)
        np.testing.assert_array_equal(single, np.asarray(want))
        out[name] = (np.asarray(want), tcfg, tp, prompts, n, kw)
    return out


@pytest.fixture(scope="module")
def mesh_runs(references, tmp_path_factory):
    out = {}
    for key, spec in MESHES.items():
        runs = []
        for name in RUNS[key]:
            _, tcfg, tp, prompts, n, kw = references[name]
            runs.append((name, tcfg, tp, _serve_kw(**kw), prompts, n))
        init = str(tmp_path_factory.mktemp("mesh") / "init")
        out[key] = spawn(W.engine_body, spec[0][1] * spec[1][1], init_file=init,
                         args=(spec, runs), timeout=SPAWN_TIMEOUT)
    return out


@pytest.mark.parametrize("key,name", [(k, n) for k in MESHES for n in RUNS[k]])
def test_mesh_tokens_match_reference(references, mesh_runs, key, name):
    want = references[name][0]
    for toks, *_ in (r[name] for r in mesh_runs[key]):
        np.testing.assert_array_equal(toks, want)


@pytest.mark.parametrize("key", list(MESHES))
def test_mesh_rank_holds_its_shard(mesh_runs, key):
    """Every rank's pools are one data shard's ``shard_blocks + 1`` rows,
    and an MoE run's ranks hold ``E / ne`` experts a layer."""
    spec = MESHES[key]
    D, ne = spec[0][1], spec[1][1]
    for r in mesh_runs[key]:
        for name, (_, _, rows, shard_blocks, experts) in r.items():
            assert shard_blocks == TServeConfig(**_serve_kw()).resolved_num_blocks // D
            assert rows == shard_blocks + 1
            if name in ("topk", "hash"):
                assert experts == 8 // ne


@pytest.mark.parametrize("key", ["2x4", "1x8"])
def test_ep_engaged_at_decode_and_mixed_steps(mesh_runs, key):
    """2 x 4: the decode step's 8 rows and the mixed step's 16 split over
    the 8 ranks, so every step of an MoE run exchanges rows (3 all_to_alls
    a layer); 1 x 8: only the decode steps do (the mixed step's 12 rows
    gather the experts instead, as the reference's GSPMD computes the
    unsharded dispatch there)."""
    for r in mesh_runs[key]:
        for name in ("topk", "hash"):
            steps = r[name][1]
            kinds = {k for k, _ in steps}
            assert kinds == {"decode", "mixed"}
            for kind, n in steps:
                if key == "2x4" or kind == "decode":
                    assert n == 3 * 2, (name, kind, n)      # 3 exchanges x 2 layers
                else:
                    assert n == 0, (name, kind, n)


def test_dense_runs_no_all_to_all(mesh_runs):
    for key in ("2x4", "8x1"):
        for r in mesh_runs[key]:
            assert all(n == 0 for _, n in r["dense"][1])


# ---------------------------------------------------------------------------
# The serve CLI on a (data 2, expert 2) mesh
# ---------------------------------------------------------------------------

CLI = ["--arch", "m6-base", "--smoke", "--engine", "continuous", "--moe-impl", "dropless",
       "--capacity-factor", "none", "--batch", "4", "--prompt-len", "9", "--gen", "6",
       "--max-slots", "4", "--max-len", "32", "--prefill-chunk", "4", "--device", "cpu"]


def test_serve_cli_on_mesh_gives_single_device_tokens(tmp_path, capsys):
    """``--mesh data=2,expert=2 --mesh-backend gloo`` on 4 spawned ranks:
    every rank's tokens equal the CLI's without ``--mesh``; rank 0's Chrome
    trace (with per-shard ``engine_step_shard`` spans) and metrics validate,
    the metrics with ``--require kv_blocks`` (per-shard series)."""
    from repro_torch.launch import serve
    from repro_torch.obs.validate import validate_chrome_trace, validate_metrics_jsonl

    got = {}
    real_run = serve.ContinuousEngine.run

    def run(self, requests, on_finish=None):
        out, stats = real_run(self, requests, on_finish=on_finish)
        got.update(out)
        return out, stats

    from unittest import mock

    with mock.patch.object(serve.ContinuousEngine, "run", run):
        serve.main(CLI)
    trace, metrics = str(tmp_path / "trace.json"), str(tmp_path / "metrics.jsonl")
    argv = CLI + ["--mesh", "data=2,expert=2", "--mesh-backend", "gloo", "--trace-out", trace,
                  "--metrics-out", metrics, "--metrics-every", "1"]
    ranks = spawn(W.cli_body, 4, init_file=str(tmp_path / "init"), args=(argv,),
                  timeout=SPAWN_TIMEOUT)
    for out, stats in ranks:
        assert out == got
        assert stats["moe_dropped_fraction"] == 0.0
    assert validate_chrome_trace(trace)["events"] > 0
    assert validate_metrics_jsonl(metrics, require=("kv_blocks", "kv_pool_bytes"))["rows"] > 0
    text = open(trace).read()
    assert '"engine_step_shard"' in text and '"shard": 1' in text
    assert "shard=1" in open(metrics).read()


def test_chip_smoke_mesh_phase_runs_on_cpu(tmp_path, capsys):
    """chip_smoke's phase 16 rehearsed at smoke size on the CPU (the launch
    gates need the card): (a) the (1, 1) mesh replaying a run's step clocks
    over bf16 and int8 pools, tokens identical to that run's; (b) four
    spawned gloo ranks of the group_size-1 config, every rank's tokens
    equal and equal to a single-device run's (no near-tie flip on the
    CPU), 3 all_to_alls in every MoE layer of every step, each rank with
    half the experts and a pool of shard_blocks + 1 rows, and the
    unreplayed run served on every rank."""
    import importlib.util
    import sys

    import torch

    from repro_torch.configs import m6 as tm6
    from repro_torch.configs.base import ServeConfig
    from repro_torch.nn import init_params
    from repro_torch.serving.trace import synthetic_trace

    root = os.path.join(os.path.dirname(__file__), "..")
    if root not in sys.path:
        sys.path.insert(0, root)        # the spawned ranks import chip_smoke by name
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    cfg = tm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    requests = synthetic_trace(6, cfg.vocab_size, seed=0)
    for r in requests:
        r.prompt, r.max_new_tokens = r.prompt[:20], min(r.max_new_tokens, 8)
    params = init_params(cfg, seed=0, device="cpu")
    outs = {}
    for key, kv_quant in (("bf16", "none"), ("int8", "int8")):
        eng = TEngine(cfg, params, TServeConfig(max_len=64, kv_quant=kv_quant), device="cpu")
        cs.STEP_CLOCKS[key] = []
        with cs.recorded_clocks(cs.STEP_CLOCKS[key]):
            outs[key], _ = eng.run(requests)
    report, _ = cs.mesh_trivial_runs(torch, cfg, params, requests, outs["bf16"], outs["int8"],
                                     device="cpu", max_len=64)
    assert report["bf16"]["tokens_identical"] and report["int8"]["tokens_identical"]
    report, _ = cs.mesh_rank_runs(torch, cfg.replace_moe(group_size=1), requests, outs["bf16"],
                                  device="cpu", spawn_dir=str(tmp_path), max_len=64)
    assert report["flips"] == [] and report["tokens_equal_phase5"]
    assert [r["experts"] for r in report["ranks"]] == [4] * 4
    assert all(r["a2a_launches"] == 3 * cfg.num_layers * r["steps"] for r in report["ranks"])
    assert len(report["run"]) == 4 and all(r["run_steps"] > 0 for r in report["run"])
    assert "(b) single device" in capsys.readouterr().out
