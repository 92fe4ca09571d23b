"""The PyTorch port's serving path against the JAX reference, on the CPU.

Inputs come from numpy seeds and go to both packages; the reference's
params cross over through ``repro_torch.nn.from_jax_params``.  Tolerances
are f32 (2e-5) unless stated.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import m6 as jm6
from repro.configs.base import ServeConfig as JServeConfig
from repro.models.registry import get_family
from repro.nn import init as jinit
from repro.serving.continuous import ContinuousEngine as JEngine
from repro.serving.kv_cache import BlockAllocator as JBlockAllocator
from repro.serving.kv_cache import PagedKVCache as JPagedKVCache
from repro_torch.configs import m6 as tm6
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.configs.base import SLOConfig
from repro_torch.nn import from_jax_params, lm_shapes
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from repro_torch.serving.kv_cache import BlockAllocator as TBlockAllocator
from repro_torch.serving.kv_cache import PagedKVCache as TPagedKVCache

REPO = os.path.join(os.path.dirname(__file__), "..")


def _cfgs():
    jcfg = jm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    tcfg = tm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jp = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(seed))
    return jp, from_jax_params(jax.device_get(jp), tcfg, device="cpu")


def test_param_tree_matches_reference_specs():
    jcfg, tcfg = _cfgs()
    jp = jax.eval_shape(lambda: jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0)))
    jflat = {jax.tree_util.keystr(p): tuple(l.shape)
             for p, l in jax.tree_util.tree_flatten_with_path(jp)[0]}

    def flat(tree, path=""):
        out = {}
        for k, v in tree.items():
            key = f"{path}['{k}']"
            out.update(flat(v, key) if isinstance(v, dict) else {key: tuple(v.shape)})
        return out

    assert flat(lm_shapes(tcfg)) == jflat


def _serve_pair(**kw):
    return JServeConfig(**kw), TServeConfig(**kw)


@pytest.mark.parametrize("S,gen,serve_kw", [
    # 5 prompts on 3 slots (slot reuse); prompts span 3 chunks and 2 blocks
    (13, 7, dict(max_slots=3, kv_block_size=8, prefill_chunk=5, max_len=32)),
    # one chunk per prompt, decode crossing a block boundary
    (6, 12, dict(max_slots=2, kv_block_size=4, prefill_chunk=8, max_len=24)),
])
def test_m6_smoke_engine_greedy_parity(S, gen, serve_kw):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (5, S)).astype(np.int32)
    jserve, tserve = _serve_pair(**serve_kw)

    jlogits = []
    jeng = JEngine(jcfg, jp, jserve,
                   logit_tap=lambda lg, *rest: jlogits.append(np.asarray(lg)))
    jtoks, jstats = jeng.generate(prompts, gen)

    teng = TEngine(tcfg, tp, tserve, device="cpu", check_invariants=True)
    tlogits = []
    fwd = teng.forward_rows

    def tap(buffers):
        lg, telem = fwd(buffers)
        tlogits.append(lg.numpy())
        return lg, telem

    teng.forward_rows = tap
    ttoks, tstats = teng.generate(prompts, gen)

    jax.effects_barrier()
    np.testing.assert_array_equal(np.asarray(jtoks), ttoks)
    assert jeng.steps == teng.steps
    # first step's logits (only live rows carry meaning; masked rows too
    # must agree: both see token 0 at position 0 with length 0)
    np.testing.assert_allclose(tlogits[0], jlogits[0], atol=1e-4, rtol=0)
    assert jstats["moe_dropped_fraction"] == 0.0
    assert tstats["moe_dropped_fraction"] == 0.0
    for k in ("moe_gate_entropy", "moe_load_entropy", "moe_load_cv"):
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-5, atol=1e-6)


def test_allocator_and_cache_state_match_reference():
    jcfg, tcfg = _cfgs()
    jserve, tserve = _serve_pair(max_slots=3, kv_block_size=4, max_len=20)
    ja, ta = JBlockAllocator(10), TBlockAllocator(10)
    for op, arg in [("alloc", 3), ("alloc", 2), ("free", [4, 1]), ("alloc", 4),
                    ("free", [0])]:
        if op == "alloc":
            assert ja.alloc(arg) == ta.alloc(arg)
        else:
            ja.free(arg)
            ta.free(arg)
        assert ja._free == ta._free and ja._allocated == ta._allocated
    with pytest.raises(RuntimeError, match="double-free"):
        ta.free([0])
    jc, tc = JPagedKVCache(jcfg, jserve), TPagedKVCache(tcfg, tserve, device="cpu")
    ops = [("allocate_slot", (0, 13)), ("ensure_capacity", (0, 5)),
           ("allocate_slot", (2, 20)), ("ensure_capacity", (2, 9)),
           ("ensure_capacity", (0, 13)), ("free_slot", (0,)),
           ("allocate_slot", (1, 7)), ("ensure_capacity", (1, 7))]
    for name, args in ops:
        assert getattr(jc, name)(*args) == getattr(tc, name)(*args)
        np.testing.assert_array_equal(jc.block_table, tc.block_table)
        assert jc._slot_blocks == tc._slot_blocks
        assert jc._slot_reserved == tc._slot_reserved
        assert jc.reserved_total == tc.reserved_total
        assert jc.allocator._free == tc.allocator._free
        assert jc.write_coords(2, 6) == tc.write_coords(2, 6)
        assert jc.occupancy() == tc.occupancy()
    tc.check_conservation()
    assert tuple(tc.k_pool.shape) == tuple(jc.k_pool.shape)


def test_learned_positions_past_table_raise():
    _, tcfg = _cfgs()
    tp = {"embed": {"table": torch.zeros(1)}}
    with pytest.raises(ValueError, match="learned position"):
        TEngine(tcfg, tp, TServeConfig(max_len=tcfg.max_seq_len + 1), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(serve=TServeConfig(max_len=32, mesh=(("data", 1), ("expert", 1)))),
    dict(serve=TServeConfig(max_len=32, slo=SLOConfig())),
])
def test_unported_options_raise(kw):
    _, tcfg = _cfgs()
    tp = {"embed": {"table": torch.zeros(1)}}
    serve = kw.pop("serve", TServeConfig(max_len=32))
    with pytest.raises(NotImplementedError):
        TEngine(tcfg, tp, serve, device="cpu", **kw)


def test_cli_serves_on_cpu(capsys):
    from repro_torch.launch.serve import main

    stats = main(["--arch", "m6-base", "--smoke", "--engine", "continuous",
                  "--moe-impl", "dropless", "--capacity-factor", "none",
                  "--batch", "3", "--prompt-len", "9", "--gen", "5",
                  "--max-slots", "2", "--max-len", "32", "--device", "cpu"])
    assert stats["generated_tokens"] == 15.0
    assert stats["moe_dropped_fraction"] == 0.0
    with pytest.raises(NotImplementedError, match="--engine static"):
        main(["--arch", "m6-base", "--smoke", "--device", "cpu"])


def test_port_imports_without_jax():
    """Every repro_torch module and chip_smoke.py import with jax and
    ml_dtypes blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not any(k == 'repro' or k.startswith('repro.') for k in sys.modules), "
        "[k for k in sys.modules if k.startswith('repro.')]\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 25


def test_chip_smoke_mixed_step_comparison_runs_on_cpu(capsys):
    """chip_smoke's kernels-vs-plain mixed-step comparison, rehearsed at
    smoke size on the CPU (where both sides run the plain versions)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    _, tp = _params(jcfg, tcfg)
    from repro_torch.serving.trace import synthetic_trace

    reqs = synthetic_trace(3, tcfg.vocab_size, seed=0)
    chip_smoke.compare_mixed_step(torch, tcfg, tp, TServeConfig(max_len=64), reqs,
                                  device="cpu")
    out = capsys.readouterr().out
    assert "greedy argmax agrees on 33/33" in out and "routing near-tie: layer" not in out


def test_traces_and_latency_stats_match_reference(tmp_path):
    from repro.serving import trace as jtrace
    from repro_torch.serving import trace as ttrace

    jr = jtrace.synthetic_trace(12, 21128, seed=3)
    tr = ttrace.synthetic_trace(12, 21128, seed=3)
    for a, b in zip(jr, tr):
        assert (a.uid, a.max_new_tokens, a.arrival_ms) == (b.uid, b.max_new_tokens, b.arrival_ms)
        np.testing.assert_array_equal(a.prompt, b.prompt)
    assert jtrace.static_max_len(jr) == ttrace.static_max_len(tr)
    path = str(tmp_path / "t.jsonl")
    jtrace.save_trace(path, jr)
    loaded = ttrace.load_trace(path, 21128, seed=3)
    assert [r.prompt.tolist() for r in loaded] == [r.prompt.tolist() for r in jr]
    lats, total, n = [5.0, 1.0, 9.0, 3.0], 1234.5, 77
    assert jtrace.latency_stats(lats, total, n) == ttrace.latency_stats(lats, total, n)
    stats = ttrace.latency_stats(lats, total, n)
    assert jtrace.latency_line(stats) == ttrace.latency_line(stats)


@pytest.mark.parametrize("arch", ["m6-base", "m6-10b", "m6-100b", "m6-1t"])
def test_configs_match_reference(arch):
    import dataclasses

    from repro.configs import registry as jreg
    from repro_torch.configs import registry as treg
    from repro_torch.nn import count_params

    for get in ("get_config", "get_smoke_config"):
        jcfg, tcfg = getattr(jreg, get)(arch), getattr(treg, get)(arch)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    from repro.nn import count_params as jcount

    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    assert count_params(tcfg) == jcount(get_family(jcfg).specs(jcfg))
