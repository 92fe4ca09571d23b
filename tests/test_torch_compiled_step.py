"""The continuous engine's compiled step (its static step forms) against
the JAX reference's jitted step, on the CPU.

On the card each form is a captured CUDA graph; here a form runs its body
eagerly over the same persistent buffers, built at its kind's first step
as the reference's jit compiles a shape at its first call.  So the census
(``engine_compiled_variants``, ``engine_recompiles_total``, the
``recompile`` instant) must equal the reference's on the same trace; the
body of every form must read no host value (run on ``meta`` under a
dispatch mode that refuses a host read or a host tensor); no persistent
buffer, pool or scale may move during a run that exercises the prefix
cache, int8 pools, SLO preemption and speculation; and the run's MoE
telemetry, accumulated from the forms' persistent outputs, must equal the
reference's (rtol 1e-5, f32).
"""
import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import m6 as jm6
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import SpecConfig as JSpecConfig
from repro.models.registry import get_family
from repro.nn import init as jinit
from repro.obs import Observability as JObservability
from repro.serving.continuous import ContinuousEngine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch.configs import m6 as tm6
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.configs.base import SLOConfig as TSLOConfig
from repro_torch.configs.base import SpecConfig as TSpecConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import counters
from repro_torch.nn import abstract, from_jax_params, init_params
from repro_torch.nn.spec import padded_vocab
from repro_torch.obs import Observability as TObservability
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from repro_torch.serving.continuous import _sample_rows
from repro_torch.serving.request import Priority as TPriority
from repro_torch.serving.request import Request as TRequest
from torch_threads import one_torch_thread  # noqa: F401

SERVE = dict(max_slots=2, kv_block_size=4, prefill_chunk=8, max_len=40)
MOE_STATS = ("moe_dropped_fraction", "moe_gate_entropy", "moe_load_entropy", "moe_load_cv")


@pytest.fixture(scope="module")
def models():
    """(jcfg, tcfg, jparams, tparams): m6's smoke widths, 2 layers, dropless."""
    jcfg = jm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    tcfg = tm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    jp = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, from_jax_params(jax.device_get(jp), tcfg, device="cpu")


def _requests(cls, vocab, gens=(9, 7, 10, 8), seed=1):
    """Four seeded prompts on 2 slots, all at t=0: prefill, mixed and
    decode-only steps, and under the ngram drafter verify steps beside
    decode steps where no slot has a draft."""
    rng = np.random.default_rng(seed)
    return [cls(uid=uid, prompt=rng.integers(0, vocab, 9 + uid % 3).astype(np.int32),
                max_new_tokens=gen) for uid, gen in enumerate(gens)]


def _census(eng):
    m = eng.obs.metrics
    return m.get("engine_compiled_variants"), m.get("engine_recompiles_total")


def _recompile_instants(eng):
    return [e["args"] for e in eng.obs.tracer.events() if e["ph"] == "i"
            and e["name"] == "recompile"]


def _pair(models, spec=None, tracing=False, **serve):
    jcfg, tcfg, jp, tp = models
    kw = {**SERVE, **serve}
    jeng = JEngine(jcfg, jp, JServeConfig(**kw, spec=spec and JSpecConfig(**spec)),
                   obs=JObservability(tracing=tracing))
    teng = TEngine(tcfg, tp, TServeConfig(**kw, spec=spec and TSpecConfig(**spec)),
                   device="cpu", obs=TObservability(tracing=tracing))
    return jeng, teng


@pytest.mark.parametrize("spec", [None, dict(drafter="ngram", gamma=3)], ids=["plain", "ngram"])
def test_census_matches_reference(models, spec):
    """On one trace the port's forms are the reference's jit-cache entries:
    2 ({decode, mixed}), 3 with a verify step, and no recompile; the MoE
    telemetry of the run, summed over the forms' persistent outputs,
    equals the reference's."""
    jcfg = models[0]
    jeng, teng = _pair(models, spec)
    jout, jstats = jeng.run(_requests(JRequest, jcfg.vocab_size))
    tout, tstats = teng.run(_requests(TRequest, jcfg.vocab_size))
    assert tout == jout
    want = 3 if spec else 2
    assert teng._expected_variants == jeng._expected_variants == want
    assert teng.compiled_variants() == jeng.compiled_variants() == want
    assert _census(teng) == _census(jeng) == (want, 0)
    assert sorted(teng._forms) == sorted(["decode", "mixed"] + ["verify"] * bool(spec))
    S, chunk = SERVE["max_slots"], SERVE["prefill_chunk"]
    assert {k: f.N for k, f in teng._forms.items()} == {
        "decode": S, "mixed": S + chunk, **({"verify": S * 4} if spec else {})}
    if spec:
        assert teng.spec_stats == jeng.spec_stats and teng.spec_stats["verify_steps"] > 0
    for k in MOE_STATS:
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-5, atol=1e-6)
    jm, tm = jeng.obs.metrics, teng.obs.metrics
    for layer in range(jcfg.num_layers):
        for e in range(jcfg.moe.num_experts):
            np.testing.assert_allclose(
                tm.get("moe_expert_load_share", layer=layer, expert=e),
                jm.get("moe_expert_load_share", layer=layer, expert=e), rtol=1e-5, atol=1e-7)


def test_recompile_detector_fires_like_reference(models):
    """With the census cut to 1, both packages count the second form as a
    recompile and emit one ``recompile`` instant with the same arguments."""
    jeng, teng = _pair(models, tracing=True)
    jeng._expected_variants = teng._expected_variants = 1
    jeng.run(_requests(JRequest, models[0].vocab_size))
    teng.run(_requests(TRequest, models[0].vocab_size))
    assert _census(teng) == _census(jeng) == (2, 1)
    assert _recompile_instants(teng) == _recompile_instants(jeng) == [
        {"variants": 2, "expected": 1}]


def test_recurrent_census_is_one():
    """The recurrent step (xLSTM) stays eager: one (max_slots, 1) shape, as
    the reference's one jit-cache entry."""
    cfg = get_smoke_config("xlstm-125m")
    eng = TEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                  TServeConfig(max_slots=2, max_len=16), device="cpu")
    assert eng.compiled_variants() == 0
    eng.generate(np.arange(8, dtype=np.int32).reshape(2, 4) % cfg.vocab_size, 3)
    assert eng._expected_variants == 1 and _census(eng) == (1, 0)


class _NoHostReads(TorchDispatchMode):
    """Refuses every op that reads a tensor's value on the host or takes a
    host tensor while the step runs on ``meta``."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.item.default):
            raise AssertionError(f"{func}: a host read in the step body")
        for a in torch.utils._pytree.tree_leaves((args, kwargs)):
            if isinstance(a, torch.Tensor) and a.device.type != "meta":
                raise AssertionError(f"{func}: a {a.device} tensor {tuple(a.shape)} in the "
                                     f"step body")
        return func(*args, **kwargs)


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv", ["none", "int8"])
def test_body_reads_no_host_value(kv, temperature):
    """Every form's body (decode, mixed, verify) over bf16 and int8 pools,
    run on ``meta``: only its device rows, the params and the pools, no
    host read, no host tensor."""
    # head_dim 32: a width the paged kernels take (their checks run on meta)
    cfg = tm6.smoke().replace(dtype="bfloat16", head_dim=32).replace_moe(
        impl="dropless", capacity_factor=None)
    eng = TEngine(cfg, abstract(cfg), TServeConfig(**SERVE, kv_quant=kv,
                                                   spec=TSpecConfig(drafter="ngram", gamma=3)),
                  device="meta", temperature=temperature)
    assert eng._graph_pool is None and not eng._forms        # built at first use off the card
    for kind in ("decode", "mixed", "verify"):
        form = eng._form(kind)
        with _NoHostReads():
            out = eng._body(form)
        key = "scores" if kind == "verify" else "tokens"
        rows = form.N if key == "tokens" or temperature == 0.0 else (form.N, padded_vocab(cfg.vocab_size))
        assert out[key].device.type == "meta"
        assert out[key].shape == ((rows,) if isinstance(rows, int) else rows)
        assert out["telem"]["expert_tokens"].shape == (cfg.num_layers, cfg.moe.num_experts)


def _addresses(eng):
    """Every persistent buffer's address: each form's staging, device rows
    and outputs, and the pools and scales."""
    out = {"pools": tuple(t.data_ptr() for t in eng._pools())}
    for kind, f in eng._forms.items():
        outs = torch.utils._pytree.tree_leaves(f.out) if f.out is not None else []
        out[kind] = (f.host.data_ptr(), f.dev.data_ptr(), tuple(t.data_ptr() for t in outs))
    return out


def _preempting_requests(vocab, seed=7):
    """Two LOW requests on both slots, sharing a periodic prompt head (the
    prefix cache binds it, the ngram drafter drafts on it), then a HIGH
    arrival that preempts one of them."""
    rng = np.random.default_rng(seed)
    head = np.tile(rng.integers(0, vocab, 3), 3)
    reqs = [TRequest(uid=i, prompt=np.concatenate([head, rng.integers(0, vocab, 2)])
                     .astype(np.int32), max_new_tokens=14, priority=TPriority.LOW)
            for i in range(2)]
    reqs.append(TRequest(uid=2, prompt=np.concatenate([head, [5]]).astype(np.int32),
                         max_new_tokens=4, arrival_ms=60.0, priority=TPriority.HIGH))
    return reqs


@pytest.mark.parametrize("spec", [None, dict(drafter="ngram", gamma=3)], ids=["plain", "ngram"])
def test_fixed_addresses_across_a_run(models, spec):
    """With the prefix cache, int8 pools, SLO preemption (a swap out and
    back) and, with a drafter, speculation (rollbacks), no form's buffers,
    outputs, pool or scale move from step to step; a rebound pool makes
    the next step raise."""
    _, tcfg, _, tp = models
    serve = TServeConfig(max_slots=2, kv_block_size=4, prefill_chunk=8, max_len=32,
                         num_blocks=16, kv_quant="int8", prefix_cache=True,
                         sched_policy="priority_strict", slo=TSLOConfig(),
                         spec=spec and TSpecConfig(**spec))
    eng = TEngine(tcfg, tp, serve, device="cpu", check_invariants=True)
    for r in _preempting_requests(tcfg.vocab_size):
        eng.scheduler.add(r)
    seen, clock = {}, 0.0
    while eng.scheduler.has_work():
        eng.step(clock)
        clock += 10.0
        now = _addresses(eng)
        assert {k: v for k, v in now.items() if k in seen} == seen
        seen = now
    # this trace drafts at every decode step: no decode form beside verify
    assert sorted(seen) == (["mixed", "pools", "verify"] if spec
                            else ["decode", "mixed", "pools"])
    assert eng.scheduler.preemptions > 0 and eng.scheduler.swap.stats["swapped_blocks"] > 0
    assert eng.cache.stats["hit_tokens"] > 0
    assert (eng.spec_stats["verify_steps"] > 0) == bool(spec)
    assert _census(eng) == (2, 0)

    eng.cache.k_scales = eng.cache.k_scales.clone()
    eng.scheduler.add(TRequest(uid=9, prompt=np.arange(5, dtype=np.int32), max_new_tokens=2))
    with pytest.raises(RuntimeError, match="pools were rebound"):
        eng.step(clock)


def test_sampling_reads_rows_where_they_lie():
    """Slots and positions from the device row buffer (tensors) draw the
    same tokens as the same host arrays, greedy and at T > 0."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((6, 50)).astype(np.float32))
    slots, pos = np.array([0, 1, 0, 2, 1, 0]), np.array([3, 3, 4, 9, 4, 5])
    for T in (0.0, 0.7):
        want = _sample_rows(logits, slots, pos, T, seed=5)
        got = _sample_rows(logits, torch.from_numpy(slots).int(), torch.from_numpy(pos).int(),
                           T, seed=5, temperature_t=torch.tensor(T))
        assert torch.equal(got, want)


def test_launch_counters_read_write_and_add():
    """The registry reads every wrapper's counters, puts them back and adds
    a capture's launches, as a replay does."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.moe_dropless import ops as rffn

    names = {(fn.__name__, attr) for fn, attr in counters.COUNTED}
    assert {("paged_decode_attention", "launches"), ("ragged_ffn", "tc_launches"),
            ("ragged_combine", "launches")} <= names
    before = counters.read()
    try:
        da.paged_decode_attention.launches += 3
        rffn.ragged_ffn.tc_launches += 2
        step = counters.since(before)
        assert sum(step) == 5
        counters.write(before)
        assert counters.read() == before
        counters.add(step)
        counters.add(step)
        assert da.paged_decode_attention.launches - before[counters.COUNTED.index(
            (da.paged_decode_attention, "launches"))] == 6
    finally:
        counters.write(before)


def test_launch_counters_cover_a_wrapper_registered_after_the_reading():
    """A wrapper whose module is first imported between a capture's reading
    and its end (say, in the warm-up) counts from 0 at the reading: putting
    the reading back zeroes it, and each replay adds its capture launches."""
    def late():
        pass

    before = counters.read()
    try:
        counters.counted(late, "launches")
        late.launches += 2                      # the warm-up
        counters.write(before)
        assert late.launches == 0
        late.launches += 3                      # the capture
        step = counters.since(before)
        assert step[-1] == 3 and len(step) == len(before) + 1
        counters.write(before)
        assert late.launches == 0
        counters.add(step)                      # two replays
        counters.add(step)
        assert late.launches == 6
        counters.add(before[:0])                # a reading older than the wrapper adds 0
        assert late.launches == 6
    finally:
        counters.COUNTED.remove((late, "launches"))
        counters.write(before)


def test_chip_smoke_graphed_vs_eager_runs_on_cpu(models, capsys):
    """chip_smoke's phase 5 lockstep of the graphed and eager engines,
    rehearsed on the CPU (both forms eager here): a run's step clocks
    replayed by both engines give its tokens, identical, logit difference
    0; the census gate holds."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    _, tcfg, _, tp = models
    serve = TServeConfig(**SERVE)
    reqs = _requests(TRequest, tcfg.vocab_size)
    eng = TEngine(tcfg, tp, serve, device="cpu")
    clocks = []
    with chip_smoke.recorded_clocks(clocks):
        out, _ = eng.run(reqs)
    assert chip_smoke.check_census(eng, "rehearsal")["compiled_variants"] == 2
    got = chip_smoke.graphed_vs_eager(torch, tcfg, tp, serve, reqs, clocks, out, device="cpu")
    assert got["tokens_identical"] and got["max_abs_logit_diff"] == 0.0
    assert got["steps"] == len(clocks) and got["live_rows"] > 0
    assert "greedy tokens identical" in capsys.readouterr().out
