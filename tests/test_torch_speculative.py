"""The port's speculative decoding against the JAX reference, on the CPU.

The drafter registry, ``SpecConfig``, the ngram lookup, both acceptance
rules and the caches' rollback must equal the reference's exactly; the
speculative engine's greedy tokens must equal the JAX engine's
non-speculative and speculative tokens, with the same verify steps,
proposed, accepted and emitted counts.  Prompts repeat a period-3
pattern, so the ngram drafter drafts by construction.  JAX engine runs
are shared through a module-scoped cache.
"""
import dataclasses
import importlib.util
import os
from contextlib import nullcontext
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs import m6 as jm6
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import SpecConfig as JSpecConfig
from repro.models.registry import get_family
from repro.nn import init as jinit
from repro.quant import get_kv_quant as jget_kv_quant
from repro.quant import quant_write_kv as jquant_write_kv
from repro.serving.continuous import ContinuousEngine as JEngine
from repro.serving.kv_cache import make_kv_cache as jmake_kv_cache
from repro.serving.request import Request as JRequest
from repro.serving.speculative import accept as jaccept
from repro.serving.speculative.ngram import lookup_continuation as jlookup
from repro_torch.configs import m6 as tm6
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.configs.base import SpecConfig as TSpecConfig
from repro_torch.kernels.decode_attention import ops as tops
from repro_torch.nn import from_jax_params
from repro_torch.serving import continuous as tcontinuous
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from repro_torch.serving.kv_cache import make_kv_cache as tmake_kv_cache
from repro_torch.serving.request import Request as TRequest
from repro_torch.serving.speculative import (
    accept as taccept,
    available_drafters,
    get_drafter_cls,
    make_drafter,
    register_drafter,
)
from repro_torch.serving.speculative.ngram import lookup_continuation as tlookup
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(__file__), "..")
TINY = dict(name="t", family="decoder_lm", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=2, d_ff=64, vocab_size=128, max_seq_len=64, dtype="float32")
DRAFT = dict(name="draft", family="decoder_lm", num_layers=1, d_model=32, num_heads=2,
             num_kv_heads=2, d_ff=64, max_seq_len=64, dtype="float32")


# ---------------------------------------------------------------------------
# Registry and config
# ---------------------------------------------------------------------------

def test_drafter_registry_and_spec_config():
    assert {"ngram", "model"} <= set(available_drafters())
    assert get_drafter_cls("ngram").name == "ngram"
    assert get_drafter_cls("model").name == "model"
    with pytest.raises(ValueError, match="registered drafters"):
        get_drafter_cls("nope")
    for bad in (dict(drafter="nope"), dict(gamma=0), dict(max_ngram=0)):
        with pytest.raises(ValueError):
            TSpecConfig(**bad)
        with pytest.raises(ValueError):
            JSpecConfig(**bad)
    assert dataclasses.asdict(TSpecConfig()) == dataclasses.asdict(JSpecConfig())
    with pytest.raises(ValueError, match="string `name`"):
        register_drafter(type("Nameless", (), {}))

    @register_drafter
    class Plugin:
        name = "port-test-plugin"

        def __init__(self, spec, target_cfg, serve, *, seed=0, draft_model=None,
                     device="cuda"):
            self.seed = seed

        def propose(self, items):
            return [np.empty(0, np.int32) for _ in items]

    spec = TSpecConfig(drafter="port-test-plugin")
    assert isinstance(make_drafter(spec, None, None, seed=3), Plugin)


def _tiny_pair(**kw):
    return JModelConfig(**{**TINY, **kw}), TModelConfig(**{**TINY, **kw})


def test_model_drafter_refusals():
    _, tcfg = _tiny_pair()
    serve = TServeConfig(max_len=32)
    wide = TModelConfig(**{**DRAFT, "vocab_size": 256})
    with pytest.raises(ValueError, match="vocab"):
        make_drafter(TSpecConfig(drafter="model"), tcfg, serve, draft_model=(wide, None),
                     device="cpu")
    with pytest.raises(ValueError, match="SpecConfig.draft"):
        make_drafter(TSpecConfig(drafter="model"), tcfg, serve, device="cpu")
    learned = TModelConfig(**{**DRAFT, "vocab_size": 128, "pos_embed": "learned",
                              "max_seq_len": 16})
    with pytest.raises(ValueError, match="learned position"):
        make_drafter(TSpecConfig(drafter="model"), tcfg, serve, draft_model=(learned, None),
                     device="cpu")
    # a registered draft config without params: random from the seed
    d = make_drafter(TSpecConfig(drafter="model", draft="m6-base"), tm6.smoke(),
                     TServeConfig(max_len=32), seed=1, device="cpu")
    assert d.params["embed"]["table"].device.type == "cpu"


# ---------------------------------------------------------------------------
# ngram lookup and acceptance: pure numpy, equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctx,k,n,want", [
    ([1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2], 4, 3, [3, 1, 2, 3]),
    ([1, 2, 3, 1, 2, 3, 1, 2], 4, 3, [3, 1, 2]),
    ([9, 5, 6, 9, 7, 9], 3, 1, [5, 6, 9]),
    (list(range(10, 20)), 4, 3, []),
    ([7], 4, 3, []),
    ([1, 2, 1, 2], 0, 3, []),
    ([1, 2, 3, 4, 1], 2, 1, [2, 3]),
])
def test_ngram_lookup_goldens(ctx, k, n, want):
    ctx = np.array(ctx, np.int32)
    assert tlookup(ctx, k, n).tolist() == want == jlookup(ctx, k, n).tolist()


def test_ngram_lookup_matches_reference_on_seeded_contexts():
    rng = np.random.default_rng(0)
    drafted = 0
    for _ in range(400):
        ctx = rng.integers(0, rng.integers(2, 9), rng.integers(0, 48)).astype(np.int32)
        k, n = int(rng.integers(0, 6)), int(rng.integers(1, 5))
        got, want = tlookup(ctx, k, n), jlookup(ctx, k, n)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        drafted += got.size > 0
    assert drafted > 200


def test_accept_greedy_matches_reference():
    rows = np.zeros((4, 8), np.float32)
    rows[0, 3] = rows[1, 5] = rows[2, 1] = rows[3, 6] = 10.0
    for draft, want in (([3, 5, 2], ([3, 5, 1], 2)), ([3, 5, 1], ([3, 5, 1, 6], 3)),
                        ([0, 0, 0], ([3], 0))):
        assert taccept.accept_greedy(np.array(draft), rows) == want
    rng = np.random.default_rng(1)
    for _ in range(300):
        g = int(rng.integers(0, 5))
        argmax_rows = rng.integers(0, 4, g + 1)
        draft = np.where(rng.random(g) < 0.7, argmax_rows[:g], rng.integers(0, 4, g))
        assert (taccept.accept_greedy_ids(draft, argmax_rows)
                == jaccept.accept_greedy_ids(draft, argmax_rows))


def test_accept_rejection_matches_reference():
    rng = np.random.default_rng(2)
    for trial in range(200):
        g, V = int(rng.integers(0, 5)), int(rng.integers(2, 40))
        logits = (rng.standard_normal((g + 1, V)) * 3).astype(np.float32)
        draft = np.where(rng.random(g) < 0.5, logits[:g].argmax(-1), rng.integers(0, V, g))
        T = float(rng.choice([0.5, 0.8, 1.3]))

        def keys(j, slot=trial % 3, c=int(rng.integers(0, 50))):
            return np.random.default_rng(np.random.SeedSequence(entropy=[7, slot, c + j]))

        np.testing.assert_array_equal(taccept.softmax_rows(logits, T),
                                      jaccept.softmax_rows(logits, T))
        assert (taccept.accept_rejection(draft, logits, T, keys)
                == jaccept.accept_rejection(draft, logits, T, keys))


# ---------------------------------------------------------------------------
# Cache rollback
# ---------------------------------------------------------------------------

def _cache_state(c):
    return dict(table=c.block_table.tolist(), blocks=c._slot_blocks,
                reserved=c._slot_reserved, total=c.reserved_total,
                free=list(c.allocator._free), occupancy=c.occupancy())


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_truncate_slot_state_matches_reference(quant):
    jcfg, tcfg = _tiny_pair()
    kw = dict(max_slots=3, kv_block_size=4, max_len=40, kv_quant=quant)
    jc = jmake_kv_cache(jcfg, JServeConfig(**kw))
    tc = tmake_kv_cache(tcfg, TServeConfig(**kw), device="cpu")
    assert type(tc).__name__ == type(jc).__name__
    rng = np.random.default_rng(3)
    lengths = {}
    for _ in range(400):
        slot = int(rng.integers(3))
        kind = int(rng.choice(4, p=[0.2, 0.35, 0.3, 0.15]))
        if slot not in lengths:
            total = int(rng.integers(1, 41))
            if not jc.can_allocate_slot(total):
                continue
            args = ("allocate_slot", slot, total)
            lengths[slot] = (0, total)
        elif kind == 1:
            n = min(lengths[slot][0] + int(rng.integers(1, 9)), lengths[slot][1])
            args = ("ensure_capacity", slot, n)
            lengths[slot] = (n, lengths[slot][1])
        elif kind in (0, 2):
            n = int(rng.integers(0, lengths[slot][0] + 1))
            args = ("truncate_slot", slot, n)
            lengths[slot] = (n, lengths[slot][1])
        else:
            args = ("free_slot", slot)
            del lengths[slot]
        assert getattr(jc, args[0])(*args[1:]) == getattr(tc, args[0])(*args[1:])
        assert _cache_state(tc) == _cache_state(jc), args
        tc.check_conservation()


# ---------------------------------------------------------------------------
# The engine: greedy parity with the reference
# ---------------------------------------------------------------------------

def _periodic_requests(cls, vocab, gens=(9, 7, 10, 8), shared_head=0, seed=4):
    """Prompts that repeat a period-3 pattern (the ngram drafter drafts on
    them by construction), optionally after a shared head; all at t=0."""
    rng = np.random.default_rng(seed)
    head = np.tile(rng.integers(0, vocab, 3), 4)[:shared_head]
    out = []
    for uid, gen in enumerate(gens):
        body = np.tile(rng.integers(0, vocab, 3), 5)[:9 + uid % 3]
        out.append(cls(uid=uid, prompt=np.concatenate([head, body]).astype(np.int32),
                       max_new_tokens=gen))
    return out


@pytest.fixture(scope="module")
def models():
    """{"dense" | "moe": (jcfg, tcfg, jparams, tparams)} and the draft pair."""
    out = {}
    jt, tt = _tiny_pair()
    jm = jm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    tm = tm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    for name, (jcfg, tcfg) in (("dense", (jt, tt)), ("moe", (jm, tm))):
        jp = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
        out[name] = (jcfg, tcfg, jp, from_jax_params(jax.device_get(jp), tcfg, device="cpu"))
    return out


SERVE = dict(max_slots=2, kv_block_size=4, prefill_chunk=8, max_len=40)


@pytest.fixture(scope="module")
def jax_runs(models):
    """Memoised reference runs: key -> (tokens, spec_stats, steps, occupancy,
    stats)."""
    memo = {}

    def run(model, kv, prefix, drafter=None, temperature=0.0, seed=0):
        key = (model, kv, prefix, drafter, temperature, seed)
        if key not in memo:
            jcfg, _, jp, _ = models[model]
            spec = None if drafter is None else JSpecConfig(drafter=drafter, gamma=3)
            dm = (jcfg, jp) if drafter == "model" else None
            eng = JEngine(jcfg, jp, JServeConfig(**SERVE, kv_quant=kv, prefix_cache=prefix,
                                                 spec=spec),
                          draft_model=dm, check_invariants=True, temperature=temperature,
                          seed=seed)
            reqs = _periodic_requests(JRequest, jcfg.vocab_size,
                                      shared_head=8 if prefix else 0)
            out, stats = eng.run(reqs)
            memo[key] = (out, eng.spec_stats, eng.steps, eng.cache.occupancy(), stats)
        return memo[key]

    return run


def _recorded_quant_writes(store: list):
    """Record every ``quant_write_kv`` call the port's attention makes: (the
    code pool's address, x, write blocks, write offsets), in order."""
    real = tops.quant_write_kv

    def record(codes, scales, x, wb, wo, *, policy):
        store.append((codes.data_ptr(), x.float().clone(), wb.clone(), wo.clone()))
        return real(codes, scales, x, wb, wo, policy=policy)

    return mock.patch.object(tops, "quant_write_kv", record)


def _assert_pools_replay_reference(cache, writes, kv):
    """The port's code and scale pools after a run, bit for bit, against the
    reference's ``quant_write_kv`` replaying the same writes (the K/V rows,
    blocks and offsets the port wrote, in order) from zero pools: every
    rewrite of a position that a verify step's rollback rewound re-scales
    its block by the reference's law."""
    import jax.numpy as jnp

    pol = jget_kv_quant(kv)
    layer_of, pools = {}, {}
    for name in ("k", "v"):
        codes, scales = getattr(cache, f"{name}_pool"), getattr(cache, f"{name}_scales")
        for layer in range(codes.shape[0]):
            layer_of[codes[layer].data_ptr()] = (name, layer)
            pools[name, layer] = (jnp.zeros(codes.shape[1:], jnp.int8),
                                  jnp.zeros(scales.shape[1:], jnp.float32))
    for ptr, x, wb, wo in writes:
        key = layer_of[ptr]
        pools[key] = jquant_write_kv(*pools[key], jnp.asarray(x.numpy()),
                                     jnp.asarray(wb.numpy()), jnp.asarray(wo.numpy()),
                                     policy=pol)
    for (name, layer), (codes, scales) in pools.items():
        got_c = getattr(cache, f"{name}_pool")[layer].numpy()
        got_s = getattr(cache, f"{name}_scales")[layer].numpy()
        np.testing.assert_array_equal(got_c.view(np.int8), np.asarray(codes).view(np.int8))
        np.testing.assert_array_equal(got_s.view(np.int32), np.asarray(scales).view(np.int32))


@pytest.mark.parametrize("model,drafter,kv,prefix", [
    ("dense", "ngram", "none", False),
    ("dense", "model", "none", False),
    ("moe", "ngram", "none", False),
    ("moe", "model", "none", False),
    ("moe", "ngram", "int8", False),
    ("moe", "ngram", "none", True),
])
def test_spec_engine_greedy_parity(models, jax_runs, model, drafter, kv, prefix):
    """4 requests on 2 slots (slot reuse, queueing) under speculation:
    tokens equal the JAX engine's without and with speculation, and the
    verify steps, drafts and acceptances equal its own.  The model drafter
    drafts with the target's own weights (the reference's, crossed over by
    ``from_jax_params``), so its bursts are long and rejections rare.  Over
    int8 pools, where rejected drafts are rolled back and their positions
    written again, the code and scale pools equal the reference's
    ``quant_write_kv`` replaying the port's writes, bit for bit."""
    _, tcfg, _, tp = models[model]
    plain = jax_runs(model, kv, prefix)
    jtoks, jspec, jsteps, jocc, jstats = jax_runs(model, kv, prefix, drafter)
    dm = (tcfg, tp) if drafter == "model" else None
    eng = TEngine(tcfg, tp, TServeConfig(**SERVE, kv_quant=kv, prefix_cache=prefix,
                                         spec=TSpecConfig(drafter=drafter, gamma=3)),
                  device="cpu", draft_model=dm, check_invariants=True)
    reqs = _periodic_requests(TRequest, tcfg.vocab_size, shared_head=8 if prefix else 0)
    writes = []
    with _recorded_quant_writes(writes) if kv != "none" else nullcontext():
        out, stats = eng.run(reqs)
    assert out == plain[0] == jtoks
    assert eng.spec_stats == jspec and eng.steps == jsteps
    assert eng.spec_stats["verify_steps"] > 0 and eng.spec_stats["accepted"] > 0
    assert stats["acceptance_rate"] == jstats["acceptance_rate"]
    assert stats["spec_tokens_per_step"] == jstats["spec_tokens_per_step"]
    assert eng.cache.occupancy() == jocc
    eng.cache.check_conservation()
    if prefix:
        assert stats["cached_tokens"] > 0
        assert eng.cache.stats["cow_detaches"] == 0
    else:
        assert eng.cache.allocator.free_count == eng.cache.num_blocks
    if kv != "none":
        assert jspec["proposed"] > jspec["accepted"]           # drafts were rolled back
        _assert_pools_replay_reference(eng.cache, writes, kv)


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_spec_engine_low_temperature_accepts_as_reference(models, jax_runs, drafter):
    """Rejection sampling with drafts accepted: at T = 0.05 the target's
    softmax is peaked, so drafts are accepted, verify steps emit several
    tokens through ``accept_rejection``, and a rejection (for the model
    drafter after a partial acceptance) rolls the slot back
    (``truncate_slot``).  On these inputs the draws of both
    engines land on the same tokens (``accept_rejection`` and its
    ``SeedSequence`` keys are the reference's; the decode steps' draws at
    this temperature pick the top token), so the tokens and the verify
    counts equal the JAX engine's."""
    _, tcfg, _, tp = models["moe"]
    jtoks, jspec, jsteps, _, _ = jax_runs("moe", "none", False, drafter, 0.05, 3)
    eng = TEngine(tcfg, tp, TServeConfig(**SERVE, spec=TSpecConfig(drafter=drafter, gamma=3)),
                  temperature=0.05, seed=3, device="cpu", check_invariants=True,
                  draft_model=(tcfg, tp) if drafter == "model" else None)
    real, calls, rewinds = tcontinuous.accept_rejection, [], []
    real_truncate = eng.cache.truncate_slot

    def rejection(d, rows, t, rng):
        emitted, n = real(d, rows, t, rng)
        calls.append((len(d), n, len(emitted)))
        return emitted, n

    def truncate(slot, n):
        rewinds.append((slot, n))
        return real_truncate(slot, n)

    with mock.patch.object(tcontinuous, "accept_rejection", rejection), \
            mock.patch.object(eng.cache, "truncate_slot", truncate):
        out, _ = eng.run(_periodic_requests(TRequest, tcfg.vocab_size))
    assert out == jtoks
    assert eng.spec_stats == jspec and eng.steps == jsteps
    assert eng.spec_stats["accepted"] > 0
    assert any(e >= 2 for _, _, e in calls)                    # a multi-token emission
    assert any(n < d for d, n, _ in calls)                     # a rejection, rolled back
    if drafter == "model":
        assert any(0 < n < d for d, n, _ in calls)             # a partial acceptance
    assert rewinds
    assert all(0 <= t < tcfg.vocab_size for v in out.values() for t in v)
    eng.cache.check_conservation()
    assert eng.cache.allocator.free_count == eng.cache.num_blocks


# ---------------------------------------------------------------------------
# More engine cases, port only
# ---------------------------------------------------------------------------

def test_spec_eos_mid_burst(models):
    """EOS inside an accepted burst cuts the emission at (and including) it,
    as sequential decoding does; accepted counts only drafts kept.  The
    prompt is the first of a seeded series whose greedy output brings a
    new token at index 2 or later (random weights mostly repeat one
    token); the model drafter with the target's weights drafts it inside
    a burst."""
    _, tcfg, _, tp = models["moe"]
    rng = np.random.default_rng(4)
    for _ in range(20):
        prompt = np.tile(rng.integers(0, tcfg.vocab_size, 3), 4).astype(np.int32)
        base = TEngine(tcfg, tp, TServeConfig(**SERVE), device="cpu").run(
            [TRequest(uid=0, prompt=prompt, max_new_tokens=12)])[0][0]
        firsts = [i for i, t in enumerate(base) if i >= 2 and base.index(t) == i]
        if firsts:
            break
    at = firsts[0]
    eng = TEngine(tcfg, tp, TServeConfig(**SERVE, spec=TSpecConfig(drafter="model", gamma=4)),
                  device="cpu", draft_model=(tcfg, tp), check_invariants=True)
    out, _ = eng.run([TRequest(uid=0, prompt=prompt, max_new_tokens=12, eos_id=base[at])])
    assert out[0] == base[:at + 1]
    s = eng.spec_stats
    assert s["verify_steps"] > 0 and 0 < s["accepted"] <= s["emitted"]
    eng.scheduler.check_conservation()
    assert eng.cache.allocator.free_count == eng.cache.num_blocks


def test_empty_drafts_fall_through_to_decode(models):
    @register_drafter
    class NullDrafter:
        name = "port-test-null"

        def __init__(self, spec, target_cfg, serve, *, seed=0, draft_model=None,
                     device="cuda"):
            pass

        def propose(self, items):
            return [np.empty(0, np.int32) for _ in items]

    _, tcfg, _, tp = models["moe"]
    reqs = _periodic_requests(TRequest, tcfg.vocab_size)
    base, _ = TEngine(tcfg, tp, TServeConfig(**SERVE), device="cpu").run(reqs)
    eng = TEngine(tcfg, tp, TServeConfig(**SERVE, spec=TSpecConfig(drafter="port-test-null")),
                  device="cpu", check_invariants=True)
    out, stats = eng.run(_periodic_requests(TRequest, tcfg.vocab_size))
    assert out == base
    assert eng.spec_stats["verify_steps"] == 0
    assert eng.obs.metrics.get("engine_steps_total", kind="verify") == 0


@pytest.mark.parametrize("drafter", [None, "ngram", "model"])
def test_temperature_runs_reproducible_and_in_range(models, drafter):
    _, tcfg, _, tp = models["moe"]
    spec = None if drafter is None else TSpecConfig(drafter=drafter, gamma=3)

    def run():
        eng = TEngine(tcfg, tp, TServeConfig(**SERVE, spec=spec), temperature=0.8, seed=3,
                      device="cpu", draft_model=(tcfg, tp) if drafter == "model" else None,
                      check_invariants=True)
        return eng.run(_periodic_requests(TRequest, tcfg.vocab_size))[0], eng

    (a, eng), (b, _) = run(), run()
    assert a == b
    assert all(len(a[r.uid]) == r.max_new_tokens
               for r in _periodic_requests(TRequest, tcfg.vocab_size))
    assert all(0 <= t < tcfg.vocab_size for v in a.values() for t in v)
    if drafter == "model":
        assert eng.spec_stats["verify_steps"] > 0        # host rejection sampling ran
    eng.cache.check_conservation()


# ---------------------------------------------------------------------------
# The CLI and chip_smoke's phase 9, at smoke size on the CPU
# ---------------------------------------------------------------------------

CLI = ["--arch", "m6-base", "--smoke", "--engine", "continuous", "--moe-impl", "dropless",
       "--capacity-factor", "none", "--batch", "3", "--prompt-len", "9", "--gen", "6",
       "--max-slots", "2", "--max-len", "32", "--device", "cpu"]


@pytest.mark.parametrize("extra", [["--spec-drafter", "ngram"], ["--temperature", "0.8"],
                                   ["--spec-drafter", "model", "--spec-draft", "m6-base",
                                    "--temperature", "0.8"]])
def test_cli_speculative_and_sampled_on_cpu(extra):
    from repro_torch.launch.serve import main

    stats = main(CLI + extra)
    assert stats["generated_tokens"] == 18.0
    assert stats["moe_dropped_fraction"] == 0.0
    assert ("acceptance_rate" in stats) == ("--spec-drafter" in extra)


def test_cli_spec_draft_ckpt_restores(tmp_path, capsys):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.serve import main
    from repro_torch.nn import init_params

    dparams = init_params(tm6.smoke(), seed=9, device="cpu")
    Checkpointer(str(tmp_path)).save(5, dparams)
    main(CLI + ["--requests", "0", "--spec-drafter", "model", "--spec-draft", "m6-base",
                "--spec-draft-ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "restored draft params from checkpoint step 5" in out
    with pytest.raises(SystemExit, match="--spec-drafter model"):
        main(CLI + ["--spec-drafter", "ngram", "--spec-draft-ckpt", str(tmp_path)])
    # speculation on a mesh is refused with the reference's message
    with pytest.raises(NotImplementedError, match="speculative decoding is not supported "
                                                  "with ServeConfig.mesh"):
        main(CLI + ["--spec-drafter", "ngram", "--mesh", "data=1,expert=1"])


def test_chip_smoke_spec_phase_runs_on_cpu(models, capsys):
    """chip_smoke's phase 9 (greedy speculative runs with every gate, the
    sampler's checks, the sampled runs), rehearsed at smoke size on the CPU
    (the launch gates need the card)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from repro_torch.serving.trace import synthetic_trace

    _, cfg, _, params = models["moe"]
    reqs = synthetic_trace(6, cfg.vocab_size, seed=0, prompt_lens=(8, 24), gen_lens=(8, 16))
    base = chip_smoke.serve_once(torch, cfg, params, TServeConfig(max_len=64), reqs, "cpu")[0]
    int8 = chip_smoke.serve_once(torch, cfg, params, TServeConfig(max_len=64, kv_quant="int8"),
                                 reqs, "cpu")[0]
    greedy = chip_smoke.spec_serving_runs(torch, cfg, params, reqs, base, int8, "cpu",
                                          max_len=64)
    assert len(greedy) == 4 and all(r["verify_steps"] > 0 for r in greedy.values())
    assert greedy["model over bf16 pools"]["max_accepted_in_a_step"] >= 2
    sampler = chip_smoke.sampler_checks(torch, "cpu")
    assert sampler["near_tie_differences"] == 0 and sampler["frequency_max_err"] <= 0.015
    sampled = chip_smoke.sampled_serving_runs(torch, cfg, params, reqs, "cpu", max_len=64)
    assert len(sampled) == 5
    assert sampled[f"T = {chip_smoke.SAMPLE_T_LOW}, model"]["spec_acceptance_rate"] > 0
    out = capsys.readouterr().out
    assert "the second run's tokens equal the first's" in out
