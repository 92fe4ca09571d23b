"""The port's static lockstep engine and its dense-cache model path
against the JAX reference, on the CPU (the dense decode kernel's plain
version runs for CPU tensors).

The m6 smoke config in f32 with its weights drawn at initializer_range
0.3 (at 0.02 random weights greedily repeat the last prompt token, which
would make token parity vacuous); the reference's params cross over
through ``from_jax_params``.  Logits and caches agree within 1e-4;
greedy tokens, trace outputs and integer stats exactly.

A reference fault shapes the comparisons: the reference's
``prefill_apply`` adds no learned positions (its ``decode_apply`` and
``lm_apply`` do), so for m6 its static engine disagrees with its own
continuous engine.  The port's prefill adds them.  So on m6's learned
positions the port's prefill and decode are held to the reference's
token-by-token ``decode_apply`` (which the fault does not reach) and its
static tokens to the reference's continuous engine; token for token
against the reference's ``ServingEngine`` on m6 with RoPE positions,
where the reference's prefill computes what it means to.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import m6 as jm6
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import transformer as JTF
from repro.models.registry import get_family
from repro.nn import init as jinit
from repro.serving.engine import ServingEngine as JStatic
from repro.serving.trace import run_trace_static as j_run_trace_static
from repro.serving.trace import synthetic_trace as j_synthetic_trace
from repro_torch.configs import m6 as tm6
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.models import transformer as TTF
from repro_torch.nn import from_jax_params
from repro_torch.serving.continuous import ContinuousEngine as TContinuous
from repro_torch.serving.engine import ServingEngine as TStatic
from repro_torch.serving.trace import run_trace_static, synthetic_trace
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(__file__), "..")
TOL = 1e-4
MOE = {
    "topk dropless": dict(impl="dropless", capacity_factor=None),
    "topk pallas 1.25": dict(impl="pallas", capacity_factor=1.25),
    "hash dropless": dict(routing="hash", impl="dropless", capacity_factor=None),
}


def _m6(moe, init_range=0.3):
    return (jm6.smoke().replace(initializer_range=init_range).replace_moe(**moe),
            tm6.smoke().replace(initializer_range=init_range).replace_moe(**moe))


def _m6_rope(moe):
    """m6 smoke with RoPE positions: the reference's static engine computes
    there what it means to (see the module doc)."""
    return tuple(c.replace(pos_embed="rope") for c in _m6(moe))


def _params(jcfg, tcfg, seed=0):
    jp = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(seed))
    return jp, from_jax_params(jax.device_get(jp), tcfg, device="cpu")


def _prompts(vocab, B=3, S=10, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol, rtol=tol)


def _reference_prompt_steps(jp, jcfg, prompts, max_len):
    """The reference's caches and last logits after the prompt, fed token
    by token through its ``decode_apply`` (which adds learned positions):
    what a prefill computes."""
    caches = JTF.init_caches(jcfg, prompts.shape[0], max_len)
    for i in range(prompts.shape[1]):
        logits, caches = _j_decode(jp, jnp.asarray(prompts[:, i:i + 1]), caches, jcfg)
    return logits, caches


_j_decode = jax.jit(JTF.decode_apply, static_argnums=(3,))


@pytest.mark.parametrize("moe", ["topk dropless", "hash dropless"])
def test_prefill_and_decode_steps_match_reference(moe):
    """prefill_apply's logits (every position against the reference's
    ``lm_apply``, the last against its token-by-token prompt) and every
    layer's cache k/v and length, then each decode step's logits and
    caches, fed the reference's greedy tokens, against the reference's
    dense-cache ``decode_apply``.  Dropless routing is batch-invariant, so
    the token-by-token prompt routes as a prefill does."""
    jcfg, tcfg = _m6(MOE[moe])
    jp, tp = _params(jcfg, tcfg)
    prompts = _prompts(jcfg.vocab_size)
    max_len = 24
    jfull, _ = JTF.lm_apply(jp, jnp.asarray(prompts), jcfg)
    jlogits, jcaches = _reference_prompt_steps(jp, jcfg, prompts, max_len)
    with torch.inference_mode():
        tlogits, tcaches, _ = TTF.prefill_apply(tp, torch.from_numpy(prompts).long(), tcfg,
                                                max_len=max_len)
        _close(jfull, tlogits)
        tlogits = tlogits[:, -1:]
        for step in range(6):
            _close(jlogits, tlogits)
            _close(jcaches.k, tcaches.k)
            _close(jcaches.v, tcaches.v)
            assert np.asarray(jcaches.length).tolist() == [tcaches.length] * tcfg.num_layers
            tok = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1)).astype(np.int32)[:, None]
            jlogits, jcaches = _j_decode(jp, jnp.asarray(tok), jcaches, jcfg)
            tlogits, tcaches = TTF.decode_apply(tp, torch.from_numpy(tok).long(), tcaches, tcfg)
            assert tlogits.shape == (3, 1, jlogits.shape[-1])
    assert tcaches.length == prompts.shape[1] + 6


@pytest.mark.parametrize("moe", list(MOE))
def test_greedy_tokens_equal_reference_engine(moe):
    """ServingEngine.generate on m6 with RoPE positions: greedy tokens
    exactly the reference's, for top-1 dropless, top-1 at capacity 1.25
    through the grouped-FFN kernel's path (``pallas``) and hash routing
    (token ids and absolute positions through the MoE context in prefill
    and decode)."""
    jcfg, tcfg = _m6_rope(MOE[moe])
    jp, tp = _params(jcfg, tcfg)
    prompts = _prompts(jcfg.vocab_size, B=4, S=12, seed=2)
    jtoks, _ = JStatic(jcfg, jp, max_len=32).generate(prompts, 14)
    ttoks, stats = TStatic(tcfg, tp, max_len=32).generate(prompts, 14)
    assert ttoks.dtype == np.int32 and ttoks.shape == (4, 14)
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    assert len(set(ttoks.ravel().tolist())) > 8           # not a repeated token
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0 and stats["decode_tokens_per_s"] > 0


@pytest.mark.parametrize("moe", ["topk dropless", "hash dropless"])
def test_learned_positions_greedy_tokens_equal_reference_continuous(moe):
    """m6's learned positions: the reference's static engine, whose prefill
    omits them, gives other tokens than its continuous engine (the fault
    shows at these weights); the port's static engine gives the reference
    continuous engine's tokens exactly."""
    from repro.configs.base import ServeConfig as JServeConfig
    from repro.serving.continuous import ContinuousEngine as JContinuous

    jcfg, tcfg = _m6(MOE[moe])
    jp, tp = _params(jcfg, tcfg)
    prompts = _prompts(jcfg.vocab_size, B=4, S=12, seed=2)
    jcont, _ = JContinuous(jcfg, jp, JServeConfig(max_slots=4, kv_block_size=8, prefill_chunk=8,
                                                  max_len=32)).generate(prompts, 14)
    jstatic, _ = JStatic(jcfg, jp, max_len=32).generate(prompts, 14)
    assert (np.asarray(jstatic) != np.asarray(jcont)).any()
    ttoks, _ = TStatic(tcfg, tp, max_len=32).generate(prompts, 14)
    np.testing.assert_array_equal(ttoks, np.asarray(jcont))


def test_num_tokens_1_stats():
    jcfg, tcfg = _m6_rope(MOE["topk dropless"])
    jp, tp = _params(jcfg, tcfg)
    prompts = _prompts(jcfg.vocab_size, B=2, S=4)
    toks, stats = TStatic(tcfg, tp, max_len=16).generate(prompts, num_tokens=1)
    jtoks, jstats = JStatic(jcfg, jp, max_len=16).generate(prompts, num_tokens=1)
    assert toks.shape == (2, 1)
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    assert stats["decode_tokens_per_s"] == jstats["decode_tokens_per_s"] == 0.0
    assert set(stats) == set(jstats)


def test_run_trace_static_outputs_equal_reference():
    """FCFS groups of 3 over a 7-request trace, right-padded prompts: every
    request's tokens equal the reference's, and the stats' token count."""
    jcfg, tcfg = _m6_rope(MOE["topk dropless"])
    jp, tp = _params(jcfg, tcfg)
    kw = dict(seed=0, qps=1e6, prompt_lens=(4, 14), gen_lens=(3, 6, 9))
    jreqs = j_synthetic_trace(7, jcfg.vocab_size, **kw)
    treqs = synthetic_trace(7, tcfg.vocab_size, **kw)
    jout, jstats = j_run_trace_static(JStatic(jcfg, jp, max_len=24), jreqs, batch=3)
    tout, tstats = run_trace_static(TStatic(tcfg, tp, max_len=24), treqs, batch=3)
    assert tout == {u: list(map(int, t)) for u, t in jout.items()}
    assert all(len(tout[r.uid]) == r.max_new_tokens for r in treqs)
    assert tstats["generated_tokens"] == jstats["generated_tokens"]
    assert tstats["p95_ms"] >= tstats["p50_ms"] >= 0.0
    with pytest.raises(ValueError, match="worst-case group"):
        run_trace_static(TStatic(tcfg, tp, max_len=16), treqs, batch=3)


def _tiny(**moe):
    """The reference serving tests' tiny decoder (RoPE, GQA 4/2)."""
    kw = dict(name="t", family="decoder_lm", num_layers=2, d_model=64, num_heads=4,
              num_kv_heads=2, d_ff=96 if moe else 128, vocab_size=128, max_seq_len=128,
              dtype="float32", initializer_range=0.3)
    if moe:
        return JModelConfig(moe=JMoEConfig(**moe), **kw), TModelConfig(moe=TMoEConfig(**moe), **kw)
    return JModelConfig(**kw), TModelConfig(**kw)


@pytest.mark.parametrize("case,B,S,gen,serve", [
    ("dense", 3, 13, 8, dict(max_slots=4, kv_block_size=8, prefill_chunk=5, max_len=64)),
    ("dense", 4, 9, 6, dict(max_slots=2, kv_block_size=8, prefill_chunk=4, max_len=32)),
    ("hash", 2, 9, 7, dict(max_slots=2, kv_block_size=8, prefill_chunk=4, max_len=64)),
])
def test_continuous_engine_equals_static_engine(case, B, S, gen, serve):
    """The reference's own oracle (``tests/test_serving.py``'s greedy
    parity), on the port: the continuous engine's tokens equal the static
    engine's on an equal-length batch, also under slot reuse and with the
    hash router reading token ids through the MoE context."""
    moe = dict(num_experts=4, routing="hash", top_k=2, impl="dropless", capacity_factor=None,
               group_size=64) if case == "hash" else {}
    jcfg, tcfg = _tiny(**moe)
    _, tp = _params(jcfg, tcfg)
    prompts = _prompts(tcfg.vocab_size, B=B, S=S)
    toks_s, _ = TStatic(tcfg, tp, max_len=S + gen + 1).generate(prompts, gen)
    toks_c, _ = TContinuous(tcfg, tp, TServeConfig(**serve), device="cpu").generate(prompts, gen)
    np.testing.assert_array_equal(toks_s, toks_c)
    assert len(set(toks_s.ravel().tolist())) > 4


def test_sampled_tokens_are_keyed_by_row_and_position():
    """T > 0: the static engine's Gumbel-max draws are keyed by (seed, row,
    absolute position), as the continuous engine's by (seed, slot,
    position): one seed gives the same tokens twice and the continuous
    engine's tokens (every request admitted to slot = row at t = 0),
    another seed other tokens.  (Parity with the reference is in
    distribution only: ``test_torch_sampling.py``.)"""
    jcfg, tcfg = _tiny()
    _, tp = _params(jcfg, tcfg)
    prompts = _prompts(tcfg.vocab_size, B=3, S=7)
    eng = TStatic(tcfg, tp, max_len=20)
    a, _ = eng.generate(prompts, 10, temperature=0.8, seed=3)
    b, _ = eng.generate(prompts, 10, temperature=0.8, seed=3)
    c, _ = eng.generate(prompts, 10, temperature=0.8, seed=4)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    cont = TContinuous(tcfg, tp, TServeConfig(max_slots=3, max_len=32), temperature=0.8, seed=3,
                       device="cpu")
    np.testing.assert_array_equal(a, cont.generate(prompts, 10)[0])


def test_learned_positions_and_cache_bounds_are_refused():
    """max_len past the learned position table is refused at construction,
    and a generate that would write past the cache is refused (the
    reference clamps both silently)."""
    _, tp = _params(*_m6(MOE["topk dropless"]))
    tcfg = _m6(MOE["topk dropless"])[1]
    with pytest.raises(ValueError, match="learned position"):
        TStatic(tcfg, tp, max_len=tcfg.max_seq_len + 1)
    eng = TStatic(tcfg, tp, max_len=tcfg.max_seq_len)
    with pytest.raises(ValueError, match="exceed max_len"):
        eng.generate(_prompts(tcfg.vocab_size, B=1, S=60), 6)


def test_serve_cli_static_engine_on_cpu(tmp_path, capsys):
    """The serve CLI's default engine (static) in both modes: one uniform
    batch, and a 16-request trace file in FCFS groups of 8 (its lengths
    within the smoke config's 64 learned positions); --spec-drafter with
    the static engine exits as in the reference."""
    import json

    from repro_torch.launch.serve import main

    stats = main(["--arch", "m6-base", "--smoke", "--device", "cpu", "--batch", "3",
                  "--prompt-len", "8", "--gen", "5"])
    assert stats["decode_tokens_per_s"] > 0
    rng = np.random.default_rng(0)
    trace = tmp_path / "trace.jsonl"
    trace.write_text("".join(json.dumps({"prompt_len": int(rng.integers(4, 20)),
                                         "gen_len": int(rng.integers(2, 12)),
                                         "arrival_ms": 5.0 * i}) + "\n" for i in range(16)))
    stats = main(["--arch", "m6-base", "--smoke", "--device", "cpu", "--engine", "static",
                  "--trace", str(trace), "--batch", "8", "--moe-impl", "dropless",
                  "--capacity-factor", "none"])
    out = capsys.readouterr().out
    assert "engine=static" in out and "tok/s" in out
    want = sum(json.loads(line)["gen_len"] for line in trace.read_text().splitlines())
    assert stats["generated_tokens"] == want
    with pytest.raises(SystemExit, match="--spec-drafter needs --engine continuous"):
        main(["--arch", "m6-base", "--smoke", "--device", "cpu", "--spec-drafter", "ngram"])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_static_phase_runs_on_cpu(capsys):
    """chip_smoke's phase 11, rehearsed at smoke size on the CPU (the launch
    gates need the card): (a)-(e) through the static engine against the
    continuous engine, then (f) the routers' training runs with their
    kernels-vs-plain step."""
    cs = _chip_smoke()
    jcfg, tcfg = _m6(MOE["topk dropless"])
    _, tp = _params(jcfg, tcfg)
    reqs = synthetic_trace(6, tcfg.vocab_size, seed=0, prompt_lens=(8, 24), gen_lens=(8, 16))
    _, cont, _, _ = cs.serve_once(torch, tcfg, tp, TServeConfig(max_len=64), reqs, "cpu")
    continuous = dict(tokens_per_s=cont["generated_tokens_per_s"], p50_ms=cont["p50_ms"],
                      p95_ms=cont["p95_ms"])
    report, _ = cs.static_serving_runs(torch, tcfg, tp, reqs, "cpu", continuous,
                                       shape=(4, 16, 8))
    assert report["greedy"]["rows_equal"] == report["hash"]["rows_equal"] == 4
    assert report["trace"]["speedup_tokens_per_s"] > 0
    T, lens = cs.static_decode_shapes(reqs)
    assert report["trace"]["decode_steps"] == len(lens) and T == report["trace"]["max_len"]
    train, _ = cs.router_train_runs(torch, ["--arch", "m6-base", "--smoke", "--batch", "2",
                                            "--seq", "36", "--log-every", "1"], "cpu")
    assert set(train) == {label for label, _, _ in cs.STATIC_TRAIN_RUNS}
    for r in train.values():
        assert len(r["losses"]) == 2 and r["kernels_vs_plain"]["min_grad_cosine"] > 0.99
    out = capsys.readouterr().out
    assert "static trace, batch 8" in out and "train hash, pallas" in out
