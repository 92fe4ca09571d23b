"""The xLSTM family in the port against the JAX reference, on the CPU: the
three mLSTM forms, the sLSTM cell and block, the model, its decode, both
serving engines, the train CLI, the recurrent refusals, and checkpoints of
per-layer-list param trees (xLSTM's, a mixed dense/MoE stack's) read by
the other package both ways.

Inputs are numpy-seeded; params are the reference's, carried across with
``from_jax_params``.  Tolerances (f32) are stated where they are used;
greedy tokens and checkpoint bits are held identical.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import m6 as jm6
from repro.configs import xlstm_125m as jx125
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import SLOConfig as JSLOConfig
from repro.configs.base import SpecConfig as JSpecConfig
from repro.models import xlstm as JX
from repro.models.registry import get_family as j_family
from repro.nn import count_params as j_count
from repro.nn import init as jinit
from repro.optim.adamw import adamw as jadamw
from repro.serving.continuous import ContinuousEngine as JEngine
from repro.serving.engine import ServingEngine as JStatic
from repro.serving.request import Request as JRequest
from repro.train.state import init_train_state as j_init_train_state
from repro_torch.checkpoint import Checkpointer, jax_key
from repro_torch.configs import m6 as tm6
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.configs.base import SLOConfig as TSLOConfig
from repro_torch.configs.base import SpecConfig as TSpecConfig
from repro_torch.models import xlstm as TX
from repro_torch.models.registry import get_family as t_family
from repro_torch.nn import count_params, flat_params, from_jax_params, model_shapes
from repro_torch.optim.adamw import adamw as tadamw
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from repro_torch.serving.engine import ServingEngine as TStatic
from repro_torch.serving.request import Request as TRequest
from repro_torch.train.state import init_train_state
from torch_threads import one_torch_thread  # noqa: F401


def _smoke():
    return jx125.smoke(), treg.get_smoke_config("xlstm-125m")


def _params(jcfg, tcfg, train=False, seed=0):
    jp = jinit(j_family(jcfg).specs(jcfg), jax.random.PRNGKey(seed))
    return jp, from_jax_params(jax.device_get(jp), tcfg, device="cpu", train=train)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _gates(B=2, H=2, S=48, D=8, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(3))
    ig = rng.standard_normal((B, H, S)).astype(np.float32)
    fg = (rng.standard_normal((B, H, S)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


def _check_vjp(jfn, tfn, args, atol_out, atol_grad, seed=9):
    """Forward within ``atol_out`` and every argument's gradient under one
    numpy-seeded cotangent within ``atol_grad`` (rtol alike)."""
    jout, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    targs = [_t(a, grad=True) for a in args]
    tout = tfn(*targs)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=atol_out,
                               rtol=atol_out)
    cot = np.random.default_rng(seed).standard_normal(jout.shape).astype(np.float32)
    jg = vjp(jnp.asarray(cot))
    (tout * _t(cot)).sum().backward()
    for i, (a, g) in enumerate(zip(targs, jg)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), atol=atol_grad,
                                   rtol=atol_grad, err_msg=f"argument {i}")


# ---------------------------------------------------------------------------
# The mLSTM forms and the sLSTM cell, each against its own reference form
# ---------------------------------------------------------------------------

def test_mlstm_parallel_matches_reference():
    """Forward within 1e-5, gradients of q, k, v and both gates within 1e-4."""
    _check_vjp(JX._mlstm_parallel, TX._mlstm_parallel, _gates(), 1e-5, 1e-4)


@pytest.mark.parametrize("S", [48, 40], ids=["chunk_multiple", "padded"])
def test_mlstm_chunked_matches_reference(S):
    """Chunk 16: S = 48 is three whole chunks; S = 40 pads 8 rows (igate
    -1e30, fgate 30).  Forward within 1e-5, gradients within 1e-4."""
    def j(*a):
        return JX._mlstm_chunked(*a, chunk=16)

    def t(*a):
        return TX._mlstm_chunked(*a, chunk=16)

    _check_vjp(j, t, _gates(S=S), 1e-5, 1e-4)


def _block(jp, tp, i):
    return jp["blocks"][i], tp["blocks"][i]


def _check_block_vjp(jfn, tfn, jb, x, atol_out, atol_grad, seed=9):
    """``fn(block params, x)``: forward within ``atol_out``; the gradient
    of every parameter and of x under one numpy-seeded cotangent within
    ``atol_grad`` (rtol alike)."""
    jout, vjp = jax.vjp(jfn, jb, jnp.asarray(x))
    tb = jax.tree_util.tree_map(lambda a: _t(a, grad=True), jax.device_get(jb))
    tx = _t(x, grad=True)
    tout = tfn(tb, tx)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=atol_out,
                               rtol=atol_out)
    cot = np.random.default_rng(seed).standard_normal(jout.shape).astype(np.float32)
    jgb, jgx = vjp(jnp.asarray(cot))
    (tout * _t(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=atol_grad, rtol=atol_grad)
    for (path, g), t in zip(jax.tree_util.tree_flatten_with_path(jgb)[0],
                            jax.tree_util.tree_leaves(tb)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=atol_grad,
                                   rtol=atol_grad, err_msg=jax.tree_util.keystr(path))


def test_mlstm_block_forward_and_recurrent_step_match_reference():
    """The smoke config's first block (mLSTM): the parallel form (S = 20) and
    the chunked form (S = 70 > 2 * ssm_chunk, padded to 128), forward
    within 1e-5 and the gradients of every parameter and the input within
    1e-4; the recurrent step over 6 tokens from zero state, outputs and
    every state field within 1e-5."""
    jcfg, tcfg = _smoke()
    jp, tp = _params(jcfg, tcfg, train=True)
    jb, tb = _block(jp, tp, 0)
    rng = np.random.default_rng(1)
    for S in (20, 70):
        x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
        _check_block_vjp(lambda p, a: JX.mlstm_block_apply(p, a, jcfg)[0],
                         lambda p, a: TX.mlstm_block_apply(p, a, tcfg)[0], jb, x, 1e-5, 1e-4)
    x = rng.standard_normal((2, 6, tcfg.d_model)).astype(np.float32)
    jst, tst = JX.mlstm_init_state(jcfg, 2), TX.mlstm_init_state(tcfg, 2)
    with torch.no_grad():
        for t in range(6):
            jy, jst = JX.mlstm_block_apply(jb, jnp.asarray(x[:, t:t + 1]), jcfg, state=jst)
            ty, tst = TX.mlstm_block_apply(tb, torch.from_numpy(x[:, t:t + 1]), tcfg, state=tst)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
            for f in jst._fields:
                np.testing.assert_allclose(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)),
                                           atol=1e-5, rtol=1e-5, err_msg=f)


def test_mlstm_recurrent_step_gradients_match_reference():
    """Gradients of one recurrent step through the block (from a state two
    steps in) with respect to its input, within 1e-4."""
    jcfg, tcfg = _smoke()
    jp, tp = _params(jcfg, tcfg, train=True)
    jb, tb = _block(jp, tp, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, tcfg.d_model)).astype(np.float32)
    jst, tst = JX.mlstm_init_state(jcfg, 2), TX.mlstm_init_state(tcfg, 2)
    with torch.no_grad():
        for t in range(2):
            _, jst = JX.mlstm_block_apply(jb, jnp.asarray(x[:, t:t + 1]), jcfg, state=jst)
            _, tst = TX.mlstm_block_apply(tb, torch.from_numpy(x[:, t:t + 1]), tcfg, state=tst)
    _check_vjp(lambda a: JX.mlstm_block_apply(jb, a, jcfg, state=jst)[0],
               lambda a: TX.mlstm_block_apply(tb, a, tcfg, state=tst)[0],
               [x[:, 2:3]], 1e-5, 1e-4)


def test_slstm_cell_and_block_match_reference():
    """The smoke config's fourth block (sLSTM): one cell step from a random
    state (every state field within 1e-5, gradients of the input within
    1e-4), the block over 12 steps (forward 1e-5, the gradients of every
    parameter and the input 1e-4),
    and the block's decode from zero state, step by step."""
    jcfg, tcfg = _smoke()
    assert [i for i in range(tcfg.num_layers) if TX._is_slstm(tcfg, i)] == [3]
    jp, tp = _params(jcfg, tcfg, train=True)
    jb, tb = _block(jp, tp, 3)
    rng = np.random.default_rng(3)
    d = tcfg.d_model
    st = [rng.standard_normal((2, d)).astype(np.float32) for _ in range(4)]
    st[1] = np.abs(st[1]) + 0.5                                 # a normaliser > 0
    jst, tst = JX.SLSTMState(*map(jnp.asarray, st)), TX.SLSTMState(*map(torch.from_numpy, st))
    xt = rng.standard_normal((2, d)).astype(np.float32)
    jn = JX._slstm_cell(jb, jnp.asarray(xt), jst, jcfg)
    tn = TX._slstm_cell(tb, torch.from_numpy(xt), tst, tcfg)
    for f in jn._fields:
        np.testing.assert_allclose(getattr(tn, f).detach().numpy(), np.asarray(getattr(jn, f)),
                                   atol=1e-5, rtol=1e-5, err_msg=f)
    _check_vjp(lambda a: JX._slstm_cell(jb, a, jst, jcfg).h,
               lambda a: TX._slstm_cell(tb, a, tst, tcfg).h, [xt], 1e-5, 1e-4)
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    _check_block_vjp(lambda p, a: JX.slstm_block_apply(p, a, jcfg)[0],
                     lambda p, a: TX.slstm_block_apply(p, a, tcfg)[0], jb, x, 1e-5, 1e-4)
    jst, tst = JX.slstm_init_state(jcfg, 2), TX.slstm_init_state(tcfg, 2)
    with torch.no_grad():
        for t in range(4):
            jy, jst = JX.slstm_block_apply(jb, jnp.asarray(x[:, t:t + 1]), jcfg, state=jst)
            ty, tst = TX.slstm_block_apply(tb, torch.from_numpy(x[:, t:t + 1]), tcfg, state=tst)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)


def test_slstm_normaliser_floor_splits_ties_as_jax():
    """At a first step from zero state whose input gate beats log σ(f), the
    normaliser is exactly 1, the floor of ``max(n, 1)``: JAX splits that
    tie's gradient in half, and so does the port (``torch.maximum``)."""
    jcfg, tcfg = _smoke()
    jp, tp = _params(jcfg, tcfg, train=True)
    jb, tb = _block(jp, tp, 3)
    xt = np.random.default_rng(4).standard_normal((2, tcfg.d_model)).astype(np.float32)
    jst, tst = JX.slstm_init_state(jcfg, 2), TX.slstm_init_state(tcfg, 2)
    tn = TX._slstm_cell(tb, torch.from_numpy(xt), tst, tcfg)
    assert (tn.n == 1.0).float().mean() > 0.2          # ties present
    _check_vjp(lambda a: JX._slstm_cell(jb, a, jst, jcfg).h,
               lambda a: TX._slstm_cell(tb, a, tst, tcfg).h, [xt], 1e-5, 1e-4)


def test_mlstm_stabiliser_starts_at_zero():
    """The reference's quirk, mirrored: the recurrent step and the chunk
    carry start the stabiliser m at 0, not -inf.  After a first step whose
    input gate lies far below log σ(f), m is log σ(f) (a start at -inf
    would give the input gate); the output is the parallel form's but for
    rounding, since exp(-m) scales the numerator and the denominator
    alike."""
    B, H, D = 1, 1, 4
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((B, H, 1, D)).astype(np.float32) for _ in range(3))
    ig = np.full((B, H, 1), -20.0, np.float32)
    fg = np.full((B, H, 1), 3.0, np.float32)
    state = TX.MLSTMState(torch.zeros(B, H, D, D), torch.zeros(B, H, D), torch.zeros(B, H),
                          torch.zeros(B, 3, D))
    h, c, n, m = TX._mlstm_step(*(torch.from_numpy(a[:, :, 0]) for a in (q, k, v, ig, fg)),
                                state, D)
    logf = float(torch.nn.functional.logsigmoid(torch.tensor(3.0)))
    assert float(m) == pytest.approx(logf, abs=1e-7) and float(m) > -20
    par = TX._mlstm_parallel(*(torch.from_numpy(a) for a in (q, k, v, ig, fg)))
    np.testing.assert_allclose(h.numpy(), par[:, :, 0].numpy(), rtol=1e-5, atol=1e-12)
    jpar = JX._mlstm_parallel(*(jnp.asarray(a) for a in (q, k, v, ig, fg)))
    np.testing.assert_allclose(par.numpy(), np.asarray(jpar), rtol=1e-6, atol=0)
    # the chunk carry: a one-chunk pass from m = 0 keeps the same m
    (_, _, m_chunk), _ = TX._mlstm_chunk(
        (torch.zeros(B, H, D, D), torch.zeros(B, H, D), torch.zeros(B, H)),
        *(torch.from_numpy(a) for a in (q, k, v, ig, fg)), D ** -0.5)
    assert float(m_chunk) == pytest.approx(logf, abs=1e-7)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_config_and_param_tree_match_reference():
    """The full and smoke configs field for field, the parameter count, and
    the param tree key for key (a list of 12 blocks at full width)."""
    for get in ("get_config", "get_smoke_config"):
        from repro.configs import registry as jreg

        assert dataclasses.asdict(getattr(treg, get)("xlstm-125m")) == \
            dataclasses.asdict(getattr(jreg, get)("xlstm-125m"))
    full = treg.get_config("xlstm-125m")
    jfull = jx125.CONFIG
    assert count_params(full) == j_count(j_family(jfull).specs(jfull))
    for jcfg, tcfg in ((jfull, full), _smoke()):
        abstract = jax.eval_shape(lambda c=jcfg: jinit(j_family(c).specs(c),
                                                       jax.random.PRNGKey(0)))
        want = {jax.tree_util.keystr(p): tuple(v.shape)
                for p, v in jax.tree_util.tree_flatten_with_path(abstract)[0]}
        got = {jax_key(p): tuple(s.shape) for p, s in flat_params(model_shapes(tcfg)).items()}
        assert got == want
    assert len(model_shapes(full)["blocks"]) == 12


@pytest.mark.parametrize("S", [24, 70], ids=["parallel", "chunked"])
def test_xlstm_apply_matches_reference(S):
    """Logits within 1e-4 through the family forward (the chunked mLSTM
    form at S = 70 > 2 * ssm_chunk)."""
    jcfg, tcfg = _smoke()
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    jl, jaux = j_family(jcfg).forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        tl, taux = t_family(tcfg).forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    V = jcfg.vocab_size
    np.testing.assert_allclose(tl[..., :V].numpy(), np.asarray(jl)[..., :V], atol=1e-4, rtol=1e-4)
    assert set(taux) == set(jaux)


def test_decode_matches_parallel():
    """tests/test_models.py's check on the port: 10 decode steps from zero
    states against the parallel forward, atol 2e-4."""
    cfg = TModelConfig(family="xlstm", num_layers=4, d_model=48, num_heads=4, num_kv_heads=4,
                       vocab_size=61, xlstm_slstm_period=4, ssm_chunk=16, dtype="float32")
    jcfg = JModelConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k != "moe"})
    jp = jinit(JX.xlstm_specs(jcfg), jax.random.PRNGKey(0))
    tp = from_jax_params(jax.device_get(jp), cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 61, (2, 10)))
    with torch.no_grad():
        full, _, _ = TX.xlstm_apply(tp, toks, cfg)
        states = TX.xlstm_init_states(cfg, 2)
        for i in range(10):
            lg, _, states = TX.xlstm_apply(tp, toks[:, i:i + 1], cfg, states=states)
            np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i].numpy(), atol=2e-4)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _serving_cfgs(case):
    if case == "xlstm-125m-smoke":
        return _smoke()
    kw = dict(name="x", family="xlstm", num_layers=2, d_model=64, num_heads=4,
              num_kv_heads=4, d_ff=128, vocab_size=128, dtype="float32", xlstm_slstm_period=2)
    return JModelConfig(**kw), TModelConfig(**kw)


@pytest.mark.parametrize("case", ["test_serving", "xlstm-125m-smoke"])
def test_continuous_recurrent_slots_equal_reference(case):
    """3 requests over 2 slots (a slot is reused, so its state must be
    reset: tests/test_serving.py's recurrent-slot case, and the smoke
    config): greedy tokens identical to the reference's continuous engine;
    every step one (2, 1) decode."""
    jcfg, tcfg = _serving_cfgs(case)
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in (6, 4, 7)]
    budgets = (5, 7, 3)
    kw = dict(max_slots=2, kv_block_size=8, prefill_chunk=4, max_len=32)
    jout, _ = JEngine(jcfg, jp, JServeConfig(**kw)).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=b)
         for i, (p, b) in enumerate(zip(prompts, budgets))])
    eng = TEngine(tcfg, tp, TServeConfig(**kw), device="cpu", check_invariants=True)
    tout, stats = eng.run([TRequest(uid=i, prompt=p, max_new_tokens=b)
                           for i, (p, b) in enumerate(zip(prompts, budgets))])
    assert {u: list(map(int, v)) for u, v in tout.items()} == \
        {u: list(map(int, v)) for u, v in jout.items()}
    assert eng.mode == "recurrent" and eng.cache is None
    assert stats["steps"] == eng.steps


@pytest.mark.parametrize("case", ["test_serving", "xlstm-125m-smoke"])
def test_static_engine_token_by_token_equals_reference(case):
    """The static engine feeds the prompt token by token from zero states:
    greedy tokens identical to the reference's ``ServingEngine`` and to the
    port's continuous engine on the same equal-length batch."""
    jcfg, tcfg = _serving_cfgs(case)
    jp, tp = _params(jcfg, tcfg)
    prompts = np.random.default_rng(8).integers(0, jcfg.vocab_size, (3, 7)).astype(np.int32)
    jtoks, _ = JStatic(jcfg, jp, max_len=32).generate(jnp.asarray(prompts), 6)
    ttoks, stats = TStatic(tcfg, tp, max_len=32).generate(prompts, 6)
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    ctoks, _ = TEngine(tcfg, tp, TServeConfig(max_slots=3, max_len=32),
                       device="cpu").generate(prompts, 6)
    np.testing.assert_array_equal(ctoks, ttoks)
    assert stats["decode_tokens_per_s"] > 0


@pytest.mark.parametrize("what,jserve,tserve", [
    ("speculative", dict(spec=JSpecConfig(drafter="ngram")),
     dict(spec=TSpecConfig(drafter="ngram"))),
    ("prefix caching", dict(prefix_cache=True), dict(prefix_cache=True)),
    ("KV quantization", dict(kv_quant="int8"), dict(kv_quant="int8")),
    ("preemption", dict(slo=JSLOConfig(preemption=True)), dict(slo=TSLOConfig(preemption=True))),
    ("mesh serving", dict(mesh=(("data", 1), ("expert", 1))),
     dict(mesh=(("data", 1), ("expert", 1)))),
])
def test_recurrent_refusals_match_reference(what, jserve, tserve):
    """What needs the paged cache is refused for a recurrent family, with
    the reference's message."""
    jcfg, tcfg = _serving_cfgs("test_serving")
    _, tp = _params(jcfg, tcfg)
    with pytest.raises(NotImplementedError, match=what) as jerr:
        JEngine(jcfg, None, JServeConfig(max_len=32, **jserve))
    with pytest.raises(NotImplementedError, match=what) as terr:
        TEngine(tcfg, tp, TServeConfig(max_len=32, **tserve), device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_serve_cli_serves_reference_tokens(monkeypatch):
    """The serve CLI at smoke size on the CPU, both engines, over the
    reference's params: the batch's greedy tokens identical to the
    reference's continuous engine on the CLI's prompts."""
    from repro_torch.launch import serve

    jcfg, tcfg = _smoke()
    jp, tp = _params(jcfg, tcfg)
    monkeypatch.setattr(serve, "init_params", lambda cfg, seed, device: tp)
    got = {}
    for cls in (serve.ContinuousEngine, serve.ServingEngine):
        real = cls.generate

        def capture(self, *a, _real=real, _name=cls.__name__, **kw):
            out = _real(self, *a, **kw)
            got[_name] = out[0]
            return out

        monkeypatch.setattr(cls, "generate", capture)
    argv = ["--arch", "xlstm-125m", "--smoke", "--batch", "3", "--prompt-len", "6", "--gen", "5",
            "--device", "cpu"]
    serve.main(argv + ["--engine", "continuous", "--max-slots", "2"])
    serve.main(argv + ["--engine", "static"])
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (3, 6)).astype(np.int32)
    want, _ = JEngine(jcfg, jp, JServeConfig(max_slots=2, max_len=32)).generate(
        jnp.asarray(prompts), 5)
    np.testing.assert_array_equal(got["ContinuousEngine"], np.asarray(want))
    np.testing.assert_array_equal(got["ServingEngine"], np.asarray(want))


# ---------------------------------------------------------------------------
# Training and checkpoints
# ---------------------------------------------------------------------------

def test_train_cli_two_steps_match_reference(monkeypatch):
    """The port's train CLI, 2 steps at batch 2 x 80 (the chunked mLSTM form
    and the sLSTM loop), from the reference's params, against the
    reference's trainer with the train config the reference's CLI builds
    for these flags (AdamW, lr 8e-5, warmup 1) on its pipeline's batches:
    loss, ce and grad norm within rtol 1e-5 a step.  (The reference's CLI
    itself cannot train xlstm on this jax version: its debug mesh's
    sharding rules refuse the embedding gather.)"""
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.data.pipeline import make_pipeline as j_pipeline
    from repro.optim import make_optimizer as j_make_optimizer
    from repro.optim import warmup_constant as j_warmup
    from repro.train.trainer import make_train_step as j_make_train_step
    from repro_torch.launch import train

    jcfg, tcfg = _smoke()
    jp = jinit(j_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
    monkeypatch.setattr(train, "init_params", lambda cfg, seed, device, train: from_jax_params(
        jax.device_get(jp), cfg, device=device, train=train))
    tlogs = train.main(["--arch", "xlstm-125m", "--smoke", "--steps", "2", "--batch", "2",
                        "--seq", "80", "--log-every", "1", "--device", "cpu"])
    jtc = JTrainConfig(optimizer="adamw", learning_rate=8e-5, warmup_steps=1)
    jopt = j_make_optimizer(jtc, j_warmup(8e-5, 1))
    jstep = jax.jit(j_make_train_step(jcfg, jtc, jopt))
    jstate = j_init_train_state(jp, jopt)
    pipe = j_pipeline(jcfg, 2, 80, seed=0)
    assert len(tlogs) == 2
    for i, tm in enumerate(tlogs):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()})
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(tm[key], float(jm[key]), rtol=1e-5, err_msg=key)
        assert abs(tm["loss"] - np.log(jcfg.vocab_size)) < 1.0


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize])


def _list_tree_cfgs(case):
    if case == "xlstm":
        return _smoke()
    return tuple(m.smoke().replace(moe_layer_period=2, num_layers=3) for m in (jm6, tm6))


@pytest.mark.parametrize("case", ["xlstm", "mixed_stack"])
def test_list_tree_checkpoints_read_both_ways(tmp_path, case):
    """A TrainState whose params hold a per-layer list of blocks (xLSTM's,
    an m6 stack at moe_layer_period=2), with random AdamW moments: the
    reference's checkpoint restores in the port bit-equal, under keys such
    as ``['blocks'][0]['ffn']['up']``, and the port's checkpoint of that
    state restores in the reference bit-equal, file for file the same
    bytes (leaves numbered in the reference's order: block 10 after 9)."""
    jcfg, tcfg = _list_tree_cfgs(case)
    if case == "xlstm":
        jcfg, tcfg = jcfg.replace(num_layers=12), tcfg.replace(num_layers=12)
    params = jinit(j_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
    jstate = j_init_train_state(params, jadamw(lambda s: 1e-3))
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 4096))
    rand = lambda x: jax.random.normal(next(keys), x.shape, x.dtype)   # noqa: E731
    jstate = jstate._replace(opt_state={"mu": jax.tree_util.tree_map(rand, jstate.opt_state["mu"]),
                                        "nu": jax.tree_util.tree_map(rand, jstate.opt_state["nu"])},
                             step=jnp.asarray(2, jnp.int32))
    JCheckpointer(str(tmp_path / "ref")).save(2, jstate)
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}

    from repro_torch.nn import init_params
    tstate = init_train_state(init_params(tcfg, seed=3, device="cpu", train=True),
                              tadamw(lambda s: 1e-3))
    tstate = Checkpointer(str(tmp_path / "ref")).restore(2, tstate)
    got = {}
    for path, t in flat_params(tstate.params).items():
        got[".params" + jax_key(path)] = t
        for m in ("mu", "nu"):
            got[f".opt_state['{m}']" + jax_key(path)] = tstate.opt_state[m][path]
    assert set(got) | {".step"} == set(want) and tstate.step == 2
    assert ".params['blocks'][10]['up_x']" in got if case == "xlstm" else \
        ".params['blocks'][1]['ffn']['up']['kernel']" in got
    for key, t in got.items():
        np.testing.assert_array_equal(_bits(t), _bits(want[key]), err_msg=key)

    Checkpointer(str(tmp_path / "port")).save(2, tstate)
    back = JCheckpointer(str(tmp_path / "port")).restore(2, jax.eval_shape(lambda: jstate))
    for p, arr in jax.tree_util.tree_flatten_with_path(back)[0]:
        key = jax.tree_util.keystr(p)
        np.testing.assert_array_equal(_bits(arr), _bits(want[key]), err_msg=key)
    a, b = tmp_path / "ref" / "step_2", tmp_path / "port" / "step_2"
    assert json.load(open(a / "manifest.json")) == json.load(open(b / "manifest.json"))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
