"""MoE attention (M6-T §3.4) and mixed dense/MoE stacks in the port against
the JAX reference, on the CPU.

Inputs are numpy-seeded; params are the reference's, carried across with
``from_jax_params`` (or, for one layer's attention experts, leaf for leaf).
Tolerances: ``moe_attention_apply`` outputs within atol = rtol 1e-4 and
its aux within 2e-5, the attention experts' gradients within 2e-4 (f32,
two einsum projections deep); ``lm_apply`` and two AdamW steps at
tests/test_torch_training.py's tolerances (logits 1e-4, aux 2e-5, loss,
ce and grad norm rtol 1e-5, parameters 2e-5); greedy tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import m6 as jm6
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core.context import MoEContext as JCtx
from repro.core.moe_attention import moe_attention_apply as j_moe_attention
from repro.core.moe_attention import moe_attention_specs
from repro.data import pipeline as jpipe
from repro.models.registry import get_family
from repro.models.transformer import lm_apply as j_lm_apply
from repro.nn import init as jinit
from repro.optim import make_optimizer as j_make_optimizer
from repro.optim import warmup_constant as j_warmup
from repro.serving.continuous import ContinuousEngine as JEngine
from repro.serving.request import Request as JRequest
from repro.train.state import init_train_state as j_init_state
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch.configs import m6 as tm6
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.core import moe_attention as tma
from repro_torch.core.context import MoEContext as TCtx
from repro_torch.core.moe import group_tokens
from repro_torch.core.routing import route
from repro_torch.models.transformer import decode_apply, init_caches
from repro_torch.models.transformer import lm_apply as t_lm_apply
from repro_torch.nn import flat_params, from_jax_params, lm_shapes
from repro_torch.optim import make_optimizer as t_make_optimizer
from repro_torch.optim import warmup_constant as t_warmup
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from repro_torch.serving.engine import ServingEngine as TStatic
from repro_torch.serving.request import Request as TRequest
from repro_torch.train.state import init_train_state as t_init_state
from repro_torch.train.trainer import make_train_step as t_make_train_step
from torch_threads import one_torch_thread  # noqa: F401

ROUTERS = [("topk", 1), ("prototype", 2), ("hash", 1), ("expert_choice", 1)]


def _attn_cfgs(routing="topk", k=1, **moe):
    """m6 smoke with MoE attention, routed as ``variant`` routes it."""
    return (jm6.variant(jm6.smoke(), routing, k).replace_moe(moe_attention=True, **moe),
            tm6.variant(tm6.smoke(), routing, k).replace_moe(moe_attention=True, **moe))


def _attn_params(jcfg, seed=0):
    jp = jinit(moe_attention_specs(jcfg), jax.random.PRNGKey(seed))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jax.device_get(jp).items()}


def _inputs(cfg, B=2, S=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    return x, tokens, positions


def _run_both(jcfg, tcfg, jp, tp, x, tokens, positions):
    jctx = JCtx().with_tokens(jnp.asarray(tokens), jnp.asarray(positions))
    tctx = TCtx().with_tokens(torch.from_numpy(tokens), torch.from_numpy(positions))
    jy, jaux = j_moe_attention(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(positions),
                               ctx=jctx)
    ty, taux = tma.moe_attention_apply(tp, torch.from_numpy(x), tcfg,
                                       positions=torch.from_numpy(positions), ctx=tctx)
    return (jy, jaux), (ty, taux)


@pytest.mark.parametrize("routing,k", ROUTERS)
def test_moe_attention_forward_matches_reference(routing, k):
    """Outputs within atol = rtol 1e-4 and the aux within 2e-5, under each
    router; the hash router sees a positions-only context (its position
    hash) on both sides."""
    jcfg, tcfg = _attn_cfgs(routing, k)
    jp, tp = _attn_params(jcfg)
    # the port's layer tree (less its layer axis) is the reference's specs'
    spec = lm_shapes(tcfg)["blocks"]["attn"]
    assert {n: s.shape[1:] for n, s in spec.items()} == {n: tuple(v.shape) for n, v in tp.items()}
    assert ("router" in tp) == (routing != "hash")
    (jy, jaux), (ty, taux) = _run_both(jcfg, tcfg, jp, tp, *_inputs(tcfg))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    assert set(taux) == set(jaux)
    for key in jaux:
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(jaux[key]), atol=2e-5,
                                   rtol=2e-5, err_msg=key)


@pytest.mark.parametrize("routing,k", ROUTERS)
def test_moe_attention_gradients_match_reference(routing, k):
    """The gradient of every attention expert weight (and the router's)
    under one numpy-seeded cotangent, within 2e-4."""
    jcfg, tcfg = _attn_cfgs(routing, k)
    jp, tp = _attn_params(jcfg)
    x, tokens, positions = _inputs(tcfg)
    cot = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    jctx = JCtx().with_tokens(jnp.asarray(tokens), jnp.asarray(positions))

    def jf(p):
        return j_moe_attention(p, jnp.asarray(x), jcfg, positions=jnp.asarray(positions),
                               ctx=jctx)[0]

    _, vjp = jax.vjp(jf, jp)
    jg = vjp(jnp.asarray(cot))[0]
    tp = {k_: v.requires_grad_(True) for k_, v in tp.items()}
    tctx = TCtx().with_tokens(torch.from_numpy(tokens), torch.from_numpy(positions))
    ty, _ = tma.moe_attention_apply(tp, torch.from_numpy(x), tcfg,
                                    positions=torch.from_numpy(positions), ctx=tctx)
    (ty * torch.from_numpy(cot)).sum().backward()
    for name in tp:
        np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(jg[name]), atol=2e-4,
                                   rtol=2e-4, err_msg=name)
    assert float(np.abs(np.asarray(jg["wq"])).max()) > 0


def test_moe_attention_applies_rope_under_learned_positions():
    """The reference's quirk, mirrored: m6 has learned positions, yet MoE
    attention rotates q and k by RoPE, so spreading the positions apart
    (which changes their distances; RoPE sees only those) moves its output,
    where attention under learned positions alone would not move; the port
    moves with the reference."""
    jcfg, tcfg = _attn_cfgs()
    assert tcfg.pos_embed == "learned"
    jp, _ = _attn_params(jcfg)
    # q and k large enough that the scores, and so RoPE, matter
    jp = {k: v * 30.0 if k in ("wq", "wk") else v for k, v in jp.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x, tokens, positions = _inputs(tcfg)
    (jy0, _), (ty0, _) = _run_both(jcfg, tcfg, jp, tp, x, tokens, positions)
    (jy1, _), (ty1, _) = _run_both(jcfg, tcfg, jp, tp, x, tokens, positions * 3)
    jy0 = np.asarray(jy0)
    assert float(np.abs(np.asarray(jy1) - jy0).max()) > 0.01 * float(np.abs(jy0).max())
    np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), atol=1e-4, rtol=1e-4)


def test_moe_attention_ignores_qkv_bias_and_qk_norm():
    """The reference's quirk, mirrored: an MoE attention layer has no bias
    or q/k norm leaves under ``qkv_bias`` / ``qk_norm``, and computes what
    it computes without them."""
    jcfg, tcfg = _attn_cfgs()
    jq, tq = jcfg.replace(qkv_bias=True, qk_norm=True), tcfg.replace(qkv_bias=True,
                                                                      qk_norm=True)
    assert set(moe_attention_specs(jq)) == set(moe_attention_specs(jcfg))
    jp, tp = _attn_params(jcfg)
    args = _inputs(tcfg)
    (_, _), (ty, _) = _run_both(jcfg, tcfg, jp, tp, *args)
    (jyq, _), (tyq, _) = _run_both(jq, tq, jp, tp, *args)
    np.testing.assert_array_equal(tyq.numpy(), ty.numpy())
    np.testing.assert_allclose(tyq.numpy(), np.asarray(jyq), atol=1e-4, rtol=1e-4)
    assert "q_norm" not in lm_shapes(tq)["blocks"]["attn"]


def test_capacity_dropped_tokens_enter_attention_as_zero(monkeypatch):
    """The reference's quirk, mirrored: at capacity factor 0.25 some tokens
    find no slot; their q, k and v rows are exactly zero going into
    attention and their output rows exactly zero, and the port's output
    equals the reference's."""
    jcfg, tcfg = _attn_cfgs(capacity_factor=0.25)
    jp, tp = _attn_params(jcfg)
    x, tokens, positions = _inputs(tcfg)
    seen = {}
    real = tma._sdpa

    def spy(q, k, v, *a, **kw):
        seen.update(q=q, k=k, v=v)
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(tma, "_sdpa", spy)
    (jy, jaux), (ty, taux) = _run_both(jcfg, tcfg, jp, tp, x, tokens, positions)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    xg, G = group_tokens(torch.from_numpy(x), tcfg.moe)
    plan = route(xg, tp["router"], tcfg.moe, tcfg.moe.capacity(xg.shape[1]))
    dropped = ~plan.valid.any(dim=-1).reshape(x.shape[0], x.shape[1])
    assert 0 < int(dropped.sum()) < dropped.numel()
    assert float(taux["moe_dropped_fraction"]) > 0
    for name in ("q", "k", "v"):
        assert (seen[name][dropped] == 0).all(), name
        assert (seen[name][~dropped].abs().amax(dim=(-1, -2)) > 0).all(), name
    assert (ty[dropped] == 0).all() and (np.asarray(jy)[dropped.numpy()] == 0).all()


# ---------------------------------------------------------------------------
# In the model: MoE attention and mixed stacks
# ---------------------------------------------------------------------------

MODEL_CASES = {
    "moe_attention": dict(moe=dict(moe_attention=True)),
    "moe_attention_prototype": dict(moe=dict(moe_attention=True, routing="prototype",
                                             num_prototypes=2)),
    "mixed_period_2": dict(cfg=dict(moe_layer_period=2, num_layers=3)),
    "mixed_moe_attention": dict(cfg=dict(moe_layer_period=2, num_layers=3),
                                moe=dict(moe_attention=True)),
}


def _model_cfgs(case, impl="pallas"):
    c = MODEL_CASES[case]
    return tuple(m.smoke().replace(**c.get("cfg", {})).replace_moe(impl=impl, **c.get("moe", {}))
                 for m in (jm6, tm6))


def _model_params(jcfg, tcfg, train=False, seed=0):
    jp = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(seed))
    return jp, from_jax_params(jax.device_get(jp), tcfg, device="cpu", train=train)


def _jflat(tree):
    return {jax.tree_util.keystr(path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_param_tree_matches_reference(case):
    """Key for key and shape for shape: the stacked (L, ...) tree for a
    uniform stack, the per-layer list for a mixed one."""
    from repro_torch.checkpoint import jax_key

    jcfg, tcfg = _model_cfgs(case)
    abstract = jax.eval_shape(lambda: jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0)))
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    got = {jax_key(p): tuple(s.shape) for p, s in flat_params(lm_shapes(tcfg, True)).items()}
    assert got == want
    assert isinstance(lm_shapes(tcfg)["blocks"], list) == (tcfg.moe_layer_period != 1)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_lm_apply_matches_reference(case):
    """m6 smoke, 4 patch embeddings + 32 tokens: logits within 1e-4 and every
    aux entry within 2e-5 (a dense layer contributes zeros)."""
    jcfg, tcfg = _model_cfgs(case)
    jp, tp = _model_params(jcfg, tcfg)
    b = jpipe.make_pipeline(jcfg, 3, 36, seed=2).batch_at(0)
    jl, jaux = j_lm_apply(jp, jnp.asarray(b["tokens"]), jcfg,
                          extra_embeds=jnp.asarray(b["patch_embeds"]))
    with torch.no_grad():
        tl, taux = t_lm_apply(tp, torch.from_numpy(b["tokens"]), tcfg,
                              extra_embeds=torch.from_numpy(b["patch_embeds"]))
    V = jcfg.vocab_size
    np.testing.assert_allclose(tl[..., :V].numpy(), np.asarray(jl)[..., :V], atol=1e-4, rtol=1e-4)
    assert set(jaux) == set(taux)
    for key in jaux:
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(jaux[key]), atol=2e-5,
                                   rtol=2e-5, err_msg=key)


@pytest.mark.parametrize("case", ["moe_attention", "mixed_period_2"])
def test_train_steps_match_reference(case):
    """Two AdamW steps (lr 1e-3, 2-step warmup) through both trainers, the
    FFN on the grouped-FFN dispatcher: loss, ce and grad norm within rtol
    1e-5 a step, every parameter after the last step within 2e-5."""
    jcfg, tcfg = _model_cfgs(case)
    jp, tp = _model_params(jcfg, tcfg, train=True)
    kw = dict(learning_rate=1e-3, warmup_steps=2)
    jtc, ttc = JTrainConfig(**kw), TTrainConfig(**kw)
    jopt = j_make_optimizer(jtc, j_warmup(1e-3, 2))
    topt = t_make_optimizer(ttc, t_warmup(1e-3, 2))
    jstate, tstate = j_init_state(jp, jopt), t_init_state(tp, topt)
    jstep, tstep = jax.jit(j_make_train_step(jcfg, jtc, jopt)), t_make_train_step(tcfg, ttc, topt)
    pipe = jpipe.make_pipeline(jcfg, 4, 36, seed=0)
    for i in range(2):
        b = pipe.batch_at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    from repro_torch.checkpoint import jax_key

    jflat = _jflat(jstate.params)
    tflat = {jax_key(p): t for p, t in flat_params(tstate.params).items()}
    assert set(jflat) == set(tflat)
    for key, t in tflat.items():
        np.testing.assert_allclose(t.detach().numpy(), jflat[key], atol=2e-5, rtol=0, err_msg=key)


def _mixed_serving_cfgs():
    jcfg, tcfg = _model_cfgs("mixed_period_2", impl="dropless")
    return (jcfg.replace_moe(capacity_factor=None), tcfg.replace_moe(capacity_factor=None))


def test_mixed_stack_engines_greedy_tokens_equal_reference():
    """m6 smoke at moe_layer_period=2 (MoE in layers 0 and 2), dropless:
    the continuous engine's greedy tokens on 4 requests over 2 slots and
    the static engine's on an equal-length batch, each identical to the
    reference's continuous engine (the reference's static prefill omits
    m6's learned positions; ROADMAP queue 3)."""
    jcfg, tcfg = _mixed_serving_cfgs()
    jp, tp = _model_params(jcfg, tcfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in (5, 9, 3, 12)]
    kw = dict(max_slots=2, max_len=32, prefill_chunk=8, kv_block_size=4)
    jout, _ = JEngine(jcfg, jp, JServeConfig(**kw)).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])
    tout, stats = TEngine(tcfg, tp, TServeConfig(**kw), device="cpu",
                          check_invariants=True).run(
        [TRequest(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])
    assert {u: list(map(int, v)) for u, v in tout.items()} == \
        {u: list(map(int, v)) for u, v in jout.items()}
    assert stats["moe_dropped_fraction"] == 0.0
    batch = rng.integers(0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    jtoks, _ = JEngine(jcfg, jp, JServeConfig(**kw)).generate(jnp.asarray(batch), 6)
    ttoks, _ = TStatic(tcfg, tp, max_len=32).generate(batch, 6)
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))


# ---------------------------------------------------------------------------
# variant() and the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("routing", ["topk", "prototype", "expert_choice", "hash"])
def test_variant_matches_reference(routing):
    for k in (1, 2, 4):
        for mode in ("k", "one"):
            for jbase, tbase in ((jm6.M6_BASE, tm6.M6_BASE), (jm6.smoke(), tm6.smoke())):
                assert dataclasses.asdict(tm6.variant(tbase, routing, k, mode)) == \
                    dataclasses.asdict(jm6.variant(jbase, routing, k, mode))


def test_moe_attention_refusals():
    """Both engines refuse MoE attention (no cached decode path), as does a
    cached decode step; dropless capacity with MoE attention is refused in
    both packages' configs."""
    jcfg, tcfg = _model_cfgs("moe_attention")
    tp = from_jax_params(jax.device_get(jinit(get_family(jcfg).specs(jcfg),
                                              jax.random.PRNGKey(0))), tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="moe_attention"):
        JEngine(jcfg, None, JServeConfig(max_len=32))
    with pytest.raises(NotImplementedError, match="moe_attention"):
        TEngine(tcfg, tp, TServeConfig(max_len=32), device="cpu")
    with pytest.raises(NotImplementedError, match="moe_attention"):
        TStatic(tcfg, tp, max_len=32)
    with pytest.raises(NotImplementedError, match="moe_attention"), torch.inference_mode():
        decode_apply(tp, torch.zeros((1, 1), dtype=torch.long), init_caches(tcfg, 1, 8), tcfg)
    for m in (jm6, tm6):
        with pytest.raises(ValueError, match="moe_attention"):
            m.smoke().replace_moe(moe_attention=True, impl="dropless", capacity_factor=None)


def test_chip_smoke_more_families_phase_runs_on_cpu(capsys):
    """chip_smoke's phase 13 rehearsed at smoke size on the CPU (the
    kernels' plain versions on both sides, so no routing may flip and no
    token may differ): (a) both Fig. 4 MoE-attention runs, 2 steps each
    with the kernels-vs-plain step; (b) the mixed stack's continuous and
    static serving and training; (c) xlstm's recurrent slots, static
    generate and training."""
    import importlib.util
    import os

    from repro_torch.configs import registry as treg
    from repro_torch.serving.trace import synthetic_trace

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    m6_argv = ["--arch", "m6-base", "--smoke", "--moe-impl", "pallas", "--batch", "2", "--seq",
               "36", "--log-every", "1"]
    for label, edit in cs.fig4_edits():
        report, _ = cs.edited_train(torch, m6_argv, edit, 2, "cpu", label)
        assert report["kernels_vs_plain"]["routing_flips"] == 0
        assert report["kernels_vs_plain"]["loss"] == report["kernels_vs_plain"]["plain_loss"]
    mixed = tm6.smoke().replace(moe_layer_period=2, num_layers=3).replace_moe(
        impl="dropless", capacity_factor=None)
    requests = synthetic_trace(4, mixed.vocab_size, seed=0, prompt_lens=(4, 12), gen_lens=(3, 6))
    report, _ = cs.mixed_stack_runs(
        torch, mixed, "cpu", m6_argv, requests=requests, max_len=32,
        train_edit=lambda c: c.replace(moe_layer_period=2, num_layers=3), shape=(3, 10, 4))
    assert report["continuous"]["requests_equal_to_plain"] == 4
    assert report["static"]["rows_equal"] == 3
    assert len(report["train"]["losses"]) == cs.MIXED_TRAIN_STEPS
    xl_argv = ["--arch", "xlstm-125m", "--smoke", "--batch", "2", "--seq", "80", "--log-every", "1"]
    report = cs.xlstm_runs(torch, treg.get_smoke_config("xlstm-125m"), "cpu", xl_argv,
                           n_requests=4, shape=(3, 8, 4))
    assert report["static"]["rows_equal"] == 3 and report["continuous"]["steps"] > 0
    assert len(report["train"]["losses"]) == cs.XLSTM_TRAIN_STEPS
    assert "near-tie" not in capsys.readouterr().out
