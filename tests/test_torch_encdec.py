"""The encdec family (seamless-m4t-large-v2) in the port against the JAX
reference, on the CPU: the configs and the full parameter count, the param
tree and ``from_jax_params``, ``encode``, the teacher-forcing forward and
its aux, ``decode_step`` against the reference's and against teacher
forcing, for the dense decoder and the MoE decoder of
tests/test_models.py:111-136 under three dispatchers, two AdamW steps,
the train CLI, checkpoints read by the other package both ways, the
refusals with the reference's messages; and the logit softcap on the
static path: the dense decode kernel's plain versions against the
reference's ``_sdpa_reference``, the static engine's greedy tokens and
logits against the reference's ``ServingEngine``, and encdec's decode
under a cap.  A CPU rehearsal of chip_smoke's phase 15 closes the file.

Inputs are numpy-seeded; params are the reference's, carried across with
``from_jax_params``.  f32 throughout; tolerances are stated where they
are used.
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
from repro.configs import registry as jreg
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.models import encdec as JED
from repro.models.attention import _sdpa_reference as j_sdpa_reference
from repro.models.registry import get_family as j_family
from repro.nn import count_params as j_count
from repro.nn import init as jinit
from repro.optim.adamw import adamw as jadamw
from repro.serving.continuous import ContinuousEngine as JEngine
from repro.serving.engine import ServingEngine as JStatic
from repro.train.state import init_train_state as j_init_train_state
from repro_torch.checkpoint import Checkpointer, jax_key
from repro_torch.configs import m6 as tm6
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.decode_attention import ref as dref
from repro_torch.models import encdec as TED
from repro_torch.models.registry import get_family as t_family
from repro_torch.nn import count_params, encdec_shapes, flat_params, from_jax_params, model_shapes
from repro_torch.optim.adamw import adamw as tadamw
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from repro_torch.serving.engine import ServingEngine as TStatic
from repro_torch.train.state import init_train_state
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "seamless-m4t-large-v2"
FULL_PARAMS = 1_369_952_256
REFUSAL = "use encdec.init_state with real memory for concrete states"
# tests/test_models.py:92-136's model; "moe" adds its hash-routed decoder FFN
SMALL = dict(family="encdec", num_layers=2, num_encoder_layers=2, d_model=48, num_heads=4,
             num_kv_heads=4, d_ff=64, vocab_size=73, norm="layernorm", ffn_activation="relu",
             dtype="float32")
MOE = dict(num_experts=4, routing="hash", top_k=1, group_size=32, capacity_factor=16.0)
CASES = ["smoke", "moe einsum", "moe dropless", "moe pallas"]


def _cfgs(case="smoke", **kw):
    if case == "smoke":
        j, t = jreg.get_smoke_config(ARCH), treg.get_smoke_config(ARCH)
    elif case == "small":
        j, t = JModelConfig(**SMALL), TModelConfig(**SMALL)
    else:
        impl = case.split()[1]
        j = JModelConfig(**SMALL, moe=JMoEConfig(**MOE, impl=impl))
        t = TModelConfig(**SMALL, moe=TMoEConfig(**MOE, impl=impl))
    return j.replace(**kw), t.replace(**kw)


def _params(jcfg, tcfg, train=False, seed=0):
    jp = jinit(j_family(jcfg).specs(jcfg), jax.random.PRNGKey(seed))
    return jp, from_jax_params(jax.device_get(jp), tcfg, device="cpu", train=train)


def _inputs(cfg, B=2, S_src=6, S=7, seed=1):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S_src, cfg.d_model)).astype(np.float32)
    return frames, rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _jflat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(t, j, atol, err_msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol, rtol=0, err_msg=err_msg)


# ---------------------------------------------------------------------------
# Configs and the param tree
# ---------------------------------------------------------------------------

def test_config_and_param_count_match_reference():
    """The full and smoke configs field for field; 1,369,952,256 parameters
    in both packages from the shapes alone (24 + 24 layers, one table of
    256256 x 1024 that also unembeds)."""
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(treg, get)(ARCH)) == \
            dataclasses.asdict(getattr(jreg, get)(ARCH))
    full, jfull = treg.get_config(ARCH), jreg.get_config(ARCH)
    assert count_params(full) == j_count(j_family(jfull).specs(jfull)) == FULL_PARAMS
    assert treg.get_module(ARCH).CONFIG == full
    fam = t_family(full)
    assert fam.prefill is None and fam.decode is TED.decode_step


@pytest.mark.parametrize("case", ["full", "smoke", "moe einsum"])
def test_param_tree_matches_reference(case):
    """``encdec_shapes`` key for key and shape for shape against the
    reference's ``encdec_specs``; no ``unembed`` even where
    ``tie_embeddings`` is False, no ``pos_embed``."""
    if case == "full":
        jcfg, tcfg = jreg.get_config(ARCH), treg.get_config(ARCH)
    else:
        jcfg, tcfg = _cfgs(case)
    abstract = jax.eval_shape(lambda: jinit(JED.encdec_specs(jcfg), jax.random.PRNGKey(0)))
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    got = {jax_key(p): tuple(s.shape) for p, s in flat_params(encdec_shapes(tcfg)).items()}
    assert got == want
    assert model_shapes(tcfg) == encdec_shapes(tcfg)
    assert not tcfg.tie_embeddings and "['unembed']['table']" not in got
    assert "['pos_embed']" not in got
    if case == "full":
        assert got["['decoder']['cross_attn']['wq']['kernel']"] == (24, 1024, 1024)
        assert got["['encoder']['ffn']['up']['kernel']"] == (24, 1024, 8192)
        assert got["['embed']['table']"] == (256256, 1024)
    if case.startswith("moe"):
        assert got["['decoder']['ffn']['up']"] == (2, 4, 48, 64)


@pytest.mark.parametrize("train", [False, True])
def test_from_jax_params_carries_reference_params(train):
    """Every leaf of the reference's smoke params in the port's tree, equal
    in value, in the training tree's f32 or the serving tree's dtypes."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg, train=train)
    jflat, tflat = _jflat(jp), flat_params(tp)
    assert set(jflat) == set(tflat)
    for k, t in tflat.items():
        np.testing.assert_array_equal(t.float().numpy(), jflat[k].astype(np.float32), err_msg=k)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["smoke", "moe einsum"])
def test_encode_matches_reference(case):
    """The encoder's memory (bidirectional, RoPE at the frame positions)
    within 1e-5."""
    jcfg, tcfg = _cfgs(case)
    jp, tp = _params(jcfg, tcfg)
    frames, _ = _inputs(jcfg, S_src=9)
    jm = JED.encode(jp, jnp.asarray(frames), jcfg)
    with torch.no_grad():
        tm = TED.encode(tp, torch.from_numpy(frames), tcfg)
    _close(tm, jm, 1e-5)


@pytest.mark.parametrize("case", CASES)
def test_train_apply_matches_reference(case):
    """The family forward (``batch["frames"]``, ``batch["tokens"]``):
    logits within 1e-4 and every aux entry within 2e-5, the MoE decoder
    dropping nothing (tests/test_models.py:129)."""
    jcfg, tcfg = _cfgs(case)
    jp, tp = _params(jcfg, tcfg)
    frames, toks = _inputs(jcfg)
    batch = {"frames": frames, "tokens": toks}
    jl, jaux = j_family(jcfg).forward(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    with torch.no_grad():
        tl, taux = t_family(tcfg).forward(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                                          tcfg)
    V = jcfg.vocab_size
    assert tuple(tl.shape) == tuple(jl.shape)
    _close(tl[..., :V], np.asarray(jl)[..., :V], 1e-4)
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(taux[k], jaux[k], 2e-5, k)
    if jcfg.moe.num_experts:
        assert abs(float(taux["moe_dropped_fraction"].sum())) < 1e-6


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_reference_and_teacher_forcing(case):
    """tests/test_models.py:92-136 through both packages: 7 ``decode_step``s
    from ``init_state(max_len=8)``, logits within 3e-4 (the reference's own
    tolerance) of the reference's steps and of the port's teacher forcing;
    the self caches within 1e-5 of the reference's, their length 7, and
    the cross K/V of every layer within 1e-5."""
    jcfg, tcfg = _cfgs(case)
    jp, tp = _params(jcfg, tcfg)
    frames, toks = _inputs(jcfg)
    V = jcfg.vocab_size
    jstep = jax.jit(lambda p, t, s: JED.decode_step(p, t, s, jcfg))
    jst = JED.init_state(jp, JED.encode(jp, jnp.asarray(frames), jcfg), jcfg, max_len=8)
    with torch.inference_mode():
        full, _ = TED.encdec_train_apply(tp, torch.from_numpy(frames), torch.from_numpy(toks),
                                         tcfg)
        tst = TED.init_state(tp, TED.encode(tp, torch.from_numpy(frames), tcfg), tcfg, max_len=8)
        for f in ("cross_k", "cross_v"):
            _close(getattr(tst, f), getattr(jst, f), 1e-5, f)
        for i in range(7):
            jl, jst = jstep(jp, jnp.asarray(toks[:, i:i + 1]), jst)
            tl, tst = t_family(tcfg).decode(tp, torch.from_numpy(toks[:, i:i + 1]), tst, tcfg)
            _close(tl[..., :V], np.asarray(jl)[..., :V], 3e-4)
            _close(tl[:, 0, :V], full[:, i, :V], 3e-4)
    _close(tst.self_cache.k, jst.self_cache.k, 1e-5)
    _close(tst.self_cache.v, jst.self_cache.v, 1e-5)
    assert tst.self_cache.length == 7 and (np.asarray(jst.self_cache.length) == 7).all()
    assert tst.self_cache.k.shape == (2, 2, 8, tcfg.num_kv_heads, tcfg.resolved_head_dim)


@pytest.mark.parametrize("case", ["smoke", "moe dropless"])
def test_two_train_steps_match_reference(case):
    """Two AdamW steps (lr 1e-3, warmup 1) through each package's trainer
    from the same f32 params on the reference pipeline's batches, under
    remat: loss, ce and grad norm within rtol 1e-5 a step, every parameter
    after them within 5e-5 = lr / 20."""
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.data import pipeline as jpipe
    from repro.optim import make_optimizer as j_make_optimizer
    from repro.optim import warmup_constant as j_warmup
    from repro.train.trainer import make_train_step as j_make_train_step
    from repro_torch.configs.base import TrainConfig as TTrainConfig
    from repro_torch.optim import make_optimizer as t_make_optimizer
    from repro_torch.optim import warmup_constant as t_warmup
    from repro_torch.train.trainer import make_train_step as t_make_train_step

    jcfg, tcfg = _cfgs(case)
    assert tcfg.remat
    jp, tp = _params(jcfg, tcfg, train=True)
    kw = dict(learning_rate=1e-3, warmup_steps=1)
    jopt = j_make_optimizer(JTrainConfig(**kw), j_warmup(1e-3, 1))
    topt = t_make_optimizer(TTrainConfig(**kw), t_warmup(1e-3, 1))
    jstep = jax.jit(j_make_train_step(jcfg, JTrainConfig(**kw), jopt))
    tstep = t_make_train_step(tcfg, TTrainConfig(**kw), topt)
    jstate, tstate = j_init_train_state(jp, jopt), init_train_state(tp, topt)
    pipe = jpipe.make_pipeline(jcfg, 2, 12, seed=0)
    for i in range(2):
        b = pipe.batch_at(i)
        assert b["frames"].shape == (2, 12, jcfg.d_model) and b["frames"].dtype == np.float32
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    jflat, tflat = _jflat(jstate.params), flat_params(tstate.params)
    assert set(jflat) == set(tflat)
    for k, t in tflat.items():
        _close(t.detach(), jflat[k], 5e-5, k)


def test_train_cli_two_steps_match_reference(monkeypatch):
    """The port's train CLI, 2 steps at batch 2 x 12, from the reference's
    params, against the reference's trainer with the train config the
    reference's CLI builds for these flags (AdamW, lr 8e-5, warmup 1) on
    its pipeline's batches: loss, ce and grad norm within rtol 1e-5 a step,
    the loss within 1 of ln V.  (The reference's CLI itself is not run:
    its debug mesh's sharding constraint raises on this jax version, as
    for xlstm and zamba.)"""
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.data.pipeline import make_pipeline as j_pipeline
    from repro.optim import make_optimizer as j_make_optimizer
    from repro.optim import warmup_constant as j_warmup
    from repro.train.trainer import make_train_step as j_make_train_step
    from repro_torch.launch import train

    jcfg, _ = _cfgs()
    jp = jinit(j_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
    monkeypatch.setattr(train, "init_params", lambda cfg, seed, device, train: from_jax_params(
        jax.device_get(jp), cfg, device=device, train=train))
    tlogs = train.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2", "--seq", "12",
                        "--log-every", "1", "--device", "cpu"])
    jtc = JTrainConfig(optimizer="adamw", learning_rate=8e-5, warmup_steps=1)
    jopt = j_make_optimizer(jtc, j_warmup(8e-5, 1))
    jstep = jax.jit(j_make_train_step(jcfg, jtc, jopt))
    jstate = j_init_train_state(jp, jopt)
    pipe = j_pipeline(jcfg, 2, 12, seed=0)
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


def test_checkpoints_read_both_ways(tmp_path):
    """A TrainState of the smoke tree (``encoder/...`` and ``decoder/...``
    stacked) with random AdamW moments: the reference's checkpoint restores
    in the port bit-equal, and the port's checkpoint of it restores in the
    reference bit-equal, file for file the same bytes."""
    jcfg, tcfg = _cfgs()
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
    assert ".params['decoder']['cross_attn']['wq']['kernel']" in got
    assert ".params['encoder']['attn']['wk']['kernel']" in got
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


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_refusals_carry_the_reference_messages():
    """``ENCDEC.init_state`` on a concrete state, hence the static engine's
    ``generate``, with the reference's message (the reference asserts, the
    port raises NotImplementedError); the continuous engine with the
    reference's refusal word for word."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    with pytest.raises(NotImplementedError, match=REFUSAL):
        t_family(tcfg).init_state(tcfg, 2, 16, device="cpu")
    with pytest.raises(AssertionError, match=REFUSAL):
        j_family(jcfg).init_state(jcfg, 2, 16)
    prompts = _inputs(jcfg)[1]
    with pytest.raises(AssertionError, match=REFUSAL):
        JStatic(jcfg, jp, max_len=16).generate(jnp.asarray(prompts), 4)
    with pytest.raises(NotImplementedError, match=REFUSAL):
        TStatic(tcfg, tp, max_len=16).generate(prompts, 4)
    with pytest.raises(NotImplementedError) as jerr:
        JEngine(jcfg, jp, JServeConfig(max_len=32))
    with pytest.raises(NotImplementedError) as terr:
        TEngine(tcfg, tp, TServeConfig(max_len=32), device="cpu")
    assert str(terr.value) == str(jerr.value) and "encdec" in str(terr.value)


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_serve_cli_refuses_with_the_reference_reasons(engine):
    """``--arch seamless-m4t-large-v2`` resolves and each engine refuses it:
    the static one at ``init_state`` (one batch and a trace), the
    continuous one naming the family."""
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--smoke", "--engine", engine, "--device", "cpu"]
    match = REFUSAL if engine == "static" else "encdec needs per-request encoder memory"
    for extra in ([], ["--requests", "2"]):
        with pytest.raises(NotImplementedError, match=match):
            serve.main(argv + extra)


# ---------------------------------------------------------------------------
# The logit softcap on the static path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G,splits", [(1, 1), (1, 4), (4, 2)])
def test_dense_plain_versions_softcap_match_reference_sdpa(G, splits):
    """``decode_attention_ref`` and its split-and-merge version with a cap
    of 2 against the reference's ``_sdpa_reference`` under the same cap and
    a length mask, on q scaled so that scores reach about +-10, within
    1e-5; the cap moves the output by more than 1e-3; the wrapper's CPU
    path is the plain version and refuses a negative cap."""
    rng = np.random.default_rng(7)
    B, T, Hkv, D = 4, 37, 2, 16
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32) * 3.0
    k, v = (rng.standard_normal((B, T, Hkv, D)).astype(np.float32) for _ in range(2))
    lens = np.array([37, 1, 16, 23], np.int32)
    mask = (np.arange(T)[None, :] < lens[:, None])[:, None, None, None, :]
    jcfg = JModelConfig(attn_logit_softcap=2.0)
    want = j_sdpa_reference(jnp.asarray(q[:, None]), jnp.asarray(k), jnp.asarray(v), jcfg,
                            jnp.asarray(mask))[:, 0]
    args = [torch.from_numpy(a) for a in (q, k, v, lens)]
    got = dref.decode_attention_ref(*args, softcap=2.0)
    _close(got, want, 1e-5)
    _close(dref.decode_attention_split_ref(*args, splits, softcap=2.0), want, 1e-5)
    _close(da.decode_attention(*args, softcap=2.0), got, 0.0)
    assert (got - dref.decode_attention_ref(*args)).abs().max() > 1e-3
    with pytest.raises(ValueError, match="softcap"):
        da.decode_attention(*args, softcap=-1.0)


def _m6_rope_softcap(cap):
    """m6 smoke with RoPE positions (where the reference's static engine
    computes what it means to: test_torch_static_engine.py's module doc) at
    initializer_range 0.3, dropless MoE, softcap ``cap``."""
    moe = dict(impl="dropless", capacity_factor=None)
    return tuple(c.replace(initializer_range=0.3, pos_embed="rope", attn_logit_softcap=cap)
                 .replace_moe(**moe) for c in (jm6.smoke(), tm6.smoke()))


def _tapped(engine_cls, cfg, params, prompts, gen, max_len):
    """(tokens, the last step's f32 logits) of an engine's greedy generate."""
    seen = []
    real = engine_cls._sample

    def tap(self, logits, *a, **kw):
        seen.append(np.asarray(logits[:, -1, :]).astype(np.float32) if engine_cls is JStatic
                    else logits[:, -1, :].float().numpy())
        return real(self, logits, *a, **kw)

    engine_cls._sample = tap
    try:
        toks, _ = engine_cls(cfg, params, max_len=max_len).generate(prompts, gen)
    finally:
        engine_cls._sample = real
    return np.asarray(toks), seen[-1]


def test_static_engine_softcap_equals_reference():
    """The static engine serves a softcapped config (the cap 0.5 moves the
    last logits by more than 1e-3): greedy tokens identical to the
    reference's ``ServingEngine``, and the last step's logits within 1e-4."""
    jcfg, tcfg = _m6_rope_softcap(0.5)
    jp, tp = _params(jcfg, tcfg)
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    jt, jl = _tapped(JStatic, jcfg, jp, jnp.asarray(prompts), 8, 24)
    with torch.inference_mode():
        tt, tl = _tapped(TStatic, tcfg, tp, prompts, 8, 24)
        _, tl0 = _tapped(TStatic, tcfg.replace(attn_logit_softcap=0.0), tp, prompts, 8, 24)
    np.testing.assert_array_equal(tt, jt)
    V = jcfg.vocab_size
    _close(tl[:, :V], jl[:, :V], 1e-4)
    assert np.abs(tl[:, :V] - tl0[:, :V]).max() > 1e-3


@pytest.mark.parametrize("case", ["smoke", "moe dropless"])
def test_encdec_decode_softcap_matches_reference(case):
    """Encdec's 7 decode steps under a cap of 0.5 (self- and cross-attention
    on the dense decode kernel's plain version, teacher forcing on
    ``_sdpa``) at initializer_range 0.3: logits within 3e-4 of the
    reference's steps and of teacher forcing; the cap moves them by more
    than 1e-3."""
    jcfg, tcfg = _cfgs(case, attn_logit_softcap=0.5, initializer_range=0.3)
    jp, tp = _params(jcfg, tcfg)
    frames, toks = _inputs(jcfg)
    V = jcfg.vocab_size
    jstep = jax.jit(lambda p, t, s: JED.decode_step(p, t, s, jcfg))
    jst = JED.init_state(jp, JED.encode(jp, jnp.asarray(frames), jcfg), jcfg, max_len=8)
    with torch.inference_mode():
        tframes, ttoks = torch.from_numpy(frames), torch.from_numpy(toks)
        full, _ = TED.encdec_train_apply(tp, tframes, ttoks, tcfg)
        plain, _ = TED.encdec_train_apply(tp, tframes, ttoks, tcfg.replace(attn_logit_softcap=0))
        assert (full - plain)[..., :V].abs().max() > 1e-3
        tst = TED.init_state(tp, TED.encode(tp, tframes, tcfg), tcfg, max_len=8)
        for i in range(7):
            jl, jst = jstep(jp, jnp.asarray(toks[:, i:i + 1]), jst)
            tl, tst = TED.decode_step(tp, ttoks[:, i:i + 1], tst, tcfg)
            _close(tl[..., :V], np.asarray(jl)[..., :V], 3e-4)
            _close(tl[:, 0, :V], full[:, i, :V], 3e-4)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 15, rehearsed
# ---------------------------------------------------------------------------

def test_chip_smoke_encdec_phase_runs_on_cpu(capsys):
    """chip_smoke's phase 15 rehearsed at smoke size on the CPU (the
    kernels' plain versions on both sides, so no token may differ): (a) the
    greedy decode loop, (c) two train CLI steps, (d) both engines'
    refusals through the serve CLI, (e) m6's static engine under a softcap;
    (b) needs the card."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = treg.get_smoke_config(ARCH)
    static_cfg = tm6.smoke().replace_moe(impl="dropless", capacity_factor=None).replace(
        attn_logit_softcap=cs.STATIC_SOFTCAP)
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "12", "--log-every", "1"]
    report, _ = cs.encdec_runs(torch, cfg, "cpu", argv, static_cfg,
                               cli_argv=("--arch", ARCH, "--smoke"), shape=(3, 16, 12), feed=4,
                               static_shape=(3, 10, 4))
    decode = report["(a) decode"]
    assert decode["rows_equal_to_plain"] == 3 and decode["steps"] == 11
    assert len(report["(c) train"]["losses"]) == cs.ENCDEC_TRAIN_STEPS
    assert report["(d) serve CLI refusals"]["static"] == REFUSAL
    assert report["(e) static softcap"]["rows_equal_to_plain"] == 3
    assert report["params"] == count_params(cfg)
    assert "near-tie" not in capsys.readouterr().out
