"""The static engine's compiled steps and the continuous engine's
recurrent step against the JAX reference's jitted ones, on the CPU.

On the card each step form is a captured CUDA graph; here a form runs its
body eagerly over the same buffers it owns for the engine's life, built
at its first use as the reference's jit compiles a shape at its first
call.  So: the cache length is a 0-dim int32 tensor on the cache's
device for every family, and the prefill and decode that read and
advance it there give the reference's caches, lengths and logits (f32;
tolerances where used); the static decode and prefill bodies and the
recurrent step and slot reset read no host value (run on ``meta`` under a
dispatch mode that refuses a host read or a host tensor); the census
``compiled_variants()`` equals the reference's jit-cache sizes after the
same calls; a form reused across ``generate`` calls gives a fresh
engine's tokens; and the slot reset zeroes the slot's rows as the
reference's ``_reset_fn`` does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import m6 as jm6
from repro.configs import registry as jreg
from repro.configs.base import ServeConfig as JServeConfig
from repro.models import encdec as JED
from repro.models import transformer as JTF
from repro.models.registry import get_family as j_family
from repro.nn import init as jinit
from repro.serving.continuous import ContinuousEngine as JEngine
from repro.serving.engine import ServingEngine as JStatic
from repro_torch.configs import m6 as tm6
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.models import encdec as TED
from repro_torch.models import transformer as TTF
from repro_torch.models.registry import get_family as t_family
from repro_torch.nn import abstract, from_jax_params
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from repro_torch.serving.engine import ServingEngine as TStatic
from test_torch_compiled_step import _NoHostReads
from torch_threads import one_torch_thread  # noqa: F401

MOE = {"topk dropless": dict(impl="dropless", capacity_factor=None),
       "hash dropless": dict(routing="hash", impl="dropless", capacity_factor=None)}


def _m6_rope(**moe):
    """m6 smoke at initializer_range 0.3 with RoPE positions: the
    reference's ``prefill_apply`` omits learned positions (see
    ``test_torch_static_engine.py``), so its prefill is held on RoPE."""
    return tuple(c.smoke().replace(initializer_range=0.3, pos_embed="rope").replace_moe(**moe)
                 for c in (jm6, tm6))


def _smoke(arch):
    return jreg.get_smoke_config(arch), treg.get_smoke_config(arch)


def _params(jcfg, tcfg, seed=0):
    jp = jinit(j_family(jcfg).specs(jcfg), jax.random.PRNGKey(seed))
    return jp, from_jax_params(jax.device_get(jp), tcfg, device="cpu")


def _toks(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _close(t, j, tol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol, rtol=tol, err_msg=what)


def _is_length(length, value):
    """A 0-dim int32 tensor on the CPU holding ``value``."""
    assert isinstance(length, torch.Tensor) and length.shape == () and length.dtype == torch.int32
    assert length.device.type == "cpu" and int(length) == value


# ---------------------------------------------------------------------------
# The device length against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moe", list(MOE))
def test_lm_prefill_and_decode_on_device_length(moe):
    """m6 (RoPE) under top-1 and hash dropless routing: the prefill into
    the engine's kept caches (``prefill_apply(caches=)``) and 4 decode
    steps, fed the reference's greedy tokens: logits and every layer's
    K/V within 1e-4 of the reference's ``prefill_apply`` / ``decode_apply``,
    and the length a 0-dim int32 tensor equal to the reference's."""
    jcfg, tcfg = _m6_rope(**MOE[moe])
    jp, tp = _params(jcfg, tcfg)
    prompts = _toks(jcfg, (3, 9), 1)
    jl, jc, _ = JTF.prefill_apply(jp, jnp.asarray(prompts), jcfg, max_len=20)
    jdecode = jax.jit(JTF.decode_apply, static_argnums=(3,))
    with torch.inference_mode():
        kept = TTF.init_caches(tcfg, 3, 20, device="cpu")
        _is_length(kept.length, 0)
        tl, tc, _ = TTF.prefill_apply(tp, torch.from_numpy(prompts).long(), tcfg, max_len=20,
                                      caches=kept)
        assert tc.k is kept.k and tc.v is kept.v          # filled in place
        for step in range(5):
            _close(tl[:, -1], jl[:, -1], 1e-4, f"logits, step {step}")
            _close(tc.k, jc.k, 1e-4, "k")
            _close(tc.v, jc.v, 1e-4, "v")
            _is_length(tc.length, 9 + step)
            assert (np.asarray(jc.length) == 9 + step).all()
            tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)[:, None]
            jl, jc = jdecode(jp, jnp.asarray(tok), jc, jcfg)
            tl, tc = TTF.decode_apply(tp, torch.from_numpy(tok).long(), tc, tcfg)


def test_zamba_decode_on_device_length():
    """zamba smoke: 6 decode steps from the zero state: logits within 3e-4
    (the reference's own decode tolerance), the shared applications' K/V
    within 1e-5, one 0-dim int32 length advanced once a step."""
    jcfg, tcfg = _smoke("zamba2-7b")
    jp, tp = _params(jcfg, tcfg)
    toks = _toks(jcfg, (2, 6), 2)
    V = jcfg.vocab_size
    jst = j_family(jcfg).init_state(jcfg, 2, 12)
    with torch.inference_mode():
        tst = t_family(tcfg).init_state(tcfg, 2, 12, device="cpu")
        _is_length(tst.attn.length, 0)
        for i in range(6):
            jl, jst = j_family(jcfg).decode(jp, jnp.asarray(toks[:, i:i + 1]), jst, jcfg)
            tl, tst = t_family(tcfg).decode(tp, torch.from_numpy(toks[:, i:i + 1]), tst, tcfg)
            _close(tl[..., :V], np.asarray(jl)[..., :V], 3e-4, f"logits, step {i}")
            _is_length(tst.attn.length, i + 1)
        _close(tst.attn.k, jst.attn.k, 1e-5, "k")
        _close(tst.attn.v, jst.attn.v, 1e-5, "v")
    assert (np.asarray(jst.attn.length) == 6).all()


def test_encdec_decode_step_on_device_length():
    """encdec smoke: 5 ``decode_step``s from ``init_state``: logits within
    3e-4 and the self caches within 1e-5 of the reference's, the length a
    0-dim int32 tensor; and the dry run's decode state at ``seq_len - 1``
    a 0-dim int32 ``meta`` tensor."""
    jcfg, tcfg = _smoke("seamless-m4t-large-v2")
    jp, tp = _params(jcfg, tcfg)
    frames = np.random.default_rng(3).standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    toks = _toks(jcfg, (2, 5), 4)
    V = jcfg.vocab_size
    jst = JED.init_state(jp, JED.encode(jp, jnp.asarray(frames), jcfg), jcfg, max_len=8)
    with torch.inference_mode():
        tst = TED.init_state(tp, TED.encode(tp, torch.from_numpy(frames), tcfg), tcfg, max_len=8)
        _is_length(tst.self_cache.length, 0)
        for i in range(5):
            jl, jst = JED.decode_step(jp, jnp.asarray(toks[:, i:i + 1]), jst, jcfg)
            tl, tst = TED.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]), tst, tcfg)
            _close(tl[..., :V], np.asarray(jl)[..., :V], 3e-4, f"logits, step {i}")
            _is_length(tst.self_cache.length, i + 1)
        _close(tst.self_cache.k, jst.self_cache.k, 1e-5, "k")
        _close(tst.self_cache.v, jst.self_cache.v, 1e-5, "v")
    from repro_torch.configs.base import ShapeConfig

    spec = t_family(tcfg).decode_input_specs(tcfg, ShapeConfig("decode", 6, 2, "decode"))
    length = spec["state"].self_cache.length
    assert length.device.type == "meta" and length.shape == () and length.dtype == torch.int32


# ---------------------------------------------------------------------------
# The forms read no host value
# ---------------------------------------------------------------------------

def _meta_static(tcfg, B=2, S=5, max_len=12):
    """A static engine over ``meta`` params and its forms' bodies run on
    ``meta`` under ``_NoHostReads``: the decode form's (and the prefill
    form's where the family has a prefill).  Returns the logits."""
    eng = TStatic(tcfg, abstract(tcfg), max_len=max_len)
    assert eng._graph_pool is None and eng.compiled_variants() == 0
    out = {}
    with torch.inference_mode():
        forms = {"decode": eng._decode_form(B)}
        if eng.fam.prefill is not None:
            forms["prefill"] = eng._prefill_form(B, S)
        for kind, form in forms.items():
            with _NoHostReads():
                out[kind] = form.body()
    assert eng.compiled_variants() == len(forms)
    return out


@pytest.mark.parametrize("impl", ["dropless", "pallas"])
def test_lm_bodies_read_no_host_value(impl):
    """m6 in bf16 (head_dim 32, a width the dense kernel takes) under the
    dropless and the grouped-FFN (``pallas``, capacity 1.25) dispatch: the
    decode and prefill bodies, the cache write at the device length and
    the length's advance included."""
    moe = dict(impl=impl, capacity_factor=None if impl == "dropless" else 1.25)
    cfg = tm6.smoke().replace(dtype="bfloat16", head_dim=32).replace_moe(**moe)
    out = _meta_static(cfg)
    assert out["decode"].shape[:2] == (2, 1) and out["prefill"].shape[:2] == (2, 5)
    assert all(t.device.type == "meta" for t in out.values())


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-125m"])
def test_recurrent_family_bodies_read_no_host_value(arch):
    """zamba (the shared attention at the device length, the Mamba2
    states in place) and xLSTM (its new states copied into the kept
    ones): the decode body."""
    cfg = treg.get_smoke_config(arch).replace(dtype="bfloat16")
    if arch == "zamba2-7b":
        cfg = cfg.replace(d_model=64, num_heads=4, num_kv_heads=4)     # D = 32
    out = _meta_static(cfg)
    assert out["decode"].shape[:2] == (2, 1) and out["decode"].device.type == "meta"


def test_recurrent_step_and_reset_read_no_host_value():
    """The continuous engine's recurrent forms on ``meta``: the (max_slots,
    1) step (decode, state copy, sampling at T > 0) and the slot reset."""
    cfg = treg.get_smoke_config("xlstm-125m")
    eng = TEngine(cfg, abstract(cfg), TServeConfig(max_slots=3, max_len=16), device="meta",
                  temperature=0.7)
    assert eng._graph_pool is None and eng.compiled_variants() == 0
    for kind in ("step", "reset"):
        form = eng._rec_form(kind)
        with _NoHostReads():
            out = form.body()
        if kind == "step":
            assert out["tokens"].shape == (3,) and out["tokens"].device.type == "meta"
    assert eng.compiled_variants() == 1           # the reset is not in the census


# ---------------------------------------------------------------------------
# The census, reuse and the reset
# ---------------------------------------------------------------------------

def _census(eng):
    return int(eng._decode._cache_size()) + (
        int(eng._prefill._cache_size()) if eng._prefill is not None else 0)


@pytest.mark.parametrize("arch", ["m6", "xlstm-125m"])
def test_census_matches_reference(arch):
    """Two ``generate``s of one shape, then a new prompt length, then a new
    batch: after each the port's ``compiled_variants()`` equals the
    reference's ``_decode`` + ``_prefill`` jit-cache sizes, and the
    greedy tokens are the reference's."""
    jcfg, tcfg = _m6_rope(**MOE["topk dropless"]) if arch == "m6" else _smoke(arch)
    jp, tp = _params(jcfg, tcfg)
    jeng, teng = JStatic(jcfg, jp, max_len=24), TStatic(tcfg, tp, max_len=24)
    assert teng.compiled_variants() == _census(jeng) == 0
    for shape, gen in (((2, 6), 4), ((2, 6), 3), ((2, 8), 4), ((3, 8), 2)):
        prompts = _toks(jcfg, shape, shape[1])
        jtoks, _ = jeng.generate(jnp.asarray(prompts), gen)
        ttoks, _ = teng.generate(prompts, gen)
        np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
        assert teng.compiled_variants() == _census(jeng), shape
    assert teng.compiled_variants() == (5 if arch == "m6" else 2)


@pytest.mark.parametrize("arch", ["m6", "zamba2-7b", "xlstm-125m"])
def test_reused_forms_give_a_fresh_engines_tokens(arch):
    """One engine serves four ``generate``s over its kept forms and state
    (a longer run first, then two seeds at T = 0.8, then greedy); each
    equals a fresh engine's run of the same call."""
    jcfg, tcfg = _m6_rope(**MOE["topk dropless"]) if arch == "m6" else _smoke(arch)
    _, tp = _params(jcfg, tcfg)
    eng = TStatic(tcfg, tp, max_len=20)
    calls = [(_toks(tcfg, (2, 7), 5), 9, 0.0, 0), (_toks(tcfg, (2, 7), 6), 5, 0.8, 1),
             (_toks(tcfg, (2, 7), 6), 5, 0.8, 2), (_toks(tcfg, (2, 7), 7), 5, 0.0, 0)]
    for prompts, gen, temperature, seed in calls:
        got, _ = eng.generate(prompts, gen, temperature=temperature, seed=seed)
        want, _ = TStatic(tcfg, tp, max_len=20).generate(prompts, gen, temperature=temperature,
                                                         seed=seed)
        np.testing.assert_array_equal(got, want)
    assert eng.compiled_variants() == (2 if arch == "m6" else 1)


def test_slot_reset_matches_reference():
    """After a run leaves every slot's xLSTM state nonzero, the reset form
    zeroes slot 1's rows and leaves the others as they were: the
    reference's ``_reset_fn`` on the same state, leaf for leaf."""
    jcfg, tcfg = _smoke("xlstm-125m")
    jp, tp = _params(jcfg, tcfg)
    serve = dict(max_slots=3, max_len=16)
    jeng = JEngine(jcfg, jp, JServeConfig(**serve))
    teng = TEngine(tcfg, tp, TServeConfig(**serve), device="cpu")
    teng.generate(_toks(tcfg, (3, 4), 8), 3)
    leaves = [t.clone() for t in torch.utils._pytree.tree_leaves(teng._state)]
    assert all(bool((t != 0).any(dim=tuple(range(1, t.dim()))).all()) for t in leaves)
    want = jeng._reset_fn([jnp.asarray(t.numpy()) for t in leaves], jnp.int32(1))
    teng._reset_slot(1)
    got = torch.utils._pytree.tree_leaves(teng._state)
    for g, w, before in zip(got, want, leaves):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert not g[1].any() and torch.equal(g[[0, 2]], before[[0, 2]])
    assert teng.compiled_variants() == 1
