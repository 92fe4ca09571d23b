"""The port's chunked online-softmax attention and its backward against the
JAX reference on the CPU.

The same numpy inputs go through ``repro.models.chunked_attention`` (a
``lax.scan`` under a ``custom_vjp``) and ``repro_torch.models.
chunked_attention`` (a ``torch.autograd.Function``): outputs and dq / dk /
dv under one random cotangent within atol 2e-4, the tolerance of
``tests/test_kernels.py::test_chunked_attention_grads_match_reference``;
inside the model within 3e-4, that of
``tests/test_models.py::test_chunked_attention_in_model_matches_reference``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import attention as jattn
from repro.models import transformer as JTF
from repro.models.chunked_attention import chunked_attention as j_chunked
from repro.nn import init as jinit
from repro.optim import make_optimizer as j_make_optimizer
from repro.optim import warmup_constant as j_warmup
from repro.train.state import init_train_state as j_init_state
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.models import attention as tattn
from repro_torch.models import chunked_attention as tchunk
from repro_torch.models import transformer as TTF
from repro_torch.nn import flat_params, from_jax_params
from repro_torch.optim import make_optimizer as t_make_optimizer
from repro_torch.optim import warmup_constant as t_warmup
from repro_torch.train.state import init_train_state as t_init_state
from repro_torch.train.trainer import make_train_step as t_make_train_step
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-4

# (B, S, T, Hkv, G, D, causal, static offset, dynamic offset, block, softcap)
CASES = {
    "causal": (2, 40, 40, 2, 2, 16, True, 0, None, 16, 0.0),
    "bidirectional": (2, 24, 40, 2, 3, 16, False, None, None, 16, 0.0),
    "static offset": (2, 8, 48, 2, 2, 16, True, 30, None, 16, 0.0),
    "dynamic offset": (1, 6, 40, 1, 5, 8, True, None, 17, 8, 0.0),
    "softcap": (2, 32, 32, 2, 2, 16, True, 0, None, 8, 5.0),
    "softcap bidirectional": (1, 16, 24, 2, 1, 32, False, None, None, 12, 3.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_attention_and_grads_match_reference(case):
    B, S, T, H, G, D, causal, static, dyn, block, cap = CASES[case]
    rng = np.random.default_rng(len(case) * 7 + S)
    q = rng.standard_normal((B, S, H, G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, H, D)).astype(np.float32)
    v = rng.standard_normal((B, T, H, D)).astype(np.float32)
    cot = rng.standard_normal((B, S, H, G, D)).astype(np.float32)
    joff = None if dyn is None else jnp.asarray(dyn, jnp.int32)

    def jf(q_, k_, v_):
        return j_chunked(q_, k_, v_, causal, static, block, cap, q_offset=joff)

    jout, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(cot))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    toff = (static or 0) if dyn is None else torch.tensor(dyn, dtype=torch.int32)
    tout = tchunk.chunked_attention(tq, tk, tv, causal, toff, block, cap)
    tout.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=ATOL)
    for name, t, j in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, err_msg=f"d{name}")


def test_blocks_and_saved_state():
    """The KV block is the reference's ``_blocks`` (the largest divisor of T
    at most the target), and the backward saves (q, k, v, out, lse) only."""
    from repro.models.chunked_attention import _blocks as j_blocks

    for T, target in ((40, 16), (48, 16), (37, 8), (2048, 512), (7, 512)):
        assert tchunk._blocks(T, target) == j_blocks(T, target)
    q = torch.randn(1, 4, 1, 2, 8, requires_grad=True)
    k = torch.randn(1, 12, 1, 8, requires_grad=True)
    out = tchunk.chunked_attention(q, k, k, True, 0, 4)
    assert len(out.grad_fn.saved_tensors) == 5


def _sdpa_inputs(S, T, Hq=2, Hkv=1, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, S, Hq, D)).astype(np.float32),
            rng.standard_normal((1, T, Hkv, D)).astype(np.float32),
            rng.standard_normal((1, T, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("impl,S,T,chunked", [
    ("auto", 2048, 1025, True),          # S*T > 2^21: the chunked path
    ("auto", 2048, 1024, False),         # S*T = 2^21: materialised scores
    ("chunked", 16, 16, True),
    ("reference", 16, 16, False),
])
def test_sdpa_dispatch_matches_reference(impl, S, T, chunked, monkeypatch):
    """``_sdpa`` takes the chunked path exactly where the reference's does,
    and computes what the reference's ``_sdpa`` computes (causal, offset 0)."""
    calls = []
    real = tchunk.chunked_attention
    monkeypatch.setattr(tchunk, "chunked_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v = _sdpa_inputs(S, T)
    jcfg = JModelConfig(attention_impl=impl, attention_block=256)
    tcfg = TModelConfig(attention_impl=impl, attention_block=256)
    want = jattn._sdpa(*map(jnp.asarray, (q, k, v)), jcfg,
                       jattn.causal_mask(S, T), causal_offset=0)
    got = tattn._sdpa(*map(torch.from_numpy, (q, k, v)), tcfg,
                      tattn.causal_mask(S, T), causal_offset=0)
    assert bool(calls) == chunked
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _cfgs(**kw):
    base = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=97,
                dtype="float32")
    base.update(kw)
    return JModelConfig(**base), TModelConfig(**base)


def test_chunked_attention_in_model_matches_reference():
    """tests/test_models.py:36 through both packages: the port's lm_apply on
    the chunked path (block 16) against the reference's on its materialised
    path and on its chunked path, at 3e-4."""
    jcfg, tcfg = _cfgs()
    jp = jinit(JTF.lm_specs(jcfg), jax.random.PRNGKey(0))
    tp = from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, 97, (2, 48)).astype(np.int32)
    ref, _ = JTF.lm_apply(jp, jnp.asarray(toks), jcfg.replace(attention_impl="reference"))
    jchk, _ = JTF.lm_apply(jp, jnp.asarray(toks),
                           jcfg.replace(attention_impl="chunked", attention_block=16))
    with torch.no_grad():
        got, _ = TTF.lm_apply(tp, torch.from_numpy(toks),
                              tcfg.replace(attention_impl="chunked", attention_block=16))
    V = jcfg.vocab_size
    np.testing.assert_allclose(got[..., :V].numpy(), np.asarray(ref)[..., :V], atol=3e-4)
    np.testing.assert_allclose(got[..., :V].numpy(), np.asarray(jchk)[..., :V], atol=3e-4)


def test_static_prefill_into_cache_takes_the_chunked_path():
    """The cache branch: a static prefill of S prompt tokens into a max_len
    cache runs chunked attention with the query offset at the cache length
    (the reference's ``causal_offset=idx``); logits and the cache's K/V
    within 3e-4 of the reference's ``prefill_apply`` on its chunked path,
    and the next decode step's logits too."""
    jcfg, tcfg = _cfgs(attention_impl="chunked", attention_block=8)
    jp = jinit(JTF.lm_specs(jcfg), jax.random.PRNGKey(3))
    tp = from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, 97, (2, 12)).astype(np.int32)
    jl, jc, _ = JTF.prefill_apply(jp, jnp.asarray(toks[:, :10]), jcfg, max_len=24)
    calls = []
    real = tchunk.chunked_attention
    with torch.inference_mode():
        tchunk.chunked_attention = lambda *a, **kw: calls.append(kw) or real(*a, **kw)
        try:
            tl, tc, _ = TTF.prefill_apply(tp, torch.from_numpy(toks[:, :10]), tcfg, max_len=24)
        finally:
            tchunk.chunked_attention = real
        assert len(calls) == tcfg.num_layers
        np.testing.assert_allclose(tl[..., :97].numpy(), np.asarray(jl)[..., :97], atol=3e-4)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=3e-4)
        jl2, _ = JTF.decode_apply(jp, jnp.asarray(toks[:, 10:11]), jc, jcfg)
        tl2, _ = TTF.decode_apply(tp, torch.from_numpy(toks[:, 10:11]), tc, tcfg)
        np.testing.assert_allclose(tl2[..., :97].numpy(), np.asarray(jl2)[..., :97], atol=3e-4)


def test_train_steps_on_the_chunked_path_match_reference():
    """Two AdamW steps of a 2-layer MoE decoder LM (GQA 2, swiglu, top-2 of
    4 experts, the gather dispatcher) with attention_impl="chunked": per-step
    loss and grad norm within rtol 1e-5 and every parameter within 2e-5
    (f32), as tests/test_torch_training.py holds the reference path."""
    moe = dict(num_experts=4, routing="topk", top_k=2, group_size=32, impl="gather")
    jcfg = JModelConfig(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, d_ff=48,
                        vocab_size=61, dtype="float32", attention_impl="chunked",
                        attention_block=8, moe=JMoEConfig(**moe))
    tcfg = TModelConfig(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, d_ff=48,
                        vocab_size=61, dtype="float32", attention_impl="chunked",
                        attention_block=8, moe=TMoEConfig(**moe))
    jp = jinit(JTF.lm_specs(jcfg), jax.random.PRNGKey(0))
    tp = from_jax_params(jax.device_get(jp), tcfg, device="cpu", train=True)
    kw = dict(learning_rate=1e-3, warmup_steps=2)
    jtc, ttc = JTrainConfig(**kw), TTrainConfig(**kw)
    jopt = j_make_optimizer(jtc, j_warmup(1e-3, 2))
    topt = t_make_optimizer(ttc, t_warmup(1e-3, 2))
    jstate, tstate = j_init_state(jp, jopt), t_init_state(tp, topt)
    jstep = jax.jit(j_make_train_step(jcfg, jtc, jopt))
    tstep = t_make_train_step(tcfg, ttc, topt)
    rng = np.random.default_rng(9)
    for _ in range(2):
        toks = rng.integers(0, 61, (2, 33)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    jflat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
             jax.tree_util.tree_flatten_with_path(jax.device_get(jstate.params))[0]}
    for k, t in flat_params(tstate.params).items():
        np.testing.assert_allclose(t.detach().numpy(), jflat[k], atol=2e-5, rtol=0, err_msg=k)
