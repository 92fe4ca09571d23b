"""The Mamba2 / SSD block in the port against the JAX reference, on the CPU:
the segment sums, the chunked scan and the recurrent step, chunk
invariance and decode against the parallel form, the block forward,
gradients and decode (the f32 conv tail's promotion under bf16 too), and
the refusal of a multi-token decode step.

Inputs are numpy-seeded; params are the reference's, carried across with
``from_jax_params``.  Tolerances (f32) are stated where they are used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import mamba2 as JM
from repro.nn import init as jinit
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models import mamba2 as TM
from repro_torch.nn.spec import _map, flat_params
from repro_torch.configs.base import torch_dtype
from torch_threads import one_torch_thread  # noqa: F401

# tests/test_models.py:62-74's block
CFG = dict(d_model=32, ssm_state=8, ssm_heads=4, ssm_chunk=8, dtype="float32")


def _cfgs(**kw):
    kw = {**CFG, **kw}
    return JModelConfig(**kw), TModelConfig(**kw)


def _block_params(jcfg, tcfg, train=True, seed=0):
    """The reference's block params and the port's copy (the training
    tree's f32 storage, or the serving tree's)."""
    jp = jinit(JM.mamba2_block_specs(jcfg), jax.random.PRNGKey(seed))
    host = jax.device_get(jp)
    wdt = tcfg.param_dtype if train else tcfg.dtype

    def one(path, s):
        node = host
        for k in path:
            node = node[k]
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(torch_dtype(s.dtype))

    return jp, _map(one, TM.mamba2_block_shapes(tcfg, wdt))


def _scan_inputs(B=2, S=48, H=3, P=4, N=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)   # softplus > 0
    A_log = (0.5 * rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A_log, Bm, Cm


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def test_segsum_matches_reference():
    """The lower-triangular cumulative sums, -inf above the diagonal, equal
    within 1e-6."""
    logd = np.random.default_rng(1).standard_normal((2, 3, 9)).astype(np.float32)
    want = np.asarray(JM._segsum(jnp.asarray(logd)))
    got = TM._segsum(torch.from_numpy(logd)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("S", [48, 40], ids=["chunk_multiple", "padded"])
def test_ssd_chunked_matches_reference(S):
    """Chunk 16: S = 48 is three whole chunks, S = 40 pads the last one
    with 8 zero steps.  y and the final state within 1e-5; the gradients
    of x, dt, A_log, B and C under one seeded cotangent on y and on the
    state within 1e-4."""
    args = _scan_inputs(S=S)
    jy, jh = JM.ssd_chunked(*map(jnp.asarray, args), chunk=16)
    targs = [_t(a, grad=True) for a in args]
    ty, th = TM.ssd_chunked(*targs, chunk=16)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)
    rng = np.random.default_rng(2)
    cy = rng.standard_normal(jy.shape).astype(np.float32)
    ch = rng.standard_normal(jh.shape).astype(np.float32)

    def jloss(*a):
        y, h = JM.ssd_chunked(*a, chunk=16)
        return (y * cy).sum() + (h * ch).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    ((ty * _t(cy)).sum() + (th * _t(ch)).sum()).backward()
    for name, a, g in zip(("x", "dt", "A_log", "B", "C"), targs, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_ssd_step_matches_reference():
    """Six recurrent steps from a random state: y and the state within
    1e-5."""
    x, dt, A_log, Bm, Cm = _scan_inputs(S=6, seed=3)
    h0 = np.random.default_rng(4).standard_normal((2, 3, 4, 5)).astype(np.float32)
    jh, th = jnp.asarray(h0), torch.from_numpy(h0)
    for t in range(6):
        jy, jh = JM.ssd_step(jh, *(jnp.asarray(a[:, t]) for a in (x, dt)), jnp.asarray(A_log),
                             *(jnp.asarray(a[:, t]) for a in (Bm, Cm)))
        ty, th = TM.ssd_step(th, *(torch.from_numpy(a[:, t]) for a in (x, dt)),
                             torch.from_numpy(A_log), *(torch.from_numpy(a[:, t]) for a in (Bm, Cm)))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)


def test_chunk_invariance_and_decode_match_parallel():
    """tests/test_models.py:62-74 on the port, with the reference's params:
    chunk 8 against one chunk of 24 within 1e-5, 8 decode steps from zero
    state against the parallel form within 1e-5; and the port's parallel
    form against the reference's within 1e-5."""
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params(jcfg, tcfg)
    x = (np.random.default_rng(1).standard_normal((2, 24, 32)) * 0.3).astype(np.float32)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        y1, _ = TM.mamba2_block_apply(tp, tx, tcfg)
        y2, _ = TM.mamba2_block_apply(tp, tx, tcfg.replace(ssm_chunk=24))
        np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)
        st = TM.mamba2_init_state(tcfg, 2)
        for i in range(8):
            yi, st = TM.mamba2_block_apply(tp, tx[:, i:i + 1], tcfg, state=st)
            np.testing.assert_allclose(yi[:, 0].numpy(), y1[:, i].numpy(), atol=1e-5)
    jy, _ = JM.mamba2_block_apply(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [24, 21], ids=["chunk_multiple", "padded"])
def test_block_forward_and_gradients_match_reference(S):
    """The block's parallel form (chunk 8; S = 21 pads the last chunk):
    forward within 1e-5, the gradients of every parameter and of the input
    under one seeded cotangent within 1e-4."""
    jcfg, tcfg = _cfgs()
    jp, _ = _block_params(jcfg, tcfg)
    x = (np.random.default_rng(5).standard_normal((2, S, 32)) * 0.5).astype(np.float32)
    jout, vjp = jax.vjp(lambda p, a: JM.mamba2_block_apply(p, a, jcfg)[0], jp, jnp.asarray(x))
    tb = jax.tree_util.tree_map(lambda a: _t(a, grad=True), jax.device_get(jp))
    tx = _t(x, grad=True)
    tout, _ = TM.mamba2_block_apply(tb, tx, tcfg)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    cot = np.random.default_rng(6).standard_normal(jout.shape).astype(np.float32)
    jgb, jgx = vjp(jnp.asarray(cot))
    (tout * _t(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-4, rtol=1e-4)
    want = {jax.tree_util.keystr(p): g for p, g in jax.tree_util.tree_flatten_with_path(jgb)[0]}
    got = flat_params(jax.tree_util.tree_map(lambda t: t.grad, tb,
                                             is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert len(got) == len(want) == 13
    for path, g in got.items():
        key = "".join(f"['{k}']" for k in path.split("/"))
        np.testing.assert_allclose(g.numpy(), np.asarray(want[key]), atol=1e-4, rtol=1e-4,
                                   err_msg=path)


def test_block_decode_matches_reference():
    """Six decode steps from zero state, with a random nonzero A_log,
    dt_bias and conv bias: the output and both state fields within 1e-5 at
    every step."""
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params(jcfg, tcfg)
    rng = np.random.default_rng(7)
    for k in ("A_log", "dt_bias", "conv_b"):
        v = (0.5 * rng.standard_normal(jp[k].shape)).astype(np.float32)
        jp[k], tp[k] = jnp.asarray(v), torch.from_numpy(v)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    jst, tst = JM.mamba2_init_state(jcfg, 2), TM.mamba2_init_state(tcfg, 2)
    with torch.no_grad():
        for t in range(6):
            jy, jst = JM.mamba2_block_apply(jp, jnp.asarray(x[:, t:t + 1]), jcfg, state=jst)
            ty, tst = TM.mamba2_block_apply(tp, torch.from_numpy(x[:, t:t + 1]), tcfg, state=tst)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
            for f in jst._fields:
                np.testing.assert_allclose(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)),
                                           atol=1e-5, rtol=1e-5, err_msg=f)


def test_f32_tail_promotes_decode_under_bf16():
    """bf16 activations over the serving tree: a decode step's f32 conv
    tail promotes the conv, x / B / C and the scan's inputs to f32, as the
    reference's concatenation does, while the parallel form rounds the
    conv's output to bf16.  The port's decode step equals the reference's
    within bf16's resolution (atol = rtol = 1e-2) with the state in f32
    (the tail holding the bf16 projections exactly), and the promoted
    conv output is f32 (the silu sees f32)."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jp, tp = _block_params(jcfg, tcfg, train=False)
    x = np.random.default_rng(8).standard_normal((2, 3, 32)).astype(np.float32)
    jst, tst = JM.mamba2_init_state(jcfg, 2), TM.mamba2_init_state(tcfg, 2)
    seen = []
    real_silu = torch.nn.functional.silu

    def spy(a, *args, **kw):
        seen.append(a.dtype)
        return real_silu(a, *args, **kw)

    with torch.no_grad():
        for t in range(3):
            xt = x[:, t:t + 1]
            jy, jst = JM.mamba2_block_apply(jp, jnp.asarray(xt, jnp.bfloat16), jcfg, state=jst)
            torch.nn.functional.silu = spy
            try:
                ty, tst = TM.mamba2_block_apply(tp, torch.from_numpy(xt).bfloat16(), tcfg,
                                                state=tst)
            finally:
                torch.nn.functional.silu = real_silu
            assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
            assert tst.conv.dtype == tst.h.dtype == torch.float32
            np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                                       atol=1e-2, rtol=1e-2)
            np.testing.assert_allclose(tst.conv.numpy(), np.asarray(jst.conv), atol=1e-6)
            np.testing.assert_allclose(tst.h.numpy(), np.asarray(jst.h), atol=1e-2, rtol=1e-2)
    # decode: the conv's silu in f32, the gate's in bf16; parallel: both bf16
    assert seen[0] == torch.float32 and seen[1] == torch.bfloat16
    seen.clear()
    torch.nn.functional.silu = spy
    try:
        with torch.no_grad():
            TM.mamba2_block_apply(tp, torch.from_numpy(x).bfloat16(), tcfg)
    finally:
        torch.nn.functional.silu = real_silu
    assert seen[:2] == [torch.bfloat16, torch.bfloat16]


def test_multi_token_decode_is_refused():
    """The reference reads token 0 alone when given a state and broadcasts
    it over S (silently wrong for S > 1); the port raises."""
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    _, tp = _block_params(jcfg, tcfg)
    with pytest.raises(ValueError, match="one token a step"):
        TM.mamba2_block_apply(tp, torch.zeros(2, 3, 32), tcfg,
                              state=TM.mamba2_init_state(tcfg, 2))


def test_param_shapes_match_reference_specs():
    """The block's shape tree key for key and dtype for dtype (the training
    tree's storage: the reference's ParamSpec dtypes), stacked over a
    layer axis as ``stack_specs`` stacks it."""
    from repro.nn.spec import stack_specs

    jcfg, tcfg = _cfgs()
    for lead, specs in (((), JM.mamba2_block_specs(jcfg)),
                        ((3,), stack_specs(JM.mamba2_block_specs(jcfg), 3))):
        want = {jax.tree_util.keystr(p): (tuple(s.shape), np.dtype(s.dtype).name)
                for p, s in jax.tree_util.tree_flatten_with_path(
                    specs, is_leaf=lambda s: hasattr(s, "logical_axes"))[0]}
        got = {"".join(f"['{k}']" for k in path.split("/")): (tuple(s.shape), s.dtype)
               for path, s in flat_params(TM.mamba2_block_shapes(tcfg, "float32", lead)).items()}
        assert got == want
