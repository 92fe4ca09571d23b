"""The dropless combine against the JAX reference, on the CPU.

The port combines the ragged FFN's rows back into token order as a
gather-sum over a row map (``kernels/moe_dropless/ref.py::index_row_map``
/ ``slot_row_map``: the inverse of the ragged view's ``sort_order``) where
the reference scatter-adds (``.at[gi, tok].add(vals)``,
``src/repro/core/dispatch/dropless.py:176``).  These tests hold the row map
bit for bit to a numpy inverse of the reference's own view (index and
slot-major; top-1, top-2, 4 top-1 prototyping, expert choice; experts with
no rows), the plain gather-sum to the reference's expression evaluated by
JAX on its view (f32 at 1e-6, bf16 at top-1 bit for bit), the wrapper's
gradients to autograd through ``index_put_(accumulate=True)`` (1e-6 in
f32), a NaN in a padding row kept out of y, and the wrapper's routes by
device.  No process group is started.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.core.routers.expert_choice import expert_choice_plan as j_ec_plan
from repro.core.routers.prototype import prototype_plan as j_proto_plan
from repro.core.routers.topk import topk_plan as j_topk_plan
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.core.dispatch.dropless import combine_rows
from repro_torch.core.routers.expert_choice import expert_choice_plan as t_ec_plan
from repro_torch.core.routers.prototype import prototype_plan as t_proto_plan
from repro_torch.core.routers.topk import topk_plan as t_topk_plan
from repro_torch.kernels.moe_dropless import combine
from repro_torch.kernels.moe_dropless.ref import ragged_combine_ref, row_tokens
from torch_elsewhere import elsewhere
from torch_threads import one_torch_thread  # noqa: F401

# (label, routing, G, T, E, k or capacity, bx): E > T * k leaves experts without rows
CASES = [
    ("top-1 decode", "topk", 1, 8, 32, 1, 8),
    ("top-1", "topk", 2, 24, 8, 1, 8),
    ("top-2", "topk", 2, 20, 16, 2, 8),
    ("4 top-1", "prototype", 2, 16, 16, 4, 8),
    ("expert choice", "expert_choice", 2, 24, 8, 6, 8),
]


def _plans(routing, G, T, E, kc, seed):
    """The reference's plan and the port's from the same numpy logits."""
    rng = np.random.default_rng(seed)
    if routing == "prototype":
        logits = rng.standard_normal((G, kc, T, E // kc)).astype(np.float32)
        kw = dict(num_experts=E, routing="prototype", num_prototypes=kc, aux_loss_coef=0.01)
        j, t = j_proto_plan, t_proto_plan
        cap = T
    elif routing == "expert_choice":
        logits = rng.standard_normal((G, T, E)).astype(np.float32)
        kw = dict(num_experts=E, routing="expert_choice")
        j, t = j_ec_plan, t_ec_plan
        cap = kc
    else:
        logits = rng.standard_normal((G, T, E)).astype(np.float32)
        kw = dict(num_experts=E, routing="topk", top_k=kc, aux_loss_coef=0.01)
        j, t = j_topk_plan, t_topk_plan
        cap = T * kc
    jp = jax.jit(lambda lg: j(lg, JMoEConfig(**kw), cap))(jnp.asarray(logits))
    return jp, t(torch.from_numpy(logits), TMoEConfig(**kw), cap)


def _j_ragged(plan, bx):
    return jax.jit(lambda p: p.ragged(bx))(plan)


@functools.lru_cache(maxsize=None)
def _case(routing, G, T, E, kc, bx):
    """Both plans and both ragged views of a case, built once a module."""
    jp, tp = _plans(routing, G, T, E, kc, seed=T + E)
    return jp, tp, _j_ragged(jp, bx), tp.ragged(bx)


def _numpy_row_map(jplan, jrag) -> np.ndarray:
    """The inverse of the reference's view in numpy: for each (g, t, k),
    the row whose sort-order id is t*K + k (index view) or e*Cs + c with
    (e, c) the choice's expert and slot (slot-major view), else -1."""
    so = np.asarray(jrag.sort_order)
    G, R = so.shape
    _, T, K = jplan.expert_index.shape
    slot_major = jplan.token_at_slot is not None
    n = int(np.prod(jplan.token_at_slot.shape[1:])) if slot_major else T * K
    inv = np.full((G, n), -1, np.int64)
    for g in range(G):
        for r in range(R):
            if so[g, r] >= 0:
                assert inv[g, so[g, r]] == -1          # the valid ids are unique
                inv[g, so[g, r]] = r
    if not slot_major:
        return inv.reshape(G, T, K)
    Cs = np.asarray(jplan.token_at_slot).shape[2]
    e, c = np.asarray(jplan.expert_index), np.asarray(jplan.slot_index)
    valid = np.asarray(jplan.valid)
    assert (c[valid] < Cs).all() and (c[valid] >= 0).all()   # Cs and the slots agree
    out = np.full((G, T, K), -1, np.int64)
    for g, t, k in zip(*np.nonzero(valid)):
        out[g, t, k] = inv[g, e[g, t, k] * Cs + c[g, t, k]]
    return out


@pytest.mark.parametrize("label,routing,G,T,E,kc,bx", CASES, ids=[c[0] for c in CASES])
def test_row_map_matches_reference_view(label, routing, G, T, E, kc, bx):
    jp, tp, jr, tr = _case(routing, G, T, E, kc, bx)
    np.testing.assert_array_equal(tr.sort_order.numpy(), np.asarray(jr.sort_order))
    rows = combine_rows(tp, tr.sort_order)
    assert rows.dtype == torch.int32 and rows.shape == tuple(jp.expert_index.shape)
    want = _numpy_row_map(jp, jr)
    np.testing.assert_array_equal(rows.numpy(), want)
    # every routed choice is named once, and the rows it names route its token
    routed = want >= 0
    assert routed.sum() == (np.asarray(jr.sort_order) >= 0).sum()
    tok = np.asarray(jr.token)
    g, t, _ = np.nonzero(routed)
    np.testing.assert_array_equal(tok[g, want[routed]], t)
    np.testing.assert_array_equal(row_tokens(rows, tok.shape[1]).numpy(), tok)
    if routing == "topk" and E > T * kc:                # experts without rows
        assert len(np.unique(np.asarray(jp.expert_index))) < E


def test_row_map_of_emptied_slots():
    """A slot-major view whose experts 1 and 3 hold no token: their ids are
    -1 in the view, and the choices that named them map to -1."""
    jp, tp = _plans("expert_choice", 1, 32, 4, 16, seed=4)
    drop = np.zeros(4, bool)
    drop[[1, 3]] = True
    jp = dataclasses.replace(jp, token_at_slot=jnp.where(jnp.asarray(drop)[None, :, None], -1,
                                                         jp.token_at_slot))
    tp = dataclasses.replace(tp, token_at_slot=torch.where(torch.from_numpy(drop)[None, :, None],
                                                           -1, tp.token_at_slot))
    jr, tr = _j_ragged(jp, 8), tp.ragged(8)
    rows = combine_rows(tp, tr.sort_order).numpy()
    np.testing.assert_array_equal(rows, _numpy_row_map(jp, jr))
    assert (rows[..., 1] == -1).all() and (rows[..., 3] == -1).all()
    assert (rows[..., 0] >= 0).any() and (rows[..., 2] >= 0).any()


def _inputs(jr, M, seed, dtype):
    """out (G, R, M) from numpy in ``dtype`` and the reference view's gate."""
    G, R = np.asarray(jr.token).shape
    out = np.random.default_rng(seed).standard_normal((G, R, M)).astype(np.float32)
    tout = torch.from_numpy(out).to(dtype)
    return tout, torch.from_numpy(np.asarray(jr.gate).copy())


def _j_scatter_add(jr, out: torch.Tensor, T: int) -> np.ndarray:
    """The reference's combine (``dropless.py:174-176``) on its view, in
    out's dtype, evaluated by JAX."""
    dt = jnp.bfloat16 if out.dtype == torch.bfloat16 else jnp.float32
    jout = jnp.asarray(out.float().numpy()).astype(dt)
    G, R, M = jout.shape

    def combine(o, token, gate):
        tok = jnp.maximum(token, 0)
        vals = o * gate[..., None].astype(dt)
        gi = jnp.arange(G)[:, None]
        return jnp.zeros((G, T, M), dt).at[gi, tok].add(vals)

    return np.asarray(jax.jit(combine)(jout, jr.token, jr.gate).astype(jnp.float32))


@pytest.mark.parametrize("label,routing,G,T,E,kc,bx", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_combine_matches_reference_scatter_add(label, routing, G, T, E, kc, bx, dtype):
    """f32 at 1e-6; bf16 bit for bit where a token has one choice (top-1)."""
    _, tp, jr, tr = _case(routing, G, T, E, kc, bx)
    out, gate = _inputs(jr, 24, seed=G * T, dtype=dtype)
    rows = combine_rows(tp, tr.sort_order)
    got = ragged_combine_ref(out, gate, rows)
    assert got.dtype == dtype and got.shape == (G, T, 24)
    want = _j_scatter_add(jr, out, T)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    elif routing == "topk" and kc == 1:
        np.testing.assert_array_equal(got.float().numpy(), want)
    # the wrapper's CPU route is the plain version, and launches nothing
    before = combine.ragged_combine.launches
    assert torch.equal(combine.ragged_combine(out, gate, rows), got)
    assert combine.ragged_combine.launches == before


def _index_put_combine(out, gate, token, T):
    """The combine as the dispatcher ran it before: gate-weighted rows
    scatter-added with ``index_put_(accumulate=True)`` (padding on token 0)."""
    G, R, M = out.shape
    vals = out * gate[..., None].to(out.dtype)
    gi = torch.arange(G)[:, None].expand(G, R)
    tok = torch.clamp(token, min=0).long()
    return torch.zeros((G, T, M), dtype=out.dtype).index_put_((gi, tok), vals, accumulate=True)


@pytest.mark.parametrize("label,routing,G,T,E,kc,bx", CASES, ids=[c[0] for c in CASES])
def test_gradients_match_index_put(label, routing, G, T, E, kc, bx):
    """d out and d gate against autograd through the scatter-add at 1e-6
    (f32), on the routed rows; 0 on the rows the map does not name, where
    the scatter-add's d gate was <out, grad y[token 0]> and the view's gate
    is a constant fill (its gradient goes nowhere)."""
    _, tp, jr, tr = _case(routing, G, T, E, kc, bx)
    out, gate = _inputs(jr, 24, seed=7, dtype=torch.float32)
    gy = torch.from_numpy(np.random.default_rng(8).standard_normal((G, T, 24)).astype(np.float32))
    rows = combine_rows(tp, tr.sort_order)

    def grads(fn):
        o, g = out.clone().requires_grad_(True), gate.clone().requires_grad_(True)
        y = fn(o, g)
        return (y,) + torch.autograd.grad(y, (o, g), gy)

    y, d_out, d_gate = grads(lambda o, g: combine.ragged_combine(o, g, rows))
    y0, d_out0, d_gate0 = grads(lambda o, g: _index_put_combine(o, g, tr.token, T))
    np.testing.assert_allclose(y.detach().numpy(), y0.detach().numpy(), atol=1e-6, rtol=1e-6)
    routed = tr.token >= 0
    np.testing.assert_allclose(d_out[routed].numpy(), d_out0[routed].numpy(), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(d_gate[routed].numpy(), d_gate0[routed].numpy(), atol=1e-6,
                               rtol=1e-6)
    assert (d_out[~routed] == 0).all() and (d_gate[~routed] == 0).all()


def test_nan_in_padding_rows_stays_out():
    """Rows the map does not name (padding, dead blocks) are never read: a
    NaN there reaches neither y nor the gradients."""
    _, tp, jr, tr = _case("topk", 2, 20, 16, 2, 8)
    out, gate = _inputs(jr, 16, seed=3, dtype=torch.float32)
    rows = combine_rows(tp, tr.sort_order)
    pad = tr.token < 0
    assert pad.any()
    poisoned = out.masked_fill(pad[..., None], float("nan")).requires_grad_(True)
    y = combine.ragged_combine(poisoned, gate, rows)
    assert torch.equal(y, combine.ragged_combine(out, gate, rows))
    (d_out,) = torch.autograd.grad(y, poisoned, torch.ones_like(y))
    assert torch.isfinite(d_out).all() and (d_out[pad] == 0).all()


def test_token_without_a_choice_is_zero():
    """A token none of whose choices is routed comes out exactly 0."""
    out = torch.randn(1, 8, 16)
    gate = torch.rand(1, 8)
    rows = torch.tensor([[[3, -1], [-1, -1], [0, 5]]], dtype=torch.int32)
    y = ragged_combine_ref(out, gate, rows)
    assert (y[0, 1] == 0).all()
    torch.testing.assert_close(y[0, 0], out[0, 3] * gate[0, 3], rtol=0, atol=0)
    torch.testing.assert_close(y[0, 2], out[0, 0] * gate[0, 0] + out[0, 5] * gate[0, 5],
                               rtol=0, atol=0)


def test_strided_inputs_match_contiguous():
    """A mesh rank's call: out a row slice of a longer buffer (its group
    stride R + 1 rows) and the row map a slice of the groups."""
    G, R, T, K, M = 4, 16, 6, 2, 8
    buf = torch.randn(G, R + 1, M)
    gate = torch.rand(G, R)
    perm = torch.stack([torch.randperm(R)[:T * K] for _ in range(G)]).int().reshape(G, T, K)
    rows = torch.where(torch.rand(G, T, K) < 0.8, perm, torch.full_like(perm, -1))
    want = ragged_combine_ref(buf[1:3, :R].contiguous(), gate[1:3].contiguous(),
                              rows[1:3].contiguous())
    got = combine.ragged_combine(buf[1:3, :R], gate[1:3], rows[1:3])
    assert torch.equal(got, want)
    wide = torch.cat([rows, torch.full_like(rows, -1)], dim=2)[1:3, :, :K]   # token stride 2K
    assert wide.stride(1) == 2 * K and torch.equal(wide, rows[1:3])
    assert torch.equal(combine.ragged_combine(buf[1:3, :R], gate[1:3], wide), want)


def test_meta_launches_nothing_and_other_devices_raise():
    out = torch.zeros(2, 16, 8, device="meta")
    gate = torch.zeros(2, 16, device="meta")
    rows = torch.zeros(2, 5, 3, dtype=torch.int32, device="meta")
    before = combine.ragged_combine.launches
    y = combine.ragged_combine(out, gate, rows)
    assert y.device.type == "meta" and y.shape == (2, 5, 8) and y.dtype == out.dtype
    assert combine.ragged_combine.launches == before
    with pytest.raises(ValueError, match="16-byte aligned"):     # the kernel's vectors
        combine.ragged_combine(torch.zeros(2, 16, 12, dtype=torch.bfloat16, device="meta"),
                               gate, rows)
    with pytest.raises(ValueError, match="no kernel"):
        combine.ragged_combine(elsewhere(torch.zeros(2, 16, 8)), elsewhere(torch.zeros(2, 16)),
                               elsewhere(torch.zeros(2, 5, 3, dtype=torch.int32)))
    with pytest.raises(TypeError):
        combine.ragged_combine(torch.zeros(2, 16, 8), torch.zeros(2, 16),
                               torch.zeros(2, 5, 3, dtype=torch.int64))
    with pytest.raises(ValueError, match="are not"):
        combine.ragged_combine(torch.zeros(2, 16, 8), torch.zeros(2, 15),
                               torch.zeros(2, 5, 3, dtype=torch.int32))
