"""The ragged FFN's liveness against the JAX reference, on the CPU.

A row block of the ragged layout is live when one of its rows holds a
routed choice (``token >= 0``); the port's kernel skips the other blocks
and writes their rows as exactly 0.  These tests hold that rule to the
reference's own ragged view (index and slot-major), the plain version with
the liveness to the one without it (live rows bit-equal, dead rows 0, NaN
in a dead row's input kept out), the dropless MoE layer that now passes the
liveness to the reference's dropless layer (forward and backward, at the
capacity dispatchers' tolerances: 1e-5, gradients 1e-4 of each leaf's
largest), and the mesh packing's liveness, a function of the segment
lengths alone, to the blocks it ships.  No process group is started.
"""
import dataclasses
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.core.moe import moe_ffn_apply as j_moe
from repro.core.moe import moe_ffn_specs
from repro.core.routers.expert_choice import expert_choice_plan as j_ec_plan
from repro.core.routers.topk import topk_plan as j_topk_plan
from repro.kernels.moe_dropless.ref import ragged_ffn_ref as j_ragged_ref
from repro.nn import init as jinit
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.core.dispatch import dropless
from repro_torch.core.moe import moe_ffn_apply as t_moe
from repro_torch.core.routers.expert_choice import expert_choice_plan as t_ec_plan
from repro_torch.core.routers.topk import topk_plan as t_topk_plan
from repro_torch.kernels.moe_dropless import ops as rffn_ops
from repro_torch.kernels.moe_dropless.ref import (
    live_blocks,
    ragged_ffn_ref,
    ragged_ffn_split_ref,
)
from torch_threads import one_torch_thread  # noqa: F401


def _ref_live(token: np.ndarray, bx: int) -> np.ndarray:
    """The rule on the reference's view: a block holds a row with token >= 0."""
    G, R = token.shape
    return (token.reshape(G, R // bx, bx) >= 0).any(-1)


def _topk(G, T, E, k, capacity, seed):
    logits = np.random.default_rng(seed).standard_normal((G, T, E)).astype(np.float32)
    kw = dict(num_experts=E, routing="topk", top_k=k, aux_loss_coef=0.01)
    jplan = jax.jit(lambda lg: j_topk_plan(lg, JMoEConfig(**kw), capacity))
    return jplan(jnp.asarray(logits)), t_topk_plan(torch.from_numpy(logits), TMoEConfig(**kw),
                                                   capacity)


def _j_ragged(plan, bx):
    """The reference's ragged view, traced once (eager JAX pays a compile an op)."""
    return jax.jit(lambda p: p.ragged(bx))(plan)


@pytest.mark.parametrize("G,T,E,k,capacity,bx,empty", [
    (1, 8, 32, 1, 8, 8, False),        # the m6-base decode step: 29 blocks, 8 routed at most
    (1, 40, 32, 1, 40, 8, False),      # the mixed step
    (2, 40, 8, 2, 40, 16, False),      # top-2
    (3, 24, 8, 2, 5, 8, False),        # finite capacity: dropped choices parked past R
    (1, 64, 4, 2, 64, 128, False),     # one block an expert
    (2, 16, 8, 1, 16, 8, True),        # a step with no routed row: every block dead
])
def test_index_view_liveness_matches_reference(G, T, E, k, capacity, bx, empty):
    jp, tp = _topk(G, T, E, k, capacity, seed=T + bx)
    if empty:
        jp = dataclasses.replace(jp, valid=jnp.zeros_like(jp.valid))
        tp = dataclasses.replace(tp, valid=torch.zeros_like(tp.valid))
    jr, tr = _j_ragged(jp, bx), tp.ragged(bx)
    want = _ref_live(np.asarray(jr.token), bx)
    nb = tr.block_expert.shape[1]
    got = live_blocks(tr.token, G * nb).reshape(G, nb).numpy()
    np.testing.assert_array_equal(got, want)
    # the same as a prefix of each group's blocks: block b live iff b bx < offsets[g, E]
    prefix = np.arange(nb)[None, :] * bx < np.asarray(jr.expert_offsets)[:, -1:]
    np.testing.assert_array_equal(got, prefix)
    assert got.any() != empty
    # the layout itself is untouched: the view's integer fields stay the reference's
    for field in ("token", "block_expert", "expert_offsets"):
        np.testing.assert_array_equal(getattr(tr, field).numpy(), np.asarray(getattr(jr, field)))


@pytest.mark.parametrize("G,T,E,capacity,bx,empty_experts", [
    (1, 64, 8, 10, 8, ()),             # Cs = 10 slots padded to 16: every block live
    (2, 96, 8, 40, 32, ()),            # Cs = 40 padded to 64
    (1, 32, 4, 16, 8, (1, 3)),         # two experts' slots emptied: their blocks dead
])
def test_slot_major_liveness_matches_reference(G, T, E, capacity, bx, empty_experts):
    logits = np.random.default_rng(E + T).standard_normal((G, T, E)).astype(np.float32)
    kw = dict(num_experts=E, routing="expert_choice")
    jp = jax.jit(lambda lg: j_ec_plan(lg, JMoEConfig(**kw), capacity))(jnp.asarray(logits))
    tp = t_ec_plan(torch.from_numpy(logits), TMoEConfig(**kw), capacity)
    if empty_experts:
        drop = np.zeros(E, bool)
        drop[list(empty_experts)] = True
        jtok = jnp.where(jnp.asarray(drop)[None, :, None], -1, jp.token_at_slot)
        ttok = torch.where(torch.from_numpy(drop)[None, :, None], -1, tp.token_at_slot)
        jp = dataclasses.replace(jp, token_at_slot=jtok)
        tp = dataclasses.replace(tp, token_at_slot=ttok)
    jr, tr = _j_ragged(jp, bx), tp.ragged(bx)
    np.testing.assert_array_equal(tr.block_expert.numpy(), np.asarray(jr.block_expert))
    want = _ref_live(np.asarray(jr.token), bx)
    nb = tr.block_expert.shape[1]
    got = live_blocks(tr.token, G * nb).reshape(G, nb).numpy()
    np.testing.assert_array_equal(got, want)
    dead_experts = set(np.asarray(jr.block_expert)[~want].tolist())
    assert dead_experts == set(empty_experts)


# (E, NB, bx, M, I, act, dtype): the kernel sweep of test_torch_kernels.py
LIVE_CASES = [
    (4, 6, 8, 32, 48, "swiglu", torch.float32),
    (2, 4, 16, 64, 96, "gelu", torch.float32),
    (3, 5, 8, 16, 40, "relu", torch.float32),
    (8, 8, 8, 64, 64, "swiglu", torch.bfloat16),
    (8, 8, 8, 64, 64, "gelu", torch.bfloat16),
]


def _live_case(E, NB, bx, M, I, act, dt, seed):
    """Rows, block experts, weights and a tag a row: block 1 wholly dead,
    block 0 with one routed row, the last block dead, the others routed
    at random; dead blocks' rows NaN in ``x_nan``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((NB * bx, M)).astype(np.float32)
    w = [(rng.standard_normal(s) * 0.1).astype(np.float32)
         for s in ((E, M, I), (E, M, I), (E, I, M))]
    if act != "swiglu":
        w[1] = None
    be = rng.integers(0, E, NB).astype(np.int32)
    tags = np.where(rng.random(NB * bx) < 0.5, rng.integers(0, 100, NB * bx), -1).reshape(NB, bx)
    tags[0] = -1
    tags[0, bx - 1] = 7
    tags[1] = -1
    tags[-1] = -1
    live = (tags >= 0).any(1)
    x_nan = np.where(np.repeat(live, bx)[:, None], x, np.nan).astype(np.float32)

    def t(a):
        return None if a is None else torch.from_numpy(a).to(dt)

    return (t(x), t(x_nan), torch.from_numpy(be), [t(a) for a in w],
            torch.from_numpy(tags.reshape(-1).astype(np.int32)), live)


@pytest.mark.parametrize("E,NB,bx,M,I,act,dt", LIVE_CASES)
def test_plain_version_with_liveness(E, NB, bx, M, I, act, dt):
    x, x_nan, be, (wu, wg, wd), tags, live = _live_case(E, NB, bx, M, I, act, dt, E * NB + M)
    rows = torch.from_numpy(np.repeat(live, bx))
    plain = ragged_ffn_ref(x, be, wu, wg, wd, act)
    for fn, without in ((ragged_ffn_ref, plain),
                        (ragged_ffn_split_ref, ragged_ffn_split_ref(x, be, wu, wg, wd, act))):
        got = fn(x_nan, be, wu, wg, wd, act, tags)
        assert torch.isfinite(got).all()
        assert (got[~rows] == 0).all()
        assert torch.equal(got[rows], without[rows])
    # the wrapper's CPU path: the plain version, the tags as (segments, rows) too
    got = rffn_ops.ragged_ffn(x_nan, be, wu, wg, wd, act, block_x=bx, live=tags.reshape(2, -1))
    assert torch.equal(got, ragged_ffn_ref(x_nan, be, wu, wg, wd, act, tags))
    # the live rows against the reference's plain version
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32

    def j(a):
        return None if a is None else jnp.asarray(a.float().numpy()).astype(jdt)

    want = np.asarray(j_ragged_ref(j(x), jnp.asarray(be.numpy()), j(wu), j(wg), j(wd), act),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy()[rows.numpy()], want[rows.numpy()],
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("E,NB,bx,M,I,act,dt", LIVE_CASES[:3])
def test_backward_with_liveness(E, NB, bx, M, I, act, dt):
    """The wrapper's backward with NaN in the dead rows: finite, the dead
    rows' input gradient 0, and every gradient the one of the run without
    the liveness whose dead rows get no output gradient (they carry gate 0
    in the combine)."""
    x, x_nan, be, ws, tags, live = _live_case(E, NB, bx, M, I, act, dt, E + NB + I)
    rows = torch.from_numpy(np.repeat(live, bx))
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((NB * bx, M))
                         .astype(np.float32))

    def grads(xx, mask, live_tags):
        leaves = [xx.clone().requires_grad_(True)] + [
            None if w is None else w.clone().requires_grad_(True) for w in ws]
        y = rffn_ops.ragged_ffn(leaves[0], be, *leaves[1:], act, block_x=bx, live=live_tags)
        (y * g * mask[:, None]).sum().backward()
        return [None if t is None else t.grad for t in leaves]

    got = grads(x_nan, torch.ones(NB * bx), tags)
    want = grads(x, rows.float(), None)
    assert (got[0][~rows] == 0).all()
    for a, b in zip(got, want):
        if a is None:
            assert b is None
            continue
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5 * float(b.abs().max()),
                                   rtol=0)


def _layer_cfgs(routing, **kw):
    moe = dict(num_experts=8, routing=routing, top_k=2, num_prototypes=2, group_size=64,
               impl="dropless", capacity_factor=None, aux_loss_coef=0.01)
    moe.update(kw)
    common = dict(d_model=32, d_ff=48, dtype="float32", ffn_activation="gelu")
    return (JModelConfig(moe=JMoEConfig(**moe), **common),
            TModelConfig(moe=TMoEConfig(**moe), **common))


def _spy_ffn(calls: list):
    """The dispatcher's kernel handle, recording what each call was given."""
    real = dropless.dropless_ops.ragged_ffn

    def ragged(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    return mock.patch.object(dropless, "dropless_ops", SimpleNamespace(ragged_ffn=ragged))


@pytest.mark.parametrize("routing,kw", [
    ("topk", dict(top_k=1)),
    ("topk", dict(top_k=2)),
    ("prototype", dict(top_k=1)),
    ("expert_choice", dict(top_k=2, capacity_factor=1.0)),
])
def test_dropless_layer_with_liveness_matches_reference(routing, kw):
    """The dropless MoE layer, whose dispatcher hands the kernel the view's
    token as its liveness and a tile width from static sizes, forward and
    backward against the reference's dropless layer (which computes every
    block)."""
    jcfg, tcfg = _layer_cfgs(routing, **kw)
    jp = jinit(moe_ffn_specs(jcfg), jax.random.PRNGKey(0))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jax.device_get(jp).items()}
    x = np.random.default_rng(1).standard_normal((2, 50, 32)).astype(np.float32)

    jy, _ = jax.jit(lambda p, xx: j_moe(p, xx, jcfg))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    for v in tp.values():
        v.requires_grad_(True)
    calls = []
    with _spy_ffn(calls):
        ty, _ = t_moe(tp, tx, tcfg)
    assert calls and all(c["live"] is not None and c["tile"] > 0 for c in calls)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)

    def jloss(p, xx):
        return jnp.mean(j_moe(p, xx, jcfg)[0] ** 2)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tg = torch.autograd.grad((ty ** 2).mean(), [tx, *tp.values()])
    for name, a, b in [("x", jgx, tg[0])] + list(zip(tp, [jg[k] for k in tp], tg[1:])):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, atol=1e-4 * max(np.abs(a).max(), 1e-9),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("G,T,E,k,ne,bx", [
    (4, 1, 32, 1, 2, 8),               # the serving mesh: one-token groups, 2 expert shards
    (2, 40, 32, 1, 2, 8),              # a mixed step's group
    (2, 64, 16, 2, 4, 16),             # top-2 over 4 shards
    (1, 256, 32, 1, 2, 32),            # the training mesh's groups, cut down
])
def test_mesh_packing_liveness(G, T, E, k, ne, bx):
    """``ragged_ep_dispatch``'s packing, without processes: the slots a
    source ships to each expert shard, the ids beside them (-1 on a slot's
    padding) and the liveness the receiving kernel reads from those ids.  A
    received block is live iff it lies in the slot's first ``seglen`` rows
    (a function of the segment lengths alone), iff it holds a valid row,
    iff the reference's view has a routed row in the source block; a live
    block's first id is that block's local expert."""
    jp, tp = _topk(G, T, E, k, T, seed=G * T + ne)
    jr, tr = _j_ragged(jp, bx), tp.ragged(bx)
    R = tr.token.shape[1]
    epl = E // ne
    e_row = tr.block_expert.long().repeat_interleave(bx, dim=1)
    src, valid = dropless.shard_slots(tr.expert_offsets.long(), epl, R)
    ebuf = dropless.slot_expert_ids(e_row, src, valid, epl)          # (G, ne, R)
    offd = tr.expert_offsets.long()[:, ::epl]
    seglen = offd[:, 1:] - offd[:, :-1]                             # (G, ne)
    ref_live = _ref_live(np.asarray(jr.token), bx)                  # (G, R / bx)
    jbe = np.asarray(jr.block_expert)
    nbs = R // bx
    for s in range(ne):                                             # the receiving shard
        recv = ebuf[:, s]                                           # (G, R): its slots
        got = live_blocks(recv, G * nbs).reshape(G, nbs)
        by_len = torch.arange(nbs)[None, :] * bx < seglen[:, s, None]
        np.testing.assert_array_equal(got.numpy(), by_len.numpy())
        np.testing.assert_array_equal(got.numpy(),
                                      valid[:, s].reshape(G, nbs, bx).any(-1).numpy())
        first = recv.reshape(G, nbs, bx)[..., 0]
        for g in range(G):
            b0 = int(offd[g, s]) // bx
            n = int(seglen[g, s]) // bx
            np.testing.assert_array_equal(ref_live[g, b0:b0 + n], np.ones(n, bool))
            np.testing.assert_array_equal(first[g, :n].numpy(), jbe[g, b0:b0 + n] - s * epl)
            assert (recv[g, n * bx:] == -1).all()
    # every routed source block is shipped to exactly one shard
    assert int(seglen.sum()) // bx == int(ref_live.sum())


@pytest.mark.parametrize("rows,bx,gated,want", [
    (8 * 1 / 32 * 2, 8, False, 8),       # m6-base decode: 8 choices over 32 experts
    (40 * 1 / 32 * 2, 8, False, 8),      # the mixed step
    (384 / 32 * 2, 8, False, 32),        # the static engine's prefill, 384 rows
    (45, 32, False, 64),                 # expert choice: 45 slots an expert, bx 32
    (2 * 1024 / 32 * 2, 32, False, 128), # a training mesh rank: a group from each of 2 ranks
    (1000.0, 32, False, 192),            # capped: an expert with more rows takes several tiles
    (1000.0, 32, True, 128),             # gated: two accumulators, 128 at most
    (1.0, 256, False, 128),              # a block wider than the cap: cut as tile_rows cuts it
])
def test_tile_rows_from_static_sizes(rows, bx, gated, want):
    n = rffn_ops.ragged_tile_rows(rows, bx, gated)
    assert n == want
    # the work list holds the most items the prologue can make: a segment of min(bx, n)
    # rows each, every live block's
    nb, col_tiles = 10, 8
    items = (rffn_ops.workspace_ints(nb, bx, n, col_tiles) - 4 - 3 * nb) // (4 + col_tiles)
    assert items >= nb * (bx // min(bx, n)) and bx % min(bx, n) == 0


def test_dispatcher_tile_rows_follow_the_plan():
    """The dispatcher's tile for a plan is a function of its static sizes."""
    _, tp = _topk(1, 8, 32, 1, 8, seed=0)
    assert dropless.plan_tile_rows(tp, 8, False) == 8
    _, tp = _topk(1, 384, 32, 1, 384, seed=0)
    assert dropless.plan_tile_rows(tp, 8, False) == 32
    _, tp = _topk(4, 1024, 32, 1, 1024, seed=0)     # one group a rank, two ranks' groups
    assert dropless.plan_tile_rows(tp, 32, False, groups=2) == 128
    assert dropless.plan_tile_rows(tp, 32, False) == 192
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 1152, 32))
                              .astype(np.float32))
    ec = t_ec_plan(logits, TMoEConfig(num_experts=32, routing="expert_choice"), 45)
    assert dropless.plan_tile_rows(ec, 32, False) == 64


def test_liveness_argument_checks():
    bf = torch.bfloat16
    x = torch.zeros(16, 64, dtype=bf)
    wu, wd = torch.zeros(2, 64, 96, dtype=bf), torch.zeros(2, 96, 64, dtype=bf)
    be = torch.zeros(2, dtype=torch.int32)
    tags = torch.full((2, 9), -1, dtype=torch.int32)[:, :8]          # a strided (G, R) view
    rffn_ops._check(x, be, wu, None, wd, 8, tags, 16)
    rffn_ops._check(x, be, wu, None, wd, 8, tags.reshape(-1).long(), 0)
    with pytest.raises(TypeError, match="int32 or int64"):
        rffn_ops._check(x, be, wu, None, wd, 8, tags.float())
    with pytest.raises(ValueError, match="one tag a row"):
        rffn_ops._check(x, be, wu, None, wd, 8, tags[:, :4])
    with pytest.raises(ValueError, match="one tag a row"):
        rffn_ops._check(x, be, wu, None, wd, 8, tags.t())
    with pytest.raises(ValueError, match="tile"):
        rffn_ops._check(x, be, wu, None, wd, 8, tags, 24)
    with pytest.raises(ValueError, match="tile"):
        rffn_ops._check(x, be, wu, wu, wd, 8, tags, 192)
    with pytest.raises(ValueError, match="1024 experts"):      # the prologue's sort
        rffn_ops._check(x, be, torch.zeros(1025, 64, 96, dtype=bf), None,
                        torch.zeros(1025, 96, 64, dtype=bf), 8)
