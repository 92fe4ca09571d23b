"""The port's hash and expert-choice routers, the slot-major dispatch and
the ragged view of a slot-major plan against the JAX reference, on the
same numpy inputs and the reference's params.

Integer fields must be bit-equal (``expert_index``, ``slot_index``,
``valid``, ``token_at_slot``, the ragged layout); gates, losses and
metrics agree to 2e-5 (as the other routing tests).  The MoE layer
through each dispatcher: forward 1e-5, and 1e-4 for ``pallas`` and
``dropless`` (the reference's own tolerances for its backends,
``tests/test_dispatch.py``); gradients 1e-4 of each leaf's largest entry.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import m6 as jm6
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.core.context import MoEContext as JMoEContext
from repro.core.moe import moe_ffn_apply as j_moe
from repro.core.moe import moe_ffn_specs
from repro.core.routers.expert_choice import expert_choice_plan as j_ec_plan
from repro.core.routers.hashed import _mix32 as j_mix32
from repro.core.routers.hashed import hash_plan as j_hash_plan
from repro.models.registry import get_family
from repro.nn import init as jinit
from repro_torch.checkpoint import Checkpointer, jax_key
from repro_torch.configs import m6 as tm6
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.core.context import MoEContext as TMoEContext
from repro_torch.core.dispatch.dropless import plan_block_rows
from repro_torch.core.moe import moe_ffn_apply as t_moe
from repro_torch.core.routers import available_routers, get_router
from repro_torch.core.routers.expert_choice import expert_choice_plan as t_ec_plan
from repro_torch.core.routers.hashed import _mix32 as t_mix32
from repro_torch.core.routers.hashed import hash_plan as t_hash_plan
from repro_torch.nn import flat_params, from_jax_params, init_params, lm_shapes
from torch_threads import one_torch_thread  # noqa: F401

TOL = 2e-5
EDGES = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=tol)


def _assert_plans_equal(jp, tp, slot_major=False):
    _eq(jp.expert_index, tp.expert_index)
    _eq(jp.slot_index, tp.slot_index)
    _eq(jp.valid, tp.valid)
    assert (tp.num_experts, tp.capacity) == (jp.num_experts, jp.capacity)
    _close(jp.gate, tp.gate)
    _close(jp.aux_loss, tp.aux_loss)
    _close(jp.z_loss, tp.z_loss)
    for key in ("cv", "dropped_fraction", "expert_loads", "routed_choices"):
        _close(jp.metrics[key], tp.metrics[key])
    _close(jp.combine, tp.combine)
    if slot_major:
        _eq(jp.token_at_slot, tp.token_at_slot)
        assert tp.token_at_slot.dtype == torch.int32
        _close(jp.gate_at_slot, tp.gate_at_slot)
    else:
        assert jp.token_at_slot is None and tp.token_at_slot is None


def test_mix32_matches_reference_on_edges_and_random_values():
    """The int64 emulation of the reference's uint32 avalanche, on the
    edge values (products there pass 2**63 in a plain int64 multiply) and
    on 10^5 random 32-bit values."""
    xs = np.concatenate([np.array(EDGES, np.uint64),
                         np.random.default_rng(0).integers(0, 2 ** 32, 100_000, np.uint64)])
    want = np.asarray(j_mix32(jnp.asarray(xs.astype(np.uint32)))).astype(np.int64)
    got = t_mix32(torch.from_numpy(xs.astype(np.int64)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert [t_mix32(x) for x in EDGES] == want[:len(EDGES)].tolist()


@pytest.mark.parametrize("G,T,E,k,capacity,normalize,ids,pos", [
    (2, 16, 8, 1, 16, False, True, True),
    (1, 24, 8, 2, 5, False, True, True),      # finite capacity: overflow dropped
    (3, 8, 4, 2, 8, True, True, False),       # no positions: group-local fallback
    (2, 12, 8, 2, 12, False, False, True),    # position hash only (absolute)
    (2, 12, 8, 1, 3, True, False, False),     # no context at all
    (1, 8, 32, 1, 1, False, True, True),      # an m6-base decode step at capacity 1.25
])
def test_hash_plan_matches_reference(G, T, E, k, capacity, normalize, ids, pos):
    """Token ids with -1 rows (m6's image prefix, which falls back to the
    position hash), absolute positions past 2**16, and the extreme id
    2**31 - 1."""
    rng = np.random.default_rng(G * T + E)
    token_ids = rng.integers(0, 2 ** 31 - 1, (G, T)).astype(np.int32)
    token_ids[:, :3] = -1
    token_ids[0, -1] = 2 ** 31 - 1
    positions = (rng.integers(0, 1 << 20, (G, T))).astype(np.int32)
    kw = dict(num_experts=E, routing="hash", top_k=k, normalize_gates=normalize)
    jargs = dict(token_ids=jnp.asarray(token_ids) if ids else None,
                 positions=jnp.asarray(positions) if pos else None)
    targs = dict(token_ids=torch.from_numpy(token_ids) if ids else None,
                 positions=torch.from_numpy(positions) if pos else None)
    jp = j_hash_plan(G, T, JMoEConfig(**kw), capacity, **jargs)
    tp = t_hash_plan(G, T, TMoEConfig(**kw), capacity, **targs)
    _assert_plans_equal(jp, tp)


def _ec(logits, capacity, normalize=False, z=0.0):
    kw = dict(num_experts=logits.shape[-1], routing="expert_choice",
              normalize_gates=normalize, router_z_loss_coef=z)
    return (j_ec_plan(jnp.asarray(logits), JMoEConfig(**kw), capacity),
            t_ec_plan(torch.from_numpy(logits), TMoEConfig(**kw), capacity))


@pytest.mark.parametrize("G,T,E,capacity,normalize", [
    (1, 16, 4, 5, False),
    (2, 40, 8, 10, True),
    (3, 24, 8, 30, False),      # capacity above T: c_eff = T, every token picked
    (1, 36, 32, 2, False),      # the m6-base width's 32 experts, scaled down
])
def test_expert_choice_plan_matches_reference(G, T, E, capacity, normalize):
    logits = np.random.default_rng(T + E).standard_normal((G, T, E)).astype(np.float32)
    jp, tp = _ec(logits, capacity, normalize, z=0.001)
    _assert_plans_equal(jp, tp, slot_major=True)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_expert_choice_breaks_exact_ties_as_the_reference(levels):
    """Logits holding exact ties (every row of a group drawn from a few
    distinct rows, so many tokens score equal for an expert): the reference's
    top_k puts the lower token first, and the port's stable sort does too."""
    rng = np.random.default_rng(levels)
    base = rng.standard_normal((levels, 8)).astype(np.float32)
    logits = base[rng.integers(0, levels, (2, 20))]                  # (2, 20, 8)
    jp, tp = _ec(logits, capacity=6)
    _assert_plans_equal(jp, tp, slot_major=True)
    ts = tp.token_at_slot.numpy()
    assert (np.diff(ts, axis=-1) != 0).all()


@pytest.mark.parametrize("G,T,E,capacity,bx", [
    (1, 16, 4, 5, 8), (2, 40, 8, 10, 16), (3, 24, 8, 30, 8), (1, 36, 32, 2, 8)])
def test_slot_major_ragged_view_bit_equal(G, T, E, capacity, bx):
    logits = np.random.default_rng(bx * T).standard_normal((G, T, E)).astype(np.float32)
    jp, tp = _ec(logits, capacity)
    from repro.core.dispatch.dropless import plan_block_rows as j_plan_block_rows

    assert plan_block_rows(tp) == j_plan_block_rows(jp)
    jr, tr = jp.ragged(bx), tp.ragged(bx)
    for field in ("sort_order", "token", "expert_offsets", "block_expert"):
        _eq(getattr(jr, field), getattr(tr, field))
        assert getattr(tr, field).dtype == torch.int32
    _close(jr.gate, tr.gate)


def _cfgs(routing, impl, capacity_factor=2.0, k=2):
    moe = dict(num_experts=8, routing=routing, top_k=k, group_size=64, impl=impl,
               capacity_factor=capacity_factor, router_z_loss_coef=0.001)
    common = dict(d_model=32, d_ff=48, dtype="float32", ffn_activation="gelu")
    return (JModelConfig(moe=JMoEConfig(**moe), **common),
            TModelConfig(moe=TMoEConfig(**moe), **common))


@pytest.mark.parametrize("routing,impl,capacity_factor", [
    ("expert_choice", "einsum", 2.0),
    ("expert_choice", "gather", 2.0),
    ("expert_choice", "pallas", 2.0),
    ("expert_choice", "dropless", 2.0),
    ("expert_choice", "dropless", None),      # c_eff = T: every expert takes every token
    ("hash", "gather", 1.0),
    ("hash", "pallas", 1.0),
    ("hash", "dropless", None),
])
def test_dispatch_forward_and_backward_match_reference(routing, impl, capacity_factor):
    """The MoE layer through each dispatcher, forward (output and aux) and
    backward (every param and the input), against the reference; the hash
    router reads token ids (the first 4 rows -1) and absolute positions
    from the context, as the serving engines give them."""
    jcfg, tcfg = _cfgs(routing, impl, capacity_factor)
    jp = jinit(moe_ffn_specs(jcfg), jax.random.PRNGKey(0))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jax.device_get(jp).items()}
    assert ("router" in tp) == (routing == "expert_choice")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 50, 32)).astype(np.float32)
    ids = rng.integers(0, 263, (2, 50)).astype(np.int32)
    ids[:, :4] = -1
    pos = np.broadcast_to(np.arange(50, dtype=np.int32) + 7, (2, 50)).copy()
    jctx = JMoEContext(token_ids=jnp.asarray(ids), positions=jnp.asarray(pos))
    tctx = TMoEContext(token_ids=torch.from_numpy(ids), positions=torch.from_numpy(pos))
    tol = 1e-4 if impl in ("pallas", "dropless") else 1e-5

    jy, jaux = jax.jit(lambda p, xx: j_moe(p, xx, jcfg, ctx=jctx))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = t_moe(tp, tx, tcfg, ctx=tctx)
    _close(jy, ty, tol)
    assert set(jaux) == set(taux)
    for key in jaux:
        _close(jaux[key], taux[key])

    def jloss(p, xx):
        return jnp.mean(j_moe(p, xx, jcfg, ctx=jctx)[0] ** 2)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tg = torch.autograd.grad((ty ** 2).mean(), [tx, *tp.values()], allow_unused=True)
    for name, a, b in [("x", jgx, tg[0])] + list(zip(tp, [jg[k] for k in tp], tg[1:])):
        a = np.asarray(a)
        b = np.zeros_like(a) if b is None else b.numpy()
        np.testing.assert_allclose(b, a, atol=1e-4 * max(np.abs(a).max(), 1e-9), rtol=0,
                                   err_msg=name)


def test_slot_major_combine_adds_every_pick_of_a_token():
    """Expert choice at capacity T: every expert picks every token, so a
    token's output is the gate-weighted sum over all E experts; the combine
    must add every pick (a plain write would keep one)."""
    from repro_torch.core.dispatch.base import expert_ffn
    from repro_torch.core.dispatch.gather import gather_dispatch

    _, tcfg = _cfgs("expert_choice", "gather")
    jp = jinit(moe_ffn_specs(_cfgs("expert_choice", "gather")[0]), jax.random.PRNGKey(4))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jax.device_get(jp).items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 6, 32)).astype(np.float32))
    logits = torch.einsum("gtm,me->gte", x, tp["router"])
    plan = t_ec_plan(logits, tcfg.moe, capacity=6)
    assert plan.valid.all() and (plan.token_at_slot >= 0).all()
    y = gather_dispatch(tp, x, plan, tcfg)
    per_expert = expert_ffn(tp, x[0].expand(8, 6, 32).contiguous(), tcfg)    # (E, T, M)
    want = torch.einsum("te,etm->tm", plan.gate[0], per_expert)
    torch.testing.assert_close(y[0], want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,S", [(2, 36), (8, 144)])
def test_slot_major_dispatch_hands_the_kernel_contiguous_buffers(B, S):
    """The grouped-FFN kernel takes contiguous (E, X, M) buffers only (its
    CPU path does not check): the slot-major dispatch must hand it one, in
    one routing group and in several."""
    from unittest import mock

    from repro_torch.core.dispatch import gather

    _, tcfg = _cfgs("expert_choice", "pallas")
    jp = jinit(moe_ffn_specs(_cfgs("expert_choice", "pallas")[0]), jax.random.PRNGKey(6))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jax.device_get(jp).items()}
    seen = []
    real = gather.expert_ffn

    def spy(params, x, cfg, use_kernel=False):
        seen.append(x.is_contiguous())
        return real(params, x, cfg, use_kernel)

    with mock.patch.object(gather, "expert_ffn", spy):
        plan_x = torch.randn(B, S, 32)
        _, aux = t_moe(tp, plan_x, tcfg)
    assert seen == [True]


def test_router_registry_and_param_leaves():
    """All four of the reference's routers are registered; the param tree
    has the reference's router leaf for each (none for hash), key for key."""
    assert available_routers() == ("expert_choice", "hash", "prototype", "topk")
    assert get_router("hash").weight_shape(TMoEConfig(num_experts=8), 32) is None
    for routing in available_routers():
        jcfg = jm6.smoke().replace_moe(routing=routing, top_k=2, num_prototypes=2)
        tcfg = tm6.smoke().replace_moe(routing=routing, top_k=2, num_prototypes=2)
        ref = jax.eval_shape(lambda: jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0)))
        want = {jax.tree_util.keystr(p): tuple(v.shape)
                for p, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
        got = {jax_key(p): tuple(s.shape) for p, s in flat_params(lm_shapes(tcfg)).items()}
        assert got == want, routing


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def test_hash_routed_checkpoint_round_trips_between_packages(tmp_path):
    """A hash-routed m6 smoke param tree (no router leaf) saved by the
    reference restores bit-equal in the port; the port's save of it restores
    bit-equal in the reference, with the same files."""
    jcfg = jm6.smoke().replace_moe(routing="hash", top_k=2)
    tcfg = tm6.smoke().replace_moe(routing="hash", top_k=2)
    jp = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(3))
    JCheckpointer(str(tmp_path / "ref")).save(2, jp)
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    restored, step = Checkpointer(str(tmp_path / "ref")).restore_latest(
        init_params(tcfg, seed=1, device="cpu", train=True))
    assert step == 2
    got = flat_params(restored)
    assert {jax_key(p) for p in got} == set(want)
    for path, t in got.items():
        np.testing.assert_array_equal(_bits(t), _bits(want[jax_key(path)]), err_msg=path)
    Checkpointer(str(tmp_path / "port")).save(2, restored)
    back = JCheckpointer(str(tmp_path / "port")).restore(2, jax.eval_shape(lambda: jp))
    for p, v in jax.tree_util.tree_flatten_with_path(back)[0]:
        np.testing.assert_array_equal(_bits(v), _bits(want[jax.tree_util.keystr(p)]))
    for name in ("manifest.json",):
        assert (json.load(open(tmp_path / "ref" / "step_2" / name))
                == json.load(open(tmp_path / "port" / "step_2" / name)))
    # the params the bridge carries over serve as the port's own
    bridged = from_jax_params(jax.device_get(jp), tcfg, device="cpu", train=True)
    for path, t in flat_params(bridged).items():
        np.testing.assert_array_equal(_bits(t), _bits(got[path]), err_msg=path)


@pytest.mark.parametrize("flags", [
    ["--routing", "hash", "--k", "1", "--moe-impl", "pallas"],
    ["--routing", "expert_choice", "--k", "2", "--moe-impl", "pallas"],
    ["--routing", "expert_choice", "--k", "2", "--moe-impl", "dropless"],
])
def test_train_cli_two_steps_under_each_router(flags):
    from repro_torch.launch.train import main

    logs = main(["--arch", "m6-base", "--smoke", "--steps", "2", "--batch", "2", "--seq", "36",
                 "--log-every", "1", "--device", "cpu", *flags])
    assert len(logs) == 2
    for row in logs:
        assert np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])
        assert 0.0 <= row["moe_dropped_fraction"] < 1.0
