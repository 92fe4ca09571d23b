"""The port's routing, ragged layout, dropless dispatch and MoE layer
against the JAX reference, on the same precomputed inputs.

Integer routing and layout fields must be bit-equal (the ragged layout
is part of the contract); float outputs agree to f32 tolerance (2e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.core.dispatch.dropless import dropless_dispatch as j_dropless
from repro.core.moe import moe_ffn_apply as j_moe, moe_ffn_specs
from repro.core.routers.topk import topk_plan as j_topk_plan
from repro.nn import init as jinit
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.core.dispatch.dropless import dropless_dispatch as t_dropless
from repro_torch.core.moe import moe_ffn_apply as t_moe
from repro_torch.core.routers.topk import topk_plan as t_topk_plan

TOL = 2e-5


def _moe_cfgs(**kw):
    moe = dict(num_experts=8, routing="topk", top_k=2, group_size=64,
               impl="dropless", capacity_factor=None)
    moe.update(kw)
    common = dict(d_model=32, d_ff=48, dtype="float32", ffn_activation="gelu")
    return (JModelConfig(moe=JMoEConfig(**moe), **common),
            TModelConfig(moe=TMoEConfig(**moe), **common))


def _plans(G, T, E, k, capacity, normalize=False, seed=0):
    logits = np.random.default_rng(seed).standard_normal((G, T, E)).astype(np.float32)
    kw = dict(num_experts=E, routing="topk", top_k=k, normalize_gates=normalize,
              aux_loss_coef=0.01, router_z_loss_coef=0.001)
    jp = j_topk_plan(jnp.asarray(logits), JMoEConfig(**kw), capacity)
    tp = t_topk_plan(torch.from_numpy(logits), TMoEConfig(**kw), capacity)
    return jp, tp


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=tol)


@pytest.mark.parametrize("G,T,E,k,capacity,normalize", [
    (1, 16, 4, 1, 16, False),
    (2, 40, 8, 2, 40, True),
    (3, 24, 8, 2, 5, False),        # finite capacity: some choices invalid
    (1, 8, 32, 1, 8, False),        # the m6-base decode step's routing shape
])
def test_topk_plan_matches_reference(G, T, E, k, capacity, normalize):
    jp, tp = _plans(G, T, E, k, capacity, normalize)
    _eq(jp.expert_index, tp.expert_index)
    _eq(jp.slot_index, tp.slot_index)
    _eq(jp.valid, tp.valid)
    _close(jp.gate, tp.gate)
    _close(jp.aux_loss, tp.aux_loss)
    _close(jp.z_loss, tp.z_loss)
    for key in ("cv", "dropped_fraction", "expert_loads", "routed_choices"):
        _close(jp.metrics[key], tp.metrics[key])


@pytest.mark.parametrize("G,T,E,k,capacity,bx", [
    (1, 8, 32, 1, 8, 8),            # decode: 8 choices over 32 experts
    (1, 40, 32, 1, 40, 8),          # mixed step: 40 choices
    (2, 40, 8, 2, 40, 16),
    (3, 24, 8, 2, 5, 8),            # invalid choices parked past R
    (1, 64, 4, 2, 64, 128),         # one block per expert, mostly padding
])
def test_ragged_view_bit_equal(G, T, E, k, capacity, bx):
    jp, tp = _plans(G, T, E, k, capacity, seed=bx + T)
    jr, tr = jp.ragged(bx), tp.ragged(bx)
    for field in ("sort_order", "token", "expert_offsets", "block_expert"):
        _eq(getattr(jr, field), getattr(tr, field))
    _close(jr.gate, tr.gate)
    assert tr.token.dtype == tr.block_expert.dtype == torch.int32


@pytest.mark.parametrize("capacity_factor,act", [(None, "gelu"), (1.0, "swiglu")])
def test_dropless_dispatch_and_moe_layer_match_reference(capacity_factor, act):
    jcfg, tcfg = _moe_cfgs(capacity_factor=capacity_factor)
    jcfg, tcfg = jcfg.replace(ffn_activation=act), tcfg.replace(ffn_activation=act)
    jparams = jinit(moe_ffn_specs(jcfg), jax.random.PRNGKey(3))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jax.device_get(jparams).items()}
    x = np.random.default_rng(4).standard_normal((2, 20, 32)).astype(np.float32)

    jy, jaux = j_moe(jparams, jnp.asarray(x), jcfg)
    ty, taux = t_moe(tparams, torch.from_numpy(x), tcfg)
    _close(jy, ty)
    assert set(jaux) == set(taux)
    for key in jaux:
        _close(jaux[key], taux[key])
    if capacity_factor is None:
        assert float(taux["moe_dropped_fraction"]) == 0.0

    # the dispatcher alone, on the reference's own plan inputs
    xg = x.reshape(1, 40, 32)
    jp, tp = _plans(1, 40, 8, 2, 40 if capacity_factor is None else 10, seed=5)
    _close(j_dropless(jparams, jnp.asarray(xg), jp, jcfg),
           t_dropless(tparams, torch.from_numpy(xg), tp, tcfg))


def test_unported_router_and_dispatcher_raise_on_use():
    from repro_torch.core.dispatch import get_dispatcher
    from repro_torch.core.routers import get_router

    TMoEConfig(num_experts=4, impl="alltoall", routing="hash")   # valid config
    with pytest.raises(NotImplementedError):
        get_dispatcher("alltoall")
    for name in ("hash", "expert_choice"):
        with pytest.raises(NotImplementedError):
            get_router(name)
    with pytest.raises(ValueError, match="registered dispatchers"):
        TMoEConfig(num_experts=4, impl="nope")
    with pytest.raises(ValueError, match="dropless"):
        TMoEConfig(num_experts=4, impl="gather", capacity_factor=None)
