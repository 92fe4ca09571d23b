"""The port's prototype router and capacity dispatchers (einsum, gather,
pallas) against the JAX reference, on the same numpy inputs and the
reference's params.

Integer routing fields must be bit-equal.  Float tolerances, f32 unless
stated: router gates and losses 2e-5 (as the other routing tests); the
dense combine view exactly (it is a scatter of the same gates); dispatch
forward 1e-5, and 1e-4 for ``pallas`` (the reference's own tolerances for
its backends, ``tests/test_dispatch.py``); gradients 1e-4 of the largest
gradient entry of each leaf (likewise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.core.moe import moe_ffn_apply as j_moe
from repro.core.moe import moe_ffn_specs
from repro.core.routers.prototype import prototype_plan as j_prototype_plan
from repro.core.routers.topk import topk_plan as j_topk_plan
from repro.nn import init as jinit
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.core.dispatch.gather import flat_slot_ids
from repro_torch.core.moe import moe_ffn_apply as t_moe
from repro_torch.core.routers.prototype import prototype_plan as t_prototype_plan
from repro_torch.core.routers.topk import topk_plan as t_topk_plan

TOL = 2e-5


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=tol)


@pytest.mark.parametrize("G,Z,T,F,kp,capacity,normalize", [
    (1, 2, 16, 4, 1, 16, False),
    (2, 4, 40, 2, 1, 12, True),       # finite capacity: some choices invalid
    (3, 2, 24, 4, 2, 5, False),       # k' = 2 inside each prototype
    (1, 4, 36, 8, 1, 5, False),       # m6's 4 top-1 over 32 experts, scaled down
])
def test_prototype_plan_matches_reference(G, Z, T, F, kp, capacity, normalize):
    logits = np.random.default_rng(Z * T + F).standard_normal((G, Z, T, F)).astype(np.float32)
    kw = dict(num_experts=Z * F, routing="prototype", num_prototypes=Z,
              prototype_top_k=kp, normalize_gates=normalize, aux_loss_coef=0.01,
              router_z_loss_coef=0.001)
    jp = j_prototype_plan(jnp.asarray(logits), JMoEConfig(**kw), capacity)
    tp = t_prototype_plan(torch.from_numpy(logits), TMoEConfig(**kw), capacity)
    _eq(jp.expert_index, tp.expert_index)
    _eq(jp.slot_index, tp.slot_index)
    _eq(jp.valid, tp.valid)
    assert tp.num_experts == jp.num_experts and tp.capacity == jp.capacity
    _close(jp.gate, tp.gate)
    _close(jp.aux_loss, tp.aux_loss)
    _close(jp.z_loss, tp.z_loss)
    for key in ("cv", "dropped_fraction", "expert_loads", "routed_choices"):
        _close(jp.metrics[key], tp.metrics[key])
    _close(jp.combine, tp.combine)


@pytest.mark.parametrize("G,T,E,k,capacity", [(2, 24, 8, 2, 5), (1, 40, 8, 2, 10)])
def test_topk_combine_view_and_slot_ids_match_reference(G, T, E, k, capacity):
    from repro.core.dispatch.gather import flat_slot_ids as j_flat_slot_ids

    logits = np.random.default_rng(T).standard_normal((G, T, E)).astype(np.float32)
    kw = dict(num_experts=E, routing="topk", top_k=k)
    jp = j_topk_plan(jnp.asarray(logits), JMoEConfig(**kw), capacity)
    tp = t_topk_plan(torch.from_numpy(logits), TMoEConfig(**kw), capacity)
    _close(jp.combine, tp.combine)
    _eq(j_flat_slot_ids(jp), flat_slot_ids(tp))


def _cfgs(routing, impl, **kw):
    moe = dict(num_experts=8, routing=routing, top_k=2, num_prototypes=2, group_size=64,
               impl=impl, capacity_factor=2.0, aux_loss_coef=0.01)
    moe.update(kw)
    common = dict(d_model=32, d_ff=48, dtype="float32", ffn_activation="gelu")
    return (JModelConfig(moe=JMoEConfig(**moe), **common),
            TModelConfig(moe=TMoEConfig(**moe), **common))


def _params(jcfg):
    jp = jinit(moe_ffn_specs(jcfg), jax.random.PRNGKey(0))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jax.device_get(jp).items()}


@pytest.mark.parametrize("routing", ["topk", "prototype"])
@pytest.mark.parametrize("impl", ["einsum", "gather", "pallas"])
def test_dispatch_forward_and_backward_match_reference(routing, impl):
    """The MoE layer through each capacity dispatcher, forward (outputs and
    aux) and backward (every param and the input), against the same
    dispatcher in the reference; capacity 2.0 over 100 tokens, 2 groups."""
    jcfg, tcfg = _cfgs(routing, impl)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(1).standard_normal((2, 50, 32)).astype(np.float32)
    tol = 1e-4 if impl == "pallas" else 1e-5

    jy, jaux = jax.jit(lambda p, xx: j_moe(p, xx, jcfg))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    for v in tp.values():
        v.requires_grad_(True)
    ty, taux = t_moe(tp, tx, tcfg)
    _close(jy, ty, tol)
    assert set(jaux) == set(taux)
    for key in jaux:
        _close(jaux[key], taux[key])

    def jloss(p, xx):
        return jnp.mean(j_moe(p, xx, jcfg)[0] ** 2)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tg = torch.autograd.grad((ty ** 2).mean(), [tx, *tp.values()])
    for name, a, b in [("x", jgx, tg[0])] + list(zip(tp, [jg[k] for k in tp], tg[1:])):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, atol=1e-4 * max(np.abs(a).max(), 1e-9),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("impl", ["einsum", "gather", "pallas"])
def test_dropped_tokens_match_reference(impl):
    """Under heavy capacity pressure the port drops the same tokens (zero
    rows in the same places) as the reference."""
    jcfg, tcfg = _cfgs("topk", impl, capacity_factor=0.05)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(2).standard_normal((1, 64, 32)).astype(np.float32)
    jy, jaux = j_moe(jp, jnp.asarray(x), jcfg)
    ty, taux = t_moe(tp, torch.from_numpy(x), tcfg)
    assert float(taux["moe_dropped_fraction"]) > 0.3
    _close(jaux["moe_dropped_fraction"], taux["moe_dropped_fraction"])
    np.testing.assert_array_equal(np.linalg.norm(np.asarray(jy)[0], axis=-1) == 0,
                                  ty[0].norm(dim=-1).numpy() == 0)
    _close(jy, ty, 1e-4)
