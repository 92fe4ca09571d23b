"""The port's training mesh against the JAX reference, on the CPU.

One 4-rank gloo world is spawned for the file (a module fixture,
``repro_torch.launch.mesh.spawn``); inside it the ranks build the (2, 2),
(4, 1) and (1, 4) ("data", "model") meshes and train the reference's
multi-device test cell (``tests/test_distributed.py``: 2 layers, d 64, 4
heads, 8 experts, vocab 128, f32, group size 32, a batch of 8 x 32) for 2
steps in each case.  Every case is held against the reference's
single-device ``make_train_step`` on the same params (``from_jax_params``)
and batches, computed here: the loss at every step and every whole
parameter after the last within the reference's own 1e-4 (its pjit test,
``test_distributed.py:90-93``).  The routing integers of every step's
forward, the ranks' groups put together, equal the port's single-device
step's exactly.  The (1, 1) mesh runs in this process on a world-1 gloo
group and must equal the port's single-device step bit for bit.  The rank
bodies are in ``torch_mesh_train_workers.py`` and import the port only.

The reference's ``pallas`` backend runs its kernel in interpret mode,
which is slow on the CPU; the port's ``pallas`` case is held against the
reference's ``gather`` backend, which computes the same function (the
reference's own dispatch tests hold the two equal).
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_mesh_train_workers as W
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jget_config
from repro.distributed.sharding import activation_shardings as jactivation_shardings
from repro.distributed.sharding import make_rules as jmake_rules
from repro.distributed.sharding import param_pspecs as jparam_pspecs
from repro.models.registry import get_family
from repro.nn import init as jinit
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim.compression import quantize_int8 as jquantize_int8
from repro.optim.zero import zero1_shardings as jzero1_shardings
from repro.train.state import init_train_state as jinit_train_state
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import jax_key
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.configs.registry import get_config as tget_config
from repro_torch.distributed.sharding import (
    MeshShape,
    activation_shardings,
    make_rules,
    param_pspecs,
)
from repro_torch.launch.mesh import make_debug_mesh, production_mesh_axes, spawn
from repro_torch.nn import flat_params, from_jax_params, model_shapes
from repro_torch.optim import make_optimizer
from repro_torch.optim.zero import zero1_shardings
from repro_torch.train.layout import MeshLayout
from repro_torch.train.state import init_train_state
from repro_torch.train.trainer import make_train_step
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4                      # the reference's pjit test
# the optimizer state and gradient norm against the reference's, relative
# to each leaf's largest magnitude (an f32 gradient summed in another order
# differs in its last bits)
STATE_RTOL = 1e-4
STEPS = 2
SPAWN_TIMEOUT = 240
MESHES = [(2, 2), (4, 1), (1, 4), (2, 1, 2)]       # the last ("pod", "data", "model")
ALL = tuple(MESHES[:3])


# the train CLI's MoE-attention run (test_train_cli_refuses_what_is_not_ported):
# smoke m6, 8 x 36 positions = 9 groups of 32
CLI = ["--arch", "m6-base", "--smoke", "--steps", "2", "--batch", "8", "--seq", "36",
       "--log-every", "1", "--device", "cpu"]


def _cfgs(**moe):
    kw = dict(num_experts=8, routing="topk", top_k=1, group_size=32, capacity_factor=1.25,
              impl="alltoall")
    kw.update(moe)
    base = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=64,
                vocab_size=128, dtype="float32")
    return JModelConfig(**base, moe=JMoEConfig(**kw)), TModelConfig(**base, moe=TMoEConfig(**kw))


# name: (moe overrides, train overrides, the reference's impl where it differs, meshes)
CASES = {
    "alltoall top-1": ({}, {}, None, ALL),
    "alltoall prototype 2": (dict(routing="prototype", num_prototypes=2), {}, None, ALL),
    "dropless": (dict(impl="dropless", capacity_factor=None), {}, None, ALL),
    "pallas": (dict(impl="pallas"), {}, "gather", ALL),
    "gather": (dict(impl="gather"), {}, None, ((2, 2),)),
    "G=1": (dict(group_size=256), {}, None, ((2, 2), (4, 1))),
    "G=2": (dict(group_size=128), {}, None, ((2, 2), (4, 1))),
    "adafactor": ({}, dict(optimizer="adafactor"), None, ALL),
    "int8": ({}, dict(grad_compression="int8"), None, ((2, 2), (1, 4))),
    "microbatches 2": ({}, dict(microbatches=2), None, ((2, 2), (4, 1))),
    "pod": ({}, dict(optimizer="adafactor"), None, ((2, 1, 2),)),
}


def _batches(seed=1, B=8, S=32, vocab=128):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        t = rng.randint(0, vocab, size=(B, S + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()})
    return out


def _tc(cls, **kw):
    return cls(optimizer=kw.get("optimizer", "adamw"), learning_rate=1e-3,
               grad_compression=kw.get("grad_compression", "none"),
               microbatches=kw.get("microbatches", 1))


def _case(name):
    moe, train, ref_impl, on = CASES[name]
    jcfg, tcfg = _cfgs(**moe)
    if ref_impl:
        jcfg = jcfg.replace_moe(impl=ref_impl)
    jparams = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, tcfg, _tc(JTrainConfig, **train), _tc(TTrainConfig, **train), jparams, on


def _reference(jcfg, jtc, jparams, batches):
    """The reference's single-device steps: (losses, grad norms, final
    state)."""
    opt = jmake_optimizer(jtc, W.SecondStepLR(jtc.learning_rate))
    step = jax.jit(jmake_train_step(jcfg, jtc, opt))
    state = jinit_train_state(jparams, opt, jtc.grad_compression)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, state


def _port_single(tcfg, ttc, params, batches):
    """The port's single-device steps with each forward's routing recorded:
    (losses, routes a step, final state)."""
    opt = make_optimizer(ttc, W.SecondStepLR(ttc.learning_rate))
    step = make_train_step(tcfg, ttc, opt)
    state = init_train_state(W._clone(params), opt, ttc.grad_compression)
    losses, routes = [], []
    for b in batches:
        got = []
        with W._routes(got):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        routes.append(got)
    return losses, routes, state


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank world's results, with the references' (computed here
    while the ranks run)."""
    from concurrent.futures import ThreadPoolExecutor

    batches = _batches()
    cases, made = [], {}
    for name in CASES:
        jcfg, tcfg, jtc, ttc, jparams, on = _case(name)
        tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu", train=True)
        cases.append((name, tcfg, ttc, tparams, batches, on))
        made[name] = (jcfg, tcfg, jtc, ttc, jparams, tparams)
    d = tmp_path_factory.mktemp("mesh_train")
    rng = np.random.RandomState(5)
    xs = [rng.randn(8, 5).astype(np.float32) * (r + 1) for r in range(4)]
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, W.train_body, 4, init_file=str(d / "init"),
                            args=(MESHES, cases, str(d / "ckpt"), xs, CLI + ["--data", "2",
                                                                            "--model", "2"]),
                            timeout=SPAWN_TIMEOUT)
        refs, by_config = {}, {}
        for name, (jcfg, tcfg, jtc, ttc, jparams, tparams) in made.items():
            key = (jcfg, jtc)                   # pallas and gather share the reference's
            if key not in by_config:
                by_config[key] = _reference(jcfg, jtc, jparams, batches)
            refs[name] = (by_config[key], _port_single(tcfg, ttc, tparams, batches), tcfg, ttc,
                          tparams)
        out = ranks.result()
    return dict(ranks=out, refs=refs, batches=batches, ckpt=str(d / "ckpt"), psum_inputs=xs)


def _state_close(got, want, key, skip=None):
    """``got`` within ``STATE_RTOL`` of ``want``, relative to the leaf's
    largest magnitude, except where ``skip`` (a mask of the leaf's elements
    whose int8 code flipped, for ``want``'s shape or its parameter's)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, key
    ok = np.abs(got - want) <= STATE_RTOL * scale
    if skip is not None and skip.shape == want.shape:
        ok |= skip
    assert ok.all(), f"{key}: {int((~ok).sum())} of {ok.size} elements off"


def _int8_codes_agree(got, want):
    """Under int8 compression: every leaf's error feedback (the residual of
    its last int8 step, at most half a quantum q per element; q is taken as
    twice the reference's largest residual) within 1e-3 q of the
    reference's, except where an int8 code flipped (a residual one quantum
    off: a gradient summed in another order lies on the other side of a
    rounding boundary) at no more elements than one, or a thousandth of the
    leaf's.  Returns {parameter path: mask of its flipped
    elements}."""
    flipped = {}
    for k, w in want.items():
        if not k.startswith(".error_feedback"):
            continue
        g, w = np.asarray(got[k]), np.asarray(w)
        q = 2 * float(np.abs(w).max())
        diff = np.abs(g - w)
        flip = diff > q / 2
        assert flip.sum() <= max(1, w.size // 1000), f"{k}: {int(flip.sum())} int8 codes flipped"
        assert (diff[~flip] <= 1e-3 * q).all(), f"{k}: residuals off by {diff[~flip].max() / q} q"
        flipped[k[len(".error_feedback"):]] = flip
    return flipped


def _rank_of(shape, d, m):
    """The world rank of data index ``d`` (over "pod" and "data", row-major)
    and model index ``m``."""
    return d * shape[-1] + m


@pytest.mark.parametrize("name,shape", [(n, s) for n in CASES for s in CASES[n][3]],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_mesh_step_matches_reference(world, name, shape):
    """Every rank's loss equal at every step; the loss and every whole
    parameter within 1e-4 of the reference's single-device step; the
    gradient norm of every step and every whole leaf of the optimizer
    state (AdamW's mu and nu, Adafactor's factors: functions of the
    reduced gradient) within ``STATE_RTOL`` of the reference's, and under
    int8 compression the error feedback (``_int8_codes_agree``); the
    routing of every step equal to the port's single-device step's."""
    (jlosses, jnorms, jstate), (tlosses, troutes, _), tcfg, _, _ = world["refs"][name]
    res = [r[0][shape, name] for r in world["ranks"]]
    for r in res:
        assert r["losses"] == res[0]["losses"]
    np.testing.assert_allclose(res[0]["losses"], jlosses, atol=TOL, rtol=0)
    np.testing.assert_allclose(res[0]["grad_norms"], jnorms, rtol=STATE_RTOL, atol=0)
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(jstate))[0]}
    got = res[0]["whole"]
    assert set(got) == set(want)
    assert any(k.startswith(".opt_state") for k in want)
    flipped = _int8_codes_agree(got, want)
    for k, v in want.items():
        if k.startswith(".params"):
            np.testing.assert_allclose(got[k], v, atol=TOL, rtol=0, err_msg=k)
        elif k.startswith(".opt_state"):
            path = k[k.index("]") + 1:]              # the leaf's path after ['mu'] / ['v']
            skip = next((m for p, m in flipped.items() if path.startswith(p)), None)
            _state_close(got[k], v, k, skip)
        elif not k.startswith(".error_feedback"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    D, M = math.prod(shape[:-1]), shape[-1]         # "pod" is more data parallelism
    G = 8 * 32 // tcfg.moe.group_size
    for step in range(STEPS):
        for layer, single in enumerate(troutes[step]):
            if G % D:                           # straddling groups: every data rank routes all
                parts = [res[_rank_of(shape, 0, 0)]["routes"][step][layer]]
                for d in range(D):
                    np.testing.assert_array_equal(
                        res[_rank_of(shape, d, 0)]["routes"][step][layer], parts[0])
            else:
                parts = [res[_rank_of(shape, d, 0)]["routes"][step][layer] for d in range(D)]
            np.testing.assert_array_equal(np.concatenate(parts), single,
                                          err_msg=f"step {step} layer {layer}")
            for d in range(D):
                for m in range(M):
                    np.testing.assert_array_equal(
                        res[_rank_of(shape, d, m)]["routes"][step][layer],
                        res[_rank_of(shape, d, 0)]["routes"][step][layer])
    assert np.allclose(tlosses, jlosses, atol=TOL)


@pytest.mark.parametrize("name,per_layer", [("alltoall top-1", 6), ("alltoall prototype 2", 6),
                                            ("dropless", 8), ("pallas", 0), ("G=1", 0)])
def test_expert_parallelism_engages(world, name, per_layer):
    """all_to_all a step on (2, 2): forward, remat recompute and backward of
    each exchange (the capacity path's two, the ragged path's three, whose
    expert ids have no backward); none where the experts are gathered
    (``pallas``, or groups that do not split over the model axis)."""
    res = world["ranks"][0][0][(2, 2), name]
    assert res["a2a"] == [2 * per_layer] * STEPS


def test_checkpoint_saved_on_one_mesh_loads_in_reference_and_on_another(world, tmp_path):
    """The first case's state saved on (2, 2) (rank 0 writes whole leaves):
    the reference's ``Checkpointer.restore`` reads it equal to the ranks'
    whole leaves, its manifest's keys, shapes and dtypes are a single-device
    save's, and it restores on (4, 1) to the same leaves."""
    name = "alltoall top-1"
    whole = world["ranks"][0][0][(2, 2), name]["whole"]
    (_, _, jstate), (_, _, tstate), tcfg, ttc, _ = world["refs"][name]
    ck = JCheckpointer(world["ckpt"])
    back = ck.restore(STEPS, jax.eval_shape(lambda: jstate))
    ref = {jax.tree_util.keystr(p): np.asarray(v)
           for p, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert set(ref) == set(whole)
    for k, v in ref.items():
        np.testing.assert_array_equal(v, np.asarray(whole[k]), err_msg=k)
    Checkpointer(str(tmp_path)).save(STEPS, tstate)
    manifests = [json.load(open(os.path.join(d, f"step_{STEPS}", "manifest.json")))
                 for d in (world["ckpt"], str(tmp_path))]
    assert ([(e["key"], e["shape"], e["dtype"]) for e in manifests[0]["leaves"]]
            == [(e["key"], e["shape"], e["dtype"]) for e in manifests[1]["leaves"]])
    restored = world["ranks"][0][1]
    assert set(restored) == set(whole)
    for k, v in whole.items():
        np.testing.assert_array_equal(np.asarray(restored[k]), np.asarray(v), err_msg=k)


def test_compressed_psum_matches_reference_arithmetic(world):
    """``compressed_psum`` over the world equals the reference's
    arithmetic: each rank's int8 codes and scale (its ``quantize_int8``),
    dequantised and summed."""
    xs = world["psum_inputs"]
    deq = []
    for x in xs:
        q, s = jquantize_int8(jnp.asarray(x))
        deq.append(np.asarray(q, np.float32) * np.float32(s))
    want = np.asarray(jnp.sum(jnp.asarray(np.stack(deq)), axis=0))
    for r in world["ranks"]:
        np.testing.assert_allclose(r[2], want, rtol=1e-6, atol=1e-6)


def test_reduce_scatter_is_each_ranks_chunk_of_the_sum(world):
    total = np.sum(np.stack(world["psum_inputs"]), axis=0)
    for rank, r in enumerate(world["ranks"]):
        np.testing.assert_allclose(r[3], total[2 * rank:2 * rank + 2], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The (1, 1) mesh in this process: the single-device step, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trivial_mesh():
    mesh = make_debug_mesh(1, 1, device="cpu", backend="gloo")
    yield mesh
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("name", ["alltoall top-1", "dropless", "adafactor", "int8",
                                  "microbatches 2"])
def test_trivial_mesh_is_single_device_bit_for_bit(trivial_mesh, name):
    _, tcfg, _, ttc, jparams, _ = _case(name)
    params = from_jax_params(jax.device_get(jparams), tcfg, device="cpu", train=True)
    batches = _batches()
    tlosses, _, tstate = _port_single(tcfg, ttc, params, batches)
    res, _, _ = W.train_one(trivial_mesh, tcfg, ttc, params, batches)
    assert res["losses"] == tlosses
    single = W._whole(MeshLayout(tcfg, make_rules(tcfg, trivial_mesh, batch_sharded=True)),
                      tstate)
    assert set(single) == set(res["whole"])

    def bits(v):
        v = np.asarray(v)
        return v.view(np.int32) if v.dtype == np.float32 else v

    for k, v in single.items():
        np.testing.assert_array_equal(bits(res["whole"][k]), bits(v), err_msg=k)


# ---------------------------------------------------------------------------
# Placement functions against the reference's
# ---------------------------------------------------------------------------

def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}['{k}']"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}[{i}]"))
        return out
    return {path: tuple(getattr(tree, "spec", tree))}


def _jflat(tree):
    P = jax.sharding.PartitionSpec
    return {jax.tree_util.keystr(p): tuple(getattr(s, "spec", s)) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, (P, jax.sharding.NamedSharding)))[0]}


GRIDS = [(2, 4), (8, 1), (1, 8), (1, 16)]


def _moe_attention(cfg):
    return cfg.replace_moe(moe_attention=True)


FAMILIES = ["m6-base", "granite-moe-3b-a800m", "qwen3-14b", "xlstm-125m", "zamba2-7b",
            "seamless-m4t-large-v2", "m6-base moe_attention"]


def _family_cfgs(arch):
    base = arch.split()[0]
    jcfg, tcfg = jget_config(base), tget_config(base)
    if arch.endswith("moe_attention"):
        jcfg, tcfg = _moe_attention(jcfg), _moe_attention(tcfg)
    return jcfg, tcfg


@pytest.mark.parametrize("shape", GRIDS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_pspecs_every_family_match_reference(arch, shape):
    jcfg, tcfg = _family_cfgs(arch)
    jrules = jmake_rules(jcfg, AbstractMesh(shape, ("data", "model")))
    trules = make_rules(tcfg, MeshShape(("data", "model"), shape))
    assert trules.params == jrules.params and trules.acts == jrules.acts
    jspecs = _jflat(jparam_pspecs(get_family(jcfg).specs(jcfg), jrules))
    assert _flat(param_pspecs(model_shapes(tcfg), trules)) == jspecs


class _Shape:
    def __init__(self, *shape):
        self.shape = shape


@pytest.mark.parametrize("shape", GRIDS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ["m6-base", "qwen3-14b", "zamba2-7b"])
def test_activation_shardings_match_reference(arch, shape):
    """Decode caches and batches: (L, B, T, Hkv, D) caches, sequence-sharded
    ones (batch 1), token and logit batches."""
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    hd, hkv, L = tcfg.resolved_head_dim, tcfg.num_kv_heads, tcfg.num_layers
    shapes = {"cache": (L, 16, 256, hkv, hd), "long": (L, 1, 4096, hkv, hd),
              "tokens": (16, 256), "logits": (16, 256, 1024), "heads": (16, tcfg.num_heads, hd),
              "scalar": ()}
    jrules = jmake_rules(jcfg, AbstractMesh(shape, ("data", "model")))
    trules = make_rules(tcfg, MeshShape(("data", "model"), shape))
    for batch, seq in ((16, 256), (1, 4096)):
        jtree = {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in shapes.items()}
        ttree = {k: _Shape(*v) for k, v in shapes.items()}
        want = _jflat(jactivation_shardings(jtree, jcfg, batch, seq, jrules))
        assert _flat(activation_shardings(ttree, tcfg, batch, seq, trules)) == want


@pytest.mark.parametrize("shape", GRIDS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["m6-base", "qwen3-14b"])
def test_zero1_shardings_match_reference(arch, optimizer, shape):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    jrules = jmake_rules(jcfg, AbstractMesh(shape, ("data", "model")))
    trules = make_rules(tcfg, MeshShape(("data", "model"), shape))
    jspecs = get_family(jcfg).specs(jcfg)
    jabs = jax.eval_shape(lambda: jinit(jspecs, jax.random.PRNGKey(0)))
    jopt = jmake_optimizer(JTrainConfig(optimizer=optimizer), lambda s: 1e-3)
    want = _jflat(jzero1_shardings(jax.eval_shape(jopt.init, jabs),
                                   jparam_pspecs(jspecs, jrules), jrules))
    topt = make_optimizer(TTrainConfig(optimizer=optimizer), lambda s: 1e-3)
    flat = {k: torch.empty(s.shape, device="meta")
            for k, s in flat_params(model_shapes(tcfg, train=True)).items()}
    pspecs = flat_params(param_pspecs(model_shapes(tcfg), trules))
    got = zero1_shardings(topt.init(flat), pspecs, trules)
    # the port keys its state by flat path: back to the reference's nested keys
    got = {f"['{name}']" + jax_key(path) + "".join(f"['{f}']" for f in sub): tuple(s.spec)
           for name, tree in got.items() for path, leaf in tree.items()
           for sub, s in ([((), leaf)] if not isinstance(leaf, dict)
                          else [((f,), v) for f, v in leaf.items()])}
    assert got == want


@pytest.mark.parametrize("env,multi", [(None, False), (None, True), ("2,4", False),
                                       ("2,2,4", True), ("1,8", False)])
def test_production_mesh_shape_matches_reference(monkeypatch, env, multi):
    from repro.launch import mesh as jmesh

    name = "REPRO_MESH_MULTI" if multi else "REPRO_MESH_SINGLE"
    if env is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, env)
    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes: (tuple(shape), tuple(axes)))
    shape, axes = jmesh.make_production_mesh(multi_pod=multi)
    assert production_mesh_axes(multi_pod=multi) == tuple(zip(axes, shape))


def test_train_cli_refuses_what_is_not_ported(world):
    """What the CLI refused before is trained: MoE attention (which has no
    flag: the config comes through ``launch.train.build``, as
    ``chip_smoke.built_config`` gives it) with ``--model 2`` (on the
    world's (data 2, model 2) mesh) on the smoke config, its experts split
    over "model" and its 9 global groups straddling the data ranks: every
    rank's losses equal, and within 1e-4 of the same CLI on one device."""
    one = W.cli_moe_attention(CLI)
    assert len(one) == 2 and all(np.isfinite(one))
    for r in world["ranks"]:
        assert r[4] == world["ranks"][0][4]
    np.testing.assert_allclose(world["ranks"][0][4], one, atol=TOL, rtol=0)


def test_rules_are_seen_by_the_autograd_threads():
    """The active rules are process-wide: a CUDA backward, and the remat
    recompute of the forward inside it, run on an autograd thread of their
    own, which must see the rules that forward ran under."""
    import threading

    from repro_torch.distributed.sharding import active_rules, use_rules

    rules = make_rules(_cfgs()[1], MeshShape(("data", "model"), (2, 2)), batch_sharded=True)
    seen = []
    with use_rules(rules):
        t = threading.Thread(target=lambda: seen.append(active_rules()))
        t.start()
        t.join()
    assert seen == [rules] and active_rules() is None
