"""MoE attention on a ("data", "model") mesh, and FSDP for the xLSTM, zamba
and encdec trees, on the CPU.

One 4-rank gloo world (spawned once for the file) runs m6's smoke config
with MoE attention (f32, the reference's params carried across with
``from_jax_params``, batches from the shared numpy pipeline), each rank
holding its blocks of the reference's partition specs (the attention
experts over "model"; the router whole):

* (a) layer 0's ``moe_attention_apply`` on (1, 4) and (2, 2) (experts
  split over "model"), on (2, 2) at a batch whose global groups straddle
  the data ranks, and with 6 experts on (1, 4) (they do not divide: the
  rules shard the heads, and the layer gathers its experts), against the
  reference's single-device ``moe_attention_apply``: the output within
  1e-4 of the reference's largest magnitude, the aux within 2e-5 (the
  data ranks' aux losses summed), and the layer's collectives as its
  form predicts;
* (b) two AdamW steps under ZeRO-1 on (2, 2), top-1 with the groups on
  their data ranks and 2 top-1 with one straddling global group, against
  the reference's single-device ``make_train_step``: every rank's loss
  equal, the loss, the gradient norm, every whole parameter (the router
  above all: a double-counted aux gradient moves it) and every AdamW
  moment within 1e-4, as ``test_torch_mesh_families.py`` holds the
  families; the MoE-attention layers' collectives a step as predicted;
* (c) xlstm-125m, zamba2-7b and seamless-m4t-large-v2 trained 2 steps on
  (2, 2) with ``cfg.fsdp``: losses, gradient norms and every final leaf
  bit-equal to the same run without FSDP (with 2 data ranks a sum over
  them has one order), and within 1e-4 of the reference's single device;
* (d) without a world: ``param_pspecs`` with ``fsdp=True`` equal to the
  reference's, for the three families and MoE attention on four grids;
* (e) the two layouts the port refused before and now computes as the
  reference's GSPMD does, gathering the layer's projections: a Mamba2
  block whose rank's channels are not whole heads (zamba smoke at 2 SSM
  heads on (1, 4)), and attention whose rank's q heads are neither whole
  GQA groups nor within one (12 q heads over 3 kv heads on (1, 4)): the
  forward's logits and two decode steps within 1e-4 of the largest
  magnitude of the reference's.

The references are the reference's single device: its mesh tests fail
under this jax version's ``Explicit`` axes (ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import torch_mesh_moe_attention_workers as AW
import torch_mesh_train_workers as MW
from repro.configs import m6 as jm6
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core.context import MoEContext as JCtx
from repro.core.moe_attention import moe_attention_apply as jmoe_attention
from repro.distributed.sharding import make_rules as jmake_rules
from repro.distributed.sharding import param_pspecs as jparam_pspecs
from repro.models.registry import get_family as jfamily
from repro.nn import init as jinit
from repro.optim import make_optimizer as jmake_optimizer
from repro.train.state import init_train_state as jinit_train_state
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch.checkpoint.checkpointer import jax_key
from repro_torch.configs import m6 as tm6
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core.moe import group_count
from repro_torch.data.pipeline import make_pipeline
from repro_torch.distributed.sharding import MeshShape, make_rules, param_pspecs
from repro_torch.launch.mesh import spawn
from repro_torch.nn import flat_params, from_jax_params, model_shapes
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4                  # outputs: of the largest magnitude; params: absolute
AUX_TOL = 2e-5
STATE_RTOL = 1e-4           # the optimizer state and gradient norm, of the leaf's largest magnitude
STEPS = 2
MESHES = ((1, 4), (2, 2))
ARCHS = ("xlstm-125m", "zamba2-7b", "seamless-m4t-large-v2")
GRIDS = [(2, 4), (8, 1), (1, 8), (1, 16)]
# name: (arch, config overrides), on (1, 4)
GATHERED = {"mamba2 half a head a rank": ("zamba2-7b", dict(ssm_heads=2)),
            "3 q heads a rank in groups of 4": ("qwen3-8b",
                                                dict(num_heads=12, num_kv_heads=3, head_dim=16))}
DECODE = 2


def _cfgs(routing="topk", k=1, **moe):
    """m6 smoke with MoE attention (both packages), routed as ``variant``
    routes it."""
    return (jm6.variant(jm6.smoke(), routing, k).replace_moe(moe_attention=True, **moe),
            tm6.variant(tm6.smoke(), routing, k).replace_moe(moe_attention=True, **moe))


# name: (config args, (rows, positions), meshes); 32 positions a row: 256
# positions are 8 groups of 32 (4 a data rank), 288 are 9 (straddling)
FORWARD = {"top-1": (((), {}), (8, 32), MESHES),
           "top-1 straddling": (((), {}), (8, 36), ((2, 2),)),
           "2 top-1 straddling": ((("prototype", 2), {}), (8, 36), ((2, 2),)),
           "6 experts": (((), dict(num_experts=6)), (8, 32), ((1, 4),))}
# name: (config args, (batch, seq)), on (2, 2)
TRAIN = {"top-1": (((), {}), (8, 32)),
         "2 top-1 straddling": ((("prototype", 2), {}), (8, 36))}


def _inputs(cfg, rows, S, seed):
    rng = np.random.RandomState(seed)
    return dict(x=rng.randn(rows, S, cfg.d_model).astype(np.float32),
                positions=np.broadcast_to(np.arange(S, dtype=np.int64), (rows, S)).copy(),
                tokens=rng.randint(0, cfg.vocab_size, size=(rows, S)).astype(np.int64))


def _reference_forward(jcfg, jp, inputs):
    attn = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["attn"])
    pos = jnp.asarray(inputs["positions"], dtype=jnp.int32)
    ctx = JCtx().with_tokens(jnp.asarray(inputs["tokens"], dtype=jnp.int32), pos)
    fwd = jax.jit(lambda a, x, p, c: jmoe_attention(a, x, jcfg, positions=p, ctx=c))
    y, aux = fwd(attn, jnp.asarray(inputs["x"]), pos, ctx)
    return np.asarray(y), {k: float(v) for k, v in aux.items()}


def _reference_train(jcfg, jp, batches):
    jtc = JTrainConfig(learning_rate=1e-3)
    opt = jmake_optimizer(jtc, MW.SecondStepLR(jtc.learning_rate))
    step = jax.jit(jmake_train_step(jcfg, jtc, opt))
    state = jinit_train_state(jp, opt, jtc.grad_compression)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                           jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]}


def _reference_logits(jcfg, jp, inputs):
    """The reference's forward logits, then ``DECODE`` one-token steps of
    the prompt's first tokens from a fresh state."""
    fam = jfamily(jcfg)
    tokens = jnp.asarray(inputs["tokens"])
    out = [np.asarray(fam.forward(jp, {"tokens": tokens}, jcfg)[0])]
    state = fam.init_state(jcfg, tokens.shape[0], DECODE)
    step = jax.jit(lambda p, t, s: fam.decode(p, t, s, jcfg))
    for i in range(DECODE):
        logits, state = step(jp, tokens[:, i:i + 1], state)
        out.append(np.asarray(logits))
    return out


def _params(jcfg, cfg, seed):
    jp = jax.device_get(jinit(jfamily(jcfg).specs(jcfg), jax.random.PRNGKey(seed)))
    return jp, from_jax_params(jp, cfg, device="cpu", train=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results, with the references' (computed here while the
    ranks run)."""
    from concurrent.futures import ThreadPoolExecutor

    tc = TrainConfig(learning_rate=1e-3)
    forward, train, families, jobs = [], [], [], {}
    for i, (name, ((rk, moe), (rows, S), on)) in enumerate(FORWARD.items()):
        jcfg, cfg = _cfgs(*rk, **moe)
        jp, params = _params(jcfg, cfg, i)
        inputs = _inputs(cfg, rows, S, 20 + i)
        forward.append((name, cfg, params, inputs, on))
        jobs["forward", name] = (_reference_forward, jcfg, jp, inputs)
    for i, (name, ((rk, moe), (B, S))) in enumerate(TRAIN.items()):
        jcfg, cfg = _cfgs(*rk, **moe)
        jp, params = _params(jcfg, cfg, 10 + i)
        pipe = make_pipeline(cfg, B, S, seed=30 + i)
        batches = [pipe.batch_at(s) for s in range(STEPS)]
        train.append((name, cfg, tc, params, batches, ((2, 2),)))
        jobs["train", name] = (_reference_train, jcfg, jp, batches)
    for i, arch in enumerate(ARCHS):
        jcfg, cfg = jget_smoke_config(arch), get_smoke_config(arch)
        jp, params = _params(jcfg, cfg, 40 + i)
        pipe = make_pipeline(cfg, 4, 16, seed=50 + i)
        batches = [pipe.batch_at(s) for s in range(STEPS)]
        families.append((arch, cfg, tc, params, batches, ((2, 2),)))
        jobs["fsdp", arch] = (_reference_train, jcfg, jp, batches)
    gathered = []
    for i, (name, (arch, kw)) in enumerate(GATHERED.items()):
        jcfg, cfg = jget_smoke_config(arch).replace(**kw), get_smoke_config(arch).replace(**kw)
        jp = jax.device_get(jinit(jfamily(jcfg).specs(jcfg), jax.random.PRNGKey(60 + i)))
        rng = np.random.RandomState(70 + i)
        inputs = {"tokens": rng.randint(0, cfg.vocab_size, size=(4, 6)).astype(np.int64)}
        gathered.append((name, cfg, from_jax_params(jp, cfg, device="cpu"), inputs, DECODE,
                         ((1, 4),)))
        jobs["gathered", name] = (_reference_logits, jcfg, jp, inputs)
    d = tmp_path_factory.mktemp("mesh_moe_attention")
    with ThreadPoolExecutor(1) as pool, ThreadPoolExecutor(3) as jax_pool:
        ranks = pool.submit(spawn, AW.moe_attention_body, 4, init_file=str(d / "init"),
                            args=(MESHES, forward, train, families, gathered), timeout=240)
        refs = {key: jax_pool.submit(fn, *a) for key, (fn, *a) in jobs.items()}
        refs = {key: r.result() for key, r in refs.items()}
        out = ranks.result()
    return dict(ranks=out, refs=refs, forward={c[0]: c for c in forward},
                train={c[0]: c for c in train})


def _close(got, want, what, tol=TOL):
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0, err_msg=what)


def _predicted(cfg, shape, rows, S):
    """A layer's collectives as the module doc of ``core.moe_attention``
    predicts them, forward only (no remat here): {kind: {axis: n}}."""
    mesh = MeshShape(("data", "model"), shape)
    rules = make_rules(cfg, mesh, batch_sharded=True)
    # on (1, n) the model axis's group is the world's, counted under its name
    model = "model" if shape[0] > 1 else "data+model"
    out = {}
    if rules.params["expert"] is not None and shape[1] > 1:
        out["all-reduce"] = {model: 2}
    elif shape[1] > 1:                  # the experts gathered over the heads' axis: q, k, v, o
        out["all-gather"] = {model: 4}
    if shape[0] > 1:
        if group_count(rows * S, cfg.moe) % shape[0]:      # the groups straddle
            out["all-gather"] = {**out.get("all-gather", {}), "data": 3}
        else:
            out.setdefault("all-reduce", {})["data"] = 1
    return out


FORWARD_PARAMS = [(n, m) for n, (_, _, on) in FORWARD.items() for m in on]


@pytest.mark.parametrize("name,mesh", FORWARD_PARAMS,
                         ids=[f"{n}-{m[0]}x{m[1]}" for n, m in FORWARD_PARAMS])
def test_moe_attention_forward_matches_reference(world, name, mesh):
    """Every rank's output (the data ranks' rows together) within 1e-4 of
    the largest magnitude of the reference's, equal on every model rank;
    the aux within 2e-5 (each data rank reports its part of the aux and z
    losses: they sum to the reference's); the collectives as predicted."""
    want_y, want_aux = world["refs"]["forward", name]
    _, cfg, _, inputs, _ = world["forward"][name]
    res = [r["forward", mesh, name] for r in world["ranks"]]
    for r in res:
        np.testing.assert_array_equal(r[0], res[0][0])
        _close(r[0], want_y, f"{name} {mesh}")
        assert r[2] == _predicted(cfg, mesh, *inputs["x"].shape[:2]), r[2]
    D, M = mesh
    for k, want in want_aux.items():
        got = [res[d * M][1][k] for d in range(D)]
        got = sum(got) if k.endswith("_loss") else got[0]
        assert abs(got - want) <= AUX_TOL, (k, got, want)
    if "straddling" in name:
        assert "data" in res[0][2]["all-gather"]


@pytest.mark.parametrize("name", TRAIN)
def test_two_mesh_train_steps_match_reference(world, name):
    """Two AdamW steps under ZeRO-1 on (2, 2): every rank's losses equal;
    the losses and every whole parameter within 1e-4 of the reference's
    single-device steps (absolute, as the mesh training tests); the
    gradient norms and every whole AdamW moment within ``STATE_RTOL`` of
    its largest magnitude; a rank holds half the attention experts; the
    MoE-attention layers ran the collectives their form predicts, forward,
    remat recompute and backward."""
    jlosses, jnorms, want = world["refs"]["train", name]
    _, cfg, _, _, batches, _ = world["train"][name]
    res = [r["train", (2, 2), name] for r in world["ranks"]]
    for r in res:
        assert r["losses"] == res[0]["losses"]
    got = res[0]
    np.testing.assert_allclose(got["losses"], jlosses, atol=TOL, rtol=0)
    np.testing.assert_allclose(got["grad_norms"], jnorms, rtol=STATE_RTOL, atol=0)
    assert set(got["whole"]) == set(want)
    routers = [k for k in want if k.startswith(".params") and "router" in k]
    assert any("attn" in k for k in routers)
    for k, v in want.items():
        if k.startswith(".params"):
            np.testing.assert_allclose(got["whole"][k], v, atol=TOL, rtol=0, err_msg=k)
        elif k.startswith(".opt_state"):
            scale = float(np.abs(v).max())
            ok = np.abs(np.asarray(got["whole"][k]) - v) <= STATE_RTOL * scale
            assert ok.all(), f"{k}: {int((~ok).sum())} of {ok.size} elements off"
        else:
            np.testing.assert_array_equal(got["whole"][k], v, err_msg=k)
    E, L = cfg.moe.num_experts, cfg.num_layers
    for r in res:
        assert r["local_shapes"]["blocks/attn/wq"][:2] == (L, E // 2)
        assert r["local_shapes"]["blocks/attn/router"] == tuple(
            model_shapes(cfg, train=True)["blocks"]["attn"]["router"].shape)
        assert r["halved"] == r["zeroed"] > 0
    rows, S = TRAIN[name][1]            # positions a row: tokens and image patches
    assert batches[0]["tokens"].shape[1] + batches[0]["patch_embeds"].shape[1] == S
    strad = group_count(rows * S, cfg.moe) % 2 != 0
    assert strad == ("straddling" in name)
    n = L * STEPS
    want_scoped = ({"all-reduce": {"model": 7 * n}, "all-gather": {"data": 6 * n},
                    "reduce-scatter": {"data": 2 * n}} if strad else
                   {"all-reduce": {"model": 7 * n, "data": 2 * n}})
    for r in res:
        assert r["scoped"] == want_scoped, r["scoped"]


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_families_bit_equal_and_match_reference(world, arch):
    """``cfg.fsdp`` on (2, 2): losses, gradient norms and every final leaf
    bit-equal to the same run without FSDP on every rank, some leaves
    FSDP blocks; the run within 1e-4 of the reference's single device."""
    jlosses, jnorms, want = world["refs"]["fsdp", arch]
    for r in world["ranks"]:
        res = r["fsdp", (2, 2), arch]
        base, fsdp = res["base"], res["fsdp"]
        assert res["fsdp_leaves"]
        assert fsdp["losses"] == base["losses"] and fsdp["grad_norms"] == base["grad_norms"]
        assert set(fsdp["whole"]) == set(base["whole"])
        for k, v in base["whole"].items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(fsdp["whole"][k].view(np.uint8), v.view(np.uint8)), k
            else:
                assert fsdp["whole"][k] == v, k
    got = world["ranks"][0]["fsdp", (2, 2), arch]["fsdp"]
    np.testing.assert_allclose(got["losses"], jlosses, atol=TOL, rtol=0)
    np.testing.assert_allclose(got["grad_norms"], jnorms, rtol=STATE_RTOL, atol=0)
    for k, v in want.items():
        if k.startswith(".params"):
            np.testing.assert_allclose(got["whole"][k], v, atol=TOL, rtol=0, err_msg=k)


def _entries(spec):
    """A spec's entries, a one-axis tuple as its axis (``PartitionSpec``
    reads ``("data",)`` as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


@pytest.mark.parametrize("name", GATHERED)
def test_gathered_layouts_match_reference(world, name):
    """The forward's logits and two decode steps on every rank of (1, 4),
    within 1e-4 of the largest magnitude of the reference's, where a rank's
    block of the layer is not its own heads and the layer gathers it."""
    want = world["refs"]["gathered", name]
    for r in world["ranks"]:
        got = r["gathered", (1, 4), name]
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{name} output {i}")


def _jflat(tree):
    from jax.sharding import PartitionSpec as P

    return {jax.tree_util.keystr(p): _entries(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]}


@pytest.mark.parametrize("shape", GRIDS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", [*ARCHS, "m6-base moe_attention"])
def test_fsdp_param_pspecs_match_reference(arch, shape):
    """With ``fsdp=True``: the rules and every leaf's partition spec equal
    the reference's ("embed" over the data axes where d_model divides)."""
    base = arch.split()[0]
    jcfg, cfg = jget_config(base).replace(fsdp=True), get_config(base).replace(fsdp=True)
    if arch.endswith("moe_attention"):
        jcfg, cfg = (c.replace_moe(moe_attention=True) for c in (jcfg, cfg))
    jrules = jmake_rules(jcfg, AbstractMesh(shape, ("data", "model")))
    rules = make_rules(cfg, MeshShape(("data", "model"), shape))
    assert rules.params == jrules.params and rules.acts == jrules.acts
    want = _jflat(jparam_pspecs(jfamily(jcfg).specs(jcfg), jrules))
    got = {jax_key(k): _entries(v)
           for k, v in flat_params(param_pspecs(model_shapes(cfg), rules)).items()}
    assert got == want
    if shape[0] > 1:
        assert any("data" in v for v in got.values())
