"""Tensor parallelism for the xLSTM, zamba and encdec trees on the CPU.

One 4-rank gloo world (spawned once for the file) runs each family's smoke
config (f32, the reference's params carried across with
``from_jax_params``) on a (1, 4) and a (2, 2) ("data", "model") mesh, each
rank holding its blocks of the reference's partition specs
(``sharding.shard_params``; Mamba2's conv and the sLSTM FFN's up
projection whole, ``sharding.HELD_WHOLE``):

* the forward's logits, encdec's encoder memory, and three one-token
  decode steps from a fresh state (a data rank's rows, a model rank's
  heads, channels and vocab columns, put together) within 1e-4 of the
  largest magnitude of the reference's single-device functions, as
  ``test_torch_fsdp.py`` holds the decoder LM's;
* greedy tokens under the serving rules: the static engine's
  ``ServingEngine(rules=...)`` for xLSTM and zamba, ``encode`` /
  ``init_state`` / ``decode_step`` for encdec (which no engine serves, in
  either package), identical on every rank and to the reference's
  ``ServingEngine.generate`` (its encdec functions for encdec);
* two AdamW steps under ZeRO-1: every rank's loss equal, the loss, the
  gradient norm, every whole parameter and every AdamW moment within 1e-4
  of the reference's single-device ``make_train_step``, as
  ``test_torch_mesh_train.py`` holds m6;
* the (2, 2) run's checkpoint (rank 0 writes whole leaves) restored on one
  device equal to the ranks' gathered leaves.

The references are the reference's single device: its mesh tests fail
under this jax version's ``Explicit`` axes (ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_families_workers as FW
import torch_mesh_train_workers as MW
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.models import encdec as JED
from repro.models.registry import get_family as jfamily
from repro.nn import init as jinit
from repro.optim import make_optimizer as jmake_optimizer
from repro.serving.engine import ServingEngine as JStatic
from repro.train.state import init_train_state as jinit_train_state
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import leaves
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_pipeline
from repro_torch.distributed.sharding import HELD_WHOLE, MeshShape, make_rules, param_shardings
from repro_torch.launch.mesh import spawn
from repro_torch.nn import flat_params, from_jax_params, model_shapes
from repro_torch.optim import make_optimizer
from repro_torch.train.state import init_train_state
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ("xlstm-125m", "zamba2-7b", "seamless-m4t-large-v2")
MESHES = ((1, 4), (2, 2))
TOL = 1e-4                      # logits: of the largest magnitude; params: absolute
STATE_RTOL = 1e-4               # the optimizer state and gradient norm, as the mesh training tests
B, S, TRAIN_STEPS = 8, 16, 2
DECODE, GEN, MAX_LEN = 3, 6, 16     # decode steps of the logits check; greedy tokens; caches


def _cases():
    """(arch, reference config, port config, reference params, serving
    inputs, train batches) of each family."""
    out = []
    for i, arch in enumerate(ARCHS):
        jcfg, cfg = jget_smoke_config(arch), get_smoke_config(arch)
        jp = jax.device_get(jinit(jfamily(jcfg).specs(jcfg), jax.random.PRNGKey(i)))
        rng = np.random.RandomState(10 + i)
        inputs = {"tokens": rng.randint(0, cfg.vocab_size, size=(B, 6)).astype(np.int64)}
        if cfg.family == "encdec":
            inputs["frames"] = rng.randn(B, 5, cfg.d_model).astype(np.float32)
        pipe = make_pipeline(cfg, B, S, seed=3 + i)
        out.append((arch, jcfg, cfg, jp, inputs, [pipe.batch_at(s) for s in range(TRAIN_STEPS)]))
    return out


def _reference_logits(jcfg, jp, inputs):
    """The reference's forward logits (and encdec's memory), then DECODE
    steps of the prompt's first tokens from a fresh state."""
    fam = jfamily(jcfg)
    batch = {k: jnp.asarray(v) for k, v in inputs.items()}
    out = [np.asarray(fam.forward(jp, batch, jcfg)[0])]
    if jcfg.family == "encdec":
        memory = JED.encode(jp, batch["frames"], jcfg)
        out.append(np.asarray(memory))
        state = JED.init_state(jp, memory, jcfg, max_len=DECODE)
    else:
        state = fam.init_state(jcfg, B, DECODE)
    step = jax.jit(lambda p, t, s: fam.decode(p, t, s, jcfg))
    for i in range(DECODE):
        logits, state = step(jp, batch["tokens"][:, i:i + 1], state)
        out.append(np.asarray(logits))
    return out


def _reference_tokens(jcfg, jp, inputs):
    """The reference's greedy tokens: its static engine, or for encdec its
    functions (the prompt fed a token a step, then argmax)."""
    prompts = jnp.asarray(inputs["tokens"], dtype=jnp.int32)
    if jcfg.family != "encdec":
        return np.asarray(JStatic(jcfg, jp, MAX_LEN).generate(prompts, GEN)[0])
    memory = JED.encode(jp, jnp.asarray(inputs["frames"]), jcfg)
    state = JED.init_state(jp, memory, jcfg, max_len=MAX_LEN)
    step = jax.jit(lambda p, t, s: JED.decode_step(p, t, s, jcfg))
    tok, out = None, []
    for i in range(prompts.shape[1] + GEN - 1):
        feed = prompts[:, i:i + 1] if i < prompts.shape[1] else tok[:, None]
        logits, state = step(jp, feed, state)
        if i >= prompts.shape[1] - 1:
            tok = jnp.argmax(logits[:, -1, :jcfg.vocab_size], axis=-1).astype(jnp.int32)
            out.append(tok)
    return np.stack([np.asarray(t) for t in out], axis=1)


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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results, with the references' (computed here while the
    ranks run)."""
    from concurrent.futures import ThreadPoolExecutor

    tc = TrainConfig(learning_rate=1e-3)
    cases, refs = [], {}
    made = _cases()
    for arch, jcfg, cfg, jp, inputs, batches in made:
        cases.append((arch, cfg, tc, from_jax_params(jp, cfg, device="cpu", train=True),
                      from_jax_params(jp, cfg, device="cpu"), inputs, batches,
                      (DECODE, GEN, MAX_LEN)))
    d = tmp_path_factory.mktemp("mesh_families")
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, FW.families_body, 4, init_file=str(d / "init"),
                            args=(MESHES, cases, str(d / "ckpt")), timeout=240)
        for arch, jcfg, cfg, jp, inputs, batches in made:
            refs[arch] = dict(logits=_reference_logits(jcfg, jp, inputs),
                              tokens=_reference_tokens(jcfg, jp, inputs),
                              train=_reference_train(jcfg, jp, batches))
        out = ranks.result()
    return dict(ranks=out, refs=refs, cases={c[0]: c for c in cases}, tc=tc,
                ckpt=str(d / "ckpt"))


def _close(got, want, what):
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0, err_msg=what)


def _state_close(got, want, key):
    scale = float(np.abs(want).max())
    ok = np.abs(np.asarray(got) - want) <= STATE_RTOL * scale
    assert ok.all(), f"{key}: {int((~ok).sum())} of {ok.size} elements off"


PARAMS = [(a, m) for a in ARCHS for m in MESHES]
IDS = [f"{a}-{m[0]}x{m[1]}" for a, m in PARAMS]


@pytest.mark.parametrize("arch,mesh", PARAMS, ids=IDS)
def test_tp_logits_match_reference(world, arch, mesh):
    """The forward's logits (encdec: and the encoder's memory) and three
    decode steps, on every rank, within 1e-4 of the largest magnitude of
    the reference's; each rank's state holds its heads and channels."""
    cfg = world["cases"][arch][1]
    V = cfg.vocab_size
    want = world["refs"][arch]["logits"]
    model = mesh[1]
    for r in world["ranks"]:
        res = r[mesh, arch]
        assert len(res["logits"]) == len(want)
        for i, (g, w) in enumerate(zip(res["logits"], want)):
            last = slice(0, V) if g.shape[-1] != cfg.d_model else slice(None)
            _close(g[..., last], w[..., last], f"{arch} {mesh} output {i}")
        if cfg.family == "zamba":
            d_inner, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
            assert res["heads"] == {"attn": cfg.num_kv_heads // model,
                                    "ssm": cfg.ssm_heads // model,
                                    "conv": d_inner // model + 2 * N}
        elif cfg.family == "encdec":
            assert res["heads"] == {"self": cfg.num_kv_heads // model,
                                    "cross": cfg.num_kv_heads // model}


@pytest.mark.parametrize("arch,mesh", PARAMS, ids=IDS)
def test_greedy_tokens_equal_reference_on_every_rank(world, arch, mesh):
    """``ServingEngine(rules=...)``'s greedy tokens (encdec: its decode
    functions under the rules) identical on every rank and to the
    reference's engine (encdec: the reference's functions)."""
    want = world["refs"][arch]["tokens"]
    assert want.shape == (B, GEN) and len(np.unique(want)) > 1
    for r in world["ranks"]:
        np.testing.assert_array_equal(r[mesh, arch]["tokens"], want)


@pytest.mark.parametrize("arch,mesh", PARAMS, ids=IDS)
def test_two_mesh_train_steps_match_reference(world, arch, mesh):
    """Two AdamW steps under ZeRO-1: every rank's losses equal; the losses
    and every whole parameter within 1e-4 of the reference's single-device
    steps (absolute, as the mesh training tests: Adam's step turns the
    last bits of a near-zero gradient into a few lr x 1e-2, one device's
    too); the gradient norms and every whole AdamW moment within
    ``STATE_RTOL`` of its largest magnitude; each rank holds its
    placement's blocks (the ``HELD_WHOLE`` leaves whole)."""
    jlosses, jnorms, want = world["refs"][arch]["train"]
    cfg = world["cases"][arch][1]
    res = [r[mesh, arch] for r in world["ranks"]]
    for r in res:
        assert r["train"]["losses"] == res[0]["train"]["losses"]
    got = res[0]["train"]
    np.testing.assert_allclose(got["losses"], jlosses, atol=TOL, rtol=0)
    np.testing.assert_allclose(got["grad_norms"], jnorms, rtol=STATE_RTOL, atol=0)
    assert set(got["whole"]) == set(want)
    for k, v in want.items():
        if k.startswith(".params"):
            np.testing.assert_allclose(got["whole"][k], v, atol=TOL, rtol=0, err_msg=k)
        elif k.startswith(".opt_state"):
            _state_close(got["whole"][k], v, k)
        else:
            np.testing.assert_array_equal(got["whole"][k], v, err_msg=k)
    rules = make_rules(cfg, MeshShape(("data", "model"), mesh), batch_sharded=True)
    shapes = flat_params(model_shapes(cfg, train=True))
    specs = flat_params(param_shardings(model_shapes(cfg, train=True), rules, keep=("router",)))
    held = [k for k in shapes if k.split("/")[-1] in HELD_WHOLE.get(cfg.family, ())]
    assert held or cfg.family == "encdec"
    for r in res:
        for k, s in shapes.items():
            assert r["local_shapes"][k] == specs[k].local_shape(s.shape), k
        for k in held:
            assert r["local_shapes"][k] == tuple(shapes[k].shape), k
    assert any(res[0]["local_shapes"][k] != tuple(s.shape) for k, s in shapes.items()
               if k != "embed/table"), "no leaf but the vocab is sharded"


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_on_2x2_restores_on_one_device(world, arch):
    """The (2, 2) run's final state, saved by rank 0 as whole leaves,
    restored into one device's state equals every rank's gathered leaves."""
    _, cfg, tc, params, *_ = world["cases"][arch]
    opt = make_optimizer(tc, MW.SecondStepLR(tc.learning_rate))
    state = init_train_state(MW._clone(params), opt, tc.grad_compression)
    state = Checkpointer(f"{world['ckpt']}/{arch}", writer=False).restore(TRAIN_STEPS, state)
    for r in world["ranks"]:
        whole = r[MESHES[-1], arch]["train"]["whole"]
        n = 0
        for key, v in leaves(state):
            if torch.is_tensor(v):
                assert np.array_equal(v.detach().numpy(), whole[key]), key
                n += 1
        assert n == len([k for k in whole if not k.startswith(".step")])


def test_chip_smoke_phase19_runs_on_cpu(tmp_path):
    """chip_smoke's phase 19 rehearsed at smoke size on the CPU (the launch
    gates need the card): (a) every family served on (1, 4), each rank
    drawing only its blocks, tokens equal on every rank and to one
    device's, parameter bytes its placement's; (b) every family trained on
    (2, 2), losses equal on every rank, step 0 within compare_train_step's
    gates of one device, half the AdamW state a rank where a dim divides,
    and again with ``cfg.fsdp``: losses and every final parameter block
    bit-equal to the run without it, some leaves FSDP blocks."""
    import importlib.util
    import os
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    if root not in sys.path:
        sys.path.insert(0, root)        # the spawned ranks import chip_smoke by name
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    report, launches = cs.mesh_family_runs(torch, str(tmp_path), device="cpu", smoke=True)
    assert set(report["serve"]) == set(ARCHS) and set(report["train"]) == set(ARCHS)
    for arch, r in report["serve"].items():
        assert r["rows_equal_to_one_device"] == r["rows"] == B, arch
        assert all(row["param_bytes"] > 0 for row in r["ranks"]), arch
    for arch, r in report["train"].items():
        assert abs(r["loss"] - r["one_device_loss"]) <= 1e-3 and r["min_grad_cosine"] >= 0.99
        assert report["fsdp"][arch]["losses"] == r["losses"], arch
        assert report["fsdp"][arch]["fsdp_leaves"] > 0, arch
    assert not any(launches.values())       # the plain versions on the CPU
