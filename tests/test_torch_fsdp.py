"""FSDP on the port's training mesh, and the decoder LM's tensor-parallel
cached attention, on the CPU.

One 4-rank gloo world (a (2, 2) ("data", "model") mesh, spawned once for
the file) trains smoke m6 (the reference's ``get_smoke_config("m6-base")``,
f32, expert-parallel ``alltoall``) for 2 steps from the reference's params
under ZeRO-1 and under FSDP (``cfg.fsdp``: the "embed" dim over "data",
gathered at each use, gradients reduce-scattered).  With 2 data ranks a
sum over them has one order, so FSDP's losses, gradient norms and final
parameters must equal ZeRO-1's bit for bit; both are held to the
reference's single-device ``make_train_step`` within the reference's pjit
tolerance (``test_distributed.py:90-93``, 1e-4), as the mesh training
tests hold ZeRO-1.  The FSDP run's checkpoint must restore whole into one
device's state.  The same world prefills and decodes under ("data",
"model") rules (a rank's rows, heads, kv heads, experts and vocab
columns) and its logits must equal one device's within the serving
tests' 1e-4.  Two more head layouts of the tensor-parallel attention
train 2 steps and serve in the same world, against one device within
1e-4: q / k norms with one kv head that the model axis cannot split (a
rank projects the kv head its q heads read), and 3 heads with q / k / v
biases (a rank's block is 1.5 heads: the layer gathers its projections).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fsdp_workers as FW
import torch_mesh_train_workers as MW
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.models.registry import get_family
from repro.nn import init as jinit
from repro.optim import make_optimizer as jmake_optimizer
from repro.train.state import init_train_state as jinit_train_state
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import jax_key, leaves
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_pipeline
from repro_torch.distributed.sharding import MeshShape, make_rules, param_shardings
from repro_torch.launch.mesh import spawn
from repro_torch.models import transformer as TF
from repro_torch.nn import flat_params, from_jax_params, model_shapes
from repro_torch.optim import make_optimizer
from repro_torch.train.state import init_train_state
from repro_torch.train.trainer import make_train_step
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4                      # the reference's pjit test; the serving tests' tolerance
STEPS = 2
CLIP = 0.5                      # under the gradient norms (~0.75): the clip scales every step
B, SEQ = 8, 36                  # 4 patch embeddings + 32 text tokens a row


def _cfgs():
    jcfg = jget_smoke_config("m6-base").replace_moe(impl="alltoall")
    return jcfg, get_smoke_config("m6-base").replace_moe(impl="alltoall")


def _batches(cfg):
    pipe = make_pipeline(cfg, B, SEQ, seed=3)
    return [pipe.batch_at(i) for i in range(STEPS)]


# name: (arch, config overrides); both f32 smoke configs on 2 model ranks
HEADS = {"kv head whole, qk norm": ("qwen3-8b", dict(num_kv_heads=1)),
         "1.5 heads a rank, qkv bias": ("qwen2.5-32b", dict(num_heads=3, num_kv_heads=1))}


def _heads_case(name):
    arch, kw = HEADS[name]
    jcfg = jget_smoke_config(arch).replace(**kw)
    cfg = get_smoke_config(arch).replace(**kw)
    jparams = jax.device_get(jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(1)))
    pipe = make_pipeline(cfg, B, 32, seed=5)
    return (name, cfg, from_jax_params(jparams, cfg, device="cpu", train=True),
            from_jax_params(jparams, cfg, device="cpu"), [pipe.batch_at(i) for i in range(STEPS)])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jcfg, cfg = _cfgs()
    jparams = jax.device_get(jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0)))
    params = from_jax_params(jparams, cfg, device="cpu", train=True)
    serve = from_jax_params(jparams, cfg, device="cpu")
    batches = _batches(cfg)
    tc = TrainConfig(learning_rate=1e-3, grad_clip_norm=CLIP)
    tokens = np.random.RandomState(4).randint(0, cfg.vocab_size, size=(4, 12)).astype(np.int64)
    heads = [_heads_case(name) for name in HEADS]
    d = tmp_path_factory.mktemp("fsdp")
    ranks = spawn(FW.fsdp_body, 4, init_file=str(d / "init"), timeout=240,
                  args=(cfg, tc, params, serve, batches, str(d / "ckpt"), tokens, heads))
    return dict(ranks=ranks, jcfg=jcfg, cfg=cfg, jparams=jparams, params=params, serve=serve,
                batches=batches, tc=tc, tokens=tokens, ckpt=str(d / "ckpt"),
                heads={h[0]: h for h in heads})


def test_fsdp_bit_equal_to_zero1(world):
    """Losses, gradient norms and every final leaf (parameters and AdamW
    moments, whole) of FSDP equal ZeRO-1's bit for bit, on every rank; the
    clip scaled the gradients at every step."""
    for r in world["ranks"]:
        assert min(r["fsdp"]["grad_norms"]) > CLIP
        z, f = r["zero"], r["fsdp"]
        assert f["losses"] == z["losses"]
        assert f["grad_norms"] == z["grad_norms"]
        assert set(f["whole"]) == set(z["whole"])
        for k, v in z["whole"].items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(f["whole"][k].view(np.uint8), v.view(np.uint8)), k
            else:
                assert f["whole"][k] == v, k


def test_fsdp_holds_blocks_and_gathers(world):
    """Every leaf with an "embed" dim (the router aside, held whole) is the
    rank's half of it on that dim; the step all-gathers the blocks at each
    use and reduce-scatters their gradients."""
    cfg = world["cfg"].replace(fsdp=True)
    rules = make_rules(cfg, MeshShape(("data", "model"), (2, 2)), batch_sharded=True)
    specs = flat_params(param_shardings(model_shapes(cfg, train=True), rules, keep=("router",)))
    shapes = flat_params(model_shapes(cfg, train=True))
    r = world["ranks"][0]
    embed = [k for k, s in shapes.items() if "embed" in s.axes and not k.endswith("router")]
    assert sorted(embed) == r["fsdp_leaves"]
    for k, s in shapes.items():
        assert r["local_shapes"][k] == specs[k].local_shape(s.shape), k
    assert r["counts"]["reduce_scatter"] > 0 and r["counts"]["all_gather"] > 0


def _reference(world):
    jcfg, jparams = world["jcfg"], world["jparams"]
    jtc = JTrainConfig(learning_rate=world["tc"].learning_rate, grad_clip_norm=CLIP)
    opt = jmake_optimizer(jtc, MW.SecondStepLR(jtc.learning_rate))
    step = jax.jit(jmake_train_step(jcfg, jtc, opt))
    state = jinit_train_state(jparams, opt, jtc.grad_compression)
    losses = []
    for b in world["batches"]:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, jax.device_get(state.params)


def test_fsdp_matches_reference_single_device(world):
    """FSDP's losses and whole final parameters within 1e-4 of the
    reference's single-device step on the same params and batches."""
    losses, jp = _reference(world)
    f = world["ranks"][0]["fsdp"]
    np.testing.assert_allclose(f["losses"], losses, atol=TOL, rtol=TOL)
    want = flat_params(from_jax_params(jp, world["cfg"], device="cpu", train=True))
    for k, v in want.items():
        got = f["whole"][".params" + jax_key(k)]
        np.testing.assert_allclose(got, v.numpy(), atol=TOL, rtol=TOL, err_msg=k)


def test_fsdp_checkpoint_restores_whole_on_one_device(world):
    """The FSDP run's checkpoint (rank 0 wrote the whole leaves) restored
    into one device's state equals the mesh's final parameters, whole."""
    cfg, tc = world["cfg"], world["tc"]
    opt = make_optimizer(tc, MW.SecondStepLR(tc.learning_rate))
    state = init_train_state(MW._clone(world["params"]), opt, tc.grad_compression)
    state = Checkpointer(world["ckpt"], writer=False).restore(STEPS, state)
    f = world["ranks"][0]["fsdp"]["whole"]
    for key, v in leaves(state):
        if torch.is_tensor(v):
            assert np.array_equal(v.detach().numpy(), f[key]), key


def _one_device_logits(cfg, serve, tokens):
    with torch.inference_mode():
        logits, caches, _ = TF.prefill_apply(serve, torch.from_numpy(tokens), cfg, max_len=15)
        want = [logits.numpy()]
        for i in range(3):
            tok = (torch.from_numpy(tokens[:, -1:]) + i + 1) % cfg.vocab_size
            logits, caches = TF.decode_apply(serve, tok, caches, cfg)
            want.append(logits.numpy())
    return want


def _close_logits(got, want, cfg):
    for g, w in zip(got, want):
        live = slice(0, cfg.vocab_size)
        np.testing.assert_allclose(g[..., live], w[..., live], atol=TOL, rtol=TOL)


def test_tp_prefill_decode_match_one_device(world):
    """Prefill and 3 decode steps under ("data", "model") rules: a rank's
    cache holds its 2 of 4 kv heads, and the logits (rows and vocab
    columns put together) equal one device's within 1e-4."""
    cfg = world["cfg"]
    want = _one_device_logits(cfg, world["serve"], world["tokens"])
    for r in world["ranks"]:
        assert r["kv_heads"] == cfg.num_kv_heads // 2
        _close_logits(r["logits"], want, cfg)


@pytest.mark.parametrize("name", list(HEADS))
def test_tp_head_layouts_match_one_device(world, name):
    """Two train steps (the second with lr 1e-3) and the prefill and
    decode logits of a head layout the model axis cannot split by whole kv
    heads or whole heads, against one device within 1e-4: the loss at each
    step, every whole final parameter (the q / k norms, ``wk`` / ``wv`` and
    their biases summed over the ranks that use them), the logits."""
    _, cfg, params, serve, batches = world["heads"][name]
    tc = world["tc"]
    opt = make_optimizer(tc, MW.SecondStepLR(tc.learning_rate))
    step = make_train_step(cfg, tc, opt)
    state = init_train_state(MW._clone(params), opt, tc.grad_compression)
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    want = _one_device_logits(cfg, serve, world["tokens"])
    kv = 1
    for r in world["ranks"]:
        got = r["heads"][name]
        np.testing.assert_allclose(got["train"]["losses"], losses, atol=TOL, rtol=TOL)
        for k, v in flat_params(state.params).items():
            np.testing.assert_allclose(got["train"]["whole"][".params" + jax_key(k)],
                                       v.detach().numpy(), atol=TOL, rtol=TOL, err_msg=k)
        logits, heads = got["serve"]
        assert heads == kv
        _close_logits(logits, want, cfg)
