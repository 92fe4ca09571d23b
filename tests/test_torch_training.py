"""The port's training path against the JAX reference on the CPU: the
data pipeline, the param trees, ``lm_apply`` with and without the flash
kernel, the train step over three steps, and the train CLI.

Inputs are the reference pipeline's numpy batches; params are the
reference's, carried across with ``from_jax_params(..., train=True)``.
Tolerances are stated where they are used.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import m6 as jm6
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as jpipe
from repro.models.registry import get_family
from repro.models.transformer import lm_apply as j_lm_apply
from repro.nn import init as jinit
from repro.optim import make_optimizer as j_make_optimizer
from repro.optim import warmup_constant as j_warmup
from repro.train.state import init_train_state as j_init_state
from repro.train.trainer import make_eval_step as j_make_eval_step
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch.configs import m6 as tm6
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.data import pipeline as tpipe
from repro_torch.models.transformer import lm_apply as t_lm_apply
from repro_torch.nn import flat_params, from_jax_params, lm_shapes
from repro_torch.optim import make_optimizer as t_make_optimizer
from repro_torch.optim import warmup_constant as t_warmup
from repro_torch.train.state import init_train_state as t_init_state
from repro_torch.train.trainer import make_eval_step as t_make_eval_step
from repro_torch.train.trainer import make_train_step as t_make_train_step
from torch_threads import one_torch_thread  # noqa: F401


def _cfgs(**moe):
    return jm6.smoke().replace_moe(**moe), tm6.smoke().replace_moe(**moe)


def _params(jcfg, tcfg, seed=0):
    jp = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(seed))
    return jp, from_jax_params(jax.device_get(jp), tcfg, device="cpu", train=True)


def _jflat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


@pytest.mark.parametrize("make", [
    lambda m: m.SyntheticLM(263, batch=3, seq_len=20, seed=5),
    lambda m: m.SyntheticMultimodal(263, 64, 4, batch=2, seq_len=32, seed=1),
    lambda m: m.make_pipeline(jm6.M6_BASE, 8, 144, seed=0),      # the m6-base train batch
])
def test_pipeline_batches_bit_equal(make):
    jp, tp = make(jpipe), make(tpipe)
    for step in (0, 1, 7):
        jb, tb = jp.batch_at(step), tp.batch_at(step)
        assert set(jb) == set(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])


@pytest.mark.parametrize("moe", [dict(), dict(routing="prototype", num_prototypes=4)])
def test_training_tree_matches_reference_specs(moe):
    """Key for key and shape for shape the reference's spec tree, every
    leaf f32 as the reference stores it; the serving tree keeps m6-base's
    matmul weights in bf16 (its numbers do not move)."""
    jcfg, tcfg = _cfgs(**moe)
    abstract = jax.eval_shape(lambda: jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0)))
    jshapes = {"/".join(str(k.key) for k in path): tuple(v.shape)
               for path, v in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    tree = flat_params(lm_shapes(tcfg, train=True))
    assert {k: tuple(v.shape) for k, v in tree.items()} == jshapes
    assert {v.dtype for v in tree.values()} == {"float32"}
    serve = flat_params(lm_shapes(tm6.M6_BASE))
    assert serve["blocks/ffn/up"].dtype == serve["embed/table"].dtype == "bfloat16"
    assert serve["blocks/ffn/router"].dtype == "float32"
    if moe:
        assert tree["blocks/ffn/router"].shape == (2, 64, 4, 2)       # (L, d, Z, F)


@pytest.mark.parametrize("use_flash", [False, True])
def test_lm_apply_matches_reference(use_flash):
    """m6 smoke (f32), 4 patch embeddings + 32 tokens: logits within 1e-4
    (f32 through two layers; the reference's engine parity uses 1e-4) and
    every aux entry within 2e-5.  With ``use_flash`` both sides run their
    flash path: the reference's Pallas kernel in interpret mode, the
    port's wrapper its plain version."""
    jcfg, tcfg = _cfgs(impl="gather")
    jp, tp = _params(jcfg, tcfg)
    b = jpipe.make_pipeline(jcfg, 3, 36, seed=2).batch_at(0)
    jl, jaux = j_lm_apply(jp, jnp.asarray(b["tokens"]), jcfg, use_flash=use_flash,
                          extra_embeds=jnp.asarray(b["patch_embeds"]))
    with torch.no_grad():
        tl, taux = t_lm_apply(tp, torch.from_numpy(b["tokens"]), tcfg, use_flash=use_flash,
                              extra_embeds=torch.from_numpy(b["patch_embeds"]))
    V = jcfg.vocab_size
    np.testing.assert_allclose(tl[..., :V].numpy(), np.asarray(jl)[..., :V], atol=1e-4, rtol=1e-4)
    assert (tl[..., V:] == torch.finfo(torch.float32).min).all()
    assert set(jaux) == set(taux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), atol=2e-5, rtol=2e-5,
                                   err_msg=k)


TRAIN_CASES = [
    # (routing overrides, impl, microbatches)
    (dict(), "pallas", 1),                                       # the slice's path
    (dict(routing="prototype", num_prototypes=2), "einsum", 1),  # 2 top-1 prototyping
    (dict(), "gather", 2),                                       # gradient accumulation
]


@pytest.mark.parametrize("moe,impl,microbatches", TRAIN_CASES)
def test_train_steps_match_reference(moe, impl, microbatches):
    """Three AdamW steps of m6 smoke from the same params on the same
    batches.  lr 1e-3 with a 2-step warmup, so each step moves a weight by
    up to ~1e-3 and a wrong update shows.  Per-step loss and grad norm
    within rtol 1e-5, every parameter after the last step within 2e-5
    (f32; observed below 5e-6)."""
    jcfg, tcfg = _cfgs(impl=impl, **moe)
    jp, tp = _params(jcfg, tcfg)
    kw = dict(learning_rate=1e-3, warmup_steps=2, microbatches=microbatches)
    jtc, ttc = JTrainConfig(**kw), TTrainConfig(**kw)
    jopt = j_make_optimizer(jtc, j_warmup(jtc.learning_rate, jtc.warmup_steps))
    topt = t_make_optimizer(ttc, t_warmup(ttc.learning_rate, ttc.warmup_steps))
    jstate, tstate = j_init_state(jp, jopt), t_init_state(tp, topt)
    jstep = jax.jit(j_make_train_step(jcfg, jtc, jopt))
    tstep = t_make_train_step(tcfg, ttc, topt)
    pipe = jpipe.make_pipeline(jcfg, 4, 36, seed=0)
    for i in range(3):
        b = pipe.batch_at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        assert set(jm) == set(tm)
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert tstate.step == int(jstate.step) == 3
    jflat, tflat = _jflat(jstate.params), flat_params(tstate.params)
    assert set(jflat) == set(tflat)
    moved = 0.0
    for k, t in tflat.items():
        np.testing.assert_allclose(t.detach().numpy(), jflat[k], atol=2e-5, rtol=0, err_msg=k)
        moved = max(moved, float(np.abs(jflat[k] - np.asarray(_jflat(jp)[k])).max()))
    assert moved > 1e-3                      # the steps did move the weights


def test_eval_step_matches_reference():
    jcfg, tcfg = _cfgs(impl="pallas")
    jp, tp = _params(jcfg, tcfg)
    b = jpipe.make_pipeline(jcfg, 2, 36, seed=3).batch_at(4)
    jm = j_make_eval_step(jcfg)(jp, {k: jnp.asarray(v) for k, v in b.items()})
    tm = t_make_eval_step(tcfg)(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(tm[k].float().numpy(), np.asarray(jm[k], np.float32),
                                   rtol=1e-5, atol=2e-5, err_msg=k)


def test_train_config_matches_reference():
    assert dataclasses.asdict(JTrainConfig()) == dataclasses.asdict(TTrainConfig())


def test_cli_trains_on_cpu(tmp_path):
    from repro_torch.launch.train import main

    logs = main(["--arch", "m6-base", "--smoke", "--moe-impl", "pallas", "--steps", "3",
                 "--batch", "4", "--seq", "36", "--log-every", "1", "--device", "cpu",
                 "--trace-out", str(tmp_path / "t.json"),
                 "--metrics-out", str(tmp_path / "m.jsonl")])
    assert [m["step"] for m in logs] == [0, 1, 2]
    for m in logs:
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
        assert 0.0 <= m["moe_dropped_fraction"] < 1.0
    assert (tmp_path / "t.json").exists() and (tmp_path / "m.jsonl").exists()
    logs = main(["--arch", "m6-base", "--smoke", "--moe-impl", "einsum", "--routing",
                 "prototype", "--k", "2", "--steps", "1", "--batch", "2", "--seq", "36",
                 "--device", "cpu"])
    assert np.isfinite(logs[-1]["loss"])


@pytest.mark.parametrize("flags,name", [
    (["--model", "2"], "--data/--model"),
    (["--data", "2"], "--data/--model"),
    (["--moe-impl", "alltoall"], "alltoall"),
    (["--moe-impl", "alltoall", "--routing", "expert_choice"], "alltoall"),
])
def test_cli_unported_flags_raise(flags, name):
    """--data/--model above 1 trains on a mesh of that many ranks, one
    process a rank: in one process, without ``torch.distributed.run``'s
    environment, it raises and says how to start the ranks (the mesh itself
    is ``test_torch_mesh_train.py``'s).  ``--moe-impl alltoall`` trains, as
    the reference's does without a mesh: as ``gather``, its losses equal to
    the gather CLI's, and its train step (the CLI's config, from the
    reference's params) within rtol 1e-5 of the reference's step under
    alltoall over two steps."""
    from repro_torch.launch.train import build, build_parser, main

    if name != "alltoall":
        with pytest.raises(RuntimeError, match="torch.distributed.run"):
            main(["--arch", "m6-base", "--smoke", "--steps", "1", "--device", "cpu", *flags])
        return
    argv = ["--arch", "m6-base", "--smoke", "--steps", "2", "--batch", "2", "--seq", "36",
            "--log-every", "1", "--device", "cpu"]
    logs = main(argv + flags)
    gather = main(argv + ["gather" if f == "alltoall" else f for f in flags])
    assert [m["loss"] for m in logs] == [m["loss"] for m in gather]
    assert all(np.isfinite(m["loss"]) for m in logs)
    tcfg = build(build_parser().parse_args(argv + flags))
    jcfg = jm6.smoke().replace_moe(routing=tcfg.moe.routing, top_k=tcfg.moe.top_k,
                                   impl="alltoall")
    jp, tp = _params(jcfg, tcfg)
    kw = dict(learning_rate=1e-3, warmup_steps=2)
    jtc, ttc = JTrainConfig(**kw), TTrainConfig(**kw)
    jopt = j_make_optimizer(jtc, j_warmup(jtc.learning_rate, jtc.warmup_steps))
    topt = t_make_optimizer(ttc, t_warmup(ttc.learning_rate, ttc.warmup_steps))
    jstate, tstate = j_init_state(jp, jopt), t_init_state(tp, topt)
    jstep = jax.jit(j_make_train_step(jcfg, jtc, jopt))
    tstep = t_make_train_step(tcfg, ttc, topt)
    pipe = jpipe.make_pipeline(jcfg, 2, 36, seed=0)
    for i in range(2):
        b = pipe.batch_at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)


def test_chip_smoke_train_comparisons_run_on_cpu(capsys):
    """chip_smoke's kernels-vs-plain train-step, flash-forward and dropless
    gradient comparisons, rehearsed at smoke size on the CPU (where both
    sides run the plain versions, so nothing may differ)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.launch.train import device_batch

    argv = ["--arch", "m6-base", "--smoke", "--moe-impl", "pallas", "--batch", "4",
            "--seq", "36", "--device", "cpu"]
    cfg, state, _, pipeline = chip_smoke.train_setup(argv + ["--steps", "2"])
    batch = device_batch(pipeline.batch_at(0), "cpu")
    out = chip_smoke.compare_train_step(torch, cfg, state.params, batch)
    assert out["loss"] == out["plain_loss"] and out["routing_flips"] == 0
    out = chip_smoke.compare_flash_forward(torch, cfg, state.params, batch, fa)
    assert out["max_abs_logit_diff"] < 1e-4 and out["routing_flips"] == 0
    out = chip_smoke.dropless_gradient_step(torch, rffn, argv + chip_smoke.DROPLESS_ARGS)
    assert out["blocks/ffn/up"]["cosine"] > 0.999999
    assert "routing near-tie" not in capsys.readouterr().out
