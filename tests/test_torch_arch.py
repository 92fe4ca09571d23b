"""The decoder-LM and VLM configs in the port against the JAX reference on
the CPU: tests/test_arch_smoke.py's forward, train step and decode step for
each of the seven ids and seamless-m4t-large-v2 (encdec), with numeric
parity in place of shape checks.

Each smoke config runs through both packages from the reference's params
(``from_jax_params``) on the reference pipeline's batches, f32: logits
within 1e-4 (two layers; the tolerance tests/test_torch_training.py holds
``lm_apply`` to), one AdamW step's loss and grad norm within rtol 1e-5 and
its parameters within 2e-5, and the prefill-then-decode logits within
1e-4 (encdec: token-by-token decode steps from the encoder's memory, as
tests/test_arch_smoke.py:58-63 drives it).  Every id resolves; no engine
serves encdec (the reference's refusals); xlstm-125m and zamba2-7b have
their own tests (test_torch_xlstm.py, test_torch_zamba.py), and encdec
its own besides (test_torch_encdec.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as jpipe
from repro.models.registry import get_family as j_family
from repro.nn import count_params as j_count
from repro.nn import init as jinit
from repro.optim import make_optimizer as j_make_optimizer
from repro.optim import warmup_constant as j_warmup
from repro.serving.continuous import ContinuousEngine as JEngine
from repro.train.state import init_train_state as j_init_state
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.models.registry import get_family as t_family
from repro_torch.nn import count_params, flat_params, from_jax_params
from repro_torch.optim import make_optimizer as t_make_optimizer
from repro_torch.optim import warmup_constant as t_warmup
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from repro_torch.train.state import init_train_state as t_init_state
from repro_torch.train.trainer import make_train_step as t_make_train_step
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["granite-moe-3b-a800m", "olmoe-1b-7b", "qwen3-8b", "qwen3-14b", "deepseek-7b",
         "qwen2.5-32b", "pixtral-12b", "seamless-m4t-large-v2"]
# the ids no serving engine takes, and the reference's reason at generate
UNPORTED = {"seamless-m4t-large-v2": "use encdec.init_state with real memory"}
SEQ = 24


def _setup(arch, train=False):
    jcfg, tcfg = jreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    jp = jinit(j_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, from_jax_params(jax.device_get(jp), tcfg, device="cpu", train=train)


def _batch(cfg, batch=2, seq=SEQ, step=0):
    return jpipe.make_pipeline(cfg, batch, seq, seed=0).batch_at(step)


def test_registry_lists_the_reference_ids():
    assert sorted(treg.ALL_IDS) == sorted(jreg.ALL_IDS)
    assert sorted(treg.ARCH_IDS) == sorted(jreg.ARCH_IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Full, smoke and (granite, olmoe) prototyped configs field for field,
    and the full config's parameter count (tests/test_arch_smoke.py holds
    the reference's to the published figures)."""
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(treg, get)(arch)) == dataclasses.asdict(
            getattr(jreg, get)(arch))
    jmod, tmod = jreg.get_module(arch), treg.get_module(arch)
    assert hasattr(jmod, "prototyped") == hasattr(tmod, "prototyped")
    if hasattr(jmod, "prototyped"):
        for k in (2, 8):
            assert dataclasses.asdict(tmod.prototyped(k)) == dataclasses.asdict(jmod.prototyped(k))
    jcfg = jreg.get_config(arch)
    assert count_params(treg.get_config(arch)) == j_count(j_family(jcfg).specs(jcfg))


@pytest.mark.parametrize("arch", list(UNPORTED))
def test_unported_families_raise(arch):
    """The id resolves to the reference's config, and the static engine's
    ``generate`` refuses it as the reference's does, with its message (the
    reference asserts, the port raises NotImplementedError)."""
    from repro.serving.engine import ServingEngine as JStatic
    from repro_torch.serving.engine import ServingEngine as TStatic

    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(treg, get)(arch)) == dataclasses.asdict(
            getattr(jreg, get)(arch))
    jcfg, tcfg, jp, tp = _setup(arch)
    prompts = np.zeros((2, 4), np.int32)
    with pytest.raises(AssertionError, match=UNPORTED[arch]):
        JStatic(jcfg, jp, max_len=16).generate(jnp.asarray(prompts), 3)
    with pytest.raises(NotImplementedError, match=UNPORTED[arch]):
        TStatic(tcfg, tp, max_len=16).generate(prompts, 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """The family forward (the VLM's patch-embedding prefix included, its
    logits sliced off): logits within 1e-4, aux within 2e-5."""
    jcfg, tcfg, jp, tp = _setup(arch)
    b = _batch(jcfg)
    jl, jaux = jax.jit(lambda p, bb: j_family(jcfg).forward(p, bb, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        tl, taux = t_family(tcfg).forward(tp, {k: torch.from_numpy(v) for k, v in b.items()},
                                          tcfg)
    assert tuple(tl.shape) == tuple(jl.shape) == b["labels"].shape + (jl.shape[-1],)
    V = jcfg.vocab_size
    np.testing.assert_allclose(tl[..., :V].numpy(), np.asarray(jl)[..., :V], atol=1e-4,
                               rtol=1e-4)
    assert set(jaux) == set(taux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), atol=2e-5, rtol=2e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One AdamW step (lr 1e-3, tests/test_arch_smoke.py's settings)."""
    jcfg, tcfg, jp, tp = _setup(arch, train=True)
    kw = dict(optimizer="adamw", learning_rate=1e-3, warmup_steps=2)
    jtc, ttc = JTrainConfig(**kw), TTrainConfig(**kw)
    jopt = j_make_optimizer(jtc, j_warmup(1e-3, 2))
    topt = t_make_optimizer(ttc, t_warmup(1e-3, 2))
    b = _batch(jcfg, step=1)
    jstate, jm = jax.jit(j_make_train_step(jcfg, jtc, jopt))(
        j_init_state(jp, jopt), {k: jnp.asarray(v) for k, v in b.items()})
    tstate, tm = t_make_train_step(tcfg, ttc, topt)(
        t_init_state(tp, topt), {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert tstate.step == int(jstate.step) == 1
    jflat = {"/".join(str(p.key) for p in path): np.asarray(v) for path, v in
             jax.tree_util.tree_flatten_with_path(jax.device_get(jstate.params))[0]}
    for k, t in flat_params(tstate.params).items():
        np.testing.assert_allclose(t.detach().numpy(), jflat[k], atol=2e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """The static path: a prefill of 8 tokens into 16-position caches, then
    two decode steps (the dense decode attention wrapper, its plain version
    here), logits within 1e-4 at every step.  Encdec has no prefill: its
    10 tokens are decode steps from ``init_state`` over the memory that
    ``encode`` makes of 6 frames."""
    jcfg, tcfg, jp, tp = _setup(arch)
    jfam, tfam = j_family(jcfg), t_family(tcfg)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    V = jcfg.vocab_size
    if jcfg.family == "encdec":
        from repro.models import encdec as JED
        from repro_torch.models import encdec as TED

        frames = np.random.default_rng(6).standard_normal((2, 6, jcfg.d_model)).astype(
            np.float32)
        jstate = JED.init_state(jp, JED.encode(jp, jnp.asarray(frames), jcfg), jcfg, 16)
        jdec = jax.jit(lambda p, t, s: jfam.decode(p, t, s, jcfg))
        with torch.inference_mode():
            tstate = TED.init_state(tp, TED.encode(tp, torch.from_numpy(frames), tcfg), tcfg, 16)
            for i in range(10):
                jl, jstate = jdec(jp, jnp.asarray(toks[:, i:i + 1]), jstate)
                tl, tstate = tfam.decode(tp, torch.from_numpy(toks[:, i:i + 1]), tstate, tcfg)
                assert tuple(tl.shape) == (2, 1, jl.shape[-1])
                np.testing.assert_allclose(tl[..., :V].numpy(), np.asarray(jl)[..., :V],
                                           atol=1e-4)
        return
    jl, jstate = jfam.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])}, jcfg, 16)
    with torch.inference_mode():
        tl, tstate = tfam.prefill(tp, {"tokens": torch.from_numpy(toks[:, :8])}, tcfg, 16)
        np.testing.assert_allclose(tl[..., :V].numpy(), np.asarray(jl)[..., :V], atol=1e-4)
        jdec = jax.jit(lambda p, t, s: jfam.decode(p, t, s, jcfg))
        for i in (8, 9):
            jl, jstate = jdec(jp, jnp.asarray(toks[:, i:i + 1]), jstate)
            tl, tstate = tfam.decode(tp, torch.from_numpy(toks[:, i:i + 1]), tstate, tcfg)
            assert tuple(tl.shape) == (2, 1, jl.shape[-1])
            np.testing.assert_allclose(tl[..., :V].numpy(), np.asarray(jl)[..., :V], atol=1e-4)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-14b"])
def test_continuous_engine_greedy_tokens_equal_reference(arch):
    """The continuous engine over the paged cache (the paged decode
    wrapper at G = 2 for granite's smoke config, G = 5 for qwen3-14b's),
    dropless MoE for granite: greedy tokens identical to the JAX engine's
    on 4 requests, 6 tokens each."""
    from repro_torch.serving.request import Request as TRequest
    from repro.serving.request import Request as JRequest

    jcfg, tcfg, jp, tp = _setup(arch)
    if jcfg.moe.num_experts:
        jcfg = jcfg.replace_moe(impl="dropless", capacity_factor=None)
        tcfg = tcfg.replace_moe(impl="dropless", capacity_factor=None)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in (5, 9, 3, 12)]
    kw = dict(max_slots=2, max_len=32, prefill_chunk=8, kv_block_size=4)
    jout, _ = JEngine(jcfg, jp, JServeConfig(**kw)).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])
    tout, _ = TEngine(tcfg, tp, TServeConfig(**kw), device="cpu").run(
        [TRequest(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])
    jtok = {u: [int(t) for t in v] for u, v in jout.items()}
    ttok = {u: [int(t) for t in v] for u, v in tout.items()}
    assert ttok == jtok and all(len(t) == 6 for t in ttok.values())


def test_chip_smoke_families_phase_runs_on_cpu(tmp_path, capsys):
    """chip_smoke's phase 12 rehearsed at smoke size on the CPU (the
    kernels' plain versions on both sides, so nothing may differ): the
    four serving runs over smoke configs of the same families (granite,
    its prototyping, qwen2.5-32b over int8 pools, olmoe) and granite's
    training with Adafactor on the chunked path (S = T = 1456, S*T past
    2^21), the CPU update against itself, two int8 steps and a
    --profile-dir trace."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    def dropless(cfg):
        return cfg.replace_moe(impl="dropless", capacity_factor=None)

    granite = treg.get_module("granite-moe-3b-a800m")
    configs = [("(a)", dropless(granite.smoke()), "none"),
               ("(b)", dropless(granite.smoke().replace_moe(routing="prototype",
                                                            num_prototypes=2)), "none"),
               ("(c) qwen2.5-32b", treg.get_smoke_config("qwen2.5-32b"), "int8"),
               ("(c) olmoe", dropless(treg.get_smoke_config("olmoe-1b-7b")), "none")]
    assert [c[0][:3] for c in cs.family_configs()] == ["(a)", "(b)", "(c)", "(c)"]
    report, _ = cs.family_serving_runs(torch, configs, "cpu", n_requests=4)
    assert all(r["requests_equal_to_plain"] == 4 and not r["divergences"]
               for r in report.values())
    argv = list(cs.FAMILY_TRAIN_ARGS) + ["--smoke"]        # the phase's flags, smoke-sized
    for flag, value in (("--k", "2"), ("--batch", "1"), ("--seq", "1456")):
        argv[argv.index(flag) + 1] = value
    report, _ = cs.family_train(torch, argv, "cpu", layers=2, steps=2,
                                profile_dir=str(tmp_path / "profile"))
    assert report["adafactor"]["chunked_calls"] == 2 * 2 * 2
    assert report["adafactor_vs_cpu"] == {"update": 0.0, "state": 0.0}
    assert report["int8"]["steps_checked"] == 2 and report["profile"]["trace_mb"] > 0
    out = capsys.readouterr().out
    assert "near-tie" not in out and "profile ->" in out
