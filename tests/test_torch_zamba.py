"""The zamba family in the port against the JAX reference, on the CPU: the
config and its parameter count, the param tree, the forward, token-by-token
decode and its state, one AdamW train step, the static engine and its
trace runner, both CLIs, checkpoints of the stacked Mamba2 tree read by the
other package both ways, the dense decode kernel's plain version at the
shared attention's head_dim 224 against the reference's Pallas kernel in
interpret mode, the D = 224 layout the CUDA kernel takes, the refusals,
and a CPU rehearsal of chip_smoke's phase 14.

Inputs are numpy-seeded; params are the reference's, carried across with
``from_jax_params``.  Tolerances (f32) are stated where they are used;
greedy tokens and checkpoint bits are held identical.
"""
import dataclasses
import json
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import registry as jreg
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import SpecConfig as JSpecConfig
from repro.kernels.decode_attention.ops import decode_attention as j_decode_attention
from repro.models import zamba as JZ
from repro.models.registry import get_family as j_family
from repro.nn import count_params as j_count
from repro.nn import init as jinit
from repro.optim.adamw import adamw as jadamw
from repro.serving.continuous import ContinuousEngine as JEngine
from repro.serving.engine import ServingEngine as JStatic
from repro.serving.request import Request as JRequest
from repro.serving.trace import run_trace_static as j_run_trace_static
from repro.train.state import init_train_state as j_init_train_state
from repro_torch.checkpoint import Checkpointer, jax_key
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.configs.base import SpecConfig as TSpecConfig
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.models import zamba as TZ
from repro_torch.models.attention import KVCache, attention_apply
from repro_torch.models.registry import get_family as t_family
from repro_torch.nn import count_params, flat_params, from_jax_params, model_shapes
from repro_torch.optim.adamw import adamw as tadamw
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from repro_torch.serving.engine import ServingEngine as TStatic
from repro_torch.serving.request import Request as TRequest
from repro_torch.serving.trace import run_trace_static as t_run_trace_static
from repro_torch.serving.trace import synthetic_trace
from repro_torch.train.state import init_train_state
from torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
# tests/test_models.py:77-90's model: 5 layers, shared block every 2 (3 applications)
SMALL = dict(family="zamba", num_layers=5, d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
             vocab_size=61, ssm_state=8, ssm_heads=4, ssm_chunk=8, zamba_shared_period=2,
             dtype="float32")


def _cfgs(case="smoke"):
    if case == "smoke":
        return jreg.get_smoke_config("zamba2-7b"), treg.get_smoke_config("zamba2-7b")
    return JModelConfig(**SMALL), TModelConfig(**SMALL)


def _params(jcfg, tcfg, train=False, seed=0):
    jp = jinit(j_family(jcfg).specs(jcfg), jax.random.PRNGKey(seed))
    return jp, from_jax_params(jax.device_get(jp), tcfg, device="cpu", train=train)


def _toks(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# Config and param tree
# ---------------------------------------------------------------------------

def test_config_and_param_count_match_reference():
    """The full and smoke configs field for field; 6,867,661,008 parameters
    in both packages (81 Mamba2 layers, the shared block, the embedding),
    and 1,097,284,272 at the 7 layers chip_smoke.py trains."""
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(treg, get)("zamba2-7b")) == \
            dataclasses.asdict(getattr(jreg, get)("zamba2-7b"))
    full, jfull = treg.get_config("zamba2-7b"), jreg.get_config("zamba2-7b")
    assert count_params(full) == j_count(j_family(jfull).specs(jfull)) == 6_867_661_008
    cut = jfull.replace(num_layers=7)
    assert count_params(full.replace(num_layers=7)) == j_count(j_family(cut).specs(cut)) \
        == 1_097_284_272
    fam = t_family(full)
    assert fam.prefill is None and fam.kv_cache
    assert treg.get_module("zamba2-7b").CONFIG == full


@pytest.mark.parametrize("case", ["full", "smoke"])
def test_param_tree_matches_reference(case):
    """The param tree key for key and shape for shape: ``mamba`` stacked over
    the layers, ``shared`` at width 2 d with head_dim 2 d / heads (224 at
    full width) and a gelu FFN without a gate."""
    jcfg = jreg.get_config("zamba2-7b") if case == "full" else _cfgs()[0]
    tcfg = treg.get_config("zamba2-7b") if case == "full" else _cfgs()[1]
    abstract = jax.eval_shape(lambda: jinit(j_family(jcfg).specs(jcfg), jax.random.PRNGKey(0)))
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    got = {jax_key(p): tuple(s.shape) for p, s in flat_params(model_shapes(tcfg)).items()}
    assert got == want
    if case == "full":
        assert got["['mamba']['in_x']"] == (81, 3584, 7168)
        assert got["['shared']['attn']['wq']['kernel']"] == (7168, 32 * 224)
        assert "['shared']['ffn']['gate']['kernel']" not in got


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,S", [("smoke", 40), ("small", 8)])
def test_forward_matches_reference(case, S):
    """The family forward: logits within 1e-4 (smoke: S = 40 pads the SSD
    scan's last chunk of 16)."""
    jcfg, tcfg = _cfgs(case)
    jp, tp = _params(jcfg, tcfg)
    toks = _toks(jcfg, (2, S), 1)
    jl, jaux = j_family(jcfg).forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        tl, taux = t_family(tcfg).forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    V = jcfg.vocab_size
    np.testing.assert_allclose(tl[..., :V].numpy(), np.asarray(jl)[..., :V], atol=1e-4,
                               rtol=1e-4)
    assert set(taux) == set(jaux)


def test_decode_matches_reference_token_by_token():
    """Ten decode steps from the zero state through the family API, both
    packages: logits within 3e-4 (the reference's own decode tolerance),
    every layer's Mamba2 state within 1e-4, the shared applications' K/V
    caches within 1e-5 and their length."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    toks = _toks(jcfg, (2, 10), 2)
    jst = j_family(jcfg).init_state(jcfg, 2, 16)
    V = jcfg.vocab_size
    with torch.inference_mode():
        tst = t_family(tcfg).init_state(tcfg, 2, 16, device="cpu")
        for i in range(10):
            jl, jst = j_family(jcfg).decode(jp, jnp.asarray(toks[:, i:i + 1]), jst, jcfg)
            tl, tst = t_family(tcfg).decode(tp, torch.from_numpy(toks[:, i:i + 1]), tst, tcfg)
            np.testing.assert_allclose(tl[..., :V].numpy(), np.asarray(jl)[..., :V], atol=3e-4)
        for f in ("h", "conv"):
            np.testing.assert_allclose(getattr(tst.mamba, f).numpy(),
                                       np.asarray(getattr(jst.mamba, f)), atol=1e-4, err_msg=f)
        for f in ("k", "v"):
            np.testing.assert_allclose(getattr(tst.attn, f).numpy(),
                                       np.asarray(getattr(jst.attn, f)), atol=1e-5, err_msg=f)
    assert tst.attn.k.shape == (TZ._n_shared(tcfg), 2, 16, 4, 32)
    assert tst.attn.length == 10 and (np.asarray(jst.attn.length) == 10).all()


def test_decode_matches_parallel():
    """tests/test_models.py:77-90 on the port: 8 decode steps from the zero
    state against the parallel forward, atol 3e-4."""
    jcfg, tcfg = _cfgs("small")
    _, tp = _params(jcfg, tcfg)
    toks = torch.from_numpy(_toks(tcfg, (2, 8), 1))
    with torch.inference_mode():
        full, _, _ = TZ.zamba_apply(tp, toks, tcfg)
        state = TZ.zamba_init_state(tcfg, 2, max_len=12)
        for i in range(8):
            lg, _, state = TZ.zamba_apply(tp, toks[:, i:i + 1], tcfg, state=state)
            np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i].numpy(), atol=3e-4)


def _jflat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_train_step_matches_reference():
    """One AdamW step (lr 1e-3, no warmup) through each package's trainer
    from the same f32 params on the reference pipeline's batch, under
    remat: loss, ce and grad norm within rtol 1e-5, every parameter after
    the step within 5e-5 = lr / 20.  (A first AdamW step moves a weight by
    lr x g / (|g| + 1e-8): where a gradient is near 1e-8, as a sum of
    cancelling terms, its f32 summation order moves the step by a visible
    share of lr; one element in 40960 of ``mamba/in_z`` sits 2.06e-5
    off.)"""
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.data import pipeline as jpipe
    from repro.optim import make_optimizer as j_make_optimizer
    from repro.optim import warmup_constant as j_warmup
    from repro.train.trainer import make_train_step as j_make_train_step
    from repro_torch.configs.base import TrainConfig as TTrainConfig
    from repro_torch.optim import make_optimizer as t_make_optimizer
    from repro_torch.optim import warmup_constant as t_warmup
    from repro_torch.train.trainer import make_train_step as t_make_train_step

    jcfg, tcfg = _cfgs()
    assert tcfg.remat
    jp, tp = _params(jcfg, tcfg, train=True)
    kw = dict(learning_rate=1e-3, warmup_steps=1)
    jtc, ttc = JTrainConfig(**kw), TTrainConfig(**kw)
    jopt = j_make_optimizer(jtc, j_warmup(1e-3, 1))
    topt = t_make_optimizer(ttc, t_warmup(1e-3, 1))
    b = jpipe.make_pipeline(jcfg, 2, 40, seed=0).batch_at(0)
    jstate, jm = jax.jit(j_make_train_step(jcfg, jtc, jopt))(
        j_init_train_state(jp, jopt), {k: jnp.asarray(v) for k, v in b.items()})
    tstate, tm = t_make_train_step(tcfg, ttc, topt)(
        init_train_state(tp, topt), {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    jflat, tflat = _jflat(jstate.params), flat_params(tstate.params)
    assert set(jflat) == set(tflat)
    for k, t in tflat.items():
        np.testing.assert_allclose(t.detach().numpy(), jflat[k], atol=5e-5, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["smoke", "small"])
def test_static_engine_equals_reference(case):
    """The static engine feeds each prompt token by token: greedy tokens of
    a 3 x 7 batch, 6 tokens, identical to the reference's
    ``ServingEngine``."""
    jcfg, tcfg = _cfgs(case)
    jp, tp = _params(jcfg, tcfg)
    prompts = _toks(jcfg, (3, 7), 8)
    jtoks, _ = JStatic(jcfg, jp, max_len=16).generate(jnp.asarray(prompts), 6)
    ttoks, stats = TStatic(tcfg, tp, max_len=16).generate(prompts, 6)
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    assert stats["decode_tokens_per_s"] > 0


def test_run_trace_static_equals_reference():
    """``run_trace_static`` over 6 requests in FCFS groups of 4 (prompts
    right-padded, each group run to its longest generation): every
    request's tokens identical to the reference's runner on its engine."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    reqs = synthetic_trace(6, tcfg.vocab_size, seed=3, prompt_lens=(3, 9), gen_lens=(2, 5))
    jreqs = [JRequest(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                      arrival_ms=r.arrival_ms) for r in reqs]
    jout, _ = j_run_trace_static(JStatic(jcfg, jp, max_len=16), jreqs, 4)
    tout, stats = t_run_trace_static(TStatic(tcfg, tp, max_len=16), reqs, 4)
    assert {u: list(map(int, v)) for u, v in tout.items()} == \
        {u: list(map(int, v)) for u, v in jout.items()}
    assert stats["generated_tokens"] == sum(r.max_new_tokens for r in reqs)


def test_serve_cli_serves_reference_tokens(monkeypatch):
    """The serve CLI's default static batch at smoke size on the CPU, over
    the reference's params: greedy tokens identical to the reference's
    static engine on the CLI's prompts."""
    from repro_torch.launch import serve

    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    monkeypatch.setattr(serve, "init_params", lambda cfg, seed, device: tp)
    got = {}
    real = serve.ServingEngine.generate

    def capture(self, *a, **kw):
        out = real(self, *a, **kw)
        got["tokens"] = out[0]
        return out

    monkeypatch.setattr(serve.ServingEngine, "generate", capture)
    serve.main(["--arch", "zamba2-7b", "--smoke", "--batch", "3", "--prompt-len", "6", "--gen",
                "5", "--device", "cpu"])
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (3, 6)).astype(np.int32)
    want, _ = JStatic(jcfg, jp, max_len=12).generate(jnp.asarray(prompts), 5)
    np.testing.assert_array_equal(got["tokens"], np.asarray(want))
    with pytest.raises(NotImplementedError, match="zamba"):
        serve.main(["--arch", "zamba2-7b", "--smoke", "--engine", "continuous", "--device",
                    "cpu"])


def test_refusals():
    """A multi-token decode step (the reference reads token 0 alone), a
    ``generate`` past ``max_len`` and a cache write past its end (the
    reference clamps the write silently), the continuous engine (the
    reference's refusal, word for word) and a model drafter without a
    prefill, zamba's or xLSTM's (the reference's message)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    with torch.inference_mode():
        state = TZ.zamba_init_state(tcfg, 2, 8)
        with pytest.raises(ValueError, match="one token a step"):
            TZ.zamba_apply(tp, torch.zeros((2, 3), dtype=torch.long), tcfg, state=state)
    with pytest.raises(ValueError, match="exceed max_len"):
        TStatic(tcfg, tp, max_len=10).generate(_toks(tcfg, (2, 6), 0), 6)
    TStatic(tcfg, tp, max_len=11).generate(_toks(tcfg, (2, 6), 0), 6)      # 6 + 6 - 1 fits
    cache = KVCache(torch.zeros(1, 4, 1, 8), torch.zeros(1, 4, 1, 8),
                    torch.tensor(3, dtype=torch.int32))
    small = TModelConfig(d_model=8, num_heads=1, num_kv_heads=1, dtype="float32")
    attn = {n: {"kernel": torch.zeros(8, 8)} for n in ("wq", "wk", "wv", "wo")}
    with pytest.raises(ValueError, match="cannot take 2 more at length 3"):
        attention_apply(attn, torch.zeros(1, 2, 8), small, positions=torch.zeros(1, 2), cache=cache)
    with pytest.raises(NotImplementedError) as jerr:
        JEngine(jcfg, jp, JServeConfig(max_len=32))
    with pytest.raises(NotImplementedError) as terr:
        TEngine(tcfg, tp, TServeConfig(max_len=32), device="cpu")
    assert str(terr.value) == str(jerr.value)
    from repro_torch.configs import m6 as tm6
    from repro.configs import m6 as jm6

    for draft in ("zamba2-7b", "xlstm-125m"):
        jtarget = jm6.smoke().replace(vocab_size=jreg.get_smoke_config(draft).vocab_size)
        ttarget = tm6.smoke().replace(vocab_size=jtarget.vocab_size)
        kw = dict(max_slots=2, max_len=32)
        with pytest.raises(ValueError, match="full-forward") as jerr:
            JEngine(jtarget.replace_moe(impl="dropless", capacity_factor=None),
                    jinit(j_family(jtarget).specs(jtarget), jax.random.PRNGKey(0)),
                    JServeConfig(spec=JSpecConfig(drafter="model", draft=draft), **kw))
        _, ttp = _params(jtarget, ttarget)
        with pytest.raises(ValueError, match="full-forward") as terr:
            TEngine(ttarget.replace_moe(impl="dropless", capacity_factor=None), ttp,
                    TServeConfig(spec=TSpecConfig(drafter="model", draft=draft), **kw),
                    device="cpu")
        assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# The dense decode kernel at head_dim 224
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_dense_plain_version_at_d224_matches_reference_kernel(dt):
    """The dense decode kernel's plain version (the wrapper's CPU path) at
    the shared attention's shape, G = 1, D = 224, against the reference's
    Pallas kernel in interpret mode: lengths 0, 1, T and two between;
    within 3e-5 (f32) or 3e-2 (bf16), length-0 rows exactly 0."""
    B, T, H, D = 5, 24, 2, 224
    rng = np.random.default_rng(224)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, H, D)).astype(np.float32)
    v = rng.standard_normal((B, T, H, D)).astype(np.float32)
    lengths = np.array([0, 1, T, 9, 17], np.int32)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    want = j_decode_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(lengths),
                              block_kv=8)
    got = da.decode_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                              torch.from_numpy(lengths))
    tol = 3e-2 if dt == "bfloat16" else 3e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)
    assert (got[0] == 0).all()
    assert da.decode_attention.launches == 0


def _vec_elems(elem_bytes: int, G: int, D: int) -> int:
    """decode_common.cuh::vec_elems, as written there."""
    floor_pow2 = 1 << ((32 // G).bit_length() - 1)
    by_warp = 1 << (-(-D // 32) - 1).bit_length()
    return min(max(min(16 // elem_bytes, floor_pow2), by_warp), D)


@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_d224_layout_and_checks(elem_bytes):
    """D = 224 at G = 1: VEC = 8 elements a lane (two 16-byte loads in
    f32), 28 lanes a token row, rounded up to a whole warp (4 idle lanes),
    so a pass of the 4 warps reads 8 rows, as ``_rows_per_pass`` tells
    ``dense_plan``; the other widths keep their layout.  The dense
    wrapper's check takes D = 224 at G = 1 and refuses it at G = 2; the C
    launch instantiates it for the dense tiles at G = 1 only."""
    vec = _vec_elems(elem_bytes, 1, 224)
    assert vec == 8 and 224 % vec == 0 and vec * elem_bytes in (16, 32)
    lanes = 1 << (224 // vec - 1).bit_length()
    assert (224 // vec, lanes) == (28, 32)
    assert da._rows_per_pass(224, 1, elem_bytes) == 2 * 4 * (32 // lanes) == 8
    for D in (16, 32, 64, 128):
        for G in (1, 2, 3, 4, 5, 8):
            v = min(16 // elem_bytes, 1 << ((32 // G).bit_length() - 1), D)
            assert _vec_elems(elem_bytes, G, D) == v
            assert da._rows_per_pass(D, G, elem_bytes) == 2 * 4 * (32 // (D // v))
    splits, stages = da.dense_plan(8, 32, 1, 224, 111, elem_bytes, 132, max_length=110)
    assert splits in da.SPLITS and stages >= 1
    q, kv, lens = torch.zeros(2, 32, 224), torch.zeros(2, 16, 32, 224), torch.ones(2).int()
    da._check_dense(q, kv, kv, lens)
    with pytest.raises(ValueError, match="D = 224 at G = 1"):
        da._check_dense(q, kv[:, :, :16], kv[:, :, :16], lens)
    common = (CSRC / "decode_common.cuh").read_text()
    assert "ceil_pow2((D + 31) / 32)" in common
    src = (CSRC / "decode_sm90.cuh").read_text()
    assert re.search(r"case 224:\s*if constexpr \(Tiles::kD224 && G == 1\)", src)
    assert "static constexpr bool kD224 = true;" in src.split("struct DenseTiles")[1]
    assert "static constexpr bool kD224 = false;" in src.split("struct PagedTiles")[1]


# ---------------------------------------------------------------------------
# Training CLI and checkpoints
# ---------------------------------------------------------------------------

def test_train_cli_two_steps_match_reference(monkeypatch):
    """The port's train CLI, 2 steps at batch 2 x 40, from the reference's
    params, against the reference's trainer with the train config the
    reference's CLI builds for these flags (AdamW, lr 8e-5, warmup 1) on
    its pipeline's batches: loss, ce and grad norm within rtol 1e-5 a step.
    (The reference's CLI itself is not run: its debug mesh's sharding rules
    refuse the embedding gather on this jax version, as for xlstm.)"""
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.data.pipeline import make_pipeline as j_pipeline
    from repro.optim import make_optimizer as j_make_optimizer
    from repro.optim import warmup_constant as j_warmup
    from repro.train.trainer import make_train_step as j_make_train_step
    from repro_torch.launch import train

    jcfg, tcfg = _cfgs()
    jp = jinit(j_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
    monkeypatch.setattr(train, "init_params", lambda cfg, seed, device, train: from_jax_params(
        jax.device_get(jp), cfg, device=device, train=train))
    tlogs = train.main(["--arch", "zamba2-7b", "--smoke", "--steps", "2", "--batch", "2",
                        "--seq", "40", "--log-every", "1", "--device", "cpu"])
    jtc = JTrainConfig(optimizer="adamw", learning_rate=8e-5, warmup_steps=1)
    jopt = j_make_optimizer(jtc, j_warmup(8e-5, 1))
    jstep = jax.jit(j_make_train_step(jcfg, jtc, jopt))
    jstate = j_init_train_state(jp, jopt)
    pipe = j_pipeline(jcfg, 2, 40, seed=0)
    assert len(tlogs) == 2
    for i, tm in enumerate(tlogs):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()})
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(tm[key], float(jm[key]), rtol=1e-5, err_msg=key)
        assert abs(tm["loss"] - np.log(jcfg.vocab_size)) < 1.0


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize])


def test_checkpoints_read_both_ways(tmp_path):
    """A TrainState of the smoke tree (``mamba`` leaves stacked over 5
    layers, the shared block) with random AdamW moments: the reference's
    checkpoint restores in the port bit-equal, and the port's checkpoint
    of it restores in the reference bit-equal, file for file the same
    bytes."""
    jcfg, tcfg = _cfgs()
    params = jinit(j_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
    jstate = j_init_train_state(params, jadamw(lambda s: 1e-3))
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 4096))
    rand = lambda x: jax.random.normal(next(keys), x.shape, x.dtype)   # noqa: E731
    jstate = jstate._replace(opt_state={"mu": jax.tree_util.tree_map(rand, jstate.opt_state["mu"]),
                                        "nu": jax.tree_util.tree_map(rand, jstate.opt_state["nu"])},
                             step=jnp.asarray(2, jnp.int32))
    JCheckpointer(str(tmp_path / "ref")).save(2, jstate)
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}

    from repro_torch.nn import init_params
    tstate = init_train_state(init_params(tcfg, seed=3, device="cpu", train=True),
                              tadamw(lambda s: 1e-3))
    tstate = Checkpointer(str(tmp_path / "ref")).restore(2, tstate)
    got = {}
    for path, t in flat_params(tstate.params).items():
        got[".params" + jax_key(path)] = t
        for m in ("mu", "nu"):
            got[f".opt_state['{m}']" + jax_key(path)] = tstate.opt_state[m][path]
    assert set(got) | {".step"} == set(want) and tstate.step == 2
    assert ".params['mamba']['A_log']" in got and ".params['shared']['out']" in got
    for key, t in got.items():
        np.testing.assert_array_equal(_bits(t), _bits(want[key]), err_msg=key)

    Checkpointer(str(tmp_path / "port")).save(2, tstate)
    back = JCheckpointer(str(tmp_path / "port")).restore(2, jax.eval_shape(lambda: jstate))
    for p, arr in jax.tree_util.tree_flatten_with_path(back)[0]:
        key = jax.tree_util.keystr(p)
        np.testing.assert_array_equal(_bits(arr), _bits(want[key]), err_msg=key)
    a, b = tmp_path / "ref" / "step_2", tmp_path / "port" / "step_2"
    assert json.load(open(a / "manifest.json")) == json.load(open(b / "manifest.json"))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 14, rehearsed
# ---------------------------------------------------------------------------

def test_chip_smoke_zamba_phase_runs_on_cpu(capsys):
    """chip_smoke's phase 14 rehearsed at smoke size on the CPU (the
    kernels' plain versions on both sides, so no token may differ): (b) the
    static engine's generate, (e) the serve CLI's trace run and its
    continuous refusal, (d) two train CLI steps at 3 layers; (c) needs the
    card.  The dense kernel's decode lengths of a trace: every prompt token
    a step."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = treg.get_smoke_config("zamba2-7b")
    reqs = synthetic_trace(4, cfg.vocab_size, seed=0, prompt_lens=(4, 12), gen_lens=(3, 6))
    lens = cs.zamba_decode_lengths(reqs, 2)
    groups = cs.static_groups(reqs, 2)
    assert len(lens) == sum(p.shape[1] + g - 1 for _, p, g in groups)
    argv = ["--arch", "zamba2-7b", "--smoke", "--batch", "2", "--seq", "40", "--log-every", "1"]
    report, _ = cs.zamba_runs(torch, cfg, "cpu", argv, cli_argv=("--arch", "zamba2-7b", "--smoke"),
                              shape=(3, 10, 4), cut_layers=3, cli_requests=4)
    assert report["(b) generate"]["rows_equal_to_plain"] == 3
    trace = report["(e) serve CLI trace"]
    assert trace["requests_equal_to_plain"] == 4 and "zamba" in trace["continuous_refusal"]
    assert len(report["(d) train"]["losses"]) == cs.ZAMBA_TRAIN_STEPS
    assert report["params"] == count_params(cfg)
    assert "near-tie" not in capsys.readouterr().out
