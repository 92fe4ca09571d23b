"""The rest of the port's training stack against the JAX reference on the
CPU: Adafactor, gradient compression (bf16, int8 with error feedback),
checkpoints of their state read by both packages, the train CLI's
learning-rate choice, and ``--profile-dir`` on both CLIs.

Both packages get the same numpy leaves, gradients and batches.  The
int8 codes, scales and residuals must be bit-equal (every operation is
elementwise, and both round half to even).  Adafactor's means are sums in
another order than XLA's, so its update and state are held within stated
tolerances, not bit for bit.
"""
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import m6 as jm6
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as jpipe
from repro.models.registry import get_family
from repro.nn import init as jinit
from repro.optim import make_optimizer as j_make_optimizer
from repro.optim import warmup_constant as j_warmup
from repro.optim.adafactor import adafactor as j_adafactor
from repro.optim.compression import compress_grads as j_compress
from repro.optim.compression import quantize_int8 as j_quantize
from repro.train.state import init_train_state as j_init_state
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch.checkpoint import Checkpointer, leaves
from repro_torch.configs import m6 as tm6
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.nn import flat_params, from_jax_params
from repro_torch.optim import make_optimizer as t_make_optimizer
from repro_torch.optim import warmup_constant as t_warmup
from repro_torch.optim.adafactor import adafactor as t_adafactor
from repro_torch.optim.compression import compress_grads as t_compress
from repro_torch.optim.compression import dequantize_int8 as t_dequantize
from repro_torch.optim.compression import quantize_int8 as t_quantize
from repro_torch.train.state import init_train_state as t_init_state
from repro_torch.train.trainer import make_train_step as t_make_train_step
from torch_threads import one_torch_thread  # noqa: F401

# a matrix, a vector, an expert tensor (E, M, I) and a layer-stacked one
SHAPES = {"wq": (48, 40), "bias": (40,), "up": (3, 8, 24), "blocks/up": (2, 3, 8, 24)}


class _Divisors(TorchFunctionMode):
    """Records the divisor of every tensor division."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.__truediv__, torch.Tensor.div, torch.Tensor.div_, torch.div,
                    torch.true_divide):
            self.seen.append(args[1])
        return func(*args, **(kwargs or {}))


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        a = a.numpy()
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize])


def _nest(flat):
    """A flat "a/b" dict as the nested dict the reference's trees are."""
    out = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adafactor_update_and_state_match_reference(dtype):
    """Three steps (a 2-step warmup, so lr moves) on f32 or bf16 leaves:
    every update within rtol 2e-6 of the reference's (f32 sums reordered:
    each mean is a sum in PyTorch's order divided by a 0-dim tensor, as the
    reference divides), the factored row and column moments (vr, vc) of the
    matrices and expert tensors, and the full moment of the vector, within
    rtol 2e-6; every division by a tensor.  The expert tensors are factored
    per expert over their last two axes."""
    rng = np.random.default_rng(11)
    np_dt = jnp.dtype(dtype).type
    tdt = getattr(torch, dtype)
    params = {k: (rng.standard_normal(s) * 0.05).astype(np.float32).astype(np_dt)
              for k, s in SHAPES.items()}
    jopt, topt = j_adafactor(j_warmup(1e-2, 2)), t_adafactor(t_warmup(1e-2, 2))
    jstate = jopt.init(_nest({k: jnp.asarray(v) for k, v in params.items()}))
    tstate = topt.init({k: torch.from_numpy(v.astype(np.float32)).to(tdt)
                        for k, v in params.items()})
    assert set(tstate["v"]["up"]) == {"vr", "vc"} and set(tstate["v"]["bias"]) == {"v"}
    assert tuple(tstate["v"]["up"]["vr"].shape) == (3, 8)
    assert tuple(tstate["v"]["blocks/up"]["vc"].shape) == (2, 3, 24)
    for step in range(3):
        grads = {k: (rng.standard_normal(s) * 1e-2).astype(np.float32) for k, s in SHAPES.items()}
        grads["up"][1] *= 30.0                           # one expert far larger
        jp = _nest({k: jnp.asarray(v) for k, v in params.items()})
        tp = {k: torch.from_numpy(v.astype(np.float32)).to(tdt) for k, v in params.items()}
        ju, jstate = jopt.update(_nest({k: jnp.asarray(v) for k, v in grads.items()}), jstate,
                                 jp, jnp.asarray(step, jnp.int32))
        with _Divisors() as divs:
            tu, tstate = topt.update({k: torch.from_numpy(v) for k, v in grads.items()},
                                     tstate, tp, step)
        assert divs.seen and all(isinstance(d, torch.Tensor) for d in divs.seen)
        ju = {k: np.asarray(v, np.float32) for k, v in _flat_leaves(ju).items()}
        for k in SHAPES:
            assert tu[k].dtype == tdt
            np.testing.assert_allclose(tu[k].float().numpy(), ju[k], rtol=2e-6,
                                       atol=1e-9 if dtype == "float32" else 0,
                                       err_msg=f"{k} update, step {step}")
            jv = _flat_leaves(jstate["v"])
            for what, t in tstate["v"][k].items():
                np.testing.assert_allclose(t.numpy(), np.asarray(jv[f"{k}/{what}"]),
                                           rtol=2e-6, err_msg=f"{k} {what}, step {step}")
            params[k] = (params[k].astype(np.float32) + ju[k]).astype(np_dt)
    assert max(np.abs(ju[k]).max() for k in SHAPES) > 1e-5          # the steps moved


def _flat_leaves(tree):
    return {"/".join(str(p.key) for p in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_adafactor_state_sublinear():
    """tests/test_training.py::test_adafactor_state_sublinear through the
    port: AdamW keeps two moments a parameter, Adafactor under a quarter of
    that on the reference's tiny prototype MoE model (m6 smoke here)."""
    from repro_torch.nn import init_params

    params = flat_params(init_params(tm6.smoke(), seed=0, device="cpu", train=True))
    n_params = sum(p.numel() for p in params.values())
    ada = t_make_optimizer(TTrainConfig(optimizer="adafactor"), t_warmup(1e-3))
    adam = t_make_optimizer(TTrainConfig(optimizer="adamw"), t_warmup(1e-3))
    n_ada = sum(t.numel() for _, t in leaves(ada.init(params)))
    n_adam = sum(t.numel() for _, t in leaves(adam.init(params)))
    assert n_adam == 2 * n_params
    assert n_ada < 0.25 * n_adam


def _special_values() -> np.ndarray:
    """Exact ties of the int8 grid (k + 0.5 of a scale of 1: absmax 127),
    zeros, signs and the clip edge."""
    ties = np.arange(-126, 127) + 0.5
    return np.concatenate([ties, [0.0, -0.0, 127.0, -127.0, 1e-6, -1e-6]]).astype(np.float32)


@pytest.mark.parametrize("case", ["ties", "random", "zeros", "tiny", "bf16"])
def test_quantize_int8_codes_and_scale_bit_equal(case):
    """Codes and scale bit-equal to the reference's on identical inputs:
    ties round half to even in both, the codes clip at +-127, an all-zero
    tensor takes the 1e-12 / 127 floor; dequantize bit-equal too, and the
    divisions are by tensors."""
    rng = np.random.default_rng(len(case))
    x = {"ties": _special_values(),
         "random": rng.standard_normal((37, 19)).astype(np.float32) * 3.0,
         "zeros": np.zeros((5, 4), np.float32),
         "tiny": (rng.standard_normal(64) * 1e-14).astype(np.float32),
         "bf16": rng.standard_normal((16, 8)).astype(np.float32)}[case]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if case == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jq, js = j_quantize(jx)
    with _Divisors() as divs:
        tq, ts = t_quantize(tx)
    assert all(isinstance(d, torch.Tensor) for d in divs.seen) and len(divs.seen) == 2
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.dim() == 0
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(np.asarray(js)))
    np.testing.assert_array_equal(_bits(t_dequantize(tq, ts)),
                                  _bits(np.asarray(jq, np.float32) * np.asarray(js)))
    if case == "ties":
        assert int(np.abs(np.asarray(jq)).max()) == 127
        assert (tq[:253].numpy() % 2 == 0).all()         # half to even, scale exactly 1
    if case == "zeros":
        np.testing.assert_array_equal(_bits(ts), _bits(np.float32(1e-12) / np.float32(127)))


@pytest.mark.parametrize("mode", ["int8", "bf16", "none"])
def test_compress_grads_over_steps_bit_equal(mode):
    """Four steps of compress_grads with the residual carried: outputs and
    (int8) the f32 error feedback bit-equal to the reference's; under int8
    the residual stays below half a code of each step's scale and the sum
    of the compressed gradients tracks the sum of the true ones (error
    feedback leaves only the last residual out)."""
    rng = np.random.default_rng(2)
    jef = tef = None
    true_sum = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    sent_sum = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    for _ in range(4):
        g = {k: (rng.standard_normal(s) * 1e-2).astype(np.float32) for k, s in SHAPES.items()}
        jg, jef = j_compress({k: jnp.asarray(v) for k, v in g.items()}, mode, jef)
        tg, tef = t_compress({k: torch.from_numpy(v) for k, v in g.items()}, mode, tef)
        for k in SHAPES:
            assert tg[k].dtype == (torch.bfloat16 if mode == "bf16" else torch.float32)
            np.testing.assert_array_equal(_bits(tg[k]), _bits(np.asarray(jg[k])), err_msg=k)
            if mode == "int8":
                np.testing.assert_array_equal(_bits(tef[k]), _bits(np.asarray(jef[k])))
                scale = np.abs(tg[k].numpy()).max() / 127          # the largest code is 127
                assert np.abs(tef[k].numpy()).max() <= 0.5001 * scale
            true_sum[k] += g[k]
            sent_sum[k] += tg[k].float().numpy()
    if mode == "int8":
        for k in SHAPES:
            np.testing.assert_allclose(sent_sum[k] + tef[k].numpy(), true_sum[k], atol=1e-7)
    else:
        assert tef is None and jef is None


def _cfgs():
    return (jm6.smoke().replace_moe(impl="pallas"), tm6.smoke().replace_moe(impl="pallas"))


def _params(jcfg, tcfg, seed=0):
    jp = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(seed))
    return jp, from_jax_params(jax.device_get(jp), tcfg, device="cpu", train=True)


@pytest.mark.parametrize("optimizer,compression", [
    ("adafactor", "none"), ("adamw", "int8"), ("adafactor", "int8"), ("adafactor", "bf16")])
def test_train_steps_match_reference(optimizer, compression):
    """Three steps of m6 smoke (pallas, top-1) through both trainers, in the
    reference's order clip -> compress -> update: per-step loss and grad
    norm within rtol 1e-5, every parameter after the last step within 2e-5
    (f32; the gradients themselves agree to ~1e-7).

    Under int8 a gradient element whose target sits at a near-tie of two
    codes can round to neighbouring codes in the two packages (a
    quantisation near-tie, as a routing near-tie is for the router): its
    residuals then differ by about one scale, and go on differing; the
    parameters it updates differ, and so every later gradient a little
    (under Adafactor its row's and column's factored moments too).  Such
    elements are found from the residuals after each step and must be rare
    (at most 1 in 2000); until the first one, each is at a near-tie of the
    reference's own target (within 1e-3 of a code's midpoint), and every
    other
    residual agrees within 1e-3 of its leaf's scale (the gradients agree to
    ~1e-6 of their largest element, which is 127 scales: observed up to
    1.2e-4 of a scale).  The flipped elements are left out of the final
    parameter comparison."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    kw = dict(optimizer=optimizer, learning_rate=1e-2, warmup_steps=2,
              grad_compression=compression)
    jtc, ttc = JTrainConfig(**kw), TTrainConfig(**kw)
    jopt = j_make_optimizer(jtc, j_warmup(jtc.learning_rate, jtc.warmup_steps))
    topt = t_make_optimizer(ttc, t_warmup(ttc.learning_rate, ttc.warmup_steps))
    jstate = j_init_state(jp, jopt, compression)
    tstate = t_init_state(tp, topt, compression)
    assert (tstate.error_feedback is None) == (compression != "int8")
    jstep = jax.jit(j_make_train_step(jcfg, jtc, jopt))
    jgrad = jax.jit(jax.grad(lambda p, b: _j_loss(jcfg)(p, b)))
    tstep = t_make_train_step(tcfg, ttc, topt)
    pipe = jpipe.make_pipeline(jcfg, 4, 36, seed=0)
    flipped = {}
    for i in range(3):
        b = {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
        if compression == "int8":          # the reference's own targets of this step
            jtarget = _int8_targets(jgrad(jstate.params, b), jstate, jtc.grad_clip_norm)
        jstate, jm = jstep(jstate, b)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        if compression == "int8":
            jef = _flat_leaves(jax.device_get(jstate.error_feedback))
            assert set(jef) == set(tstate.error_feedback)
            flips_before = dict(flipped)
            for k, t in tstate.error_feedback.items():
                target, scale = jtarget[k]
                diff = np.abs(t.numpy() - np.asarray(jef[k]))
                before = flipped.get(k, np.zeros(diff.shape, bool))
                flip = diff > 0.25 * scale
                flipped[k] = before | flip
                if any(f.any() for f in flips_before.values()):
                    continue
                codes = target[flip] / scale
                assert (np.abs(np.abs(codes - np.floor(codes)) - 0.5) < 1e-3).all(), k
                assert (diff[~flip] <= 1e-3 * scale).all(), k
    if compression == "int8":
        n = sum(f.sum() for f in flipped.values())
        assert n <= sum(f.size for f in flipped.values()) / 2000, n
    jflat = _flat_leaves(jax.device_get(jstate.params))
    for k, t in flat_params(tstate.params).items():
        keep = ~flipped.get(k, np.zeros(t.shape, bool))
        np.testing.assert_allclose(t.detach().numpy()[keep], np.asarray(jflat[k])[keep],
                                   atol=2e-5, rtol=0, err_msg=k)


def _j_loss(jcfg):
    from repro.core.context import MoEContext
    from repro.train.trainer import make_loss_fn

    loss_fn = make_loss_fn(jcfg)
    return lambda p, b: loss_fn(p, b, MoEContext(step=jnp.asarray(0), is_training=True))[0]


def _int8_targets(grads, jstate, clip_norm):
    """The reference trainer's int8 targets (clipped gradient + residual)
    and their scales, per flat path."""
    from repro.optim.clip import clip_by_global_norm

    grads, _ = clip_by_global_norm(grads, clip_norm)
    out = {}
    for k, g in _flat_leaves(jax.device_get(grads)).items():
        ef = np.asarray(_flat_leaves(jax.device_get(jstate.error_feedback))[k])
        target = np.asarray(g, np.float32) + ef
        out[k] = (target, np.float32(max(np.abs(target).max(), 1e-12)) / np.float32(127))
    return out


def _ref_state(jcfg, seed=0):
    """A reference TrainState of Adafactor with random (positive) moments
    and an int8 residual, step 3."""
    params = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(seed))
    state = j_init_state(params, j_adafactor(lambda s: 1e-3), "int8")
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 1), 256))
    rand = lambda x: jnp.abs(jax.random.normal(next(keys), x.shape, x.dtype))   # noqa: E731
    return state._replace(opt_state=jax.tree_util.tree_map(rand, state.opt_state),
                          error_feedback=jax.tree_util.tree_map(rand, state.error_feedback),
                          step=jnp.asarray(3, jnp.int32))


def _ref_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_adafactor_int8_checkpoint_round_trips_both_ways(tmp_path):
    """TrainState(params, Adafactor state, step, int8 residual): the port's
    leaves carry the reference's keys (``.opt_state['v'][...]['vc']``,
    ``.error_feedback[...]``) in its order; the reference's checkpoint
    restores into the port bit-equal, the port's into the reference bit-equal,
    and the two checkpoints are the same files, manifest included."""
    jcfg, tcfg = _cfgs()
    jstate = _ref_state(jcfg)
    want = _ref_leaves(jstate)
    params = from_jax_params(jax.device_get(jstate.params), tcfg, device="cpu", train=True)
    tstate = t_init_state(params, t_adafactor(lambda s: 1e-3), "int8")
    assert [k for k, _ in leaves(tstate)] == list(want)       # keys and order
    JCheckpointer(str(tmp_path / "ref")).save(3, jstate)
    got = Checkpointer(str(tmp_path / "ref")).restore(3, tstate)
    assert got.step == 3
    for key, t in leaves(got):
        t = np.asarray(t, np.int32) if key == ".step" else t        # a Python int
        np.testing.assert_array_equal(_bits(t), _bits(want[key]), err_msg=key)
    Checkpointer(str(tmp_path / "port")).save(3, got)
    back = JCheckpointer(str(tmp_path / "port")).restore(3, jax.eval_shape(lambda: jstate))
    for key, arr in _ref_leaves(back).items():
        np.testing.assert_array_equal(_bits(arr), _bits(want[key]), err_msg=key)
    d1, d2 = tmp_path / "ref" / "step_3", tmp_path / "port" / "step_3"
    assert sorted(os.listdir(d1)) == sorted(os.listdir(d2))
    for n in os.listdir(d1):
        assert (d1 / n).read_bytes() == (d2 / n).read_bytes(), n


def _train_config_of(module, argv):
    """The TrainConfig a train CLI builds from ``argv`` (its make_optimizer
    stopped at the call)."""
    seen = []

    class _Stop(Exception):
        pass

    def stop(tc, schedule):
        seen.append(tc)
        raise _Stop

    with mock.patch.object(module, "make_optimizer", stop), pytest.raises(_Stop):
        module.main(argv)
    return seen[0]


@pytest.mark.parametrize("arch", ["m6-1t", "m6-base"])
@pytest.mark.parametrize("flags", [[], ["--optimizer", "adafactor"], ["--optimizer", "adamw"],
                                   ["--lr", "0.25"], ["--optimizer", "adafactor", "--lr", "0.5"],
                                   ["--grad-compression", "int8", "--microbatches", "2"]])
def test_cli_train_config_matches_reference(arch, flags):
    """The flags -> TrainConfig mapping is the reference's, field for field.
    The learning rate follows the flag, not the resolved optimizer: m6-1t's
    default Adafactor trains at AdamW's 8e-5 unless --optimizer names it (a
    reference quirk the port mirrors)."""
    import dataclasses

    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    argv = ["--arch", arch, "--steps", "8", *flags]
    jtc = _train_config_of(jtrain, argv)
    ttc = _train_config_of(ttrain, argv + ["--device", "cpu"])
    assert dataclasses.asdict(ttc) == dataclasses.asdict(jtc)
    if arch == "m6-1t" and not flags:
        assert ttc.optimizer == "adafactor" and ttc.learning_rate == 8e-5


def test_train_cli_adafactor_int8_profile_on_cpu(tmp_path):
    """The train CLI with the flags that raised before: Adafactor, int8
    compression with error feedback and a --profile-dir trace (a Chrome
    trace of the loop's CPU activity here) on a decoder-LM smoke config."""
    from repro_torch.launch.train import main

    logs = main(["--arch", "granite-moe-3b-a800m", "--smoke", "--moe-impl", "pallas",
                 "--optimizer", "adafactor", "--grad-compression", "int8", "--steps", "3",
                 "--batch", "2", "--seq", "24", "--log-every", "1", "--device", "cpu",
                 "--routing", "prototype", "--k", "2", "--profile-dir", str(tmp_path)])
    assert [m["step"] for m in logs] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in logs)
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("einsum" in n for n in names)


def test_serve_cli_profile_dir_on_cpu(tmp_path, capsys):
    """--profile-dir on the serve CLI: a trace of the continuous engine's
    run; the static engine refuses it, as the reference's does."""
    from repro_torch.launch import serve

    argv = ["--arch", "qwen3-14b", "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--gen", "3", "--max-len", "16"]
    stats = serve.main(argv + ["--engine", "continuous", "--profile-dir", str(tmp_path)])
    assert stats["generated_tokens"] == 6.0
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    with pytest.raises(SystemExit, match="--profile-dir needs --engine continuous"):
        serve.main(argv + ["--profile-dir", str(tmp_path)])
