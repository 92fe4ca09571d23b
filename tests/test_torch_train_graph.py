"""The train step as a static form (``train.trainer.TrainForm``) on the CPU.

On the card the form's body is captured once as a CUDA graph and
replayed; here it runs eagerly over the same buffers, which is what a
replay computes.  So: (a) the body, built once and fed only through its
buffers (the batch, the step, the optimizer's per-step numbers), gives
the eager ``make_train_step``'s losses, metrics and parameters bit for
bit over steps 0-3, and the MoE context sees each step's number from the
device buffer (a value frozen at the first step would fail both); (b)
the same steps agree with the reference's jitted ``make_train_step`` at
``test_torch_training.py``'s tolerances (per-step loss, ce and grad norm
within rtol 1e-5, every parameter within atol 2e-5); (c) the body run on
``meta`` reads no host value and takes no host tensor, forward and
backward, for every one-device dispatcher and router of m6, MoE
attention, a mixed stack and the other families, nor makes a tensor of
host data (a host-to-device copy a capture refuses); (d) a checkpoint
restored into the form's leaves gives the unbroken run's next steps bit
for bit; and the train CLI takes ``--no-graphs``.
"""
from contextlib import contextmanager
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import m6 as jm6
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as jpipe
from repro.models.registry import get_family
from repro.nn import init as jinit
from repro.optim import make_optimizer as j_make_optimizer
from repro.optim import warmup_constant as j_warmup
from repro.train.state import init_train_state as j_init_state
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import m6 as tm6
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.context import MoEContext
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.train import build_parser
from repro_torch.nn import abstract, flat_params, from_jax_params, init_params
from repro_torch.optim import make_optimizer as t_make_optimizer
from repro_torch.optim import warmup_constant as t_warmup
from repro_torch.serving.graphs import Staging
from repro_torch.train import trainer
from repro_torch.train.state import init_train_state as t_init_state
from repro_torch.train.trainer import TrainForm, make_train_step
from test_torch_compiled_step import _NoHostReads
from torch.overrides import TorchFunctionMode
from torch_threads import one_torch_thread  # noqa: F401

BATCH, SEQ, STEPS = 2, 36, 4          # m6 smoke: 4 patch embeddings + 32 tokens
ROUTES = {"top-1 pallas": dict(impl="pallas"),
          "4 top-1 prototype": dict(routing="prototype", num_prototypes=4, impl="pallas"),
          "dropless": dict(impl="dropless", capacity_factor=None)}


def _config(route, **train):
    cfg = tm6.smoke().replace_moe(**ROUTES[route])
    # warm-up over 2 steps: the learning rate differs at steps 0, 1 and 2
    tc = TTrainConfig(**{"learning_rate": 1e-2, "warmup_steps": 2, **train})
    return cfg, tc, t_make_optimizer(tc, t_warmup(tc.learning_rate, tc.warmup_steps))


def _state(cfg, tc, opt, params=None):
    params = init_params(cfg, seed=0, device="cpu", train=True) if params is None else params
    return t_init_state(params, opt, tc.grad_compression)


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bit_equal(a: dict, b: dict, what: str) -> None:
    assert set(a) == set(b), what
    for k in a:
        assert torch.equal(_bits(a[k]), _bits(b[k])), f"{what}: {k}"


class _NoHostData(TorchFunctionMode):
    """Refuses a tensor made from host data (``torch.tensor``,
    ``Tensor.new_tensor``, ...): on ``meta`` it never reaches the dispatch
    as a host tensor, but on the card it is a host-to-device copy, which a
    capture refuses from pageable memory."""

    MAKERS = ("tensor", "new_tensor", "as_tensor", "from_numpy", "scalar_tensor")

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) in self.MAKERS:
            raise AssertionError(f"{func.__name__}: a tensor of host data in the step body")
        return func(*args, **(kwargs or {}))


@contextmanager
def no_host_values():
    """No host read, no host tensor and no tensor of host data."""
    with _NoHostData(), _NoHostReads():
        yield


def _recorded_steps(store: list):
    """The MoE context the step builds, recording its step's value."""
    def ctx(**kw):
        store.append(int(kw["step"]))
        return MoEContext(**kw)

    return mock.patch.object(trainer, "MoEContext", ctx)


# every route under both optimizers; each optimizer's two cases between
# them take microbatches 1 and 2 and compression none and int8, and every
# pair of those values occurs under some optimizer
FORM_CASES = [(opt, route, mb, comp) for route in ROUTES
              for opt, pairs in (("adamw", ((1, "none"), (2, "int8"))),
                                 ("adafactor", ((1, "int8"), (2, "none"))))
              for mb, comp in pairs]


@pytest.mark.parametrize("optimizer,route,microbatches,compression", FORM_CASES)
def test_form_is_the_eager_step_bit_for_bit(optimizer, route, microbatches, compression):
    cfg, tc, opt = _config(route, optimizer=optimizer, microbatches=microbatches,
                           grad_compression=compression)
    eager, graphed = _state(cfg, tc, opt), _state(cfg, tc, opt)
    step_fn, form = make_train_step(cfg, tc, opt), TrainForm(cfg, tc, opt, graphed)
    pipe = tpipe.make_pipeline(cfg, BATCH, SEQ, seed=0)
    seen = []
    for i in range(STEPS):
        b = pipe.batch_at(i)
        eager, em = step_fn(eager, {k: torch.from_numpy(v) for k, v in b.items()})
        with _recorded_steps(seen):
            graphed, gm = form(graphed, b)
        _assert_bit_equal(em, gm, f"metrics of step {i}")
    assert seen == list(range(STEPS))       # from the buffer, each step's own
    assert graphed.step == eager.step == STEPS
    _assert_bit_equal(flat_params(eager.params), flat_params(graphed.params), "params")
    for a, b in zip(torch.utils._pytree.tree_leaves(eager.opt_state),
                    torch.utils._pytree.tree_leaves(graphed.opt_state)):
        assert torch.equal(_bits(a), _bits(b))
    if compression == "int8":
        _assert_bit_equal(eager.error_feedback, graphed.error_feedback, "error feedback")
    assert form.graph_bytes == 0 and form.form.graph is None          # the CPU: eager


def _jflat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def test_form_matches_reference_jitted_step():
    """AdamW at lr 1e-3, top-1 through the grouped FFN: the train CLI's
    default and ``test_torch_training.py``'s first case."""
    route, optimizer, microbatches, lr = "top-1 pallas", "adamw", 1, 1e-3
    moe = ROUTES[route]
    jcfg = jm6.smoke().replace_moe(**moe)
    cfg, tc, opt = _config(route, optimizer=optimizer, microbatches=microbatches,
                           learning_rate=lr)
    jtc = JTrainConfig(optimizer=optimizer, microbatches=microbatches, learning_rate=lr,
                       warmup_steps=2)
    jopt = j_make_optimizer(jtc, j_warmup(jtc.learning_rate, jtc.warmup_steps))
    jp = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
    jstate = j_init_state(jp, jopt)
    state = _state(cfg, tc, opt, from_jax_params(jax.device_get(jp), cfg, device="cpu",
                                                 train=True))
    jstep, form = jax.jit(j_make_train_step(jcfg, jtc, jopt)), TrainForm(cfg, tc, opt, state)
    pipe = jpipe.make_pipeline(jcfg, BATCH, SEQ, seed=0)
    for i in range(STEPS):
        b = pipe.batch_at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, tm = form(state, b)
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert state.step == int(jstate.step) == STEPS
    jflat = _jflat(jstate.params)
    for k, t in flat_params(state.params).items():
        np.testing.assert_allclose(t.detach().numpy(), jflat[k], atol=2e-5, rtol=0, err_msg=k)


META_CASES = {
    **{f"m6 {impl}": ("m6-base", dict(impl=impl))
       for impl in ("einsum", "gather", "pallas", "alltoall")},
    "m6 dropless": ("m6-base", dict(impl="dropless", capacity_factor=None)),
    "m6 prototype": ("m6-base", dict(routing="prototype", num_prototypes=4)),
    "m6 hash": ("m6-base", dict(routing="hash", top_k=1)),
    "m6 expert choice dropless": ("m6-base", dict(routing="expert_choice", top_k=2,
                                                  impl="dropless", capacity_factor=None)),
    "m6 moe attention": ("m6-base", dict(moe_attention=True)),
    "m6 mixed stack": ("m6-base", "mixed"),
    "granite": ("granite-moe-3b-a800m", dict(impl="pallas")),
    "xlstm": ("xlstm-125m", None),
    "zamba": ("zamba2-7b", None),
    "encdec": ("seamless-m4t-large-v2", None),
}
META_SEQ = {"xlstm-125m": 16, "zamba2-7b": 16, "seamless-m4t-large-v2": 12}


# the grouped FFN's and the dropless path also under Adafactor, int8 and
# two microbatches (every one of those is elementwise or a reduction)
SECOND = ("m6 pallas", "m6 dropless")


@pytest.mark.parametrize("case,optimizer,compression,microbatches", [
    (case, "adamw", "none", 1) for case in META_CASES] + [
    (case, "adafactor", "int8", 2) for case in SECOND])
def test_body_reads_no_host_value(case, optimizer, compression, microbatches):
    """The body over ``meta`` leaves and buffers, forward, backward, clip,
    compression and update: no host read, no host tensor."""
    arch, moe = META_CASES[case]
    cfg = get_smoke_config(arch)
    if moe == "mixed":
        cfg = cfg.replace(moe_layer_period=2)
    elif moe is not None:
        cfg = cfg.replace_moe(**moe)
    tc = TTrainConfig(optimizer=optimizer, grad_compression=compression,
                      microbatches=microbatches)
    opt = t_make_optimizer(tc, t_warmup(1e-3, 2))
    state = t_init_state(abstract(cfg, train=True), opt, compression)
    form = TrainForm(cfg, tc, opt, state)
    form.stage(state, tpipe.make_pipeline(cfg, 2, META_SEQ.get(arch, SEQ), seed=0).batch_at(0))
    with no_host_values():
        metrics = form.form.body()
    assert metrics["loss"].device.type == "meta" and metrics["loss"].shape == ()
    assert metrics["grad_norm"].device.type == "meta"


def test_restore_into_form_continues_bit_for_bit(tmp_path):
    """Four steps unbroken, against two steps, a checkpoint, and a fresh
    state and form that the checkpoint restores into before steps 2-3."""
    cfg, tc, opt = _config("top-1 pallas", grad_compression="int8")
    pipe = tpipe.make_pipeline(cfg, BATCH, SEQ, seed=0)
    straight = _state(cfg, tc, opt)
    form = TrainForm(cfg, tc, opt, straight)
    losses = []
    for i in range(STEPS):
        straight, m = form(straight, pipe.batch_at(i))
        losses.append(m["loss"])
    first = _state(cfg, tc, opt)
    form = TrainForm(cfg, tc, opt, first)
    for i in range(2):
        first, _ = form(first, pipe.batch_at(i))
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(first.step, first)
    resumed = _state(cfg, tc, opt, init_params(cfg, seed=1, device="cpu", train=True))
    form = TrainForm(cfg, tc, opt, resumed)
    resumed = ckpt.restore(2, resumed)
    assert resumed.step == 2
    for i in range(2, STEPS):
        resumed, m = form(resumed, pipe.batch_at(i))
        assert torch.equal(_bits(m["loss"]), _bits(losses[i])), i
    _assert_bit_equal(flat_params(straight.params), flat_params(resumed.params), "params")
    _assert_bit_equal(straight.error_feedback, resumed.error_feedback, "error feedback")
    with pytest.raises(ValueError, match="the state it was built on"):
        form(first, pipe.batch_at(2))


def test_staging_checks_shapes_and_aligns_fields():
    st = Staging({"a": ((3, 5), torch.int32), "s": ((), torch.int32),
                  "f": ((2,), torch.float32)}, "cpu")
    assert all(t.data_ptr() % 16 == 0 for t in st.buffers.values())
    st.put({"a": np.arange(15, dtype=np.int32).reshape(3, 5), "s": 7,
            "f": np.array([0.5, -1.25], np.float32)})
    st.send()
    assert st.buffers["a"].tolist() == np.arange(15).reshape(3, 5).tolist()
    assert int(st.buffers["s"]) == 7 and st.buffers["f"].tolist() == [0.5, -1.25]
    with pytest.raises(ValueError, match="shape"):
        st.put({"a": np.zeros((3, 4), np.int32)})


def test_cli_graphs_flag():
    assert build_parser().parse_args([]).graphs is True
    assert build_parser().parse_args(["--no-graphs"]).graphs is False
