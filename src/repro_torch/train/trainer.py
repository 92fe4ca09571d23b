"""The train step (``repro.train.trainer``): forward and backward,
gradient accumulation over microbatches, global-norm clipping, gradient
compression and the optimizer update, in the reference's order.

The reference's step is a pure function that jit compiles with the old
state donated; the port's updates the parameters and the optimizer state
in place, returning them in a new ``TrainState``.  The update is added in
f32, as the reference adds it.  :func:`make_train_step` runs eagerly;
:class:`TrainForm` is the one-device step as a static form over buffers
it keeps, captured on the card as a CUDA graph and replayed (the train
CLI's).  A mesh rank's step stays eager: its collectives over gloo are
host-staged copies, which a graph cannot hold.

On a ("data", "model") mesh (``layout``, a
:class:`~repro_torch.train.layout.MeshLayout`) the step is the
reference's under pjit, with GSPMD's collectives written out: every rank
is given the global batch and takes its rows (the pipeline is a pure
function of the step, so every rank draws the same bytes), computes its
blocks' gradients under the mesh's rules (tensor and expert parallelism
over "model", ``models`` and ``core.dispatch``), sums them over the data
axes, clips by the whole gradient's norm, compresses with whole-leaf int8
scales, updates its ZeRO-1 block of each parameter and all-gathers the
blocks over the data axes.  One device runs the same step on a mesh of one
rank (``MeshLayout.single``), on which every collective is skipped.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.context import MoEContext
from repro_torch.distributed.sharding import use_rules
from repro_torch.models.registry import get_family
from repro_torch.nn import flat_params
from repro_torch.optim.api import Optimizer
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.compression import compress_grads
from repro_torch.serving.graphs import GraphForm, Staging, copy_state
from repro_torch.train.layout import MeshLayout
from repro_torch.train.losses import total_loss
from repro_torch.train.state import TrainState


def make_loss_fn(cfg: ModelConfig):
    fam = get_family(cfg)

    def loss_fn(params, batch, ctx: Optional[MoEContext] = None):
        logits, aux = fam.forward(params, batch, cfg, ctx=ctx)
        return total_loss(logits, batch["labels"], aux)

    return loss_fn


def _grads(loss, flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    got = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(flat.items(), got)}


def _split_microbatches(batch: Dict, n: int):
    return [{k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(n)]


def microbatch_mean(sums: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    """Each sum over ``n`` microbatches divided by ``n`` truly, as the
    reference's ``g / tc.microbatches``: PyTorch on the card multiplies by
    the reciprocal when the divisor is a Python number, so the divisor is
    a 0-dim f32 tensor on each sum's device, made once a call."""
    divisors: Dict[torch.device, torch.Tensor] = {}
    out = {}
    for k, t in sums.items():
        if t.device not in divisors:
            divisors[t.device] = torch.full((), n, dtype=torch.float32, device=t.device)
        out[k] = t / divisors[t.device]
    return out


def make_train_step(cfg: ModelConfig, tc: TrainConfig, optimizer: Optimizer,
                    layout: Optional[MeshLayout] = None) -> Callable:
    """The train step of a mesh rank whose state ``init_train_state(...,
    layout=layout)`` builds; without ``layout``, of one device (a mesh of
    one rank, on which every collective is skipped)."""
    update = _make_update(cfg, tc, optimizer, layout)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        new_opt, ef, metrics = update(state, batch, state.step)
        return TrainState(state.params, new_opt, state.step + 1, ef), metrics

    return train_step


def _make_update(cfg: ModelConfig, tc: TrainConfig, optimizer: Optimizer,
                 layout: Optional[MeshLayout] = None) -> Callable:
    """``update(state, batch, scalars)`` -> (new optimizer state, new
    error feedback, metrics): the step's body, the params updated in place.
    ``scalars`` is what the optimizer's update takes as its step (the
    step's number, or its numbers on the device); ``state.step`` reaches
    the MoE context as it is (an int, or a device tensor)."""
    loss_fn = make_loss_fn(cfg)
    layout = layout if layout is not None else MeshLayout.single(cfg)
    sum_squares, global_max, shards = layout.sum_squares(), layout.global_max(), layout.shards()

    def update(state: TrainState, batch: Dict, scalars):
        flat = flat_params(state.params)
        with use_rules(layout.rules):
            grads, metrics = _loss_and_grads(
                loss_fn, tc, state, layout.local_batch(batch, tc.microbatches), flat)
        grads = layout.reduce_grads(grads)
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip_norm, sum_squares)
        grads, ef = compress_grads(grads, tc.grad_compression, state.error_feedback, global_max)
        with torch.no_grad():
            blocks = {k: layout.zero_block(k, p) for k, p in flat.items()}
            updates, new_opt = optimizer.update(
                {k: layout.zero_block(k, g) for k, g in grads.items()}, state.opt_state,
                blocks, scalars, shards=shards)
            for k, p in blocks.items():
                p.copy_(p.float() + updates[k].float())
            for k, p in flat.items():
                layout.gather_update(k, p)
        metrics["grad_norm"] = gnorm
        return new_opt, ef, metrics

    return update


class TrainForm:
    """The one-device train step as one static form, the reference's
    ``jax.jit(wrapped, donate_argnums=(0,))``: a body over buffers the
    form keeps for its life (``serving.graphs.Staging``: the batch, the
    step and the optimizer's per-step numbers, which :meth:`__call__`
    writes on the host and sends with one copy) and the leaves of
    ``state`` (params, optimizer state and error feedback, each updated in
    place: a step's new error feedback is copied into the kept one).
    On a CUDA device with ``graphs`` the first call captures the body as a
    CUDA graph, and that capture's warm-up is the step itself, run
    eagerly (its launches counted, its metrics returned); every later call
    replays the graph.  On the CPU, on ``meta`` and with ``graphs=False``
    every call runs the body eagerly.  A failed capture raises.

    Each call takes the state the form holds (``state.params`` its tree)
    and a host batch (numpy arrays of the first batch's shapes), and
    returns the state with its step advanced, and the step's metrics.  A
    checkpoint restores into the held leaves in place
    (``Checkpointer.restore``), as into any state.  One form a state: the
    train CLI builds one for each attempt of its loop."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, optimizer: Optimizer,
                 state: TrainState, graphs: bool = True):
        self._update = _make_update(cfg, tc, optimizer)
        self.optimizer = optimizer
        self.params, self.opt_state, self.ef = state.params, state.opt_state, state.error_feedback
        self._leaves = list(flat_params(state.params).values())
        self.device = self._leaves[0].device
        self.graphs = graphs and self.device.type == "cuda"
        self.staging: Optional[Staging] = None
        self.form: Optional[GraphForm] = None

    @property
    def graph_bytes(self) -> int:
        """What the capture added to the device's memory pools (0 eager)."""
        return 0 if self.form is None else self.form.graph_bytes

    def _build(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(self.optimizer.scalars(0))
        fields = {k: (v.shape, torch.from_numpy(v).dtype) for k, v in batch.items()}
        fields.update(step=((), torch.int32), scalars=((n,), torch.float32))
        self.staging = staging = Staging(fields, self.device)
        buffers, update = staging.buffers, self._update
        params, opt_state, ef = self.params, self.opt_state, self.ef
        keys = tuple(batch)

        def body():
            # the step's number reaches the MoE context from the device
            state = TrainState(params, opt_state, buffers["step"], ef)
            new_opt, new_ef, metrics = update(state, {k: buffers[k] for k in keys},
                                              buffers["scalars"])
            copy_state(opt_state, new_opt)
            if ef is not None:
                copy_state(ef, new_ef)
            return metrics

        shapes = " x ".join(str(d) for d in next(iter(batch.values())).shape)
        self.form = GraphForm(body, f"the train step ({shapes})", inputs=staging.dev)

    def stage(self, state: TrainState, batch: Dict[str, np.ndarray]) -> None:
        """Write ``state``'s step, its numbers and ``batch`` into the
        buffers, and send them to the device."""
        leaves = flat_params(state.params).values()
        if len(leaves) != len(self._leaves) or any(a is not b for a, b in
                                                   zip(leaves, self._leaves)):
            raise ValueError("the train form steps the state it was built on (its leaves, "
                             "into which a checkpoint restores in place)")
        if self.form is None:
            self._build(batch)
        elif set(batch) != set(self.staging.fields) - {"step", "scalars"}:
            raise ValueError(f"batch keys {sorted(batch)} differ from the form's")
        self.staging.put(dict(batch, step=state.step,
                              scalars=self.optimizer.scalars(state.step)))
        self.staging.send()

    def __call__(self, state: TrainState, batch: Dict[str, np.ndarray]
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        self.stage(state, batch)
        if self.graphs and self.form.graph is None:
            metrics = self.form.capture(self.device, None, real_warm_up=True)
        elif self.form.graph is None:
            metrics = self.form.run()
        else:
            # the replay's outputs are the graph's, which the next overwrites
            metrics = {k: v.clone() for k, v in self.form.run().items()}
        return TrainState(self.params, self.opt_state, state.step + 1, self.ef), metrics


def _loss_and_grads(loss_fn, tc: TrainConfig, state: TrainState, batch: Dict, flat):
    """(grads, metrics) of the batch, microbatched as ``tc`` says."""
    # The MoE side channel: routers and dispatchers see the step and the
    # train flag; the ported routers read no PRNG.
    ctx = MoEContext(step=state.step, is_training=True)
    if tc.microbatches > 1:
        grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in flat.items()}
        msum = {"loss": 0.0, "ce": 0.0}
        for one in _split_microbatches(batch, tc.microbatches):
            loss, metrics = loss_fn(state.params, one, ctx)
            for k, g in _grads(loss, flat).items():
                grads[k] = grads[k] + g
            # the metrics' loss: the global one on a data-sharded mesh, where
            # ``loss`` is this rank's part of it
            msum = {"loss": msum["loss"] + metrics["loss"].detach(),
                    "ce": msum["ce"] + metrics["ce"].detach()}
        return microbatch_mean(grads, tc.microbatches), microbatch_mean(msum, tc.microbatches)
    loss, metrics = loss_fn(state.params, batch, ctx)
    return _grads(loss, flat), {k: v.detach() for k, v in metrics.items()}


def make_eval_step(cfg: ModelConfig) -> Callable:
    loss_fn = make_loss_fn(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch, MoEContext(is_training=False))
        return metrics

    return eval_step
