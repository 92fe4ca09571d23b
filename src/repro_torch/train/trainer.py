"""The train step (``repro.train.trainer``): forward and backward,
gradient accumulation over microbatches, global-norm clipping and the
optimizer update.

The reference's step is a pure function that jit compiles with the old
state donated; the port's runs eagerly and updates the parameters and
the optimizer state in place, returning them in a new ``TrainState``.
The update is added in f32, as the reference adds it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.context import MoEContext
from repro_torch.models.registry import get_family
from repro_torch.nn import flat_params
from repro_torch.optim.api import Optimizer
from repro_torch.optim.clip import clip_by_global_norm
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


def make_train_step(cfg: ModelConfig, tc: TrainConfig, optimizer: Optimizer) -> Callable:
    loss_fn = make_loss_fn(cfg)
    if tc.grad_compression != "none":
        raise NotImplementedError(f"grad_compression {tc.grad_compression!r} is not ported")

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        # The MoE side channel: routers and dispatchers see the step and
        # the train flag; the ported routers read no PRNG.
        ctx = MoEContext(step=state.step, is_training=True)
        flat = flat_params(state.params)
        if tc.microbatches > 1:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in flat.items()}
            msum = {"loss": 0.0, "ce": 0.0}
            for one in _split_microbatches(batch, tc.microbatches):
                loss, metrics = loss_fn(state.params, one, ctx)
                for k, g in _grads(loss, flat).items():
                    grads[k] = grads[k] + g
                msum = {"loss": msum["loss"] + loss.detach(),
                        "ce": msum["ce"] + metrics["ce"].detach()}
            grads = {k: g / tc.microbatches for k, g in grads.items()}
            metrics = {k: v / tc.microbatches for k, v in msum.items()}
        else:
            loss, metrics = loss_fn(state.params, batch, ctx)
            grads = _grads(loss, flat)
            metrics = {k: v.detach() for k, v in metrics.items()}

        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip_norm)
        updates, new_opt = optimizer.update(grads, state.opt_state, flat, state.step)
        with torch.no_grad():
            for k, p in flat.items():
                p.copy_(p.float() + updates[k].float())
        metrics["grad_norm"] = gnorm
        return TrainState(state.params, new_opt, state.step + 1, None), metrics

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    loss_fn = make_loss_fn(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch, MoEContext(is_training=False))
        return metrics

    return eval_step
