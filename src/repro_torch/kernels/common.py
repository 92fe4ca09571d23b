"""Helpers shared by the kernel wrappers: the activation codes of the
grouped-FFN sources and the backward of a kernel without a backward kernel."""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def act_code(activation: str, gated: bool) -> int:
    """The C sources' activation code, with the reference's mapping: gated
    -> silu for "swiglu", else gelu; ungated -> gelu for "gelu", else relu."""
    if gated:
        return 3 if activation == "swiglu" else 4
    return 1 if activation == "gelu" else 2


def ref_vjp(ref: Callable, inputs: Sequence, needs_grad: Sequence[bool],
            grad: torch.Tensor) -> tuple:
    """Gradients of ``ref(*inputs)`` against ``grad`` for the inputs flagged
    in ``needs_grad`` (None for the others): autograd through the plain
    version, as the reference's ``custom_vjp`` backward differentiates its
    ``ref.py``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) if isinstance(t, torch.Tensor) else t
                  for t, n in zip(inputs, needs_grad)]
        out = ref(*leaves)
        wrt = [t for t, n in zip(leaves, needs_grad) if n]
        grads = iter(torch.autograd.grad(out, wrt, grad) if wrt else ())
    return tuple(next(grads) if n else None for n in needs_grad)
