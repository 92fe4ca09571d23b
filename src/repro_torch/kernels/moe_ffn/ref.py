"""Plain PyTorch versions of the grouped expert FFN.

``moe_ffn_ref`` (``repro.kernels.moe_ffn.ref.moe_ffn_ref``): each expert's
dense FFN over its (X, M) buffer in f32, the result in the input dtype.
The CPU path of the wrapper, its backward, and the yardstick the CUDA
kernel is held to.

``moe_ffn_split_ref``: the tensor-core route's numerics, for the card's
checks only: the same f32 up product, h split into bf16 hi + lo planes
(about 16 mantissa bits), the down product from both.  The kernel differs
from it only in how its f32 sums are taken (order, and the tensor cores'
accumulation)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _act(h: torch.Tensor, g: Optional[torch.Tensor], activation: str) -> torch.Tensor:
    if g is not None:
        return (F.silu(g) if activation == "swiglu" else F.gelu(g, approximate="tanh")) * h
    return F.gelu(h, approximate="tanh") if activation == "gelu" else F.relu(h)


def split_h(h: torch.Tensor) -> torch.Tensor:
    """f32 h as its bf16 hi + lo planes (hi = bf16(h), lo = bf16(h - hi)),
    summed back in f32, which is exact: about 16 significant bits of h."""
    hi = h.to(torch.bfloat16).float()
    return hi + (h - hi).to(torch.bfloat16).float()


def _ffn(x, w_up, w_gate, w_down, activation, keep_h):
    x32 = x.float()
    g = torch.bmm(x32, w_gate.float()) if w_gate is not None else None
    h = keep_h(_act(torch.bmm(x32, w_up.float()), g, activation))
    return torch.bmm(h, w_down.float()).to(x.dtype)


def moe_ffn_ref(x: torch.Tensor, w_up: torch.Tensor, w_gate: Optional[torch.Tensor],
                w_down: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    """x: (E, X, M); w_up/w_gate: (E, M, I); w_down: (E, I, M)."""
    return _ffn(x, w_up, w_gate, w_down, activation, lambda h: h)


def moe_ffn_split_ref(x: torch.Tensor, w_up: torch.Tensor, w_gate: Optional[torch.Tensor],
                      w_down: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    """As :func:`moe_ffn_ref`, with h kept as bf16 hi + lo before the down
    product (the tensor-core route's numerics)."""
    return _ffn(x, w_up, w_gate, w_down, activation, split_h)
