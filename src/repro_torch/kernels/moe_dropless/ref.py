"""Plain PyTorch versions of the ragged grouped FFN.

``ragged_ffn_ref`` (``repro.kernels.moe_dropless.ref.ragged_ffn_ref``):
rows reshape to (NB, bx, M) blocks, each block gathers its expert's
weights and runs the dense FFN in f32.  The CPU path of the wrapper and
the yardstick the CUDA kernel is held to.

``ragged_ffn_split_ref``: the tensor-core route's numerics (h split into
bf16 hi + lo before the down product), for the card's checks only."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_ffn.ref import moe_ffn_split_ref


def ragged_ffn_ref(x: torch.Tensor, block_expert: torch.Tensor, w_up: torch.Tensor,
                   w_gate: Optional[torch.Tensor], w_down: torch.Tensor,
                   activation: str = "swiglu") -> torch.Tensor:
    """x: (N, M) sorted rows; block_expert: (NB,) with N % NB == 0."""
    N, M = x.shape
    nb = block_expert.shape[0]
    bx = N // nb
    be = block_expert.long()
    xb = x.reshape(nb, bx, M).float()
    h = torch.bmm(xb, w_up[be].float())
    if w_gate is not None:
        g = torch.bmm(xb, w_gate[be].float())
        h = (F.silu(g) if activation == "swiglu" else F.gelu(g, approximate="tanh")) * h
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        h = torch.clamp(h, min=0.0)
    return torch.bmm(h, w_down[be].float()).reshape(N, M).to(x.dtype)


def ragged_ffn_split_ref(x: torch.Tensor, block_expert: torch.Tensor, w_up: torch.Tensor,
                         w_gate: Optional[torch.Tensor], w_down: torch.Tensor,
                         activation: str = "swiglu") -> torch.Tensor:
    """As :func:`ragged_ffn_ref`, with h kept as bf16 hi + lo before the
    down product (the tensor-core route's numerics)."""
    N, M = x.shape
    nb = block_expert.shape[0]
    be = block_expert.long()
    y = moe_ffn_split_ref(x.reshape(nb, N // nb, M), w_up[be],
                          None if w_gate is None else w_gate[be], w_down[be], activation)
    return y.reshape(N, M)
