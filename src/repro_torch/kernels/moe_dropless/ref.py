"""Plain PyTorch version of the ragged grouped FFN
(``repro.kernels.moe_dropless.ref.ragged_ffn_ref``): rows reshape to
(NB, bx, M) blocks, each block gathers its expert's weights and runs the
dense FFN in f32.  The CPU path of the wrapper and the yardstick the CUDA
kernel is held to."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


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
