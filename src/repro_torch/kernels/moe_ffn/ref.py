"""Plain PyTorch version of the grouped expert FFN
(``repro.kernels.moe_ffn.ref.moe_ffn_ref``): each expert's dense FFN over
its (X, M) buffer in f32, the result in the input dtype.  The CPU path of
the wrapper, its backward, and the yardstick the CUDA kernel is held to."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def moe_ffn_ref(x: torch.Tensor, w_up: torch.Tensor, w_gate: Optional[torch.Tensor],
                w_down: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    """x: (E, X, M); w_up/w_gate: (E, M, I); w_down: (E, I, M)."""
    x32 = x.float()
    h = torch.bmm(x32, w_up.float())
    if w_gate is not None:
        g = torch.bmm(x32, w_gate.float())
        h = (F.silu(g) if activation == "swiglu" else F.gelu(g, approximate="tanh")) * h
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        h = F.relu(h)
    return torch.bmm(h, w_down.float()).to(x.dtype)
