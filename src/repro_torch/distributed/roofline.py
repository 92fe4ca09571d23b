"""Three-term roofline model for the NVIDIA H100 SXM 80 GB
(``repro.distributed.roofline``, whose peaks are a TPU v5e's):

  t_compute    = flops            / (chips * 989e12)   dense bf16 tensor-core peak a card
  t_memory     = bytes_accessed   / (chips * 3.35e12)  HBM3 bytes/s a card
  t_collective = collective_bytes / (chips * collective_bw)

The peaks are the card's datasheet figures, not measurements.  So is the
collective bandwidth: NVLink 4 moves 450e9 bytes/s each way between the
8 cards of one node (:data:`NVLINK_BW`); an axis whose ranks span nodes
goes through one 400 Gb/s NDR port a card, 50e9 bytes/s
(:data:`NETWORK_BW`).  ``collective_bytes`` is the sum over the chips of
each one's wire bytes, so the term is one chip's bytes over its link.

The dry run (``repro_torch.launch.dryrun``) feeds it the analytic models
of :mod:`repro_torch.distributed.costs` and the collective counter of
:mod:`repro_torch.distributed.collectives`.  ``model_flops`` = 6 N_active D
(dense: N_active = N) gives the useful-compute ratio.
:func:`kernel_bound` is one kernel's least time on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

PEAK_FLOPS = 989e12        # dense bf16 flop/s a card (H100 SXM)
HBM_BW = 3.35e12           # HBM3 bytes/s a card
NVLINK_BW = 450e9          # bytes/s each way between the cards of a node (NVLink 4)
NETWORK_BW = 50e9          # bytes/s a card between nodes (one 400 Gb/s NDR port)
NODE_CARDS = 8


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    chips: int
    model_flops: Optional[float] = None   # 6 * N_active * tokens
    collective_bw: float = NETWORK_BW

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * self.collective_bw)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if not self.model_flops or not self.flops:
            return None
        return self.model_flops / self.flops

    @property
    def mfu_bound(self) -> Optional[float]:
        """Upper bound on model-FLOPs utilisation implied by the terms:
        useful FLOPs / (chips * peak * bound_time)."""
        if not self.model_flops or self.bound_time == 0:
            return None
        return self.model_flops / (self.chips * PEAK_FLOPS * self.bound_time)

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "collective_bw": self.collective_bw,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def model_flops_train(n_params_active: float, tokens: float) -> float:
    """6 N D for a train step (forward 2 N D + backward 4 N D)."""
    return 6.0 * n_params_active * tokens


def model_flops_forward(n_params_active: float, tokens: float) -> float:
    return 2.0 * n_params_active * tokens


def axis_bandwidth(axes: Tuple[Tuple[str, int], ...], axis: str) -> float:
    """The link rate of mesh axis ``axis`` of a row-major mesh ``((name,
    size), ...)`` laid over nodes of :data:`NODE_CARDS` consecutive ranks:
    NVLink where its ranks lie within one node (the axes inside it and it
    span at most a node), else the network's."""
    span = 1
    for name, size in reversed(axes):
        span *= size
        if name == axis:
            break
    return NVLINK_BW if span <= NODE_CARDS else NETWORK_BW


def effective_bandwidth(bytes_by_axis: Mapping[str, float],
                        bandwidth: Mapping[str, float]) -> float:
    """The one rate at which ``sum(bytes_by_axis)`` takes as long as each
    axis's bytes over its own rate (``NETWORK_BW`` where nothing moved)."""
    total = sum(bytes_by_axis.values())
    seconds = sum(b / bandwidth[a] for a, b in bytes_by_axis.items())
    return total / seconds if seconds else NETWORK_BW


def kernel_bound(nbytes: float, flops: float) -> Tuple[float, str]:
    """(bound ms, "bytes" or "operations") of one kernel on one card: the
    larger of the bytes over the memory rate and the flops over the bf16
    tensor-core rate."""
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
