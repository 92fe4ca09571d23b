"""Weight initializers (``repro.nn.initializers``).

The paper (M6-T §4, Table 5) uses BERT truncated-normal init (mu = 0,
sigma = 0.02) for models up to 100 B and sigma reduced 10x (0.002) for the
1 T model.  Each initializer here is a function ``(generator, shape,
dtype, device) -> Tensor`` (the reference's take a PRNG key): the values
are drawn in float32 from ``generator`` and cast to ``dtype``.  They match
the reference in distribution only: ``jax.random`` and ``torch`` give
different numbers for the same seed.
"""
from __future__ import annotations

import math

import torch


def zeros_init(generator, shape, dtype, device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(generator, shape, dtype, device=None) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def normal_init(stddev: float = 0.02):
    def _init(generator, shape, dtype, device=None):
        x = torch.empty(shape, dtype=torch.float32, device=device)
        return x.normal_(0.0, 1.0, generator=generator).mul_(stddev).to(dtype)

    return _init


def truncated_normal_init(stddev: float = 0.02, lower: float = -2.0, upper: float = 2.0):
    """BERT-style truncated normal: a standard normal truncated to
    [lower, upper] (+-2 sigma), times ``stddev``."""

    def _init(generator, shape, dtype, device=None):
        x = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, lower, upper, generator=generator)
        return x.mul_(stddev).to(dtype)

    return _init


def scaled_normal_init(fan_in_axes=(-2,), scale: float = 1.0):
    """Variance-scaled (1 / sqrt(fan_in)) truncated normal, for projections."""

    def _init(generator, shape, dtype, device=None):
        fan_in = 1
        for ax in fan_in_axes:
            fan_in *= shape[ax]
        return truncated_normal_init(scale / math.sqrt(max(fan_in, 1)))(
            generator, shape, dtype, device)

    return _init
