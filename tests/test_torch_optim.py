"""The port's AdamW update and the trainer's microbatch average against the
JAX reference on the CPU, bit for bit.

Both packages get the same numpy leaves and gradients; the reference's
update runs op by op (not under jit, so XLA fuses nothing).  The update and
the moments must be bit-equal.  Two faults of the port break that and are
held here: a division by a Python number (on the card PyTorch multiplies
by its reciprocal; the CPU cannot show it, so the divisors must be
tensors), and PyTorch's vectorized CPU sqrt, which is not correctly
rounded where XLA's and the card's are.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.optim.adamw import adamw as j_adamw
from repro.optim.schedules import warmup_constant as j_warmup
from repro_torch.optim.adamw import adamw as t_adamw
from repro_torch.optim.schedules import warmup_constant as t_warmup
from repro_torch.train.trainer import microbatch_mean
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = {"wq": (48, 40), "bias": (40,), "up": (3, 8, 24)}
B1 = 0.9


class _Divisors(TorchFunctionMode):
    """Records the divisor of every tensor division."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.__truediv__, torch.Tensor.div, torch.Tensor.div_, torch.div,
                    torch.true_divide):
            self.seen.append(args[1])
        return func(*args, **(kwargs or {}))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_bit_equal_to_reference(dtype):
    """Six steps (warmup 4, so lr changes) on f32 or bf16 leaves: the
    updates, mu and nu bit-equal to the reference's at every step, every
    division by a tensor; the bias corrections c1 = 1 - 0.9^t are never
    powers of two, so a reciprocal would round differently."""
    rng = np.random.default_rng(7)
    np_dt = jnp.dtype(dtype).type
    params = {k: (rng.standard_normal(s) * 0.05).astype(np.float32).astype(np_dt)
              for k, s in SHAPES.items()}
    jopt, topt = j_adamw(j_warmup(1e-3, 4)), t_adamw(t_warmup(1e-3, 4))
    jstate = jopt.init({k: jnp.asarray(v) for k, v in params.items()})
    tstate = topt.init({k: torch.from_numpy(v.astype(np.float32)).to(getattr(torch, dtype))
                        for k, v in params.items()})
    for step in range(6):
        c1 = np.float32(1) - np.float32(B1) ** np.float32(step + 1)
        assert np.frexp(c1)[0] != 0.5                     # not a power of two
        grads = {k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
                 for k, s in SHAPES.items()}
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        tp = {k: torch.from_numpy(v.astype(np.float32)).to(getattr(torch, dtype))
              for k, v in params.items()}
        ju, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp,
                                 jnp.asarray(step, jnp.int32))
        with _Divisors() as divs:
            tu, tstate = topt.update({k: torch.from_numpy(v) for k, v in grads.items()},
                                     tstate, tp, step)
        assert divs.seen and all(isinstance(d, torch.Tensor) for d in divs.seen)
        for k in SHAPES:
            for what, t, j in (("update", tu[k].float().numpy().astype(np_dt), ju[k]),
                               ("mu", tstate["mu"][k].numpy(), jstate["mu"][k]),
                               ("nu", tstate["nu"][k].numpy(), jstate["nu"][k])):
                np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=f"{k} {what}")
            params[k] = (params[k].astype(np.float32) + np.asarray(ju[k]).astype(np.float32)
                         ).astype(np_dt)


def test_adamw_sqrt_is_correctly_rounded():
    """The update's sqrt on the CPU: the correctly rounded f32 root (that of
    f64, rounded once), as XLA's; PyTorch's own vectorized f32 sqrt is not
    everywhere, so the update would differ from the reference's without it."""
    from repro_torch.optim.adamw import _sqrt

    x = np.abs(np.random.default_rng(5).standard_normal(100_000)).astype(np.float32) + 0.1
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(_bits(_sqrt(torch.from_numpy(x.copy())).numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(jnp.sqrt(jnp.asarray(x))), _bits(want))


def test_microbatch_mean_bit_equal_to_reference():
    """The trainer's average over 3 microbatches is the reference's g / 3,
    a true division, by a 0-dim tensor on the sums' device."""
    rng = np.random.default_rng(3)
    sums = {k: (rng.standard_normal(s) * 3.0).astype(np.float32) for k, s in SHAPES.items()}
    sums["loss"] = np.float32(7.25)
    with _Divisors() as divs:
        got = microbatch_mean({k: torch.from_numpy(np.asarray(v)) for k, v in sums.items()}, 3)
    assert len(divs.seen) == len(sums)
    assert all(isinstance(d, torch.Tensor) and d.dim() == 0 for d in divs.seen)
    for k, v in sums.items():
        np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(jnp.asarray(v) / 3),
                                      err_msg=k)
