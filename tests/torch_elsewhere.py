"""A tensor on a device the kernel wrappers have no route for.

The wrappers run the plain version on the CPU, launch the kernel on CUDA
and make the kernel's tensors without launching on ``meta`` (the dry
run); on any other device they raise.  This machine can make tensors of
no other device, so :func:`elsewhere` gives a wrapper of ``t``'s shape and
dtype that reports device ``xpu`` and holds no data (any op on it raises).
"""
import torch


class _Elsewhere(torch.Tensor):
    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_wrapper_subclass(cls, t.shape, dtype=t.dtype, device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func}: a tensor of a device with no data")


def elsewhere(t: torch.Tensor) -> torch.Tensor:
    return _Elsewhere(t)
