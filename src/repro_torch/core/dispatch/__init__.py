"""MoE execution backends (``repro.core.dispatch``).  ``MoEConfig.impl``
is a key into this registry; the port registers the reference's five:
``dropless`` (the capacity-free ragged grouped GEMM that serving uses),
the capacity backends ``einsum``, ``gather`` and ``pallas`` that training
uses, and ``alltoall`` (explicit expert parallelism over a serving mesh,
``gather`` without one)."""
from __future__ import annotations

from typing import Dict, Tuple, Type

_REGISTRY: Dict[str, object] = {}


def register_dispatcher(cls: Type) -> Type:
    name = getattr(cls, "name", None)
    if not name or not isinstance(name, str):
        raise ValueError(f"dispatcher class {cls!r} needs a string `name` attribute")
    _REGISTRY[name] = cls()
    return cls


def get_dispatcher(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown moe impl {name!r}; registered dispatchers: "
            f"{', '.join(available_dispatchers())}") from None


def available_dispatchers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


from repro_torch.core.dispatch import alltoall, dropless, einsum, gather, pallas  # noqa: E402,F401
