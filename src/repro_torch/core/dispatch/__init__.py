"""MoE execution backends (``repro.core.dispatch``).  ``MoEConfig.impl``
is a key into this registry; the port registers ``dropless`` (the
capacity-free ragged grouped GEMM that serving uses) and the capacity
backends ``einsum``, ``gather`` and ``pallas`` that training uses."""
from __future__ import annotations

from typing import Dict, Tuple, Type

_REGISTRY: Dict[str, object] = {}

# The reference's other backends: valid in a config, not ported.
UNPORTED = ("alltoall",)


def register_dispatcher(cls: Type) -> Type:
    name = getattr(cls, "name", None)
    if not name or not isinstance(name, str):
        raise ValueError(f"dispatcher class {cls!r} needs a string `name` attribute")
    _REGISTRY[name] = cls()
    return cls


def get_dispatcher(name: str):
    if name in UNPORTED and name not in _REGISTRY:
        raise NotImplementedError(
            f"moe impl {name!r} is not ported; ported: {', '.join(available_dispatchers())}")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown moe impl {name!r}; registered dispatchers: "
            f"{', '.join(available_dispatchers())}") from None


def available_dispatchers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


from repro_torch.core.dispatch import dropless, einsum, gather, pallas  # noqa: E402,F401
