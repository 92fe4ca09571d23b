"""Router registry (``repro.core.routers``).  The port registers
``topk`` and ``prototype``; ``MoEConfig.routing`` is a key into this
registry."""
from __future__ import annotations

from typing import Dict, Tuple, Type

from repro_torch.core.routers.base import Router, RoutingPlan  # noqa: F401

_REGISTRY: Dict[str, Router] = {}

# The reference's other routers: valid in a config, not ported.
UNPORTED = ("expert_choice", "hash")


def register_router(cls: Type) -> Type:
    name = getattr(cls, "name", None)
    if not name or not isinstance(name, str):
        raise ValueError(f"router class {cls!r} needs a string `name` attribute")
    _REGISTRY[name] = cls()
    return cls


def get_router(name: str) -> Router:
    if name in UNPORTED and name not in _REGISTRY:
        raise NotImplementedError(
            f"routing {name!r} is not ported; ported: {', '.join(available_routers())}")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown routing mode {name!r}; registered routers: "
            f"{', '.join(available_routers())}") from None


def available_routers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


from repro_torch.core.routers import prototype, topk  # noqa: E402,F401
