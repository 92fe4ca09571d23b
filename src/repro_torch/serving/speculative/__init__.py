"""Pluggable speculative-decoding drafters (``repro.serving.speculative``).

``SpecConfig.drafter`` is a key into this registry.  Built-ins:

* ``ngram`` — prompt-lookup self-drafting: propose the continuation of the
  most recent earlier occurrence of the slot's context suffix.  No
  parameters, no second model.
* ``model`` — a draft model sharing the target's vocab proposes greedy
  continuations through ``gamma`` full-context forwards of static shape
  ``(max_slots, max_len)``.

A drafter only proposes; the engine scores every proposal in one verify
step and the acceptance rule (``speculative.accept``) keeps greedy output
token-identical to non-speculative decoding and temperature > 0 output
distributed as the target model's.  A bad drafter costs throughput,
never correctness.

Adding a drafter::

    from repro_torch.serving.speculative import register_drafter

    @register_drafter
    class MyDrafter:
        name = "mine"
        def __init__(self, spec, target_cfg, serve, *, seed=0,
                     draft_model=None, device="cuda"): ...
        def propose(self, items):  # List[DraftItem] -> List[np.ndarray]
            ...

Register before a ``SpecConfig(drafter="mine")`` is built (config
validation consults this registry).  ``device`` is the engine's device,
where a drafter that runs a model keeps it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

from repro_torch.serving.speculative.base import Drafter, DraftItem  # noqa: F401

_REGISTRY: Dict[str, Type] = {}


def register_drafter(cls: Type) -> Type:
    """Class decorator: register a drafter class under ``cls.name``.  The
    registry holds classes, not instances: drafters are stateful (the model
    drafter owns params), so :func:`make_drafter` builds one per engine."""
    name = getattr(cls, "name", None)
    if not name or not isinstance(name, str):
        raise ValueError(f"drafter class {cls!r} needs a string `name` attribute")
    _REGISTRY[name] = cls
    return cls


def get_drafter_cls(name: str) -> Type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown drafter {name!r}; registered drafters: "
            f"{', '.join(available_drafters())}") from None


def available_drafters() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_drafter(spec, target_cfg, serve, *, seed: int = 0,
                 draft_model: Optional[Tuple] = None, device="cuda") -> Drafter:
    """Build ``spec.drafter`` for one engine.  ``draft_model`` is an optional
    ``(ModelConfig, params)`` for the model drafter (``SpecConfig.draft``
    names a registered config otherwise)."""
    return get_drafter_cls(spec.drafter)(spec, target_cfg, serve, seed=seed,
                                         draft_model=draft_model, device=device)


# built-ins register themselves on import
from repro_torch.serving.speculative import model, ngram  # noqa: E402,F401

__all__ = ["Drafter", "DraftItem", "register_drafter", "get_drafter_cls",
           "available_drafters", "make_drafter"]
