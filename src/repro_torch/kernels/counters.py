"""The kernel wrappers' launch counters, read and written as one.

Each wrapper counts the kernels it launches in attributes on itself
(``.launches``; the grouped FFN's and flash attention's ``.tc_launches``
those on the tensor-core route), ticked in Python where it launches.  A
CUDA graph replays its kernels without running that Python, so the owner
of a graph reads the counters around its capture (:func:`read`,
:func:`since`), puts them back (:func:`write`: a capture launches nothing)
and adds the capture's launches at every replay (:func:`add`).  The
counters then read the same whether a step ran eagerly or as a replay.
A counter registered after a reading (its module first imported in
between) counts as 0 in that reading.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

# (wrapper, attribute) in registration order; a module imported later
# appends, so a reading taken earlier covers a prefix of the registry
COUNTED: List[Tuple[Callable, str]] = []


def counted(fn: Callable, *attrs: str) -> Callable:
    """Register ``fn``'s counter attributes, each set to 0."""
    for attr in attrs:
        setattr(fn, attr, 0)
        COUNTED.append((fn, attr))
    return fn


def read() -> Tuple[int, ...]:
    """Every registered counter's value."""
    return tuple(getattr(fn, attr) for fn, attr in COUNTED)


def _padded(values: Sequence[int]) -> Tuple[int, ...]:
    """``values``, read when the registry was shorter, with 0 for each
    counter registered since."""
    return tuple(values) + (0,) * (len(COUNTED) - len(values))


def write(values: Sequence[int]) -> None:
    """Set the counters to ``values`` (a :func:`read`; counters registered
    since it was taken are set to 0)."""
    for (fn, attr), v in zip(COUNTED, _padded(values)):
        setattr(fn, attr, v)


def since(before: Sequence[int]) -> Tuple[int, ...]:
    """Each counter's launches since ``before`` was read (all of a counter's
    launches where it was registered after the reading)."""
    return tuple(now - was for now, was in zip(read(), _padded(before)))


def add(launches: Sequence[int]) -> None:
    """Add ``launches`` (a :func:`since`; counters registered since it was
    taken add nothing) to the counters."""
    for (fn, attr), n in zip(COUNTED, launches):
        if n:
            setattr(fn, attr, getattr(fn, attr) + n)
