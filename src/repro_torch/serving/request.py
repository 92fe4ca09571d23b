"""Request model for the continuous-batching engine (a copy of the parts
of ``repro.serving.request`` the port's engine uses).

A :class:`Request` is what a client submits: prompt tokens, a generation
budget and an arrival time (milliseconds on the serving clock — 0 for
"already here", or trace-driven Poisson arrivals), plus the priority and
deadline a trace file may carry (kept as data; the port has no SLO
scheduling).  A :class:`RequestState` is the scheduler's view of one
admitted request: its decode slot, how far prefill has progressed, and
what has been generated so far.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class Priority(enum.IntEnum):
    """Request priority class: lower value = more urgent."""

    HIGH = 0
    NORMAL = 1
    LOW = 2


class Status(enum.Enum):
    QUEUED = "queued"        # waiting for a slot / KV blocks
    PREFILL = "prefill"      # admitted; prompt chunks being ingested
    DECODE = "decode"        # one token per engine step
    FINISHED = "finished"    # evicted; slot and blocks returned


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (prompt_len,) int32 token ids
    max_new_tokens: int
    arrival_ms: float = 0.0
    eos_id: Optional[int] = None
    priority: Priority = Priority.NORMAL
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, dtype=np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.uid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.uid}: max_new_tokens must be >= 1")
        try:
            if isinstance(self.priority, str):
                self.priority = Priority[self.priority.upper()]
            elif not isinstance(self.priority, Priority):
                self.priority = Priority(self.priority)
        except KeyError:
            raise ValueError(
                f"request {self.uid}: unknown priority {self.priority!r}; "
                f"expected one of {[p.name.lower() for p in Priority]}") from None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def total_len(self) -> int:
        """Upper bound on context positions this request can occupy."""
        return self.prompt_len + self.max_new_tokens


@dataclasses.dataclass
class RequestState:
    request: Request
    slot: int = -1
    status: Status = Status.QUEUED
    prefill_pos: int = 0             # context tokens already ingested
    cached_tokens: int = 0           # prompt tokens served from the prefix cache
    generated: List[int] = dataclasses.field(default_factory=list)
    admitted_ms: float = 0.0
    admit_seq: int = -1              # admission order (the prefilling tiebreak)
    first_token_ms: Optional[float] = None
    finished_ms: Optional[float] = None

    @property
    def last_token(self) -> int:
        """Token to feed next in decode (the most recent sample)."""
        return self.generated[-1]

    @property
    def confirmed_tokens(self) -> np.ndarray:
        """The prompt plus every generated token that has been fed back
        (all samples except the newest): the token stream behind every KV
        position this request can have written."""
        if self.generated:
            return np.concatenate(
                [self.request.prompt, np.asarray(self.generated[:-1], np.int32)])
        return self.request.prompt

    @property
    def prefill_target(self) -> int:
        """Context length at which prefill completes and decode starts."""
        return int(self.confirmed_tokens.size)

    @property
    def context_len(self) -> int:
        """KV positions written so far."""
        if self.status is Status.PREFILL:
            return self.prefill_pos
        return self.request.prompt_len + max(len(self.generated) - 1, 0)

    def done(self) -> bool:
        if len(self.generated) >= self.request.max_new_tokens:
            return True
        eos = self.request.eos_id
        return eos is not None and len(self.generated) > 0 and self.generated[-1] == eos

    def latency_ms(self) -> Optional[float]:
        if self.finished_ms is None:
            return None
        return self.finished_ms - self.request.arrival_ms
