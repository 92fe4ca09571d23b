"""Admission scheduling for the continuous-batching engine
(``repro.serving.scheduler``, single device).

The scheduler owns request lifecycle: a waiting queue, a fixed pool of
``max_slots`` decode slots and the KV cache's reservations.  A request is
admissible when a slot is free and the cache can reserve its worst-case
block footprint.  *Which* admissible request goes next is an admission
policy from a registry keyed by ``ServeConfig.sched_policy``:

* ``fcfs`` — strict arrival order; a head that does not fit blocks the queue;
* ``sjf`` — smallest worst-case footprint first among arrived requests that fit;
* ``prefill_first`` — first fit in arrival order;
* ``priority_strict`` / ``edf`` / ``cache_aware`` — the SLO-aware policies
  (:mod:`repro_torch.serving.slo.policies`, registered by the import at the
  bottom of this module).

**Preemption** (``ServeConfig.slo``): when a more urgent arrival cannot be
admitted, :meth:`Scheduler.maybe_preempt` evicts a running lower-priority
victim: it commits the victim's confirmed context, swaps its owned KV blocks
to the host pool of :class:`~repro_torch.serving.slo.swap.SwapManager` and
requeues it in arrival order as ``PREEMPTED``.  Re-admission goes through
the same policy; ``_fits`` asks ``kv_cache.can_restore``, and admission
restores the blocks (host upload, or re-binding still-published prefix
blocks) so generation resumes at the exact token.  **Shedding**
(``SLOConfig.shed``): :meth:`Scheduler.shed_unmeetable` finishes a waiting
request as ``SHED`` once its deadline is provably unmeetable at the
measured decode rate.
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

from repro_torch.configs.base import SLOConfig
from repro_torch.serving.request import Request, RequestState, Status

_POLICIES: Dict[str, "AdmissionPolicy"] = {}


def register_policy(cls: Type) -> Type:
    name = getattr(cls, "name", None)
    if not name or not isinstance(name, str):
        raise ValueError(f"policy class {cls!r} needs a string `name` attribute")
    _POLICIES[name] = cls()
    return cls


def get_policy(name: str) -> "AdmissionPolicy":
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown admission policy {name!r}; registered policies: "
            f"{', '.join(available_policies())}") from None


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_POLICIES))


class AdmissionPolicy:
    """Picks the index into ``waiting`` (arrival order) to admit next, or
    None to admit nothing now.  ``sched`` is the calling
    :class:`Scheduler`, for policies that read engine state
    (``cache_aware``'s warm-prefix probe); every policy accepts
    ``sched=None``."""

    name = "abstract"

    def pick(self, waiting: Sequence[RequestState], clock_ms: float,
             fits: Callable[[RequestState], bool],
             sched: Optional["Scheduler"] = None) -> Optional[int]:
        raise NotImplementedError


@register_policy
class FCFSPolicy(AdmissionPolicy):
    name = "fcfs"

    def pick(self, waiting, clock_ms, fits, sched=None):
        if not waiting:
            return None
        head = waiting[0]
        if head.request.arrival_ms > clock_ms or not fits(head):
            return None
        return 0


@register_policy
class SJFPolicy(AdmissionPolicy):
    name = "sjf"

    def pick(self, waiting, clock_ms, fits, sched=None):
        best: Optional[int] = None
        for i, st in enumerate(waiting):
            r = st.request
            if r.arrival_ms > clock_ms or not fits(st):
                continue
            if best is None or ((r.total_len, r.arrival_ms, r.uid)
                                < (waiting[best].request.total_len,
                                   waiting[best].request.arrival_ms,
                                   waiting[best].request.uid)):
                best = i
        return best


@register_policy
class PrefillFirstPolicy(AdmissionPolicy):
    name = "prefill_first"

    def pick(self, waiting, clock_ms, fits, sched=None):
        for i, st in enumerate(waiting):
            if st.request.arrival_ms <= clock_ms and fits(st):
                return i
        return None


class Scheduler:
    def __init__(self, max_slots: int, max_len: int, kv_cache=None,
                 policy: str = "fcfs", slo: Optional[SLOConfig] = None, obs=None):
        self.max_slots = max_slots
        self.max_len = max_len
        self.kv_cache = kv_cache
        self.policy = get_policy(policy)
        self.slo = slo
        if obs is None:
            from repro_torch.obs import Observability

            obs = Observability()
        self.obs = obs
        self.swap = None
        if slo is not None and slo.preemption and kv_cache is not None:
            from repro_torch.serving.slo.swap import SwapManager

            self.swap = SwapManager(kv_cache, host_blocks=slo.host_blocks,
                                    metrics=obs.metrics)
        self.waiting: List[RequestState] = []
        self.running: Dict[int, RequestState] = {}     # slot -> state
        self.free_slots: List[int] = list(range(max_slots - 1, -1, -1))
        self._admit_seq = 0
        # measured decode ms a token (an EMA over finished requests), the
        # service rate shedding reasons with; None until the first finish
        # measures it, so shedding never acts on a guess
        self._decode_ms_ema: Optional[float] = None

    @property
    def preemptions(self) -> int:
        """Swap-out count."""
        return int(self.obs.metrics.get("sched_preemptions_total"))

    @property
    def restore_tokens(self) -> int:
        """Context resumed from swapped or re-bound KV."""
        return int(self.obs.metrics.get("sched_restore_tokens_total"))

    @property
    def recompute_tokens(self) -> int:
        """Context prefilled again after a restore hole."""
        return int(self.obs.metrics.get("sched_recompute_tokens_total"))

    def add(self, request: Request) -> RequestState:
        if request.total_len > self.max_len:
            raise ValueError(
                f"request {request.uid}: prompt_len + max_new_tokens = "
                f"{request.total_len} exceeds serve max_len {self.max_len}")
        if self.kv_cache is not None:
            need = self.kv_cache.blocks_needed(request.total_len)
            if need > self.kv_cache.max_request_blocks:
                raise ValueError(
                    f"request {request.uid}: needs {need} KV blocks but a "
                    f"request can hold at most {self.kv_cache.max_request_blocks}")
        st = RequestState(request)
        self.waiting.append(st)
        self.obs.metrics.counter("sched_requests_total").inc()
        self.obs.request_arrived(request.uid, prompt_len=request.prompt_len,
                                 max_new_tokens=request.max_new_tokens)
        return st

    def _slot_index(self, st: RequestState) -> Optional[int]:
        """Where in ``free_slots`` the request's admission lands, or None
        when no free slot's pool has room for its worst-case footprint.
        The cache chooses (``pick_slot``: the LIFO slot of one pool, the
        LIFO-first slot whose shard fits of a sharded one); a ``PREEMPTED``
        request takes the LIFO slot if its swap record can come back."""
        cache = self.kv_cache
        if cache is None:
            return len(self.free_slots) - 1
        if st.status is Status.PREEMPTED:
            return len(self.free_slots) - 1 if cache.can_restore(st.swap_record) else None
        return cache.pick_slot(self.free_slots, st.request.total_len, prompt=st.request.prompt)

    def _fits(self, st: RequestState) -> bool:
        return self._slot_index(st) is not None

    def admit(self, clock_ms: float) -> List[RequestState]:
        """Admit arrived requests under the policy while slots (and
        unreserved KV footprint) last; the slot is ``_slot_index``'s.  A
        ``PREEMPTED`` pick is restored instead of freshly allocated: its
        recorded blocks come back and prefill resumes at the restored
        position, or decode does when the whole context came back."""
        admitted = []
        while self.free_slots:
            idx = self.policy.pick(self.waiting, clock_ms, self._fits, sched=self)
            if idx is None:
                break
            st = self.waiting.pop(idx)
            slot = self.free_slots.pop(self._slot_index(st))
            st.cached_tokens = 0
            if st.status is Status.PREEMPTED:
                # (a swap record exists only with a cache: see __init__)
                rec, st.swap_record = st.swap_record, None
                resume = self.kv_cache.restore_slot(slot, rec, self.swap)
                self.swap.release(rec)
                m = self.obs.metrics
                m.counter("sched_restore_tokens_total").inc(resume)
                m.counter("sched_recompute_tokens_total").inc(rec.context_len - resume)
                self.obs.tracer.instant("restore", uid=st.request.uid, restored=resume,
                                        recomputed=rec.context_len - resume)
                st.prefill_pos = resume
                st.status = (Status.DECODE if resume >= st.prefill_target
                             else Status.PREFILL)
            else:
                if self.kv_cache is not None:
                    # prefix caching binds the matched prompt-prefix blocks,
                    # so prefill resumes at the first uncached token
                    st.cached_tokens = self.kv_cache.allocate_slot(
                        slot, st.request.total_len, prompt=st.request.prompt)
                st.status = Status.PREFILL
                st.prefill_pos = st.cached_tokens
            st.slot = slot
            st.admitted_ms = clock_ms
            st.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.running[slot] = st
            self.obs.metrics.histogram("request_queue_ms").observe(
                max(clock_ms - st.request.arrival_ms, 0.0))
            self.obs.request_phase(st.request.uid,
                                   "decode" if st.status is Status.DECODE else "prefill",
                                   slot=slot)
            admitted.append(st)
        return admitted

    def finish(self, st: RequestState, clock_ms: float) -> None:
        if self.running.get(st.slot) is not st:
            raise RuntimeError(f"request {st.request.uid} is not running in slot {st.slot}")
        del self.running[st.slot]
        self.free_slots.append(st.slot)
        if self.kv_cache is not None:
            # confirm the written context (prompt + every fed-back sample)
            # so the slot's full blocks are published before they are
            # released: they land on the cached-free list, matchable
            self.kv_cache.commit(st.slot, st.confirmed_tokens)
            self.kv_cache.free_slot(st.slot)
        st.status = Status.FINISHED
        st.finished_ms = clock_ms
        if st.first_token_ms is not None and len(st.generated) > 1:
            per_tok = (clock_ms - st.first_token_ms) / (len(st.generated) - 1)
            if per_tok > 0:
                ema = self._decode_ms_ema
                self._decode_ms_ema = per_tok if ema is None else 0.8 * ema + 0.2 * per_tok
        m = self.obs.metrics
        m.counter("sched_finished_total").inc()
        m.counter("generated_tokens_total").inc(len(st.generated))
        m.counter("prefix_cached_tokens_total").inc(st.cached_tokens)
        m.counter("prefix_prompt_tokens_total").inc(st.request.prompt_len)
        m.histogram("request_latency_ms").observe(st.latency_ms())
        self.obs.request_finished(st.request.uid)

    # -- preemption -----------------------------------------------------------

    def preempt(self, st: RequestState, clock_ms: float) -> None:
        """Evict a running request for a more urgent one: commit its
        confirmed context (published full blocks stay matchable), swap its
        owned KV blocks to the host pool, free the slot, and put it back in
        the waiting queue at its *arrival-order* place as ``PREEMPTED``."""
        if self.swap is None:
            raise RuntimeError("preemption needs ServeConfig.slo with preemption on")
        slot = st.slot
        if self.running.get(slot) is not st:
            raise RuntimeError(f"request {st.request.uid} is not running in slot {slot}")
        del self.running[slot]
        self.free_slots.append(slot)
        ctx = st.context_len
        self.kv_cache.commit(slot, st.confirmed_tokens[:ctx])
        st.swap_record = self.kv_cache.swap_out(
            slot, self.swap, uid=st.request.uid, total_len=st.request.total_len,
            context_len=ctx)
        st.slot = -1
        st.status = Status.PREEMPTED
        st.preemptions += 1
        self.obs.metrics.counter("sched_preemptions_total").inc()
        self.obs.tracer.instant("preempt", uid=st.request.uid, slot=slot, context_len=ctx)
        self.obs.request_phase(st.request.uid, "preempted")
        keys = [(w.request.arrival_ms, w.request.uid) for w in self.waiting]
        self.waiting.insert(
            bisect.bisect_left(keys, (st.request.arrival_ms, st.request.uid)), st)

    def maybe_preempt(self, clock_ms: float) -> int:
        """The preemption decision, once per engine step before admission.
        The candidate is the admission policy's own next pick under a
        permissive fit, so preemption enforces the policy's order and adds
        none of its own (``cache_aware`` thrashes all the same: its pick for
        the freed slot is the warm victim itself, as in the reference).
        While the candidate is in the preempting band
        (``slo.preempt_threshold``) and cannot be admitted, evict the
        strictly-lower-priority victim with the lowest class, then the most
        remaining work, then the latest admission.  No victim, a victim at its preemption cap, or a full
        host pool: stop, and the candidate waits.  Returns the evictions."""
        if self.swap is None:
            return 0
        evicted = 0
        while self.waiting:
            idx = self.policy.pick(self.waiting, clock_ms, lambda st: True, sched=self)
            if idx is None:
                break
            cand = self.waiting[idx]
            if int(cand.request.priority) > self.slo.preempt_threshold:
                break            # urgent enough to jump the queue, not to evict
            if self.free_slots and self._fits(cand):
                break                                   # admit() will take it
            victims = [st for st in self.running.values()
                       if int(st.request.priority) > int(cand.request.priority)
                       and st.preemptions < self.slo.max_preemptions]
            if not victims:
                break
            victim = max(victims, key=lambda s: (int(s.request.priority),
                                                 s.request.total_len - s.context_len,
                                                 s.admit_seq))
            if not self.swap.can_store(self.kv_cache.swap_footprint(victim.slot)):
                break
            self.preempt(victim, clock_ms)
            evicted += 1
        return evicted

    # -- deadline shedding ------------------------------------------------------

    def shed_unmeetable(self, clock_ms: float) -> List[RequestState]:
        """Finish as ``SHED`` every arrived waiting request whose effective
        deadline is provably unmeetable: even admitted now, prefilled at
        one chunk a step and decoding its whole budget at the measured
        ms/token, it would finish late.  Needs ``slo.shed`` and a measured
        rate (none before the first finish); requests without a deadline
        and ``PREEMPTED`` ones (their swapped KV is sunk work) are never
        shed.  Counted in ``requests_shed_total``."""
        if self.slo is None or not self.slo.shed or self._decode_ms_ema is None:
            return []
        ms_tok = self._decode_ms_ema
        chunk = self.kv_cache.serve.prefill_chunk if self.kv_cache is not None else 1
        shed: List[RequestState] = []
        keep: List[RequestState] = []
        for st in self.waiting:
            r = st.request
            d = r.effective_deadline_ms
            if d is None or st.status is Status.PREEMPTED or r.arrival_ms > clock_ms:
                keep.append(st)
                continue
            steps = -(-r.prompt_len // chunk) + r.max_new_tokens
            if clock_ms + ms_tok * steps > d:
                st.status = Status.SHED
                st.finished_ms = clock_ms
                self.obs.metrics.counter("requests_shed_total").inc()
                self.obs.tracer.instant("shed", uid=r.uid, deadline_ms=d,
                                        needed_ms=ms_tok * steps)
                self.obs.request_finished(r.uid)
                shed.append(st)
            else:
                keep.append(st)
        self.waiting = keep
        return shed

    # -- queries ------------------------------------------------------------

    @property
    def prefilling(self) -> Optional[RequestState]:
        """The earliest-admitted PREFILL request: the one that makes
        prefill progress this step."""
        cands = [st for st in self.running.values() if st.status is Status.PREFILL]
        return min(cands, key=lambda s: s.admit_seq) if cands else None

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def next_arrival_ms(self) -> Optional[float]:
        if not self.waiting:
            return None
        return min(st.request.arrival_ms for st in self.waiting)

    def check_conservation(self) -> None:
        """Every slot exactly free or running; the cache accounts for every
        block and reservation once; with preemption on, the host pool
        conserves too: every allocated host block belongs to exactly one
        live swap record, and every record to exactly one PREEMPTED waiting
        request, so a swapped block counts on the host side only."""
        if (len(self.free_slots) + len(self.running) != self.max_slots
                or not set(self.free_slots).isdisjoint(self.running.keys())):
            raise AssertionError("scheduler: slots are not exactly free or running")
        if self.kv_cache is not None:
            self.kv_cache.check_conservation()
        for st in self.waiting:
            uid = st.request.uid
            if st.status is Status.PREEMPTED:
                if (self.swap is None or st.swap_record is None
                        or self.swap.records.get(uid) is not st.swap_record):
                    raise AssertionError(f"scheduler: preempted request {uid} has no live "
                                         f"swap record")
            elif st.status is not Status.QUEUED or st.swap_record is not None:
                raise AssertionError(f"scheduler: waiting request {uid} is {st.status}"
                                     f"{' with a swap record' if st.swap_record else ''}")
        if self.swap is not None:
            self.swap.check_conservation()
            preempted = {st.request.uid for st in self.waiting
                         if st.status is Status.PREEMPTED}
            if preempted != set(self.swap.records):
                raise AssertionError(f"scheduler: preempted {sorted(preempted)} != swap "
                                     f"records {sorted(self.swap.records)}")
        for st in self.running.values():
            if st.swap_record is not None:
                raise AssertionError(f"scheduler: running request {st.request.uid} holds "
                                     f"a swap record")


# Registered last so the registry (and ``ServeConfig.sched_policy``
# validation) always holds the SLO-aware policies; the module imports
# ``register_policy`` back from here, which is safe because everything it
# needs is defined above.
from repro_torch.serving.slo import policies as _slo_policies  # noqa: E402,F401
