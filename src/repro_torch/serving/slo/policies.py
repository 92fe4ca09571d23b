"""SLO-aware admission policies (``repro.serving.slo.policies``).

Registered into the registry of fcfs, sjf and prefill_first
(:mod:`repro_torch.serving.scheduler` imports this module at its bottom, so
every ``ServeConfig`` validation sees them).  With uniform priorities and no
deadlines all three reduce to arrival order.

* ``priority_strict`` — the most urgent class first (HIGH, NORMAL, LOW),
  arrival order within a class.  Pairs with preemption
  (``SLOConfig.preemption``): a HIGH arrival that cannot be admitted evicts
  a lower-class victim.  LOW can starve under sustained HIGH load.
* ``edf`` — earliest effective deadline first (``deadline_ms``, or derived
  from ``slo_tokens_per_s``); requests without one sort last (+inf), in
  arrival order.
* ``cache_aware`` — the most *warm* prompt tokens first: prefix-cache hits
  for a queued request, the whole recorded context for a preempted one.
  Ties (an all-cold queue too) fall back to arrival order.
"""
from __future__ import annotations

from repro_torch.serving.request import Status
from repro_torch.serving.scheduler import AdmissionPolicy, register_policy


def _best(waiting, clock_ms, fits, key):
    """Index of the arrived, fitting request with the smallest ``key``."""
    best = best_key = None
    for i, st in enumerate(waiting):
        if st.request.arrival_ms > clock_ms or not fits(st):
            continue
        k = key(st)
        if best is None or k < best_key:
            best, best_key = i, k
    return best


@register_policy
class PriorityStrictPolicy(AdmissionPolicy):
    name = "priority_strict"

    def pick(self, waiting, clock_ms, fits, sched=None):
        return _best(waiting, clock_ms, fits, lambda st: (
            int(st.request.priority), st.request.arrival_ms, st.request.uid))


@register_policy
class EDFPolicy(AdmissionPolicy):
    name = "edf"

    def pick(self, waiting, clock_ms, fits, sched=None):
        def key(st):
            d = st.request.effective_deadline_ms
            return (d if d is not None else float("inf"), st.request.arrival_ms,
                    st.request.uid)

        return _best(waiting, clock_ms, fits, key)


@register_policy
class CacheAwarePolicy(AdmissionPolicy):
    name = "cache_aware"

    def pick(self, waiting, clock_ms, fits, sched=None):
        cache = getattr(sched, "kv_cache", None)

        def key(st):
            warm = 0
            if cache is not None:
                # a preempted request's whole context is warm: its blocks
                # come back by re-bind or host upload
                warm = (st.swap_record.context_len if st.status is Status.PREEMPTED
                        else cache.warm_prefix_tokens(st.request.prompt))
            return (-warm, st.request.arrival_ms, st.request.uid)

        return _best(waiting, clock_ms, fits, key)
