"""The port's SLO scheduling (``repro_torch.serving.slo``) against the JAX
reference, on the CPU: a mirror of ``tests/test_slo_sched.py`` that feeds
the same inputs to both packages, plus the swap cases of
``tests/test_kv_quant.py`` (int8 and fp8), preemption under speculative
decoding, and deadline shedding under a driven clock.

Every comparison is exact: policy picks, swap records, allocator and
block-table state, greedy tokens, counters and shed uids are integers or
token ids; pool contents after a swap round trip are compared bit for bit
(bf16/f32 values, int8/fp8 codes and f32 scale bits); latencies and
deadlines come from the same float arithmetic on the same inputs.  Engine
runs are driven by a fixed virtual clock (10 ms a step), so which request
is mid-decode when an urgent one arrives never depends on the host's speed.
"""
from contextlib import ExitStack
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import SLOConfig as JSLOConfig
from repro.configs.base import SpecConfig as JSpecConfig
from repro.models.registry import get_family
from repro.nn import init as jinit
from repro.quant import get_kv_quant as jget_kv_quant
from repro.quant import quant_write_kv as jquant_write_kv
from repro.quant.kv_cache import QuantizedPagedKVCache as JQPagedCache
from repro.serving import request as jreq
from repro.serving import trace as jtrace
from repro.serving.continuous import ContinuousEngine as JEngine
from repro.serving.kv_cache import PagedKVCache as JPagedCache
from repro.serving.prefix_cache import PrefixCachingKVCache as JPrefixCache
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import get_policy as jget_policy
from repro.serving.slo.swap import SwapManager as JSwapManager
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.configs.base import SLOConfig as TSLOConfig
from repro_torch.configs.base import SpecConfig as TSpecConfig
from repro_torch.kernels.decode_attention import ops as tops
from repro_torch.nn import from_jax_params
from repro_torch.quant.kv_cache import QuantizedPagedKVCache as TQPagedCache
from repro_torch.serving import request as treq
from repro_torch.serving import trace as ttrace
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from repro_torch.serving.kv_cache import PagedKVCache as TPagedCache
from repro_torch.serving.prefix_cache import PrefixCachingKVCache as TPrefixCache
from repro_torch.serving.scheduler import Scheduler as TScheduler
from repro_torch.serving.scheduler import get_policy as tget_policy
from repro_torch.serving.slo.swap import SwapManager as TSwapManager
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(name="t", family="decoder_lm", num_layers=1, d_model=32, num_heads=2,
             num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32")
TINY = dict(name="t", family="decoder_lm", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=128, max_seq_len=128, dtype="float32")


def _caches(kind, **kw):
    """The same cache built by both packages: (reference, port)."""
    serve = dict(kw)
    jcfg, tcfg = JModelConfig(**SMALL), TModelConfig(**SMALL)
    classes = {"paged": (JPagedCache, TPagedCache), "prefix": (JPrefixCache, TPrefixCache),
               "int8": (JQPagedCache, TQPagedCache), "fp8": (JQPagedCache, TQPagedCache)}
    if kind == "prefix":
        serve["prefix_cache"] = True
    if kind in ("int8", "fp8"):
        serve["kv_quant"] = kind
    jc, tc = classes[kind]
    return jc(jcfg, JServeConfig(**serve)), tc(tcfg, TServeConfig(**serve), device="cpu")


def _paged(max_slots=2, bs=4, num_blocks=8, max_len=32):
    return _caches("paged", max_slots=max_slots, kv_block_size=bs, max_len=max_len,
                   num_blocks=num_blocks)


def _prefix(max_slots=4, bs=4, num_blocks=16, max_len=64):
    return _caches("prefix", max_slots=max_slots, kv_block_size=bs, max_len=max_len,
                   num_blocks=num_blocks)


def _host_state(c):
    """A cache's whole host state, comparable across the two packages."""
    a = c.allocator
    out = dict(table=c.block_table.tolist(), blocks=c._slot_blocks,
               reserved=c._slot_reserved, total=c.reserved_total, free=list(a._free))
    if hasattr(c, "index"):
        out.update(bound=c._slot_bound, chain=c._slot_chain, cached=list(a._cached),
                   ref=a._ref, owner=a._owner, index=c.index._block_of, stats=c.stats)
    return out


def _rec(rec):
    return (rec.uid, rec.total_len, rec.context_len, rec.num_blocks, rec.skip,
            list(rec.hashes), dict(rec.host_of))


def _states(mod, specs):
    """RequestStates of ``mod`` from (uid, arrival, priority, deadline)."""
    return [mod.RequestState(mod.Request(uid=uid, prompt=np.arange(4, dtype=np.int32),
                                         max_new_tokens=4, arrival_ms=arrival,
                                         priority=pri, deadline_ms=deadline))
            for uid, arrival, pri, deadline in specs]


def _picks(name, specs, fits_list, clock=10.0):
    """The policy's pick in each package for every fit predicate."""
    out = []
    for mod, get in ((jreq, jget_policy), (treq, tget_policy)):
        waiting = _states(mod, specs)
        out.append([get(name).pick(waiting, clock, f) for f in fits_list])
    return out


# ---------------------------------------------------------------------------
# Request: priority coercion, effective deadline
# ---------------------------------------------------------------------------

def test_priority_coercion_and_effective_deadline():
    """String and int priorities coerce to the same class in both packages,
    the same bad inputs raise, and the effective deadline (explicit, or
    arrival + budget at the rate SLO) is the same float."""
    p = np.arange(4, dtype=np.int32)
    for mod in (jreq, treq):
        assert mod.Request(uid=0, prompt=p, max_new_tokens=4,
                           priority="high").priority is mod.Priority.HIGH
        assert mod.Request(uid=1, prompt=p, max_new_tokens=4,
                           priority=2).priority is mod.Priority.LOW
        with pytest.raises(ValueError):
            mod.Request(uid=2, prompt=p, max_new_tokens=4, priority="urgent")
        with pytest.raises(ValueError):
            mod.Request(uid=2, prompt=p, max_new_tokens=4, slo_tokens_per_s=0.0)
    for kw in (dict(deadline_ms=500.0, slo_tokens_per_s=1000.0), dict(slo_tokens_per_s=1000.0),
               dict(slo_tokens_per_s=7.0), {}):
        got = [mod.Request(uid=3, prompt=p, max_new_tokens=10, arrival_ms=100.0,
                           **kw).effective_deadline_ms for mod in (jreq, treq)]
        assert got[0] == got[1]
    assert treq.Request(uid=4, prompt=p, max_new_tokens=10, arrival_ms=100.0,
                        slo_tokens_per_s=1000.0).effective_deadline_ms == pytest.approx(110.0)
    assert [s.value for s in treq.Status] == [s.value for s in jreq.Status]
    st = treq.RequestState(treq.Request(uid=5, prompt=p, max_new_tokens=2, deadline_ms=40.0))
    assert st.slack_ms(10.0) == 30.0 and st.met_deadline() is None
    st.finished_ms = 50.0
    assert st.met_deadline() is False


# ---------------------------------------------------------------------------
# Policy ordering: the same picks as the reference's
# ---------------------------------------------------------------------------

def test_priority_strict_ordering():
    """Earliest HIGH first regardless of queue position, un-arrived requests
    invisible, a HIGH that does not fit falls through to the next class."""
    H, N, L = 0, 1, 2
    fits = [lambda st: True, lambda st: int(st.request.priority) != 0, lambda st: False]
    specs = [(0, 0.0, N, None), (1, 5.0, H, None), (2, 3.0, H, None), (3, 0.0, L, None)]
    j, t = _picks("priority_strict", specs, fits)
    assert j == t == [2, 0, None]
    specs[2] = (2, 100.0, H, None)                  # not yet arrived
    j, t = _picks("priority_strict", specs, fits)
    assert j == t == [1, 0, None]


def test_edf_ordering():
    """Earliest effective deadline first; deadline-less requests last
    (+inf), in arrival order among themselves."""
    fits = [lambda st: True, lambda st: st.request.uid != 2]
    j, t = _picks("edf", [(0, 0.0, 1, None), (1, 2.0, 1, 500.0), (2, 4.0, 1, 200.0)], fits)
    assert j == t == [2, 1]
    j, t = _picks("edf", [(0, 5.0, 1, None), (1, 1.0, 1, None), (2, 3.0, 1, 9999.0)], fits)
    assert j == t == [2, 1]


def test_slo_policies_degrade_to_arrival_order():
    """Uniform priorities, no deadlines, no cache: every SLO policy picks
    the earliest arrival, as fcfs does."""
    for name in ("priority_strict", "edf", "cache_aware"):
        j, t = _picks(name, [(0, 3.0, 1, None), (1, 1.0, 1, None), (2, 2.0, 1, None)],
                      [lambda st: True])
        assert j == t == [1], name


def test_cache_aware_prefers_warm_prompt():
    """A warm prompt (published prefix blocks) is admitted before an
    earlier cold one; both packages admit in the same order, bind the same
    blocks and end in the same host state."""
    warm_prompt = np.arange(14, dtype=np.int32)
    order, cached = [], []
    caches = _prefix()
    for cache, sched_cls, mod in zip(caches, (JScheduler, TScheduler), (jreq, treq)):
        bs = cache.block_size
        cache.allocate_slot(0, 20, prompt=warm_prompt)
        cache.ensure_capacity(0, warm_prompt.size)
        cache.commit(0, warm_prompt)
        cache.free_slot(0)
        assert cache.warm_prefix_tokens(warm_prompt) == (14 // bs) * bs
        assert cache.warm_prefix_tokens(warm_prompt + 1) == 0
        sched = sched_cls(max_slots=2, max_len=64, kv_cache=cache, policy="cache_aware")
        sched.add(mod.Request(uid=0, prompt=warm_prompt + 40, max_new_tokens=4))
        sched.add(mod.Request(uid=1, prompt=warm_prompt, max_new_tokens=4, arrival_ms=5.0))
        admitted = sched.admit(10.0)
        order.append([st.request.uid for st in admitted])
        cached.append([st.cached_tokens for st in admitted])
    assert order[0] == order[1] == [1, 0]
    assert cached[0] == cached[1] == [12, 0]
    assert _host_state(caches[1]) == _host_state(caches[0])


# ---------------------------------------------------------------------------
# SwapManager: round trip, misuse, capacity
# ---------------------------------------------------------------------------

def test_swap_roundtrip_preserves_pool_contents():
    """Device -> host -> device: the restored blocks hold exactly the values
    swapped out (f32, bit for bit), the record, the resume position, the
    new block ids and the allocator state equal the reference's."""
    import jax.numpy as jnp

    jc, tc = _paged()
    rng = np.random.default_rng(0)
    recs, swaps = [], []
    for c in (jc, tc):
        c.allocate_slot(0, total_len=12)
        c.ensure_capacity(0, 10)                    # 3 blocks, the last partial
    blocks = [int(b) for b in tc.block_table[0][:3]]
    k = rng.normal(size=(1, 3) + tuple(tc.k_pool.shape[2:])).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    jc.k_pool = jc.k_pool.at[:, blocks].set(k)
    jc.v_pool = jc.v_pool.at[:, blocks].set(v)
    tc.k_pool[:, blocks] = torch.from_numpy(k)
    tc.v_pool[:, blocks] = torch.from_numpy(v)
    for c, swap_cls in ((jc, JSwapManager), (tc, TSwapManager)):
        swap = swap_cls(c, host_blocks=4)
        rec = c.swap_out(0, swap, uid=7, total_len=12, context_len=10)
        assert c.allocator.free_count == c.num_blocks and c.reserved_total == 0
        assert swap.used_host_blocks == 3
        swap.check_conservation()
        c.check_conservation()
        assert c.can_restore(rec)
        assert c.restore_slot(1, rec, swap) == 10
        recs.append(_rec(rec))
        swaps.append(swap)
    assert recs[0] == recs[1] and recs[1][3:5] == (3, 0)
    assert _host_state(tc) == _host_state(jc)
    new = [int(b) for b in tc.block_table[1][:3]]
    np.testing.assert_array_equal(tc.k_pool[:, new].numpy(), k)
    np.testing.assert_array_equal(tc.v_pool[:, new].numpy(), v)
    np.testing.assert_array_equal(tc.k_pool.numpy(), np.asarray(jc.k_pool))
    np.testing.assert_array_equal(tc.v_pool.numpy(), np.asarray(jnp.asarray(jc.v_pool)))
    for c, swap, rec in ((jc, swaps[0], swaps[0].records[7]), (tc, swaps[1], swaps[1].records[7])):
        swap.release(rec)
        assert swap.used_host_blocks == 0
        c.free_slot(1)
        c.check_conservation()
        swap.check_conservation()
    assert swaps[1].stats == swaps[0].stats == {"swap_outs": 1, "swap_ins": 1,
                                                "swapped_blocks": 3, "restored_blocks": 3}


def test_swap_release_and_store_misuse_detected():
    """Releasing a stale record and storing a second live record for one
    uid raise RuntimeError in both packages."""
    for c, swap_cls in zip(_paged(), (JSwapManager, TSwapManager)):
        swap = swap_cls(c, host_blocks=4)
        c.allocate_slot(0, total_len=8)
        c.ensure_capacity(0, 8)
        rec = c.swap_out(0, swap, uid=1, total_len=8, context_len=8)
        swap.release(rec)
        with pytest.raises(RuntimeError):
            swap.release(rec)                       # stale record
        c.allocate_slot(0, total_len=8)
        c.ensure_capacity(0, 8)
        c.swap_out(0, swap, uid=2, total_len=8, context_len=8)
        c.allocate_slot(1, total_len=8)
        c.ensure_capacity(1, 8)
        with pytest.raises(RuntimeError):
            swap.store(c, uid=2, total_len=8, context_len=8,
                       blocks=[int(b) for b in c.block_table[1][:2]], skip=0, hashes=[])
        swap.check_conservation()


def test_swap_capacity_refusal():
    """A 2-block host pool takes one 2-block swap-out and then refuses."""
    got = []
    for c, swap_cls in zip(_paged(), (JSwapManager, TSwapManager)):
        swap = swap_cls(c, host_blocks=2)
        seen = [swap.can_store(2), swap.can_store(3)]
        c.allocate_slot(0, total_len=8)
        c.ensure_capacity(0, 8)
        seen.append(c.swap_footprint(0))
        c.swap_out(0, swap, uid=1, total_len=8, context_len=8)
        seen.append(swap.can_store(1))
        got.append(seen)
    assert got[0] == got[1] == [True, False, 2, False]


def test_prefix_swap_restores_full_blocks_by_rebind():
    """Published full blocks come back by re-bind without their host
    copies; only the partial tail uploads.  Records, counters and the
    whole host state (refcounts, owners, the index) equal the reference's;
    the uploaded tail's values come back bit for bit."""
    prompt = np.arange(10, dtype=np.int32)          # 2 full blocks + 2 tokens
    caches = _prefix()
    out = []
    tail = np.random.default_rng(1).normal(size=(1,) + tuple(caches[1].k_pool.shape[2:]))
    for c, swap_cls in zip(caches, (JSwapManager, TSwapManager)):
        c.allocate_slot(0, 16, prompt=prompt)
        c.ensure_capacity(0, prompt.size)
        c.commit(0, prompt)
        if isinstance(c, TPrefixCache):
            c.k_pool[:, c._slot_blocks[0][2]] = torch.from_numpy(tail).float()
        swap = swap_cls(c)
        rec = c.swap_out(0, swap, uid=3, total_len=16, context_len=10)
        resume = c.restore_slot(1, rec, swap)
        out.append((_rec(rec), resume, swap.stats, c.stats["bound_blocks"], _host_state(c)))
        if isinstance(c, TPrefixCache):
            np.testing.assert_array_equal(c.k_pool[:, c._slot_blocks[1][2]].numpy(),
                                          tail.astype(np.float32))
        swap.release(rec)
        c.free_slot(1)
        c.check_conservation()
        swap.check_conservation()
    assert out[0] == out[1]
    rec, resume, stats, bound, _ = out[1]
    assert rec[3] == 3 and len(rec[5]) == 2 and resume == 10
    assert stats["restored_blocks"] == 1 and bound >= 2


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_swap_manager_preserves_bytes(kind):
    """Direct swap_out -> clobber -> restore_slot over int8 and fp8 code
    pools: codes and scale rows (f32 bits) come back equal to those swapped
    out, into the blocks the reference restores into."""
    jc, tc = _caches(kind, max_slots=2, kv_block_size=4, max_len=32, num_blocks=8)
    rng = np.random.default_rng(2)
    codes = {n: rng.integers(-127, 128, tuple(tc.k_pool.shape), dtype=np.int64).astype(np.int8)
             for n in ("k", "v")}
    scales = {n: rng.uniform(0.5, 2.0, tuple(tc.k_scales.shape)).astype(np.float32)
              for n in ("k", "v")}
    for n in ("k", "v"):
        getattr(tc, f"{n}_pool").copy_(torch.from_numpy(codes[n]))
        getattr(tc, f"{n}_scales").copy_(torch.from_numpy(scales[n]))
        setattr(jc, f"{n}_pool", jax.numpy.asarray(codes[n]))
        setattr(jc, f"{n}_scales", jax.numpy.asarray(scales[n]))
    recs, was = [], None
    for c, swap_cls in ((jc, JSwapManager), (tc, TSwapManager)):
        c.allocate_slot(0, 8)
        c.ensure_capacity(0, 8)
        was = list(c._slot_blocks[0])
        swap = swap_cls(c, host_blocks=8)
        rec = c.swap_out(0, swap, uid=0, total_len=8, context_len=8)
        recs.append(_rec(rec))
        # clobber every device row, then restore into a fresh slot
        for n in ("k", "v"):
            if c is tc:
                getattr(tc, f"{n}_pool").zero_()
                getattr(tc, f"{n}_scales").zero_()
            else:
                setattr(jc, f"{n}_pool", jax.numpy.zeros_like(getattr(jc, f"{n}_pool")))
                setattr(jc, f"{n}_scales", jax.numpy.zeros_like(getattr(jc, f"{n}_scales")))
        assert c.restore_slot(1, rec, swap) == 8
        swap.release(rec)
        swap.check_conservation()
        c.check_conservation()
    assert recs[0] == recs[1]
    new = list(tc._slot_blocks[1])
    assert new == list(jc._slot_blocks[1])
    for n in ("k", "v"):
        got_c = getattr(tc, f"{n}_pool")[:, new].numpy()
        got_s = getattr(tc, f"{n}_scales")[:, new].numpy()
        np.testing.assert_array_equal(got_c, codes[n][:, was])
        np.testing.assert_array_equal(got_s.view(np.int32), scales[n][:, was].view(np.int32))
        np.testing.assert_array_equal(getattr(tc, f"{n}_pool").numpy(),
                                      np.asarray(getattr(jc, f"{n}_pool")))
        np.testing.assert_array_equal(getattr(tc, f"{n}_scales").numpy().view(np.int32),
                                      np.asarray(getattr(jc, f"{n}_scales")).view(np.int32))


# ---------------------------------------------------------------------------
# Engine level: preemption and restore are invisible in greedy tokens
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """{"dense" | "moe": (jcfg, tcfg, jparams, tparams)}: the reference's
    params carried into the port by ``from_jax_params``.  The MoE is topk
    dropless over 4 experts (the reference's own test routes by hash, which
    the port does not have yet)."""
    out = {}
    for name in ("dense", "moe"):
        jcfg, tcfg = JModelConfig(**TINY), TModelConfig(**TINY)
        if name == "moe":
            kw = dict(impl="dropless", num_experts=4, routing="topk", capacity_factor=None)
            jcfg, tcfg = jcfg.replace_moe(**kw), tcfg.replace_moe(**kw)
        jp = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
        out[name] = (jcfg, tcfg, jp, from_jax_params(jax.device_get(jp), tcfg, device="cpu"))
    return out


def _preempt_requests(mod):
    """Two long LOW decodes that fill both slots, then a HIGH arrival that
    can be admitted only by evicting one of them."""
    reqs = [mod.Request(uid=i, prompt=np.arange(6, dtype=np.int32) + 3 * i, max_new_tokens=20,
                        priority=mod.Priority.LOW) for i in range(2)]
    reqs.append(mod.Request(uid=2, prompt=np.arange(5, dtype=np.int32) + 50, max_new_tokens=4,
                            arrival_ms=75.0, priority=mod.Priority.HIGH))
    return reqs


def _plain(mod, reqs):
    """The same prompts and budgets, all at t = 0, no priority."""
    return [mod.Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
            for r in reqs]


def _drive(eng, requests, step_ms=10.0):
    """A fixed virtual clock instead of run()'s wall clock: ({uid: tokens},
    {uid: final status value})."""
    for r in requests:
        eng.scheduler.add(r)
    done, status = {}, {}
    clock = 0.0
    while eng.scheduler.has_work():
        nxt = eng.scheduler.next_arrival_ms()
        if not eng.scheduler.running and nxt is not None and nxt > clock:
            clock = nxt
        for st in eng.step(clock):
            done[st.request.uid] = list(st.generated)
            status[st.request.uid] = st.status.value
        clock += step_ms
    return done, status


def _counters(eng):
    s = eng.scheduler
    return dict(preemptions=s.preemptions, restore=s.restore_tokens,
                recompute=s.recompute_tokens, swap=s.swap.stats if s.swap else None,
                steps=eng.steps)


def _serve(mod, **kw):
    base = dict(max_slots=2, kv_block_size=4, prefill_chunk=8, max_len=32, num_blocks=16)
    base.update(kw)
    return (JServeConfig if mod is jreq else TServeConfig)(**base)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "dropless_topk"])
@pytest.mark.parametrize("prefix", [False, True], ids=["paged", "prefix"])
def test_preempt_restore_token_identity(models, moe, prefix):
    """A HIGH arrival preempts a LOW decode, whose KV swaps to the host and
    comes back (by upload, or by re-bind under the prefix cache): the
    port's greedy tokens equal its own run with 4 slots and nothing
    preempted, and the JAX engine's preempted run; preemptions, swapped and
    restored blocks, restore/recompute tokens and steps equal the
    reference's; every record is released; conservation holds after every
    step."""
    jcfg, tcfg, jp, tp = models["moe" if moe else "dense"]
    ref = TEngine(tcfg, tp, _serve(treq, max_slots=4, num_blocks=None), device="cpu",
                  check_invariants=True)
    want, _ = _drive(ref, _plain(treq, _preempt_requests(treq)))
    kw = dict(prefix_cache=prefix, sched_policy="priority_strict")
    jeng = JEngine(jcfg, jp, _serve(jreq, **kw, slo=JSLOConfig()), check_invariants=True)
    jgot, _ = _drive(jeng, _preempt_requests(jreq))
    teng = TEngine(tcfg, tp, _serve(treq, **kw, slo=TSLOConfig()), device="cpu",
                   check_invariants=True)
    got, _ = _drive(teng, _preempt_requests(treq))
    assert got == want == jgot
    assert _counters(teng) == _counters(jeng)
    s = teng.scheduler
    assert s.preemptions > 0 and s.swap.stats["swapped_blocks"] > 0
    assert s.restore_tokens + s.recompute_tokens > 0
    assert not s.swap.records
    assert _host_state(teng.cache) == _host_state(jeng.cache)
    s.check_conservation()


def test_preemption_respects_cap_and_host_pool(models):
    """``max_preemptions=0`` makes every request a non-victim, so the HIGH
    arrival waits (no preemption, every budget finished), as in the
    reference; and a 1-block host pool refuses the swap the same way."""
    jcfg, tcfg, jp, tp = models["dense"]
    for slo in (dict(max_preemptions=0), dict(host_blocks=1)):
        jeng = JEngine(jcfg, jp, _serve(jreq, sched_policy="priority_strict",
                                        slo=JSLOConfig(**slo)), check_invariants=True)
        teng = TEngine(tcfg, tp, _serve(treq, sched_policy="priority_strict",
                                        slo=TSLOConfig(**slo)), device="cpu",
                       check_invariants=True)
        jgot, _ = _drive(jeng, _preempt_requests(jreq))
        got, _ = _drive(teng, _preempt_requests(treq))
        assert got == jgot and sorted(got) == [0, 1, 2] and len(got[2]) == 4
        assert teng.scheduler.preemptions == 0 == jeng.scheduler.preemptions
        assert teng.steps == jeng.steps


def _replayed_quant_events(store: list):
    """Record, in order, every ``quant_write_kv`` the port makes (the code
    pool's address, x, write blocks, write offsets) and every swap copy
    (store: [(device block, host block)], load: [(host block, device
    block)])."""
    real_w, real_s, real_l = tops.quant_write_kv, TSwapManager.store, TSwapManager.load

    def write(codes, scales, x, wb, wo, *, policy):
        store.append(("w", codes.data_ptr(), x.float().clone(), wb.clone(), wo.clone()))
        return real_w(codes, scales, x, wb, wo, policy=policy)

    def swap_store(self, cache, *, blocks, **kw):
        rec = real_s(self, cache, blocks=blocks, **kw)
        store.append(("store", [(blocks[k], h) for k, h in rec.host_of.items()]))
        return rec

    def swap_load(self, cache, pairs):
        store.append(("load", list(pairs)))
        return real_l(self, cache, pairs)

    stack = ExitStack()
    stack.enter_context(mock.patch.object(tops, "quant_write_kv", write))
    stack.enter_context(mock.patch.object(TSwapManager, "store", swap_store))
    stack.enter_context(mock.patch.object(TSwapManager, "load", swap_load))
    return stack


def _assert_pools_replay_reference(cache, events, kv):
    """The port's code and scale pools after a preempting run, bit for bit,
    against the reference's ``quant_write_kv`` replaying the port's writes
    from zero pools, with every swap applied as a verbatim copy of a
    block's codes and scale rows: no block is re-quantized in flight."""
    import jax.numpy as jnp

    pol = jget_kv_quant(kv)
    layer_of, pools = {}, {}
    for name in ("k", "v"):
        codes, scales = getattr(cache, f"{name}_pool"), getattr(cache, f"{name}_scales")
        for layer in range(codes.shape[0]):
            layer_of[codes[layer].data_ptr()] = (name, layer)
            pools[name, layer] = (jnp.zeros(codes.shape[1:], jnp.int8),
                                  jnp.zeros(scales.shape[1:], jnp.float32))
    host = {}
    for ev in events:
        if ev[0] == "w":
            _, ptr, x, wb, wo = ev
            key = layer_of[ptr]
            pools[key] = jquant_write_kv(*pools[key], jnp.asarray(x.numpy()),
                                         jnp.asarray(wb.numpy()), jnp.asarray(wo.numpy()),
                                         policy=pol)
        elif ev[0] == "store":
            for dev, h in ev[1]:
                host[h] = {key: (c[dev], s[dev]) for key, (c, s) in pools.items()}
        else:
            for h, dev in ev[1]:
                for key, (c, s) in pools.items():
                    hc, hs = host[h][key]
                    pools[key] = (c.at[dev].set(hc), s.at[dev].set(hs))
    assert any(ev[0] == "load" for ev in events)
    for (name, layer), (codes, scales) in pools.items():
        got_c = getattr(cache, f"{name}_pool")[layer].numpy()
        got_s = getattr(cache, f"{name}_scales")[layer].numpy()
        np.testing.assert_array_equal(got_c.view(np.int8), np.asarray(codes).view(np.int8))
        np.testing.assert_array_equal(got_s.view(np.int32), np.asarray(scales).view(np.int32))


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_swap_restore_token_identical(models, kv):
    """Preempt and restore over int8 and fp8 pools (one slot, so the HIGH
    arrival must evict the LOW request mid-decode): the host pools carry
    codes and scales verbatim, so the resumed request's tokens equal an
    un-preempted run's and the JAX engine's, and the code and scale pools
    after the run equal the reference's write law replayed with the swaps
    as verbatim copies, bit for bit."""
    jcfg, tcfg, jp, tp = models["dense"]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 128, 12).astype(np.int32), rng.integers(1, 128, 8).astype(np.int32)]

    def reqs(mod):
        return [mod.Request(uid=0, prompt=prompts[0], max_new_tokens=10,
                            priority=mod.Priority.LOW),
                mod.Request(uid=1, prompt=prompts[1], max_new_tokens=4, arrival_ms=1.0,
                            priority=mod.Priority.HIGH)]

    kw = dict(max_slots=1, prefill_chunk=4, max_len=64, num_blocks=32, kv_quant=kv)
    solo, _ = _drive(TEngine(tcfg, tp, _serve(treq, **kw), device="cpu"), _plain(treq, reqs(treq))[:1])
    jeng = JEngine(jcfg, jp, _serve(jreq, **kw, slo=JSLOConfig()), check_invariants=True)
    jgot, _ = _drive(jeng, reqs(jreq))
    teng = TEngine(tcfg, tp, _serve(treq, **kw, slo=TSLOConfig()), device="cpu",
                   check_invariants=True)
    events = []
    with _replayed_quant_events(events):
        got, _ = _drive(teng, reqs(treq))
    assert teng.scheduler.preemptions >= 1
    assert got == jgot and got[0] == solo[0]
    assert _counters(teng) == _counters(jeng)
    _assert_pools_replay_reference(teng.cache, events, kv)


def test_preemption_under_speculation(models):
    """Preemption with ngram speculative decoding (the reference does not
    refuse the combination): period-3 prompts draft by construction, a
    HIGH arrival evicts a LOW request between verify steps, and the tokens
    equal a non-speculative un-preempted run's and the JAX engine's; the
    verify counts and preemptions equal the reference's."""
    jcfg, tcfg, jp, tp = models["dense"]
    rng = np.random.default_rng(4)
    prompts = [np.tile(rng.integers(0, 128, 3), 4)[:9 + i].astype(np.int32) for i in range(3)]

    def reqs(mod):
        out = [mod.Request(uid=i, prompt=prompts[i], max_new_tokens=14,
                           priority=mod.Priority.LOW) for i in range(2)]
        out.append(mod.Request(uid=2, prompt=prompts[2], max_new_tokens=5, arrival_ms=35.0,
                               priority=mod.Priority.HIGH))
        return out

    want, _ = _drive(TEngine(tcfg, tp, _serve(treq, max_slots=4, num_blocks=None),
                             device="cpu"), _plain(treq, reqs(treq)))
    kw = dict(sched_policy="priority_strict", max_len=40)
    jeng = JEngine(jcfg, jp, _serve(jreq, **kw, slo=JSLOConfig(),
                                    spec=JSpecConfig(drafter="ngram", gamma=3)),
                   check_invariants=True)
    jgot, _ = _drive(jeng, reqs(jreq))
    teng = TEngine(tcfg, tp, _serve(treq, **kw, slo=TSLOConfig(),
                                    spec=TSpecConfig(drafter="ngram", gamma=3)),
                   device="cpu", check_invariants=True)
    got, _ = _drive(teng, reqs(treq))
    assert got == want == jgot
    assert teng.scheduler.preemptions > 0
    assert teng.spec_stats == jeng.spec_stats and teng.spec_stats["verify_steps"] > 0
    assert _counters(teng) == _counters(jeng)
    assert not teng.scheduler.swap.records


# ---------------------------------------------------------------------------
# Deadline shedding under a driven clock
# ---------------------------------------------------------------------------

def test_shed_uids_match_reference(models):
    """``SLOConfig(shed=True)`` over a bursty priority trace with tight HIGH
    deadlines, one slot and a driven clock: the port sheds exactly the
    reference's uids, serves every other request its full budget with the
    reference's tokens, counts ``requests_shed_total`` alike, and no shed
    request holds a slot or a block (conservation after every step)."""
    jcfg, tcfg, jp, tp = models["dense"]
    args = dict(seed=2, qps=200.0, prompt_lens=(4, 10), gen_lens=(4, 8),
                deadline_budgets={0: (20.0, 5.0), 1: (400.0, 40.0)})
    kw = dict(max_slots=1, prefill_chunk=4, max_len=32, num_blocks=16)
    out = []
    for mod, trace, eng_cls, scfg, slo in (
            (jreq, jtrace, JEngine, _serve, JSLOConfig), (treq, ttrace, TEngine, _serve, TSLOConfig)):
        reqs = trace.synthetic_priority(12, 128, **args)
        extra = {} if mod is jreq else dict(device="cpu")
        params = jp if mod is jreq else tp
        cfg = jcfg if mod is jreq else tcfg
        eng = eng_cls(cfg, params, scfg(mod, **kw, slo=slo(preemption=False, shed=True)),
                      check_invariants=True, **extra)
        toks, status = _drive(eng, reqs)
        shed = sorted(u for u, s in status.items() if s == "shed")
        out.append((toks, shed, eng.obs.metrics.get("requests_shed_total"), eng.steps))
        for r in reqs:
            assert len(toks[r.uid]) == (0 if r.uid in shed else r.max_new_tokens)
    assert out[0] == out[1]
    assert len(out[1][1]) >= 1 and out[1][2] == len(out[1][1])


def test_shed_needs_measured_rate():
    """Nothing is shed before the first finish measures ms/token, and
    shedding is off by default."""
    sched = TScheduler(2, 64, None, slo=TSLOConfig(preemption=False, shed=True))
    assert sched._decode_ms_ema is None and sched.shed_unmeetable(1e9) == []
    assert TSLOConfig().shed is False


# ---------------------------------------------------------------------------
# synthetic_priority, trace files, per-class stats
# ---------------------------------------------------------------------------

def test_synthetic_priority_equals_reference():
    """The port's priority trace equals the reference's field by field
    (arrival, class, deadline, budget, prompt bytes), with and without
    tenant system prompts and per-class budgets; deterministic in the seed,
    LOW best-effort by default."""
    from repro.serving.request import Priority as JP

    cases = [dict(seed=3, qps=20.0), dict(seed=4, qps=20.0),
             dict(seed=0, qps=50.0, burst_qps=150.0, prompt_lens=(8, 24), gen_lens=(16, 32, 64),
                  gen_lens_by_class={JP.HIGH: (4, 8)}, class_weights=(0.125, 0.5, 0.375),
                  burst_len=8, system_prompt_len=16, num_tenants=2)]
    for kw in cases:
        a = jtrace.synthetic_priority(32, 21128, **kw)
        b = ttrace.synthetic_priority(32, 21128, **kw)
        assert len(a) == len(b) == 32
        for ra, rb in zip(a, b):
            assert (ra.uid, ra.arrival_ms, int(ra.priority), ra.deadline_ms, ra.max_new_tokens) \
                == (rb.uid, rb.arrival_ms, int(rb.priority), rb.deadline_ms, rb.max_new_tokens)
            assert ra.prompt.tobytes() == rb.prompt.tobytes()
    b = ttrace.synthetic_priority(32, 128, seed=3, qps=20.0)
    assert {r.priority for r in b} == set(treq.Priority)
    for r in b:
        assert (r.deadline_ms is None) == (r.priority is treq.Priority.LOW)
        assert r.deadline_ms is None or r.deadline_ms > r.arrival_ms


def test_priority_trace_roundtrip(tmp_path):
    """A trace saved by either package loads in the other to the same
    requests (priority and deadline kept)."""
    reqs = ttrace.synthetic_priority(16, 64, seed=1)
    path = str(tmp_path / "port.jsonl")
    ttrace.save_trace(path, reqs)
    jpath = str(tmp_path / "ref.jsonl")
    jtrace.save_trace(jpath, jtrace.synthetic_priority(16, 64, seed=1))
    assert open(path).read() == open(jpath).read()
    back = ttrace.load_trace(path, 64, seed=1)
    jback = jtrace.load_trace(path, 64, seed=1)
    for a, b in zip(jback, back):
        assert (a.uid, a.arrival_ms, int(a.priority), a.deadline_ms, a.max_new_tokens) == \
            (b.uid, b.arrival_ms, int(b.priority), b.deadline_ms, b.max_new_tokens)
        assert a.prompt.tobytes() == b.prompt.tobytes()
    by_arrival = {r.arrival_ms: r for r in back}
    for r in reqs:
        rb = by_arrival[r.arrival_ms]
        assert rb.priority is r.priority and rb.deadline_ms == r.deadline_ms
        assert rb.prompt_len == r.prompt_len


def test_slo_class_stats_shape():
    """The same finished states give the same per-class stats and summary
    line in both packages: empty for plain traffic, p50/p95 and goodput per
    class (best-effort LOW has no goodput) otherwise."""
    def states(mod, specs, finished_ms):
        out = []
        for uid, (pri, dl) in enumerate(specs):
            st = mod.RequestState(mod.Request(uid=uid, prompt=np.arange(4, dtype=np.int32),
                                              max_new_tokens=2, priority=pri, deadline_ms=dl))
            st.finished_ms = finished_ms
            out.append(st)
        return out

    plain = [(1, None)] * 3
    mixed = [(0, 40.0), (0, 200.0), (2, None)]
    assert ttrace.slo_class_stats(states(treq, plain, 50.0)) == {} == \
        jtrace.slo_class_stats(states(jreq, plain, 50.0))
    got = ttrace.slo_class_stats(states(treq, mixed, 100.0))
    assert got == jtrace.slo_class_stats(states(jreq, mixed, 100.0))
    assert got["high_n"] == 2.0 and got["low_n"] == 1.0
    assert got["high_goodput"] == 0.5 and got["goodput"] == 0.5 and "low_goodput" not in got
    assert all(isinstance(v, float) for v in got.values())
    got["preemptions"], got["swapped_blocks"], got["restore_tokens"] = 3.0, 5.0, 40.0
    assert ttrace.slo_class_line(got) == jtrace.slo_class_line(got)
    assert ttrace.slo_class_line(got).startswith("slo: high n=2")


def test_run_reports_per_class_stats(models):
    """``run()`` over a priority trace with preemption reports the SLO
    counters and per-class stats as floats, its tokens equal the JAX
    engine's run of the same trace (greedy: the wall clock moves only the
    schedule), and the stats' key set equals the reference's."""
    jcfg, tcfg, jp, tp = models["dense"]
    kw = dict(seed=0, qps=500.0, gen_lens=(4, 8), prompt_lens=(4, 12))
    serve = dict(max_len=64, num_blocks=32, sched_policy="priority_strict")
    jtoks, jstats = JEngine(jcfg, jp, _serve(jreq, **serve, slo=JSLOConfig()),
                            check_invariants=True).run(jtrace.synthetic_priority(10, 128, **kw))
    eng = TEngine(tcfg, tp, _serve(treq, **serve, slo=TSLOConfig()), device="cpu",
                  check_invariants=True)
    toks, stats = eng.run(ttrace.synthetic_priority(10, 128, **kw))
    assert toks == jtoks
    for key in ("preemptions", "restore_tokens", "recompute_tokens", "swapped_blocks",
                "restored_blocks", "goodput"):
        assert key in stats, key
    assert any(k.endswith("_p95_ms") for k in stats)
    assert all(isinstance(v, float) for v in stats.values())
    assert set(stats) == set(jstats)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 10 cell, on the CPU
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _VirtualClock:
    """A ``time`` stand-in whose ``perf_counter`` moves ``step_s`` a call:
    ``run()`` reads it once an engine step, so the schedule is a function of
    the trace alone."""

    def __init__(self, step_s):
        self.t, self.step_s = 0.0, step_s

    def perf_counter(self):
        self.t += self.step_s
        return self.t


def test_slo_sweep_schedule_matches_reference():
    """chip_smoke.py phase 10's cell (the reference benchmark's slo_sweep
    shapes: 4 slots, 28 blocks of 16, prefix cache, the 48-request priority
    trace at 2x overload of the capacity a saturated fcfs run measures)
    with a 1-layer model and each engine's clock advanced 12.5 ms a read:
    under priority_strict, edf and cache_aware the steps, preemptions,
    restored and recomputed tokens, swapped and uploaded blocks, per-class
    latencies and greedy tokens equal the reference's; priority_strict
    preempts and cuts HIGH's p95 below the port's fcfs run's, and
    cache_aware preempts more often for no HIGH gain (ROADMAP queue 3)."""
    from repro.serving import continuous as jcontinuous
    from repro.serving.request import Priority as JP
    from repro_torch.serving import continuous as tcontinuous

    cs = _chip_smoke()
    # the vocabulary moves no scheduling decision (prompt lengths, budgets,
    # arrivals and classes come from the trace's own draws; the tenant
    # prompts repeat at any vocabulary), so a small one keeps the steps cheap
    V = 512
    kw = dict(TINY, num_layers=1, d_model=32, num_heads=2, d_ff=64, vocab_size=V,
              max_seq_len=256)
    jcfg, tcfg = JModelConfig(**kw), TModelConfig(**kw)
    jp = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
    tp = from_jax_params(jax.device_get(jp), tcfg, device="cpu")

    def run(cont, eng_cls, serve_cls, slo_cls, cfg, params, reqs, name, **extra):
        slo = None if name == "fcfs" else slo_cls(preemption=True,
                                                  host_blocks=cs.SLO_HOST_BLOCKS)
        serve = serve_cls(**cs.SLO_SERVE, max_len=max(r.total_len for r in reqs),
                          sched_policy=name, slo=slo)
        eng = eng_cls(cfg, params, serve, check_invariants=True, **extra)
        with mock.patch.object(cont, "time", _VirtualClock(0.0125)):
            toks, stats = eng.run(reqs)
        stats = {k: v for k, v in stats.items()
                 if not k.startswith(("moe_", "compiled", "recompiles"))}
        return toks, stats, eng.steps

    port = (tcontinuous, TEngine, TServeConfig, TSLOConfig, tcfg, tp)
    # 2x overload against the capacity this clock gives, measured as
    # chip_smoke measures it: a saturated fcfs run of the calibration trace
    calib = cs.slo_trace(24, V, seed=1, qps=1e6)
    cstats = run(*port, calib, "fcfs", device="cpu")[1]
    qps = (4.0 / 3.0) * cstats["generated_tokens_per_s"] / np.mean(
        [r.max_new_tokens for r in calib])
    tkw = dict(cs.SLO_TRACE, gen_lens_by_class={JP.HIGH: (4, 8)})
    jreqs = jtrace.synthetic_priority(cs.SLO_REQUESTS, V, seed=cs.SLO_SEED, qps=qps,
                                      burst_qps=3 * qps, **tkw)
    treqs = cs.slo_trace(cs.SLO_REQUESTS, V, seed=cs.SLO_SEED, qps=qps, burst_qps=3 * qps)
    assert [int(r.priority) for r in treqs].count(0) == 6
    results = {"fcfs": run(*port, treqs, "fcfs", device="cpu")[1]}
    for name in ("priority_strict", "edf", "cache_aware"):
        got = run(*port, treqs, name, device="cpu")
        assert got == run(jcontinuous, JEngine, JServeConfig, JSLOConfig, jcfg, jp, jreqs,
                          name), name
        results[name] = got[1]
    strict, fcfs, warm = results["priority_strict"], results["fcfs"], results["cache_aware"]
    assert strict["preemptions"] > 0 and strict["restore_tokens"] > 0
    assert strict["high_p95_ms"] < fcfs["high_p95_ms"]
    assert warm["preemptions"] > strict["preemptions"]
    assert warm["high_p95_ms"] >= strict["high_p95_ms"]


def test_chip_smoke_slo_phase_runs_on_cpu(capsys):
    """chip_smoke's phase 10 rehearsed at smoke size on the CPU (generations
    cut to fit the smoke config's 64 learned positions), on a virtual clock
    of 5 ms a read so that its gates see the same schedule every time: the
    four policies over bf16 pools and fcfs and priority_strict over int8
    pools, with every gate; the swap round trips bit-equal over bf16, int8
    and fp8 pools; and the shedding run."""
    import types

    from repro_torch.configs import m6 as tm6
    from repro_torch.nn import init_params
    from repro_torch.serving import continuous as tcontinuous

    cs = _chip_smoke()
    cfg = tm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    params = init_params(cfg, seed=0, device="cpu")
    clock = _VirtualClock(0.005)
    tkw = dict(gen_lens=(8, 16, 24))
    with mock.patch.object(tcontinuous, "time", types.SimpleNamespace(
            perf_counter=clock.perf_counter)):
        report, _ = cs.slo_policy_runs(torch, cfg, params, "cpu", n_requests=24, n_calib=12,
                                       trace_kw=tkw)
        swap = cs.swap_roundtrips(torch, cfg, "cpu", reps=2)
        shed, _ = cs.shed_run(torch, cfg, params, report["trace"]["qps"], "cpu",
                              n_requests=16, trace_kw=tkw)
    for pools in ("bf16", "int8"):
        strict = report[f"priority_strict over {pools} pools"]
        assert strict["preemptions"] > 0 and strict["token_match"] == 1.0
        assert strict["high_p95_ratio_fcfs_over_strict"] > 1.0
    assert set(swap) == {"bf16", "int8", "fp8"}
    assert shed["requests_shed"] >= 1
    out = capsys.readouterr().out
    assert "slo: high n=" in out and "bit-equal" in out and "shedding:" in out
