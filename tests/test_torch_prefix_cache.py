"""The port's prefix cache, and the engine over every KV cache variant,
against the JAX reference on the CPU.

Host state (chain hashes, block tables, refcounts, owners, the index, the
cached LRU list, stats) must match the reference's exactly after every
operation; the m6 smoke engine's greedy tokens must be identical to the
JAX engine's for {none, int8, fp8} x {prefix off, on}.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import m6 as jm6
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.models.registry import get_family
from repro.nn import init as jinit
from repro.quant.kv_cache import QuantizedPrefixCachingKVCache as JQPCache
from repro.serving import prefix_cache as jpc
from repro.serving import trace as jtrace
from repro.serving.continuous import ContinuousEngine as JEngine
from repro_torch.configs import m6 as tm6
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.nn import from_jax_params
from repro_torch.quant.kv_cache import QuantizedPrefixCachingKVCache as TQPCache
from repro_torch.serving import prefix_cache as tpc
from repro_torch.serving import trace as ttrace
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from repro_torch.serving.kv_cache import make_kv_cache


def test_chain_hash_bytes_equal():
    rng = np.random.default_rng(0)
    parent = tpc.ROOT_HASH
    for n in (1, 4, 16, 16, 33):
        toks = rng.integers(0, 21128, n).astype(np.int32)
        h = tpc.chain_hash(parent, toks)
        assert h == jpc.chain_hash(parent, toks) and len(h) == 16
        parent = h
    assert tpc.ROOT_HASH == jpc.ROOT_HASH


def _tiny_cfgs():
    kw = dict(name="t", family="decoder_lm", num_layers=1, d_model=32, num_heads=2,
              num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32")
    return JModelConfig(**kw), TModelConfig(**kw)


def _state(c):
    a = c.allocator
    return dict(table=c.block_table.tolist(), blocks=c._slot_blocks, bound=c._slot_bound,
                chain=c._slot_chain, reserved=c._slot_reserved, total=c.reserved_total,
                free=a._free, cached=list(a._cached), ref=a._ref, owner=a._owner,
                index=c.index._block_of, stats=c.stats, occupancy=c.occupancy())


def _apply(cache, name, *args, **kw):
    """(result, raised?) of one cache operation."""
    try:
        return getattr(cache, name)(*args, **kw), False
    except RuntimeError:
        return None, True


def _ops(seed, max_slots, bs, L, n=300):
    """A seeded sequence of admissions (three tenants sharing a two-block
    head), grow + commit, truncate and free, as the reference's
    operation-sequence checker draws them."""
    rng = np.random.default_rng(seed)
    common = (np.arange(2 * bs) * 7 % 61).astype(np.int32)
    templates = [np.concatenate([common, ((np.arange(L) * 13 + 100 * t) % 61)
                                 .astype(np.int32)])[:L] for t in range(3)]
    running = {}
    ops = []
    for _ in range(n):
        kind = int(rng.choice(4, p=[0.3, 0.4, 0.1, 0.2]))
        slot, amount = int(rng.integers(max_slots)), int(rng.integers(200))
        if kind == 0 and slot not in running:
            plen = min(bs + amount % (L // 2), L - 1)
            total = min(plen + 1 + amount % 16, L)
            prompt = templates[amount % 3][:plen]
            tail = ((np.arange(total - plen) * 29 + slot) % 61).astype(np.int32)
            ops.append(("admit", slot, total, prompt))
            running[slot] = dict(cur=0, total=total, stream=np.concatenate([prompt, tail]))
        elif kind == 1 and slot in running:
            m = running[slot]
            m["cur"] = min(m["cur"] + 1 + amount % (2 * bs), m["total"])
            ops.append(("grow", slot, m["cur"], m["stream"][:m["cur"]].copy()))
        elif kind == 2 and slot in running:
            m = running[slot]
            m["cur"] = amount % (m["cur"] + 1)
            m["stream"] = np.concatenate([m["stream"][:m["cur"]], (
                (np.arange(m["total"] - m["cur"]) * 31 + amount) % 61).astype(np.int32)])
            ops.append(("truncate", slot, m["cur"], None))
        elif kind == 3 and slot in running:
            ops.append(("free", slot, 0, None))
            del running[slot]
    return ops


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("seed,max_slots,bs,num_blocks", [
    (0, 3, 4, 10), (1, 2, 2, 6), (2, 4, 4, 12), (3, 3, 4, 8)])
def test_cache_state_matches_reference(seed, max_slots, bs, num_blocks, quant):
    jcfg, tcfg = _tiny_cfgs()
    kw = dict(max_slots=max_slots, kv_block_size=bs, max_len=num_blocks * bs,
              num_blocks=num_blocks, prefix_cache=True, kv_quant=quant)
    jc = (JQPCache if quant != "none" else jpc.PrefixCachingKVCache)(jcfg, JServeConfig(**kw))
    tc = make_kv_cache(tcfg, TServeConfig(**kw), device="cpu")
    assert type(tc).__name__ == type(jc).__name__
    cur = {}                      # admitted slot -> written length
    for kind, slot, n, tokens in _ops(seed, max_slots, bs, num_blocks * bs):
        if kind != "admit" and slot not in cur:
            continue                  # its admission was refused
        if kind == "admit":
            got = [_apply(c, "can_allocate_slot", n, prompt=tokens) for c in (jc, tc)]
            assert got[0] == got[1]
            got = [_apply(c, "allocate_slot", slot, n, prompt=tokens) for c in (jc, tc)]
            if not got[0][1]:
                cur[slot] = got[0][0]
        elif kind == "grow":
            got = [_apply(c, "ensure_capacity", slot, n) for c in (jc, tc)]
            if not got[0][1]:
                coords = [[_apply(c, "write_coords", slot, p) for p in range(cur[slot], n)]
                          for c in (jc, tc)]
                assert coords[0] == coords[1]
                got += [_apply(c, "commit", slot, tokens) for c in (jc, tc)]
                cur[slot] = n
        elif kind == "truncate":
            got = [_apply(c, "truncate_slot", slot, n) for c in (jc, tc)]
            cur[slot] = n
        else:
            got = [_apply(c, "free_slot", slot) for c in (jc, tc)]
            del cur[slot]
        assert got[0::2] == got[1::2], (kind, slot, n)
        assert _state(tc) == _state(jc), (kind, slot, n)
        tc.check_conservation()
    assert tc.stats["bound_blocks"] > 0 and tc.stats["published_blocks"] > 0


def test_cow_copies_scale_and_code_rows():
    """Truncating into a block another slot binds detaches onto a copy
    whose codes and scales equal the original's (and the reference's)."""
    jcfg, tcfg = _tiny_cfgs()
    kw = dict(max_slots=4, kv_block_size=4, max_len=64, num_blocks=16, prefix_cache=True,
              kv_quant="int8")
    jc, tc = JQPCache(jcfg, JServeConfig(**kw)), TQPCache(tcfg, TServeConfig(**kw),
                                                        device="cpu")
    prompt = np.arange(12, dtype=np.int32)
    for c in (jc, tc):
        c.allocate_slot(0, 16, prompt=prompt)
        c.ensure_capacity(0, 12)
        c.commit(0, prompt)
    old = tc._slot_blocks[0][1]
    tc.k_pool[:, old] = 5
    tc.v_pool[:, old] = -3
    tc.k_scales[:, old] = 7.0
    tc.v_scales[:, old] = 3.0
    for c in (jc, tc):
        assert c.allocate_slot(1, 16, prompt=prompt) == 8      # binds blocks 0..1
        c.truncate_slot(0, 5)                                   # COW edge: block 1
    new = tc._slot_blocks[0][1]
    assert new != old and tc.stats["cow_copies"] == 1
    assert (tc.k_pool[:, new] == 5).all() and (tc.v_pool[:, new] == -3).all()
    assert (tc.k_scales[:, new] == 7.0).all() and (tc.v_scales[:, new] == 3.0).all()
    assert _state(tc) == _state(jc)
    tc.check_conservation()


def test_multitenant_trace_matches_reference():
    jr = jtrace.synthetic_multitenant(12, 21128, seed=2, num_tenants=3, system_prompt_len=20)
    tr = ttrace.synthetic_multitenant(12, 21128, seed=2, num_tenants=3, system_prompt_len=20)
    for a, b in zip(jr, tr):
        assert (a.uid, a.max_new_tokens, a.arrival_ms) == (b.uid, b.max_new_tokens,
                                                           b.arrival_ms)
        assert a.prompt.tobytes() == b.prompt.tobytes()
    assert (tr[0].prompt[:20] == tr[3].prompt[:20]).all()
    with pytest.raises(ValueError):
        ttrace.synthetic_multitenant(2, 10, num_tenants=0)


def _m6_smoke():
    jcfg = jm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    tcfg = tm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    jp = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, from_jax_params(jax.device_get(jp), tcfg, device="cpu")


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
def test_m6_smoke_engine_parity_all_caches(quant, prefix):
    """Greedy tokens of the port's engine equal the JAX engine's over a
    multi-tenant trace (all arrivals at 0, so admission never depends on
    the wall clock) on 2 slots: later requests bind the blocks earlier ones
    published."""
    jcfg, tcfg, jp, tp = _m6_smoke()
    kw = dict(max_slots=2, kv_block_size=4, prefill_chunk=8, max_len=40,
              prefix_cache=prefix, kv_quant=quant)
    args = dict(seed=1, qps=1e9, num_tenants=2, system_prompt_len=12,
                suffix_lens=(1, 6), gen_lens=(3, 6))
    jreq = jtrace.synthetic_multitenant(6, jcfg.vocab_size, **args)
    treq = ttrace.synthetic_multitenant(6, tcfg.vocab_size, **args)
    jtoks, jstats = JEngine(jcfg, jp, JServeConfig(**kw), check_invariants=True).run(jreq)
    teng = TEngine(tcfg, tp, TServeConfig(**kw), device="cpu", check_invariants=True)
    ttoks, tstats = teng.run(treq)
    assert ttoks == jtoks
    assert tstats["steps"] == jstats["steps"]
    if prefix:
        assert tstats["cached_tokens"] == jstats["cached_tokens"] > 0
        assert tstats["cached_token_ratio"] == jstats["cached_token_ratio"]
    if quant != "none":
        assert teng.cache.k_pool.dtype == torch.int8 and teng.cache.k_scales.max() > 0
    teng.cache.check_conservation()


def test_logit_tap_sees_every_step():
    _, tcfg, _, tp = _m6_smoke()
    seen = []
    eng = TEngine(tcfg, tp, TServeConfig(max_slots=2, kv_block_size=4, prefill_chunk=8,
                                         max_len=32, kv_quant="int8"), device="cpu",
                  logit_tap=lambda lg, slots, pos, lens: seen.append((lg.shape, lens.copy())))
    eng.generate(np.arange(10, dtype=np.int32).reshape(2, 5), 3)
    assert len(seen) == eng.steps
    assert all(shape[1] >= tcfg.vocab_size and len(lens) == shape[0] for shape, lens in seen)


def test_cli_serves_quantized_prefix_cached_multitenant_on_cpu(capsys):
    from repro_torch.launch.serve import main

    stats = main(["--arch", "m6-base", "--smoke", "--engine", "continuous",
                  "--moe-impl", "dropless", "--capacity-factor", "none",
                  "--kv-quant", "int8", "--prefix-cache", "--trace-kind", "multitenant",
                  "--requests", "6", "--tenants", "2", "--system-prompt-len", "16",
                  "--max-slots", "2", "--kv-block", "4", "--max-len", "48",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefix cache:" in out and "synthetic multitenant" in out
    assert stats["cached_tokens"] > 0 and stats["moe_dropped_fraction"] == 0.0


def test_chip_smoke_kv_phase_runs_on_cpu(capsys):
    """chip_smoke's phase 7 (quantized serving, equal-byte capacity, prefix
    caching, the dense kernel on the engine's pools), rehearsed at smoke
    size on the CPU, where every kernel wrapper runs its plain version."""
    import importlib.util
    import os

    from repro_torch.nn import init_params

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    cfg = tm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    params = init_params(cfg, seed=0, device="cpu")
    reqs = ttrace.synthetic_trace(8, cfg.vocab_size, seed=0, prompt_lens=(8, 20),
                                  gen_lens=(4, 8))
    base, _, _, _ = chip_smoke.serve_once(torch, cfg, params, TServeConfig(max_len=64),
                                          reqs, "cpu")
    _, report, _ = chip_smoke.quant_serving_runs(torch, cfg, params, reqs, base, "cpu",
                                              max_len=64, probe_lens=(12, 16))
    assert report["int8"]["token_match_vs_bf16"] > 0.5
    assert report["kernels_vs_plain_int8"]["argmax_agree"] == report[
        "kernels_vs_plain_int8"]["rows"]
    cap = chip_smoke.capacity_runs(torch, cfg, params, "cpu")
    assert cap["peak_running_ratio"] >= 1.3
    pre = chip_smoke.prefix_runs(torch, cfg, params, "cpu", system_prompt_len=16, max_len=64)
    assert pre["int8 prefix on"]["cached_token_ratio"] > 0
    dense = chip_smoke.dense_on_engine_pools(torch, cfg, params, reqs, "cpu", max_len=64,
                                             gen=16)
    assert dense["max_abs_err_vs_paged"] < 1e-5
    assert "logit divergence int8" in capsys.readouterr().out
