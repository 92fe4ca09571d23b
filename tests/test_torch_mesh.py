"""The port's serving mesh against the JAX reference, on the CPU: the
mesh's configuration and rules, the data-sharded KV cache's host
accounting, expert-parallel dispatch and data-sharded paged attention on
gloo ranks, and the trivial (1, 1) mesh engine in this process.

Ranks are processes that ``repro_torch.launch.mesh.spawn`` starts (one
torch thread each, a ``file://`` rendezvous in the test's temporary
directory, a timeout on the join and on every collective); their bodies are
in ``torch_mesh_workers.py`` and import the port only.  The reference's
results are computed here, in the parent.  Each mesh shape is spawned once
per file (a module fixture) and its results read by several tests.
Tolerances: tokens, block ids, tables, layouts and occupancy exact; float
dispatch and attention outputs within the reference's own f32 ``atol =
2e-5`` (``tests/test_dispatch.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_mesh_workers as W
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import SLOConfig as JSLOConfig
from repro.configs.base import SpecConfig as JSpecConfig
from repro.configs.registry import get_config as jget_config
from repro.core.dispatch.dropless import dropless_dispatch as j_dropless
from repro.core.dispatch.gather import gather_dispatch as j_gather
from repro.core.routing import route as j_route
from repro.distributed.sharding import make_rules as jmake_rules
from repro.distributed.sharding import param_pspecs as jparam_pspecs
from repro.kernels.decode_attention.ops import paged_update_attention as j_paged_update
from repro.kernels.decode_attention.ops import (
    quantized_paged_update_attention as j_quant_update,
)
from repro.models.registry import get_family
from repro.nn import init as jinit
from repro.quant import get_kv_quant as jget_kv_quant
from repro.serving.continuous import ContinuousEngine as JEngine
from repro.serving.kv_cache import ShardedPagedKVCache as JShardedCache
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.configs.base import SLOConfig as TSLOConfig
from repro_torch.configs.base import SpecConfig as TSpecConfig
from repro_torch.configs.registry import get_config as tget_config
from repro_torch.core.dispatch.dropless import dropless_dispatch as t_dropless
from repro_torch.core.dispatch.gather import gather_dispatch as t_gather
from repro_torch.core.routing import route as t_route
from repro_torch.distributed.sharding import (
    MeshShape,
    make_rules,
    param_pspecs,
    placement,
    shard_params,
)
from repro_torch.launch.mesh import make_serve_mesh, spawn
from repro_torch.nn import from_jax_params, init_params, model_shapes
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from repro_torch.serving.kv_cache import ShardedPagedKVCache as TShardedCache
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-5
SPAWN_TIMEOUT = 240


def _spawn(tmp_path_factory, body, spec, *args):
    world = spec[0][1] * spec[1][1]
    init = str(tmp_path_factory.mktemp("mesh") / "init")
    return spawn(body, world, init_file=init, args=(spec, *args), timeout=SPAWN_TIMEOUT)


# ---------------------------------------------------------------------------
# 1. ServeConfig and parse_mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(mesh=(("rows", 2), ("expert", 1))),                         # unknown axis
    dict(mesh=(("data", 0), ("expert", 1))),                         # size 0
    dict(max_slots=8, mesh=(("data", 3), ("expert", 1))),            # max_slots % data
    dict(max_slots=8, num_blocks=30, mesh=(("data", 4), ("expert", 1))),   # num_blocks % data
], ids=["unknown-axis", "size-0", "slots", "blocks"])
def test_serve_config_refuses_meshes_as_reference(kw):
    with pytest.raises(ValueError) as jerr:
        JServeConfig(**kw)
    with pytest.raises(ValueError) as terr:
        TServeConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_serve_config_mesh_properties_match_reference():
    for mesh in (None, (("data", 2), ("expert", 4)), (("data", 8), ("expert", 1))):
        j, t = JServeConfig(mesh=mesh), TServeConfig(mesh=mesh)
        assert (t.data_shards, t.expert_shards) == (j.data_shards, j.expert_shards)


@pytest.mark.parametrize("text", ["data=2,expert=4", "2,4", "2", "expert=8", "data=2,rows=1",
                                  "1,2,3"])
def test_parse_mesh_matches_reference(text):
    from repro.launch.serve import parse_mesh as jparse
    from repro_torch.launch.serve import parse_mesh as tparse

    try:
        want = jparse(text)
    except SystemExit as e:
        with pytest.raises(SystemExit) as terr:
            tparse(text)
        assert str(terr.value) == str(e)
        return
    assert tparse(text) == want


def test_static_engine_refuses_mesh_as_reference():
    from repro.launch.serve import main as jmain
    from repro_torch.launch.serve import main as tmain

    argv = ["--arch", "m6-base", "--smoke", "--mesh", "data=2"]
    with pytest.raises(SystemExit) as jerr:
        jmain(argv)
    with pytest.raises(SystemExit) as terr:
        tmain(argv + ["--device", "cpu"])
    assert str(terr.value) == str(jerr.value) == "--mesh needs --engine continuous"


# ---------------------------------------------------------------------------
# 2. make_rules, param_pspecs, shard_params
# ---------------------------------------------------------------------------

def _flat_specs(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, f"{path}['{k}']"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_specs(v, f"{path}[{i}]"))
        return out
    return {path: tuple(tree)}


@pytest.mark.parametrize("shape", [(2, 4), (8, 1), (1, 8), (1, 16)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ["m6-base", "granite-moe-3b-a800m", "qwen3-14b"])
def test_rules_and_param_pspecs_match_reference(arch, shape):
    """granite's 40 experts shard on 2 x 4 and 8 x 1, not on 1 x 16 (the
    rules fall back to replication); qwen3-14b is dense."""
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    jrules = jmake_rules(jcfg, AbstractMesh(shape, ("data", "expert")), expert_axis="expert")
    trules = make_rules(tcfg, MeshShape(("data", "expert"), shape), expert_axis="expert")
    assert trules.params == jrules.params
    assert trules.acts == jrules.acts
    P = jax.sharding.PartitionSpec
    jspecs = jparam_pspecs(get_family(jcfg).specs(jcfg), jrules)
    jflat = {jax.tree_util.keystr(p): tuple(s) for p, s in
             jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda x: isinstance(x, P))[0]}
    assert _flat_specs(param_pspecs(model_shapes(tcfg), trules)) == jflat
    if arch == "granite-moe-3b-a800m":
        assert (trules.params["expert"] is None) == (shape == (1, 16))


def _tiny_moe(routing="topk", **kw):
    moe = dict(num_experts=8, routing=routing, top_k=2, group_size=1, impl="dropless",
               capacity_factor=None)
    moe.update(kw.pop("moe", {}))
    base = dict(name="t", family="decoder_lm", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=96, vocab_size=128, max_seq_len=128, dtype="float32")
    base.update(kw)
    return (JModelConfig(**base, moe=JMoEConfig(**moe)),
            TModelConfig(**base, moe=TMoEConfig(**moe)))


def test_shard_params_slices_concatenate_to_the_tree():
    """On a (2, 4) mesh every rank's slice of every leaf, concatenated over
    the ranks along its sharded dim, is the whole leaf; the router stays
    whole when kept; and ``init_params(place=...)`` draws the same slices."""
    _, tcfg = _tiny_moe()
    full = init_params(tcfg, seed=3, device="cpu")
    mesh = MeshShape(("data", "expert"), (2, 4))
    rules = make_rules(tcfg, mesh, expert_axis="expert")
    specs = _flat_specs(param_pspecs(model_shapes(tcfg), rules))
    coords = [{"data": d, "expert": e} for d in range(2) for e in range(4)]
    slices = [shard_params(full, rules, c) for c in coords]
    from repro_torch.nn.spec import flat_params

    flat_full = flat_params(full)
    flat_slices = [flat_params(s) for s in slices]
    for path, leaf in flat_full.items():
        key = "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in path.split("/"))
        spec = specs[key]
        sharded = [i for i, ax in enumerate(spec) if ax is not None]
        if not sharded:
            for fs in flat_slices:
                assert torch.equal(fs[path], leaf)
            continue
        (dim,) = sharded
        ax = spec[dim]
        parts = {c[ax]: fs[path] for c, fs in zip(coords, flat_slices)}
        assert torch.equal(torch.cat([parts[i] for i in sorted(parts)], dim=dim), leaf)
    assert specs["['blocks']['ffn']['up']"] == (None, "expert")
    assert specs["['blocks']['ffn']['router']"] == (None, None, "expert")
    kept = shard_params(full, rules, coords[5], keep=("router",))
    assert torch.equal(kept["blocks"]["ffn"]["router"], full["blocks"]["ffn"]["router"])
    assert kept["blocks"]["ffn"]["up"].shape[1] == 2
    drawn = init_params(tcfg, seed=3, device="cpu",
                        place=placement(rules, coords[5], keep=("router",)))
    for path, leaf in flat_params(kept).items():
        assert torch.equal(flat_params(drawn)[path], leaf)


# ---------------------------------------------------------------------------
# 3. ShardedPagedKVCache's host accounting against the reference's
# ---------------------------------------------------------------------------

def _cache_cfgs():
    base = dict(name="t", family="decoder_lm", num_layers=2, d_model=32, num_heads=2,
                num_kv_heads=2, d_ff=64, vocab_size=64, max_seq_len=64, dtype="float32")
    return JModelConfig(**base), TModelConfig(**base)


def _alloc_state(a):
    out = {"free": list(a._free)}
    for k in ("_allocated", "_cached", "_ref", "_owner"):
        if hasattr(a, k):
            v = getattr(a, k)
            out[k] = sorted(v) if isinstance(v, set) else (list(v) if k == "_cached" else dict(v))
    return out


def _host_state(cache):
    out = []
    for s in cache.shards:
        st = {"table": s.block_table.tolist(), "blocks": dict(s._slot_blocks),
              "reserved": dict(s._slot_reserved), "reserved_total": s.reserved_total,
              "alloc": _alloc_state(s.allocator), "occupancy": s.occupancy()}
        if hasattr(s, "_slot_bound"):
            st.update(bound=dict(s._slot_bound), chain=dict(s._slot_chain), stats=dict(s.stats),
                      index=dict(s.index._block_of))
        out.append(st)
    return out


def _both(jc, tc, name, *args, **kw):
    """Call ``name`` on both caches: equal results, or the same exception type."""
    try:
        want = getattr(jc, name)(*args, **kw)
    except (RuntimeError, NotImplementedError, AssertionError) as e:
        with pytest.raises(type(e)):
            getattr(tc, name)(*args, **kw)
        return None
    got = getattr(tc, name)(*args, **kw)
    assert got == want, (name, args)
    return got


@pytest.mark.parametrize("kv_quant,prefix", [("none", False), ("none", True), ("int8", False),
                                             ("fp8", False), ("int8", True)],
                         ids=["plain", "prefix", "int8", "fp8", "int8-prefix"])
def test_sharded_cache_host_accounting_matches_reference(kv_quant, prefix):
    """One seeded sequence of allocate / ensure / commit / truncate / free
    on 2 shards of 2 slots: every result and every shard's tables,
    reservations, allocator lists, prefix index and occupancy equal the
    reference's after every op; conservation holds on both; the port's
    pools are one shard's ``shard_blocks + 1`` rows."""
    jcfg, tcfg = _cache_cfgs()
    D, sps, bs, bps, max_len = 2, 2, 4, 10, 24
    kw = dict(max_slots=D * sps, kv_block_size=bs, max_len=max_len, num_blocks=D * bps,
              kv_quant=kv_quant, prefix_cache=prefix, mesh=(("data", D), ("expert", 1)))
    jc = JShardedCache(jcfg, JServeConfig(**kw))
    tc = TShardedCache(tcfg, TServeConfig(**kw), device="cpu", shard=1)
    assert (tc.num_shards, tc.max_request_blocks, tc.garbage_block) == (
        jc.num_shards, jc.max_request_blocks, jc.garbage_block)
    L, Hkv, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.resolved_head_dim
    assert tuple(tc.k_pool.shape) == (L, bps + 1, Hkv, bs, hd)
    if kv_quant != "none":
        assert tc.k_pool.dtype == torch.int8
        assert tuple(tc.k_scales.shape) == (L, bps + 1, Hkv)
    rng = np.random.default_rng(11)
    prefixes = [rng.integers(0, 64, 8).astype(np.int32) for _ in range(2)]
    streams, written = {}, {}
    for _ in range(160):
        kind, slot = int(rng.integers(5)), int(rng.integers(D * sps))
        if kind == 0 and slot not in streams:
            prompt = np.concatenate([prefixes[int(rng.integers(2))],
                                     rng.integers(0, 64, int(rng.integers(1, 6)))]).astype(np.int32)
            total = prompt.size + int(rng.integers(1, max_len - prompt.size + 1))
            fits = _both(jc, tc, "can_allocate_slot_on", slot, total, prompt=prompt)
            if fits:
                written[slot] = _both(jc, tc, "allocate_slot", slot, total, prompt=prompt)
                streams[slot] = np.concatenate(
                    [prompt, rng.integers(0, 64, total - prompt.size)]).astype(np.int32)
        elif kind == 1 and slot in streams:
            written[slot] = min(written[slot] + int(rng.integers(1, 7)), streams[slot].size)
            _both(jc, tc, "ensure_capacity", slot, written[slot])
            if prefix:
                _both(jc, tc, "commit", slot, streams[slot][:written[slot]])
        elif kind == 2 and slot in streams and not prefix:
            written[slot] = int(rng.integers(0, written[slot] + 1))
            _both(jc, tc, "truncate_slot", slot, written[slot])
        elif kind == 3 and slot in streams:
            for p in range(written[slot]):
                if not prefix:
                    _both(jc, tc, "write_coords", slot, p)
            assert np.array_equal(tc.row_table(slot), jc.row_table(slot))
            assert _both(jc, tc, "held_blocks", slot) is not None
        elif kind == 4 and slot in streams:
            if prefix:
                _both(jc, tc, "commit", slot, streams[slot][:written[slot]])
            _both(jc, tc, "free_slot", slot)
            del streams[slot], written[slot]
        jc.check_conservation()
        tc.check_conservation()
        assert _host_state(tc) == _host_state(jc)
        assert tc.occupancy() == jc.occupancy()
        assert tc.reserved_total == jc.reserved_total
        assert tc.can_allocate_slot(1) == jc.can_allocate_slot(1)
        if prefix:
            assert tc.stats == jc.stats
    for name, args in (("swap_footprint", (0,)), ("can_restore", (None,)),
                       ("restore_slot", (0, None, None))):
        _both(jc, tc, name, *args)
    with pytest.raises(NotImplementedError) as jerr:
        jc.swap_out(0, None, uid=0, total_len=4, context_len=2)
    with pytest.raises(NotImplementedError) as terr:
        tc.swap_out(0, None, uid=0, total_len=4, context_len=2)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# 4. Dispatch on gloo ranks
# ---------------------------------------------------------------------------

def _dispatch_cases(G_dropless: int, seed: int):
    """(name, port cfg, numpy params, xg, kind) for the ranks, and the
    reference's and the port's single-device outputs."""
    rng = np.random.default_rng(seed)
    cases, ref, single = [], {}, {}
    specs = [("dropless topk", "topk", None, G_dropless, 1, "dropless"),
             ("dropless hash", "hash", None, G_dropless, 1, "dropless"),
             ("alltoall topk", "topk", 1.25, 16, 8, "alltoall"),
             ("alltoall expert_choice", "expert_choice", 1.25, 16, 8, "alltoall")]
    for name, routing, cf, G, T, kind in specs:
        impl = "dropless" if kind == "dropless" else "gather"
        jcfg, tcfg = _tiny_moe(routing, moe=dict(capacity_factor=cf, impl=impl, group_size=T))
        E, M, I = 8, jcfg.d_model, jcfg.d_ff
        params = {"up": (rng.standard_normal((E, M, I)) * 0.05).astype(np.float32),
                  "down": (rng.standard_normal((E, I, M)) * 0.05).astype(np.float32)}
        if routing != "hash":
            params["router"] = (rng.standard_normal((M, E)) * 0.1).astype(np.float32)
        xg = rng.standard_normal((G, T, M)).astype(np.float32)
        m = jcfg.moe
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        jplan = j_route(jnp.asarray(xg), jp.get("router"), m, m.capacity(T))
        tp = {k: torch.from_numpy(v) for k, v in params.items()}
        tplan = t_route(torch.from_numpy(xg), tp.get("router"), tcfg.moe, tcfg.moe.capacity(T))
        if kind == "dropless":
            ref[name] = np.asarray(j_dropless(jp, jnp.asarray(xg), jplan, jcfg))
            single[name] = t_dropless(tp, torch.from_numpy(xg), tplan, tcfg).numpy()
        else:
            ref[name] = np.asarray(j_gather(jp, jnp.asarray(xg), jplan, jcfg))
            single[name] = t_gather(tp, torch.from_numpy(xg), tplan, tcfg).numpy()
        cases.append((name, tcfg.replace_moe(impl="alltoall" if kind == "alltoall" else impl),
                      params, xg, kind))
    return cases, ref, single


DISPATCH_MESHES = {"2x2": ((("data", 2), ("expert", 2)), 16),
                   "2x4": ((("data", 2), ("expert", 4)), 16),
                   "1x4": ((("data", 1), ("expert", 4)), 6)}   # G = 6: the groups do not split


@pytest.fixture(scope="module")
def dispatch_runs(tmp_path_factory):
    out = {}
    for key, (spec, G) in DISPATCH_MESHES.items():
        cases, ref, single = _dispatch_cases(G, seed=len(out))
        ranks = _spawn(tmp_path_factory, W.dispatch_body, spec, cases)
        out[key] = (spec, ref, single, ranks)
    return out


@pytest.mark.parametrize("key", list(DISPATCH_MESHES))
def test_ragged_ep_dispatch_matches_reference(dispatch_runs, key):
    """``dropless_dispatch`` on the mesh (``ragged_ep_dispatch`` where the
    groups split over it, the gathered experts where they do not, as on
    1 x 4 at G = 6) equals the reference's and the port's single-device
    dropless dispatch; every rank holds E / ne experts; all_to_all ran on
    every rank exactly where the plan is placed."""
    spec, ref, single, ranks = dispatch_runs[key]
    ne = spec[1][1]
    placed = key != "1x4"
    for name in ("dropless topk", "dropless hash"):
        for y, a2a, experts in (r[name] for r in ranks):
            np.testing.assert_allclose(y, ref[name], atol=ATOL, rtol=0)
            np.testing.assert_allclose(y, single[name], atol=ATOL, rtol=0)
            assert experts == 8 // ne
            assert (a2a > 0) == placed, (name, a2a)


@pytest.mark.parametrize("key", ["2x2", "2x4"])
def test_alltoall_dispatch_matches_reference_gather(dispatch_runs, key):
    """``alltoall_dispatch`` at capacity 1.25, token choice and expert
    choice, equals the reference's ``gather_dispatch``; all_to_all ran."""
    spec, ref, single, ranks = dispatch_runs[key]
    for name in ("alltoall topk", "alltoall expert_choice"):
        for y, a2a, experts in (r[name] for r in ranks):
            np.testing.assert_allclose(y, ref[name], atol=ATOL, rtol=0)
            np.testing.assert_allclose(y, single[name], atol=ATOL, rtol=0)
            assert a2a == 2 and experts == 8 // spec[1][1]


def test_alltoall_dispatcher_registered():
    """``get_dispatcher("alltoall")`` is the ported dispatcher: without a
    mesh it is ``gather`` (and dropless plans ``dropless``)."""
    from repro_torch.core.dispatch import available_dispatchers, get_dispatcher

    assert "alltoall" in available_dispatchers()
    cases, _, single = _dispatch_cases(8, seed=7)
    for name, tcfg, params, xg, kind in cases:
        tp = {k: torch.from_numpy(v) for k, v in params.items()}
        m = tcfg.moe
        plan = t_route(torch.from_numpy(xg), tp.get("router"), m, m.capacity(xg.shape[1]))
        y = get_dispatcher("alltoall")(tp, torch.from_numpy(xg), plan, tcfg)
        np.testing.assert_allclose(y.numpy(), single[name], atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# 5. Data-sharded paged attention on (2, 1) ranks
# ---------------------------------------------------------------------------

def _attention_cases(seed=5):
    """Two shards of 7 blocks + garbage each, 3 rows a shard (one masked),
    f32 operands with shard-local ids; the reference's inputs are
    the stacked pool with global ids."""
    rng = np.random.default_rng(seed)
    D, per, Hq, Hkv, hd, bs, sb, MB = 2, 3, 4, 2, 16, 4, 7, 3
    P = sb + 1
    N = D * per
    q = rng.standard_normal((N, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((N, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((N, Hkv, hd)).astype(np.float32)
    k_pool = rng.standard_normal((D, P, Hkv, bs, hd)).astype(np.float32)
    v_pool = rng.standard_normal((D, P, Hkv, bs, hd)).astype(np.float32)
    tables = np.full((N, MB), sb, np.int32)
    lengths = np.zeros(N, np.int32)
    wb = np.full(N, sb, np.int32)
    wo = np.zeros(N, np.int32)
    for r in range(N):
        if r % per == per - 1:
            continue                                   # a masked row
        ln = int(rng.integers(1, MB * bs + 1))
        blocks = rng.permutation(sb)[:MB].astype(np.int32)
        tables[r] = blocks
        lengths[r] = ln
        wb[r], wo[r] = blocks[(ln - 1) // bs], (ln - 1) % bs
    a = dict(q=q, k=k, v=v, k_pool=k_pool, v_pool=v_pool, wb=wb, wo=wo, tables=tables,
             lengths=lengths, k_scales=None, v_scales=None)
    shift = (np.arange(N) // per * P).astype(np.int32)
    glob = dict(wb=wb + shift, tables=tables + shift[:, None])
    return a, glob, (D, P)


@pytest.fixture(scope="module")
def attention_runs(tmp_path_factory):
    a, glob, (D, P) = _attention_cases()
    stacked = lambda x: x.reshape(D * P, *x.shape[2:])   # noqa: E731
    cases, refs = [], {}
    out, kp, vp = j_paged_update(*(jnp.asarray(a[n]) for n in "qkv"),
                                 jnp.asarray(stacked(a["k_pool"])),
                                 jnp.asarray(stacked(a["v_pool"])), jnp.asarray(glob["wb"]),
                                 jnp.asarray(a["wo"]), jnp.asarray(glob["tables"]),
                                 jnp.asarray(a["lengths"]))
    cases.append(("f32", a, None))
    refs["f32"] = (np.asarray(out), np.asarray(kp), np.asarray(vp), None, None)
    for name in ("int8", "fp8"):
        policy = jget_kv_quant(name)
        rng = np.random.default_rng(6)
        codes = rng.integers(-100, 100, a["k_pool"].shape).astype(np.int8)
        if name == "fp8":       # finite e4m3fn bit patterns
            codes = np.where((codes & 0x7F) == 0x7F, 0, codes).astype(np.int8)
        qa = dict(a, k_pool=codes, v_pool=codes[::-1].copy(),
                  k_scales=rng.uniform(0.01, 0.1, (D, P, 2)).astype(np.float32),
                  v_scales=rng.uniform(0.01, 0.1, (D, P, 2)).astype(np.float32))
        res = j_quant_update(*(jnp.asarray(qa[n]) for n in "qkv"),
                             jnp.asarray(stacked(qa["k_pool"])),
                             jnp.asarray(stacked(qa["v_pool"])),
                             jnp.asarray(stacked(qa["k_scales"])),
                             jnp.asarray(stacked(qa["v_scales"])), jnp.asarray(glob["wb"]),
                             jnp.asarray(qa["wo"]), jnp.asarray(glob["tables"]),
                             jnp.asarray(qa["lengths"]), policy=policy)
        cases.append((name, qa, name))
        refs[name] = tuple(np.asarray(x) for x in res)
    ranks = _spawn(tmp_path_factory, W.attention_body, (("data", D), ("expert", 1)), cases)
    return ranks, refs, (D, P)


@pytest.mark.parametrize("name", ["f32", "int8", "fp8"])
def test_sharded_paged_attention_matches_reference(attention_runs, name):
    """Each rank's rows through its pool slice, all-gathered: the outputs
    equal the reference's over the stacked pool, and each rank's pool slice
    (codes and scales) after the write equals its shard's slice of the
    reference's pools."""
    ranks, refs, (D, P) = attention_runs
    want = refs[name]
    for d, r in enumerate(ranks):
        out, kp, vp, ks, vs = r[name]
        np.testing.assert_allclose(out, want[0], atol=ATOL, rtol=0)
        sl = slice(d * P, (d + 1) * P)
        assert np.array_equal(kp, want[1][sl]) and np.array_equal(vp, want[2][sl])
        if ks is not None:
            assert np.array_equal(ks, want[3][sl]) and np.array_equal(vs, want[4][sl])


# ---------------------------------------------------------------------------
# 6a. The trivial (1, 1) mesh engine, in this process on a world-1 gloo group
# ---------------------------------------------------------------------------

TRIVIAL = (("data", 1), ("expert", 1))


@pytest.fixture(scope="module")
def world1():
    import torch.distributed as dist

    mesh = make_serve_mesh(TRIVIAL, "cpu")
    yield mesh
    dist.destroy_process_group()


def _dense_cfgs():
    base = dict(name="t", family="decoder_lm", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=128, max_seq_len=128, dtype="float32")
    return JModelConfig(**base), TModelConfig(**base)


def _serve_kw(**kw):
    base = dict(max_slots=8, kv_block_size=4, prefill_chunk=4, max_len=32)
    base.update(kw)
    return base


def _prompts(B=6, S=9, seed=1, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _prefix_prompts(vocab=128):
    rng = np.random.default_rng(3)
    base = rng.integers(0, vocab, 12)
    tails = rng.integers(0, vocab, (6, 4))
    return np.concatenate([np.tile(base[None], (6, 1)), tails], axis=1).astype(np.int32)


def _reference_and_single(jcfg, tcfg, prompts, n, **serve_kw):
    jp = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
    tp = from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    want, _ = JEngine(jcfg, jp, JServeConfig(**_serve_kw(**serve_kw)),
                      check_invariants=True).generate(jnp.asarray(prompts), n)
    single, _ = TEngine(tcfg, tp, TServeConfig(**_serve_kw(**serve_kw)), device="cpu",
                        check_invariants=True).generate(prompts, n)
    np.testing.assert_array_equal(single, np.asarray(want))
    return np.asarray(want), tp


@pytest.mark.parametrize("case", ["dense", "dropless-topk", "slot-reuse", "prefix", "int8"])
def test_trivial_mesh_tokens_match_reference(world1, case):
    """The whole sharded path (the sharded cache, data-sharded attention,
    the shard-major rows, the mesh's rules) on one rank: greedy tokens
    identical to the reference's and the port's single-device engines;
    prefix caching's second serve hits the cache and repeats them."""
    jcfg, tcfg = _tiny_moe() if case == "dropless-topk" else _dense_cfgs()
    prompts, n, kw = _prompts(), 10, {}
    if case == "slot-reuse":
        prompts, n = _prompts(B=12, seed=2), 6
    elif case == "prefix":
        prompts, n, kw = _prefix_prompts(), 8, dict(prefix_cache=True)
    elif case == "int8":
        kw = dict(kv_quant="int8")
    want, tp = _reference_and_single(jcfg, tcfg, prompts, n, **kw)
    rules = make_rules(tcfg, world1, expert_axis="expert")
    placed = shard_params(tp, rules, world1.coord, keep=("router",))
    eng = TEngine(tcfg, placed, TServeConfig(mesh=TRIVIAL, **_serve_kw(**kw)), device="cpu",
                  check_invariants=True, mesh=world1)
    assert isinstance(eng.cache, TShardedCache) and eng.cache.num_shards == 1
    out, _ = eng.generate(prompts, n)
    np.testing.assert_array_equal(out, want)
    eng.cache.check_conservation()
    if case == "prefix":
        again, _ = eng.generate(prompts, n)
        np.testing.assert_array_equal(again, want)
        assert eng.cache.stats["hit_tokens"] > 0


def test_trivial_mesh_prefix_off_and_on_identical(world1):
    _, tcfg = _dense_cfgs()
    params = init_params(tcfg, seed=0, device="cpu")
    outs = {}
    for pc in (False, True):
        eng = TEngine(tcfg, params, TServeConfig(mesh=TRIVIAL, **_serve_kw(prefix_cache=pc)),
                      device="cpu", check_invariants=True, mesh=world1)
        outs[pc], _ = eng.generate(_prompts(), 8)
    np.testing.assert_array_equal(outs[False], outs[True])


def test_engine_refuses_unplaced_params(world1):
    """On a mesh the engine takes the rank's placement; on a 1 x 1 mesh
    that is the whole tree, and a tree cut for another mesh is refused."""
    _, tcfg = _tiny_moe()
    params = init_params(tcfg, seed=0, device="cpu")
    other = shard_params(params, make_rules(tcfg, MeshShape(("data", "expert"), (1, 2)),
                                            expert_axis="expert"),
                         {"data": 0, "expert": 0}, keep=("router",))
    with pytest.raises(ValueError, match="placement"):
        TEngine(tcfg, other, TServeConfig(mesh=TRIVIAL, **_serve_kw()), device="cpu",
                mesh=world1)


# ---------------------------------------------------------------------------
# 7. Refusals with the reference's messages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["speculative decoding", "SLO scheduling", "mesh serving"])
def test_mesh_refusals_match_reference(what):
    """Speculation and SLO scheduling with a mesh, and a recurrent family
    on one, raise the reference's NotImplementedError, before any process
    group is needed."""
    jcfg, tcfg = _dense_cfgs()
    jkw, tkw = {}, {}
    if what == "speculative decoding":
        jkw, tkw = dict(spec=JSpecConfig(drafter="ngram", gamma=2)), dict(
            spec=TSpecConfig(drafter="ngram", gamma=2))
    elif what == "SLO scheduling":
        jkw, tkw = dict(slo=JSLOConfig(preemption=True, host_blocks=8)), dict(
            slo=TSLOConfig(preemption=True, host_blocks=8))
    else:
        jcfg = jget_config("xlstm-125m")
        tcfg = tget_config("xlstm-125m")
    jserve = JServeConfig(mesh=TRIVIAL, **_serve_kw(**jkw))
    tserve = TServeConfig(mesh=TRIVIAL, **_serve_kw(**tkw))
    with pytest.raises(NotImplementedError, match=what) as jerr:
        JEngine(jcfg, None, jserve)
    tp = {"embed": {"table": torch.zeros(1)}}
    with pytest.raises(NotImplementedError, match=what) as terr:
        TEngine(tcfg, tp, tserve, device="cpu")
    assert str(terr.value) == str(jerr.value)
