"""The port's quantized KV cache and decode attention kernels against the
JAX reference, on the CPU.

Inputs come from numpy seeds and go to both packages.  Integer state
(codes, the bit patterns of the scales) must match exactly; attention
outputs within the reference's own kernel tolerances (2e-5 f32 for the
quantized kernel, 3e-5 f32 / 3e-2 bf16 for dense decode).  The reference's
Pallas kernels run in interpret mode, as its own tests run them here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.kernels.decode_attention.kernel import quantized_paged_decode_attention_kernel
from repro.kernels.decode_attention.ops import decode_attention as j_decode_attention
from repro.quant import get_kv_quant as j_policy
from repro.quant import quant_write_kv as j_quant_write
from repro.quant.kv_cache import QuantizedPagedKVCache as JQCache
from repro.quant.kv_cache import QuantizedPrefixCachingKVCache as JQPCache
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.quant import check_quant_roundtrip
from repro_torch.quant import get_kv_quant as t_policy
from repro_torch.quant import quant_write_kv as t_quant_write
from repro_torch.quant.kv_cache import QuantizedPagedKVCache as TQCache
from repro_torch.quant.kv_cache import QuantizedPrefixCachingKVCache as TQPCache
from torch_elsewhere import elsewhere
from torch_threads import one_torch_thread  # noqa: F401

POLICIES = ["int8", "fp8"]


def _special_values():
    """Zeros, ties of both grids, the +-448 clip and values past it."""
    ties_int8 = np.arange(-130, 130) + 0.5
    # e4m3 midpoints: halfway between neighbouring representable values
    grid = np.asarray(jax.lax.bitcast_convert_type(
        jnp.arange(-128, 128, dtype=jnp.int32).astype(jnp.int8), jnp.float8_e4m3fn
    ).astype(jnp.float32))
    grid = np.sort(grid[np.isfinite(grid)])
    ties_fp8 = (grid[1:] + grid[:-1]) / 2
    edges = [0.0, -0.0, 448.0, -448.0, 449.0, -449.0, 464.0, 1e4, -1e4, 127.0, -127.0,
             127.5, -127.5, 200.0, 1e-9, -1e-9, 2.0 ** -10, 3 * 2.0 ** -11]
    return np.concatenate([ties_int8, ties_fp8, edges]).astype(np.float32)


@pytest.mark.parametrize("name", POLICIES)
def test_policy_codes_bit_equal(name):
    rng = np.random.default_rng(0)
    u = np.concatenate([rng.standard_normal(100_000) * 60.0,
                        rng.uniform(-500.0, 500.0, 100_000),
                        _special_values()]).astype(np.float32)
    jcodes = np.asarray(j_policy(name).encode(jnp.asarray(u)))
    tcodes = t_policy(name).encode(torch.from_numpy(u)).numpy()
    assert tcodes.dtype == np.int8
    np.testing.assert_array_equal(tcodes, jcodes)
    every = np.arange(-128, 128, dtype=np.int8)     # every code decodes alike
    jdec = np.asarray(j_policy(name).decode(jnp.asarray(every)))
    tdec = t_policy(name).decode(torch.from_numpy(every)).numpy()
    # bit-equal, apart from the NaN payload of e4m3's two NaN codes (which
    # the encoder never produces: it clips to +-448)
    nan = np.isnan(jdec)
    np.testing.assert_array_equal(np.isnan(tdec), nan)
    np.testing.assert_array_equal(tdec[~nan].view(np.int32), jdec[~nan].view(np.int32))
    deq, scale, err = check_quant_roundtrip(u[:1000], t_policy(name))
    assert err <= t_policy(name).error_bound(scale) + 1e-6


def _fixed_grid():
    """test_kv_quant.py::test_quant_write_fixed_grid's writes: (steps of
    (block, offset, values)), bs 4, Hkv 2, D 2, P 4."""
    return [[(0, 0, [1.0, -2.0, 3.0, -4.0])],
            [(0, 1, [100.0, 0.5, -0.25, 7.0])],     # scale growth -> rescale
            [(0, 2, [0.1, 0.2, 0.3, 0.4])],         # no growth
            [(1, 0, [0.0, 0.0, 0.0, 0.0])],         # all-zero block
            [(0, 0, [5.0, 5.0, 5.0, 5.0])]]         # refill resets the scale


def _random_steps(seed, P=6, bs=4, hkv=2, hd=8, steps=12):
    """Engine-like steps: a chunk of consecutive positions of one slot
    (crossing block boundaries, so several rows share a block) plus single
    decode rows; coordinates unique within a step; magnitudes varying so
    scales grow."""
    rng = np.random.default_rng(seed)
    fill = {b: 0 for b in range(P)}
    out = []
    for _ in range(steps):
        rows, used = [], set()
        start_block = int(rng.integers(P))
        chunk = int(rng.integers(2, 2 * bs + 1))
        b, o = start_block, fill[start_block] % bs
        for _ in range(chunk):
            if (b, o) not in used:
                used.add((b, o))
                rows.append((b, o))
            o += 1
            if o == bs:
                b, o = (b + 1) % P, 0
        for _ in range(int(rng.integers(0, 3))):
            c = (int(rng.integers(P)), int(rng.integers(bs)))
            if c not in used:
                used.add(c)
                rows.append(c)
        for b, o in rows:
            fill[b] = o + 1
        scale = float(rng.choice([0.1, 1.0, 30.0]))
        out.append([(b, o, rng.standard_normal(hkv * hd) * scale) for b, o in rows])
    return out


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("seq", ["fixed_grid", "random_shared_blocks"])
def test_quant_write_kv_bit_equal(name, seq):
    if seq == "fixed_grid":
        steps, P, hkv, bs, hd = _fixed_grid(), 4, 2, 4, 2
    else:
        steps, P, hkv, bs, hd = _random_steps(seed=1), 6, 2, 4, 8
    jcodes = jnp.zeros((P, hkv, bs, hd), jnp.int8)
    jscales = jnp.zeros((P, hkv), jnp.float32)
    tcodes = torch.zeros((P, hkv, bs, hd), dtype=torch.int8)
    tscales = torch.zeros((P, hkv), dtype=torch.float32)
    for step in steps:
        x = np.stack([np.asarray(v, np.float32).reshape(hkv, hd) for _, _, v in step])
        wb = np.asarray([b for b, _, _ in step], np.int32)
        wo = np.asarray([o for _, o, _ in step], np.int32)
        jcodes, jscales = j_quant_write(jcodes, jscales, jnp.asarray(x), jnp.asarray(wb),
                                        jnp.asarray(wo), policy=j_policy(name))
        t_quant_write(tcodes, tscales, torch.from_numpy(x), torch.from_numpy(wb),
                      torch.from_numpy(wo), policy=t_policy(name))
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(tscales.numpy().view(np.int32),
                                      np.asarray(jscales).view(np.int32))
    assert np.asarray(jscales).max() > 0


def _quant_pools(name, P, H, bs, D, seed):
    """Per-(block, head) absmax quantized pools, as the reference's
    kernel test builds them (numpy f32 values, the reference's encoder)."""
    rng = np.random.default_rng(seed)
    pol = j_policy(name)
    out = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((P, H, bs, D)).astype(np.float32))
        s = jnp.abs(x).max(axis=(2, 3)) / pol.qmax
        codes = pol.encode(x / jnp.maximum(s, 1e-30)[:, :, None, None])
        out += [np.array(codes), np.array(s)]
    return out                       # k_codes, k_scales, v_codes, v_scales


@pytest.mark.parametrize("name", POLICIES)
def test_quantized_attention_matches_reference_kernel(name):
    """The reference's kernel test shapes, plus a length-0 row."""
    N, H, G, D, P, bs = 4, 2, 2, 8, 9, 4
    kc, ks, vc, vs = _quant_pools(name, P, H, bs, D, seed=3)
    q = np.random.default_rng(4).standard_normal((N, H, G, D)).astype(np.float32)
    tbl = np.asarray([[1, 2], [3, 4], [5, 0], [8, 8]], np.int32)
    lens = np.asarray([5, 8, 3, 0], np.int32)
    want = np.asarray(quantized_paged_decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(tbl), jnp.asarray(lens), decode=j_policy(name).decode, interpret=True))
    got = da_ops.quantized_paged_decode_attention(
        *map(torch.from_numpy, (q.reshape(N, H * G, D), kc, vc, ks, vs, tbl, lens)),
        policy=t_policy(name))
    np.testing.assert_allclose(got.numpy(), want.reshape(N, H * G, D), atol=2e-5, rtol=2e-5)
    assert (got[3] == 0).all()                           # length 0: exactly 0
    assert da_ops.quantized_paged_decode_attention.launches == 0   # CPU: no kernel


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("name", POLICIES)
def test_quantized_split_plain_version(name, splits):
    """The quantized kernel's split over ``splits`` CTAs and its merge, in
    plain PyTorch: against the reference's quantized Pallas kernel in
    interpret mode and the unsplit plain version at 2e-5, over rows with
    more and fewer blocks than splits and a length-0 row (exactly 0)."""
    from repro_torch.kernels.decode_attention.ref import (
        quantized_paged_decode_attention_ref,
        quantized_paged_decode_attention_split_ref,
    )

    N, H, G, D, bs, MB = 5, 2, 2, 8, 4, 8
    P = N * MB + 1
    kc, ks, vc, vs = _quant_pools(name, P, H, bs, D, seed=20 + splits)
    rng = np.random.default_rng(21 + splits)
    q = rng.standard_normal((N, H, G, D)).astype(np.float32)
    tbl = rng.permutation(N * MB).reshape(N, MB).astype(np.int32)
    lens = np.asarray([29, 0, 4, 32, 9], np.int32)
    tbl[np.arange(MB)[None, :] * bs >= lens[:, None]] = P - 1          # garbage past the length
    want = np.asarray(quantized_paged_decode_attention_kernel(
        *map(jnp.asarray, (q, kc, vc, ks, vs, tbl, lens)), decode=j_policy(name).decode,
        interpret=True)).reshape(N, H * G, D)
    args = list(map(torch.from_numpy, (q.reshape(N, H * G, D), kc, vc, ks, vs, tbl, lens)))
    got = quantized_paged_decode_attention_split_ref(*args, splits, policy=t_policy(name))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        got.numpy(), quantized_paged_decode_attention_ref(*args, policy=t_policy(name)).numpy(),
        atol=2e-5, rtol=2e-5)
    assert (got[1] == 0).all()


def test_quantized_update_attention_matches_reference():
    """Quantize-scatter then attend: pools, scales and outputs as the
    reference's ``quantized_paged_update_attention``."""
    from repro.kernels.decode_attention import quantized_paged_update_attention as j_qupdate

    rng = np.random.default_rng(5)
    N, H, G, D, P, bs = 4, 2, 1, 8, 6, 4
    q = rng.standard_normal((N, H * G, D)).astype(np.float32)
    k = rng.standard_normal((N, H, D)).astype(np.float32)
    v = rng.standard_normal((N, H, D)).astype(np.float32)
    wb = np.asarray([1, 1, 3, 5], np.int32)        # two rows into block 1; a garbage row
    wo = np.asarray([0, 1, 2, 0], np.int32)
    tbl = np.asarray([[1, 2], [1, 2], [3, 4], [5, 5]], np.int32)
    lens = np.asarray([1, 2, 3, 0], np.int32)
    pools = [np.zeros((P, H, bs, D), np.int8), np.zeros((P, H, bs, D), np.int8),
             np.full((P, H), 0.5, np.float32), np.full((P, H), 0.5, np.float32)]
    jout = j_qupdate(*map(jnp.asarray, (q, k, v, *pools, wb, wo, tbl, lens)),
                     policy=j_policy("int8"))
    tout = da_ops.quantized_paged_update_attention(
        *map(torch.from_numpy, (q, k, v, *[p.copy() for p in pools], wb, wo, tbl, lens)),
        policy=t_policy("int8"))
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), atol=2e-5, rtol=2e-5)
    for t, j in zip(tout[1:], jout[1:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


DECODE_CASES = [                    # tests/test_kernels.py::DECODE_CASES
    (2, 128, 8, 2, 32, "float32"),
    (1, 96, 4, 4, 16, "float32"),
    (3, 256, 8, 1, 64, "bfloat16"),
    (2, 80, 2, 2, 128, "float32"),      # non-pow2 cache length
]


@pytest.mark.parametrize("B,T,Hq,Hkv,D,dt", DECODE_CASES)
def test_decode_attention_matches_reference(B, T, Hq, Hkv, D, dt):
    rng = np.random.default_rng(B * T + D)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    lengths = rng.integers(1, T + 1, B).astype(np.int32)
    lengths[0] = 0 if B > 1 else lengths[0]          # a length-0 row where B allows
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    want = j_decode_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                              jnp.asarray(lengths), block_kv=32)
    got = da_ops.decode_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                  torch.from_numpy(lengths))
    tol = 3e-2 if dt == "bfloat16" else 3e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)
    if B > 1:
        assert (got[0] == 0).all()                       # length 0: exactly 0
    assert da_ops.decode_attention.launches == 0


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_decode_attention_split_plain_version(G, D, dt):
    """The dense kernel's split over 1-4 CTAs and their merge, in plain
    PyTorch (``decode_attention_split_ref``), against the reference's
    Pallas kernel in interpret mode: lengths 0, 1, T and one that ends
    inside a 16-position tile, T = 72 not a multiple of the tile.  A
    length-0 row is exactly 0, as the reference's kernel gives it."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_split_ref

    B, T, Hkv = 4, 72, 2
    rng = np.random.default_rng(G * 1000 + D)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    lengths = np.array([0, 1, T, 37], np.int32)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    want = np.asarray(j_decode_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                         jnp.asarray(lengths), block_kv=16), np.float32)
    assert (want[0] == 0).all()
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)] + [torch.from_numpy(lengths)]
    assert da_ops.DENSE_TILE_ROWS == 16
    for splits in (1, 2, 3, 4):
        got = decode_attention_split_ref(*args, splits, tile_rows=da_ops.DENSE_TILE_ROWS)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)
        assert (got[0] == 0).all()


@pytest.mark.parametrize("shape,max_length,splits,want", [
    ((8, 16, 1, 64, 256, 2), None, None, (4, 4)),     # m6 decode, plan from T
    ((8, 16, 1, 64, 256, 2), 112, None, (2, 4)),      # ... from the longest length
    ((8, 16, 1, 64, 256, 2), 256, 1, (1, 16)),        # 8 x 256, splits forced
    ((8, 16, 1, 64, 256, 2), 256, 4, (4, 4)),
    ((40, 16, 1, 64, 256, 2), None, None, (1, 10)),   # enough CTAs: no split
    ((3, 16, 1, 64, 1024, 2), None, None, (8, 8)),    # a long cache: the ring wraps
    ((1, 4, 4, 16, 96, 4), None, None, (1, 6)),       # f32, D = 16
])
def test_dense_plan_per_shape(shape, max_length, splits, want):
    """``dense_plan``: ``split_plan`` over 16-position tiles of the dense
    cache, for an H100's 132 SMs."""
    assert da_ops.dense_plan(*shape, sm_count=132, splits=splits,
                             max_length=max_length) == want


def test_dense_wrapper_refuses_layouts_the_copy_engine_does_not_take():
    """TMA takes a contiguous last dim, a 16-byte aligned base and strides
    of multiples of 16 bytes, and no empty tensor: the wrapper raises
    where it would not; a dim of extent 1 may have any stride."""
    q = torch.zeros(2, 4, 16, dtype=torch.bfloat16)
    lens = torch.zeros(2, dtype=torch.int32)
    odd = torch.zeros(2, 40, 3, 20, dtype=torch.bfloat16)[..., :16]      # 40-byte head stride
    with pytest.raises(ValueError, match="16 bytes"):
        da_ops._check_dense(q, odd[:, :, :2], odd[:, :, :2], lens)
    with pytest.raises(ValueError, match="T = 0"):
        empty = torch.zeros(2, 0, 2, 16, dtype=torch.bfloat16)
        da_ops._check_dense(q, empty, empty, lens)
    one = torch.zeros(1, 40, 2, 16, dtype=torch.bfloat16).as_strided((1, 40, 2, 16),
                                                                      (7, 32, 16, 1))
    da_ops._check_dense(q[:1], one, one, lens[:1])
    assert da_ops._map_strides(one) == (40 * 32, 32, 16)


def test_decode_attention_reads_strided_cache():
    """A (B, T, Hkv, D) view with gaps (a slice of a longer cache) gives
    what its contiguous copy gives."""
    rng = np.random.default_rng(9)
    big = torch.from_numpy(rng.standard_normal((2, 40, 3, 16)).astype(np.float32))
    k, v = big[:, :32, :2], big[:, 8:, 1:]
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    lens = torch.tensor([32, 7], dtype=torch.int32)
    np.testing.assert_array_equal(
        da_ops.decode_attention(q, k, v, lens).numpy(),
        da_ops.decode_attention(q, k.contiguous(), v.contiguous(), lens).numpy())


@pytest.mark.parametrize("name,argtypes", [
    ("quantized_paged_decode_attention", da_ops._QUANT_ARGTYPES),
    ("decode_attention", da_ops._DENSE_ARGTYPES)])
def test_ctypes_signatures_match_c_sources(name, argtypes):
    """The wrappers' ctypes argtypes mirror the extern "C" signatures:
    pointers for pointers and the stream, 64-bit ints for the strides, a
    float for the dense kernel's softcap."""
    import ctypes
    import re

    from repro_torch.kernels import build

    src = build.SOURCES[name].read_text()
    sig = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src).group(1)
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_longlong if "long long" in p
             else ctypes.c_float if p.startswith("float ") else ctypes.c_int
             for p in (p.strip() for p in sig.split(","))]
    assert argtypes == kinds


def test_wrapper_checks_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(4, 16, 64, dtype=torch.bfloat16)
    codes = torch.zeros(9, 16, 16, 64, dtype=torch.int8)
    sc = torch.zeros(9, 16)
    tbl, lens = torch.zeros(4, 3, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)
    int8 = t_policy("int8")
    da_ops._check_quantized(q, codes, codes, sc, sc, tbl, lens, int8)
    with pytest.raises(ValueError, match="G in"):
        da_ops._check_quantized(q[:, :, :48].contiguous(), codes[..., :48].contiguous(),
                                codes[..., :48].contiguous(), sc, sc, tbl, lens, int8)
    with pytest.raises(TypeError, match="int8"):
        da_ops._check_quantized(q, codes.float(), codes, sc, sc, tbl, lens, int8)
    with pytest.raises(ValueError, match="scales"):
        da_ops._check_quantized(q, codes, codes, sc[:, :2], sc, tbl, lens, int8)
    with pytest.raises(ValueError, match="no kernel"):
        da_ops._check_quantized(q, codes, codes, sc, sc, tbl, lens, t_policy("none"))
    k = torch.zeros(4, 80, 2, 16, dtype=torch.bfloat16)
    da_ops._check_dense(q[:, :8, :16].contiguous(), k, k, lens)
    with pytest.raises(ValueError, match="D in"):
        da_ops._check_dense(q[:, :8, :8].contiguous(), k[..., :8], k[..., :8], lens)
    q16 = q[:, :8, :16].contiguous()
    for bad in (torch.zeros(4, 80, 16, 2, dtype=torch.bfloat16).transpose(2, 3),
                torch.zeros(4 * 80 * 2 * 16 + 1, dtype=torch.bfloat16)[1:].view(4, 80, 2, 16)):
        with pytest.raises(ValueError, match="strides"):
            da_ops._check_dense(q16, bad, k, lens)
    with pytest.raises(ValueError, match="no kernel"):
        da_ops.decode_attention(elsewhere(q), k, k, lens)


def _tiny_cfgs(**kw):
    base = dict(name="t", family="decoder_lm", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=128, max_seq_len=128, dtype="float32")
    base.update(kw)
    return JModelConfig(**base), TModelConfig(**base)


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("name", POLICIES)
def test_quantized_cache_pools_and_block_bytes(prefix, name):
    jcfg, tcfg = _tiny_cfgs()
    kw = dict(max_slots=4, kv_block_size=4, max_len=64, num_blocks=16,
              prefix_cache=prefix, kv_quant=name)
    jc = (JQPCache if prefix else JQCache)(jcfg, JServeConfig(**kw))
    tc = (TQPCache if prefix else TQCache)(tcfg, TServeConfig(**kw), device="cpu")
    assert tc.block_bytes == jc.block_bytes
    assert tc.occupancy() == jc.occupancy()
    assert tuple(tc.k_pool.shape) == tuple(jc.k_pool.shape) and tc.k_pool.dtype == torch.int8
    assert tuple(tc.k_scales.shape) == tuple(jc.k_scales.shape) == (2, 17, 2)
    tc.check_conservation()


def test_m6_base_block_bytes():
    """The m6-base figures the capacity check on the card relies on:
    bf16 327,680 B a block, int8 with scales 164,480 B."""
    from repro_torch.configs.m6 import M6_BASE
    from repro_torch.serving.kv_cache import PagedKVCache

    kw = dict(kv_block_size=16, max_slots=1, max_len=16, num_blocks=1)
    assert PagedKVCache(M6_BASE, TServeConfig(**kw), device="meta").block_bytes == 327_680
    assert TQCache(M6_BASE, TServeConfig(kv_quant="int8", **kw),
                   device="meta").block_bytes == 164_480
