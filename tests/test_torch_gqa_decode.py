"""The decode attention wrappers at GQA groups of 3 and 5 against the JAX
reference on the CPU.

granite-moe-3b-a800m has G = 24 / 8 = 3, qwen2.5-32b and qwen3-14b have
G = 40 / 8 = 5.  The reference's Pallas kernels take any G (a (1, 1, G, D)
block); the port's three wrappers, their plain versions and the split
plain versions are held to them here, the reference's kernels in
interpret mode as its own tests run them.  Tolerances: 2e-5 f32 for the
paged and quantized kernels, 3e-5 f32 / 3e-2 bf16 for dense decode (the
reference's own, tests/test_kernels.py), 2e-2 for the split versions in
bf16.  On the card the same wrappers launch the CUDA kernels, which
``chip_smoke.py`` phase 3 holds against these plain versions.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import (
    paged_decode_attention_kernel as j_paged,
    quantized_paged_decode_attention_kernel as j_quant,
)
from repro.kernels.decode_attention.ops import decode_attention as j_dense
from repro.quant import get_kv_quant as j_policy
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.quant import get_kv_quant as t_policy
from torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "kernels" / "csrc"


def _paged(N, Hkv, G, D, bs, MB, lengths, seed):
    """q (N, Hkv*G, D), pools (P, Hkv, bs, D) of a permuted block table,
    blocks past each length pointing at a garbage block of 1e4."""
    rng = np.random.default_rng(seed)
    P = N * MB + 1
    q = rng.standard_normal((N, Hkv * G, D)).astype(np.float32)
    kp = rng.standard_normal((P, Hkv, bs, D)).astype(np.float32)
    vp = rng.standard_normal((P, Hkv, bs, D)).astype(np.float32)
    kp[P - 1] = vp[P - 1] = 1e4
    tbl = rng.permutation(N * MB).reshape(N, MB).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    tbl[np.arange(MB)[None, :] * bs >= lens[:, None]] = P - 1
    return q, kp, vp, tbl, lens


@pytest.mark.parametrize("G,D", [(3, 64), (5, 128), (3, 32), (5, 64)])
def test_paged_wrapper_matches_reference_kernel(G, D):
    """The paged wrapper (its plain version on the CPU) and its split plain
    version at splits 1, 2, 4, 8 against the reference's Pallas kernel:
    rows longer and shorter than the splits, lengths ending mid-block and
    on a boundary, a length-0 row exactly 0."""
    N, Hkv, bs, MB = 6, 2, 8, 6
    lengths = [0, 45, 3, 16, 8, 1]
    q, kp, vp, tbl, lens = _paged(N, Hkv, G, D, bs, MB, lengths, seed=G * 100 + D)
    want = np.asarray(j_paged(jnp.asarray(q.reshape(N, Hkv, G, D)), jnp.asarray(kp),
                              jnp.asarray(vp), jnp.asarray(tbl), jnp.asarray(lens),
                              interpret=True)).reshape(N, Hkv * G, D)
    args = list(map(torch.from_numpy, (q, kp, vp, tbl, lens)))
    got = da.paged_decode_attention(*args)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert (got[0] == 0).all()
    for splits in da.SPLITS:
        split = da_ref.paged_decode_attention_split_ref(*args, splits)
        np.testing.assert_allclose(split.numpy(), want, atol=2e-5, rtol=2e-5)
        assert (split[0] == 0).all()
    assert da.paged_decode_attention.launches == 0            # CPU: no kernel


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("G,D", [(3, 64), (5, 128)])
def test_quantized_wrapper_matches_reference_kernel(G, D, name):
    """The quantized paged wrapper over int8 / fp8 codes with per-(block,
    head) scales, and its split plain version, against the reference's
    quantized Pallas kernel."""
    N, Hkv, bs, MB = 5, 2, 8, 5
    q, kp, vp, tbl, lens = _paged(N, Hkv, G, D, bs, MB, [37, 0, 8, 19, 2], seed=G + D)
    jpol, tpol = j_policy(name), t_policy(name)
    rng = np.random.default_rng(G * D)
    ks = (np.abs(rng.standard_normal(kp.shape[:2])) * 0.05 + 0.01).astype(np.float32)
    vs = (np.abs(rng.standard_normal(kp.shape[:2])) * 0.05 + 0.01).astype(np.float32)
    kc = np.asarray(jpol.encode(jnp.asarray(kp / ks[:, :, None, None] * 0.01)))
    vc = np.asarray(jpol.encode(jnp.asarray(vp / vs[:, :, None, None] * 0.01)))
    want = np.asarray(j_quant(*map(jnp.asarray, (q.reshape(N, Hkv, G, D), kc, vc, ks, vs, tbl,
                                                 lens)),
                              decode=jpol.decode, interpret=True)).reshape(N, Hkv * G, D)
    args = list(map(torch.from_numpy, (q, kc, vc, ks, vs, tbl, lens)))
    got = da.quantized_paged_decode_attention(*args, policy=tpol)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert (got[1] == 0).all()
    for splits in (2, 8):
        split = da_ref.quantized_paged_decode_attention_split_ref(*args, splits, policy=tpol)
        np.testing.assert_allclose(split.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,D", [(3, 64), (5, 128), (3, 16)])
def test_dense_wrapper_matches_reference_kernel(G, D, dt):
    """The dense-cache wrapper and its split plain version (splits 1-4,
    16-position tiles) against the reference's dense Pallas kernel: lengths
    0, 1, T and one ending inside a tile, T = 72 not a multiple of 16."""
    B, T, Hkv = 4, 72, 2
    rng = np.random.default_rng(G * 10 + D)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    lengths = np.array([0, 1, T, 37], np.int32)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    want = np.asarray(j_dense(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(lengths),
                              block_kv=16), np.float32)
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)] + [torch.from_numpy(lengths)]
    got = da.decode_attention(*args)
    tol = 3e-2 if dt == "bfloat16" else 3e-5
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)
    assert (got[0] == 0).all()
    for splits in (1, 2, 3, 4):
        split = da_ref.decode_attention_split_ref(*args, splits, tile_rows=da.DENSE_TILE_ROWS)
        np.testing.assert_allclose(split.float().numpy(), want, atol=2e-2, rtol=2e-2)
        assert (split[0] == 0).all()


def _launch_groups() -> set:
    src = (CSRC / "decode_sm90.cuh").read_text()
    body = src[src.index("switch (a.G)"):]
    body = body[:body.index("default:")]
    return {int(g) for g in re.findall(r"case (\d+): return launch_g<TQ, Fmt, Tiles, \1>", body)}


def test_wrapper_groups_are_the_kernels_instantiations():
    """The wrappers' GROUPS are the G the C launch switch instantiates, 3
    and 5 among them beside the earlier 1, 2, 4, 8."""
    assert set(da.GROUPS) == _launch_groups() == {1, 2, 3, 4, 5, 8}


def _vec_elems(elem_bytes: int, G: int, D: int) -> int:
    """decode_common.cuh::vec_elems, as written there."""
    floor_pow2 = 1 << ((32 // G).bit_length() - 1)
    return min(16 // elem_bytes, floor_pow2, D)


@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("elem_bytes", [1, 2, 4])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_vector_width_is_a_power_of_two_that_divides_d(G, elem_bytes, D):
    """VEC (elements a lane loads) is a power of two dividing D, a 4-, 8-
    or 16-byte load (load_vec's static_assert), and D / VEC lanes divide a
    warp; the earlier groups keep their width (32 / G was a power of two),
    so their plans do not move."""
    vec = _vec_elems(elem_bytes, G, D)
    assert vec & (vec - 1) == 0 and D % vec == 0 and 32 % (D // vec) == 0
    assert vec * elem_bytes in (4, 8, 16)
    assert vec * G <= 32
    if G in (1, 2, 4, 8):
        assert vec == min(16 // elem_bytes, 32 // G, D)
    rows = da._rows_per_pass(D, G, elem_bytes)
    assert rows == 2 * 4 * (32 // (D // vec))
    text = (CSRC / "decode_common.cuh").read_text()
    assert "floor_pow2(32 / G)" in text


@pytest.mark.parametrize("shape,want", [
    # (N, Hkv, G, D, bs, MB, elem bytes, splits, longest) -> (splits, stages)
    ((8, 8, 3, 64, 16, 16, 2, None, 112), (2, 4)),      # granite decode, bf16 pools
    ((8, 8, 5, 128, 16, 16, 1, None, 112), (8, 1)),     # qwen2.5-32b, int8: 8 rows a pass
    ((8, 8, 5, 128, 16, 16, 2, 8, None), (8, 2)),       # forced 8-way split
    ((40, 8, 3, 64, 16, 16, 2, None, 112), (1, 7)),     # a mixed step: no split
])
def test_split_plan_at_groups_of_3_and_5(shape, want):
    """split_plan at the new groups: the merge's slot of each rank is
    (2 G + G D) f32 (decode_sm90.cuh), and the launch's shared memory (the
    stages, the warps' states, the merge) fits an SM beside its neighbours."""
    *dims, forced, longest = shape
    splits, stages = da.split_plan(*dims, sm_count=132, splits=forced, max_length=longest)
    assert (splits, stages) == want
    N, Hkv, G, D, bs, MB, eb = dims
    slot = (2 * G + G * D) * 4
    assert da._merge_bytes(G, D, splits) == 4 * G * (D + 2) * 4 + 8 + (
        splits * slot if splits > 1 else 0)
    per_sm = -(-N * Hkv * splits // 132)
    smem = stages * da._stage_bytes(bs, D, eb) + da._merge_bytes(G, D, splits) + 1024
    assert smem * per_sm <= da.SMEM_PER_SM


@pytest.mark.parametrize("G", [3, 5])
def test_wrapper_checks_take_groups_of_3_and_5(G):
    """The three wrappers' argument checks accept G = 3 and 5 (the CUDA
    launch follows them on the card) and still refuse a G the kernels are
    not built for."""
    q, kp, vp, tbl, lens = map(torch.from_numpy, _paged(2, 2, G, 64, 16, 2, [5, 9], seed=G))
    da._check(q, kp, vp, tbl, lens)
    pol = t_policy("int8")
    codes = kp.to(torch.int8)
    scales = torch.ones(kp.shape[:2])
    da._check_quantized(q, codes, codes, scales, scales, tbl, lens, pol)
    k = torch.zeros(2, 32, 2, 64)
    da._check_dense(q, k, k, lens)
    bad = torch.zeros(2, 12, 64)                          # G = 6
    with pytest.raises(ValueError, match="G in"):
        da._check(bad, kp, vp, tbl, lens)
    with pytest.raises(ValueError, match="G in"):
        da._check_dense(bad, k, k, lens)
