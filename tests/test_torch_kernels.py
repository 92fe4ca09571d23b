"""The port's kernel modules against the JAX reference on the CPU.

Here the wrappers run their plain PyTorch versions (CPU tensors); the CUDA
kernels themselves are held to those plain versions on the card by
``chip_smoke.py``.  Inputs come from numpy seeds and go to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.kernels.decode_attention import paged_update_attention as j_update
from repro.kernels.decode_attention.ref import paged_decode_attention_ref as j_pda_ref
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.moe_dropless.kernel import ragged_ffn_kernel
from repro.kernels.moe_dropless.ops import padded_rows as j_padded_rows
from repro.kernels.moe_dropless.ops import pick_block_rows as j_pick
from repro.kernels.moe_dropless.ops import ragged_ffn as j_ragged_ffn
from repro.kernels.moe_dropless.ref import ragged_ffn_ref as j_ragged_ref
from repro.kernels.moe_ffn.ops import moe_ffn as j_moe_ffn
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ops as pda_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.moe_dropless import ops as rffn_ops
from repro_torch.kernels.moe_ffn import ops as moe_ops

TOL = 2e-5


def _paged_case(N, Hkv, G, D, bs, MB, lengths, seed=0):
    """Random pools with a garbage block (last), shuffled block tables;
    unused table entries point at the garbage block."""
    rng = np.random.default_rng(seed)
    P = N * MB + 1
    garbage = P - 1
    k_pool = rng.standard_normal((P, Hkv, bs, D)).astype(np.float32)
    v_pool = rng.standard_normal((P, Hkv, bs, D)).astype(np.float32)
    perm = rng.permutation(N * MB).reshape(N, MB).astype(np.int32)
    tables = np.full((N, MB), garbage, np.int32)
    for i, L in enumerate(lengths):
        nb = -(-L // bs)
        tables[i, :nb] = perm[i, :nb]
    q = rng.standard_normal((N, Hkv * G, D)).astype(np.float32)
    return q, k_pool, v_pool, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("G", [1, 4])
def test_paged_decode_attention_matches_reference(G):
    # length 0, one full table, lengths ending mid-block and on a boundary
    lengths = [0, 32, 5, 17, 16, 1]
    q, kp, vp, tbl, lens = _paged_case(6, 2, G, 16, 8, 4, lengths, seed=G)
    want = np.asarray(j_pda_ref(*map(jnp.asarray, (q, kp, vp, tbl, lens))))
    got = pda_ops.paged_decode_attention(*map(torch.from_numpy, (q, kp, vp, tbl, lens)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert (got[0] == 0).all()                       # length 0: exactly 0
    assert pda_ops.paged_decode_attention.launches == 0   # CPU: no kernel


def test_paged_decode_attention_ignores_garbage_block():
    """Whatever the garbage block holds never reaches a live row."""
    q, kp, vp, tbl, lens = _paged_case(3, 2, 2, 16, 8, 4, [9, 0, 30], seed=7)
    base = pda_ops.paged_decode_attention(*map(torch.from_numpy, (q, kp, vp, tbl, lens)))
    kp[-1], vp[-1] = 1e4, -1e4
    poked = pda_ops.paged_decode_attention(*map(torch.from_numpy, (q, kp, vp, tbl, lens)))
    np.testing.assert_array_equal(base.numpy(), poked.numpy())


def test_paged_update_attention_write_then_read():
    """Write this step's K/V (chunk rows of one slot plus a decode row
    and a masked row), then attend: pools and outputs match the reference."""
    rng = np.random.default_rng(11)
    Hkv, G, D, bs, MB = 2, 2, 16, 4, 4
    q, kp, vp, _, _ = _paged_case(4, Hkv, G, D, bs, MB, [0] * 4, seed=12)
    P = kp.shape[0]
    garbage = P - 1
    tbl = np.full((4, MB), garbage, np.int32)
    tbl[0:2] = [3, 9, garbage, garbage]      # slot A: chunk rows at positions 5, 6
    tbl[2] = [1, garbage, garbage, garbage]  # slot B: decode row at position 2
    wb = np.array([9, 9, 1, garbage], np.int32)
    wo = np.array([1, 2, 2, 0], np.int32)
    lengths = np.array([6, 7, 3, 0], np.int32)
    k = rng.standard_normal((4, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((4, Hkv, D)).astype(np.float32)

    jout, jk, jv = j_update(*map(jnp.asarray, (q, k, v, kp, vp, wb, wo, tbl, lengths)))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tout, tk2, tv2 = pda_ops.paged_update_attention(
        *map(torch.from_numpy, (q, k, v)), tk, tv,
        *map(torch.from_numpy, (wb, wo, tbl, lengths)))
    assert tk2 is tk and tv2 is tv               # updated in place
    live = slice(0, 3)                           # the garbage block's content is unspecified
    np.testing.assert_array_equal(tk.numpy()[:garbage], np.asarray(jk)[:garbage])
    np.testing.assert_array_equal(tv.numpy()[:garbage], np.asarray(jv)[:garbage])
    np.testing.assert_allclose(tout.numpy()[live], np.asarray(jout)[live], atol=TOL, rtol=TOL)
    assert (tout[3] == 0).all()


RAGGED_CASES = [
    # (E, NB, bx, M, I, act, dtype) — the reference's kernel sweep
    (4, 6, 8, 32, 48, "swiglu", np.float32),
    (2, 4, 16, 64, 96, "gelu", np.float32),
    (3, 5, 8, 16, 40, "relu", np.float32),
    (8, 8, 8, 64, 64, "swiglu", "bfloat16"),
]


@pytest.mark.parametrize("E,NB,bx,M,I,act,dt", RAGGED_CASES)
def test_ragged_ffn_matches_reference_and_pallas_kernel(E, NB, bx, M, I, act, dt):
    rng = np.random.default_rng(E * NB + I)
    x = rng.standard_normal((NB * bx, M)).astype(np.float32)
    wu = (rng.standard_normal((E, M, I)) * 0.1).astype(np.float32)
    wg = (rng.standard_normal((E, M, I)) * 0.1).astype(np.float32) if act == "swiglu" else None
    wd = (rng.standard_normal((E, I, M)) * 0.1).astype(np.float32)
    be = rng.integers(0, E, NB).astype(np.int32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dt == "bfloat16" else (jnp.float32, torch.float32)
    tol = 2e-2 if dt == "bfloat16" else TOL

    def j(a):
        return None if a is None else jnp.asarray(a).astype(jdt)

    def t(a):
        return None if a is None else torch.from_numpy(a).to(tdt)

    bi = I
    while bi > 1 and I % bi:
        bi //= 2
    want = np.asarray(j_ragged_ref(j(x), jnp.asarray(be), j(wu), j(wg), j(wd), act), np.float32)
    pallas = np.asarray(ragged_ffn_kernel(j(x), jnp.asarray(be), j(wu), j(wg), j(wd), act,
                                          block_x=bx, block_i=bi, interpret=True), np.float32)
    got = rffn_ops.ragged_ffn(t(x), torch.from_numpy(be), t(wu), t(wg), t(wd), act,
                              block_x=bx).float().numpy()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)


@pytest.mark.parametrize("n", [1, 7, 8, 40, 64, 255, 256, 1000, 4096, 65536])
@pytest.mark.parametrize("E", [1, 4, 8, 32, 128])
def test_block_rows_rules_match_reference(n, E):
    for max_block in (8, 64, 128):
        assert rffn_ops.pick_block_rows(n, E, max_block) == j_pick(n, E, max_block)
        bx = j_pick(n, E, max_block)
        assert rffn_ops.padded_rows(n, E, bx) == j_padded_rows(n, E, bx)


def test_m6_base_step_layouts():
    """The layouts this slice's decode (8) and mixed (40) steps run."""
    assert rffn_ops.pick_block_rows(8, 32) == rffn_ops.pick_block_rows(40, 32) == 8
    assert rffn_ops.padded_rows(8, 32, 8) == 232
    assert rffn_ops.padded_rows(40, 32, 8) == 264


def test_cuda_argument_checks():
    """The checks that guard a kernel launch, exercised on CPU tensors."""
    bf = torch.bfloat16
    x = torch.zeros(16, 64, dtype=bf)
    wu, wd = torch.zeros(2, 64, 96, dtype=bf), torch.zeros(2, 96, 64, dtype=bf)
    be = torch.zeros(2, dtype=torch.int32)
    rffn_ops._check(x, be, wu, None, wd, 8)
    with pytest.raises(ValueError, match="multiples of 8"):
        rffn_ops._check(x, be, wu, None, wd, 4)
    with pytest.raises(TypeError):
        rffn_ops._check(x, be.long(), wu, None, wd, 8)
    with pytest.raises(TypeError):
        rffn_ops._check(x.float(), be, wu, None, wd, 8)
    with pytest.raises(ValueError, match="contiguous"):
        rffn_ops._check(x, be, wu.transpose(1, 2).contiguous().transpose(1, 2), None, wd, 8)

    q = torch.zeros(4, 16, 64, dtype=bf)
    pool = torch.zeros(9, 4, 16, 64, dtype=bf)
    tbl, lens = torch.zeros(4, 3, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)
    pda_ops._check(q, pool, pool, tbl, lens)
    with pytest.raises(ValueError, match="G in"):
        pda_ops._check(torch.zeros(4, 12, 64, dtype=bf), pool[:, :1], pool[:, :1], tbl, lens)
    with pytest.raises(TypeError):
        pda_ops._check(q, pool, pool, tbl.long(), lens)
    with pytest.raises(ValueError, match="block_tables"):
        pda_ops._check(q, pool, pool, tbl[:3], lens)
    with pytest.raises(ValueError, match="no kernel"):
        pda_ops.paged_decode_attention(q.to("meta"), pool, pool, tbl, lens)


def test_build_keys_libraries_by_source_and_needs_nvcc(tmp_path, monkeypatch):
    a, b = build.library_path("ragged_ffn"), build.library_path("paged_decode_attention")
    assert a != b and a.parent == build.BUILD_DIR and a.suffix == ".so"
    assert build.library_path("ragged_ffn") == a                  # stable key
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "Path", lambda p: tmp_path / "no-such-nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["ragged_ffn"])


@pytest.mark.parametrize("ops,name", [(pda_ops, "paged_decode_attention"),
                                      (rffn_ops, "ragged_ffn"), (moe_ops, "moe_ffn"),
                                      (flash_ops, "flash_attention")])
def test_ctypes_signature_matches_c_source(ops, name):
    """The wrapper's ctypes argtypes mirror the extern "C" signature:
    ints for ints, pointers for pointers and the stream."""
    import ctypes
    import re

    src = build.SOURCES[name].read_text()
    sig = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src).group(1)
    params = [p.strip() for p in sig.split(",")]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert ops._ARGTYPES == kinds


def _grad_case(shapes, seed, dt, scale=0.1):
    """numpy f32 arrays for ``shapes`` (those after the first times
    ``scale``), and their JAX and torch casts to ``dt``."""
    rng = np.random.default_rng(seed)
    arrs = [None if sh is None else (rng.standard_normal(sh) * (1 if i == 0 else scale)
                                     ).astype(np.float32) for i, sh in enumerate(shapes)]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dt == "bfloat16" else (jnp.float32, torch.float32)
    j = [None if a is None else jnp.asarray(a).astype(jdt) for a in arrs]
    t = [None if a is None else torch.from_numpy(a).to(tdt) for a in arrs]
    return j, t


def _grad_tol(a, dt):
    """Gradients: 1e-4 of the largest entry in f32 (the reference's own
    backend-equivalence tolerance), 2e-2 of it in bf16."""
    return (2e-2 if dt == "bfloat16" else 1e-4) * max(float(np.abs(a).max()), 1e-9)


# (E, X, M, I, act, dtype): the reference's tests/test_kernels.py MOE_CASES
MOE_CASES = [
    (4, 64, 32, 48, "swiglu", "float32"),
    (2, 100, 64, 96, "gelu", "float32"),        # X not a multiple of 8
    (3, 128, 128, 256, "swiglu", "bfloat16"),
    (1, 8, 16, 512, "relu", "float32"),
    (8, 32, 64, 64, "swiglu", "bfloat16"),
    (2, 256, 32, 40, "gelu", "float32"),         # I not a power of two
]


@pytest.mark.parametrize("E,X,M,I,act,dt", MOE_CASES)
def test_moe_ffn_matches_reference_kernel_and_vjp(E, X, M, I, act, dt):
    """The wrapper's plain path against the reference's ``moe_ffn`` (its
    Pallas kernel in interpret mode), forward at the reference's kernel
    tolerance (f32 2e-5, bf16 2e-2), and the gradients of x and every
    weight through the port's autograd Function against the reference's
    ``custom_vjp``."""
    gated = act == "swiglu"
    (jx, ju, jg, jd), (tx, tu, tg, td) = _grad_case(
        [(E, X, M), (E, M, I), (E, M, I) if gated else None, (E, I, M)], E * X + I, dt)
    tol = 2e-2 if dt == "bfloat16" else TOL
    want = j_moe_ffn(jx, ju, jg, jd, act)
    leaves = [t.requires_grad_(True) for t in (tx, tu, tg, td) if t is not None]
    got = moe_ops.moe_ffn(tx, tu, tg, td, act)
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    assert moe_ops.moe_ffn.launches == 0                 # CPU: no kernel

    w = np.random.default_rng(1).standard_normal((E, X, M)).astype(np.float32)
    jw = jnp.asarray(w).astype(jx.dtype)
    argnums = (0, 1, 2, 3) if gated else (0, 1, 3)
    jgrads = jax.grad(lambda *a: jnp.sum((j_moe_ffn(*a, act) * jw).astype(jnp.float32)),
                      argnums=argnums)(jx, ju, jg, jd)
    tgrads = torch.autograd.grad((got * torch.from_numpy(w).to(got.dtype)).float().sum(),
                                 leaves)
    for a, b in zip(jgrads, tgrads):
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(b.float().numpy(), a, atol=_grad_tol(a, dt), rtol=0)


@pytest.mark.parametrize("E,NB,bx,M,I,act,dt", RAGGED_CASES)
def test_ragged_ffn_gradients_match_reference_vjp(E, NB, bx, M, I, act, dt):
    """The ragged FFN's autograd Function (its backward differentiates the
    plain version) against the reference's ``custom_vjp``; block_expert
    gets no gradient."""
    gated = act == "swiglu"
    (jx, ju, jg, jd), (tx, tu, tg, td) = _grad_case(
        [(NB * bx, M), (E, M, I), (E, M, I) if gated else None, (E, I, M)], E + I, dt)
    be = np.random.default_rng(E).integers(0, E, NB).astype(np.int32)
    w = np.random.default_rng(2).standard_normal((NB * bx, M)).astype(np.float32)
    argnums = (0, 2, 3, 4) if gated else (0, 2, 4)
    jgrads = jax.grad(
        lambda x, b, u, g, d: jnp.sum((j_ragged_ffn(x, b, u, g, d, act, block_x=bx)
                                       * jnp.asarray(w).astype(x.dtype)).astype(jnp.float32)),
        argnums=argnums)(jx, jnp.asarray(be), ju, jg, jd)
    leaves = [t.requires_grad_(True) for t in (tx, tu, tg, td) if t is not None]
    y = rffn_ops.ragged_ffn(tx, torch.from_numpy(be), tu, tg, td, act, block_x=bx)
    tgrads = torch.autograd.grad((y * torch.from_numpy(w).to(y.dtype)).float().sum(), leaves)
    for a, b in zip(jgrads, tgrads):
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(b.float().numpy(), a, atol=_grad_tol(a, dt), rtol=0)


# (B, S, Hq, Hkv, D, causal, dtype): the reference's FLASH_CASES
FLASH_CASES = [
    (2, 128, 4, 2, 32, True, "float32"),
    (1, 96, 8, 8, 16, True, "float32"),
    (2, 64, 4, 1, 64, False, "float32"),
    (1, 256, 4, 2, 32, True, "bfloat16"),
    (1, 80, 2, 2, 128, True, "float32"),         # S not a power of two
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,dt", FLASH_CASES)
def test_flash_attention_matches_reference_kernel(B, S, Hq, Hkv, D, causal, dt):
    """The wrapper's plain path against the reference's ``flash_attention``
    (its Pallas kernel in interpret mode), at the reference's own flash
    tolerance: f32 3e-5, bf16 3e-2 (``tests/test_kernels.py``)."""
    (jq, jk, jv), (tq, tk, tv) = _grad_case(
        [(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)], B * S + D, dt, scale=1.0)
    want = j_flash(jq, jk, jv, causal=causal, block_q=64, block_kv=32)
    got = flash_ops.flash_attention(tq, tk, tv, causal=causal)
    tol = 3e-2 if dt == "bfloat16" else 3e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)
    assert flash_ops.flash_attention.launches == 0


def test_flash_attention_refuses_gradients_and_checks_arguments():
    q = torch.zeros(1, 8, 2, 16, requires_grad=True)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_ops.flash_attention(q, k, k)
    with torch.no_grad():
        flash_ops.flash_attention(q, k, k)
    flash_ops._check(q, k, k)
    with pytest.raises(ValueError, match="D in"):
        flash_ops._check(torch.zeros(1, 8, 2, 24), torch.zeros(1, 8, 2, 24),
                         torch.zeros(1, 8, 2, 24))
    with pytest.raises(TypeError):
        flash_ops._check(q, k.double(), k)
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops._check(q, k.transpose(1, 2).contiguous().transpose(1, 2), k)
    with pytest.raises(ValueError, match="no kernel"), torch.no_grad():
        flash_ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))

    x = torch.zeros(2, 45, 64, dtype=torch.bfloat16)
    wu, wd = torch.zeros(2, 64, 40, dtype=torch.bfloat16), torch.zeros(2, 40, 64, dtype=torch.bfloat16)
    moe_ops._check(x, wu, None, wd)                       # X = 45, I = 40: taken as they are
    with pytest.raises(ValueError, match="do not fit"):
        moe_ops._check(x, wu, None, wd[:, :, :32])
    with pytest.raises(TypeError):
        moe_ops._check(x.float(), wu, None, wd)
    with pytest.raises(ValueError, match="no kernel"):
        moe_ops.moe_ffn(x.to("meta"), wu.to("meta"), None, wd.to("meta"), "gelu")
