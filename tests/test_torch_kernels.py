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
from repro.kernels.decode_attention.kernel import paged_decode_attention_kernel as j_pda_kernel
from repro.kernels.decode_attention.ref import paged_decode_attention_ref as j_pda_ref
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.moe_dropless.kernel import ragged_ffn_kernel
from repro.kernels.moe_dropless.ops import padded_rows as j_padded_rows
from repro.kernels.moe_dropless.ops import pick_block_rows as j_pick
from repro.kernels.moe_dropless.ops import ragged_ffn as j_ragged_ffn
from repro.kernels.moe_dropless.ref import ragged_ffn_ref as j_ragged_ref
from repro.kernels.moe_ffn.ops import moe_ffn as j_moe_ffn
from repro_torch.kernels import build, common
from repro_torch.kernels.decode_attention import ops as pda_ops
from repro_torch.kernels.decode_attention import ref as pda_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.moe_dropless import ops as rffn_ops
from repro_torch.kernels.moe_dropless import ref as rag_ref
from repro_torch.kernels.moe_ffn import ops as moe_ops
from repro_torch.kernels.moe_ffn import ref as moe_ref
from torch_elsewhere import elsewhere
from torch_threads import one_torch_thread  # noqa: F401

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
        pda_ops.paged_decode_attention(elsewhere(q), pool, pool, tbl, lens)


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
                                      (flash_ops, "flash_attention"),
                                      (rffn_ops, "ragged_ffn_tc"), (moe_ops, "moe_ffn_tc"),
                                      (flash_ops, "flash_attention_tc")])
def test_ctypes_signature_matches_c_source(ops, name):
    """The wrapper's ctypes argtypes mirror the extern "C" signature:
    ints for ints, pointers for pointers and the stream.  ``*_tc`` is the
    tensor-core entry point of the same library."""
    import ctypes
    import re

    tc = name.endswith("_tc")
    src = build.SOURCES[name.removesuffix("_tc")].read_text()
    sig = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src).group(1)
    params = [p.strip() for p in sig.split(",")]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert (ops._TC_ARGTYPES if tc else ops._ARGTYPES) == kinds


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
        flash_ops.flash_attention(elsewhere(q), elsewhere(k), elsewhere(k))

    x = torch.zeros(2, 45, 64, dtype=torch.bfloat16)
    wu, wd = torch.zeros(2, 64, 40, dtype=torch.bfloat16), torch.zeros(2, 40, 64, dtype=torch.bfloat16)
    moe_ops._check(x, wu, None, wd)                       # X = 45, I = 40: taken as they are
    with pytest.raises(ValueError, match="do not fit"):
        moe_ops._check(x, wu, None, wd[:, :, :32])
    with pytest.raises(TypeError):
        moe_ops._check(x.float(), wu, None, wd)
    with pytest.raises(ValueError, match="no kernel"):
        moe_ops.moe_ffn(elsewhere(x), elsewhere(wu), None, elsewhere(wd), "gelu")


# (kind, E, rows, M, I, act, dtype, route): rows is X for "moe" and the block
# rows bx for "ragged"; route is None for the CUDA-core device code, else
# the (n, tiles) wgmma tiles of each group.
ROUTE_CASES = (
    [("moe", E, X, M, I, act, dt, None if dt != "bfloat16" else want)
     for (E, X, M, I, act, dt), want in zip(MOE_CASES, [None, None, (128, 1), None, (32, 1), None])]
    + [("ragged", E, bx, M, I, act, dt, None if dt != "bfloat16" else (8, 1))
       for E, NB, bx, M, I, act, dt in RAGGED_CASES]
    + [("moe", 32, 45, 1024, 4096, "gelu", "bfloat16", (48, 1)),       # m6 top-1, C = 45
       ("moe", 32, 180, 1024, 4096, "gelu", "bfloat16", (192, 1)),     # m6 4 top-1, C = 180
       ("ragged", 32, rffn_ops.pick_block_rows(8, 32), 1024, 4096, "gelu", "bfloat16", (8, 1)),
       ("ragged", 32, rffn_ops.pick_block_rows(40, 32), 1024, 4096, "gelu", "bfloat16", (8, 1)),
       ("moe", 2, 100, 64, 96, "gelu", "bfloat16", (128, 1)),
       ("moe", 3, 13, 128, 44, "relu", "bfloat16", None),               # I % 8: rows unaligned
       ("moe", 2, 300, 64, 128, "gelu", "bfloat16", (192, 2)),
       ("moe", 4, 300, 64, 128, "swiglu", "bfloat16", (128, 3)),
       ("ragged", 8, 128, 512, 1024, "swiglu", "bfloat16", (128, 1)),
       ("ragged", 8, 256, 64, 64, "gelu", "bfloat16", (128, 2))]
)


@pytest.mark.parametrize("kind,E,rows,M,I,act,dt,want", ROUTE_CASES)
def test_grouped_ffn_route_and_tile_rows(kind, E, rows, M, I, act, dt, want):
    """Which device code each shape takes (f32 and widths that are not
    multiples of 8 the CUDA cores, bf16 otherwise the tensor cores, every
    m6 shape among them) and the wgmma tile width N chosen for each group;
    the wrappers' argument checks accept the shape."""
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    gated = act == "swiglu"
    assert common.tensor_core_route(tdt, M, I) == (want is not None)
    if want is not None:
        n, tiles = common.tile_rows(rows, gated)
        assert (n, tiles) == want
        assert n in common.TC_TILE_ROWS and n % 8 == 0 and n * tiles >= rows
        assert n <= (128 if gated else 192)
    wu = torch.zeros(E, M, I, dtype=tdt)
    wd = torch.zeros(E, I, M, dtype=tdt)
    wg = wu if gated else None
    if kind == "moe":
        moe_ops._check(torch.zeros(E, rows, M, dtype=tdt), wu, wg, wd)
    elif M % 8 == 0 and I % 8 == 0:
        rffn_ops._check(torch.zeros(2 * rows, M, dtype=tdt), torch.zeros(2, dtype=torch.int32),
                        wu, wg, wd, rows)


def _split_case(shapes, seed):
    rng = np.random.default_rng(seed)
    return [None if sh is None else (rng.standard_normal(sh) * (1 if i == 0 else 0.1)
                                     ).astype(np.float32) for i, sh in enumerate(shapes)]


def _t(a, dt=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dt)


def _j(a):
    return None if a is None else jnp.asarray(a).astype(jnp.bfloat16)


@pytest.mark.parametrize("E,X,M,I,act,dt", MOE_CASES)
def test_moe_ffn_split_h_plain_version(E, X, M, I, act, dt):
    """The tensor-core route's numerics (h as bf16 hi + lo): within 1e-5 of
    max |y| of the f32 plain version (hi + lo keeps about 16 bits), and on
    the bf16 cases within the reference's bf16 kernel tolerance (2e-2 of
    max |y|) of the reference's ``moe_ffn`` (its Pallas kernel in interpret
    mode)."""
    x, wu, wg, wd = _split_case([(E, X, M), (E, M, I), (E, M, I) if act == "swiglu" else None,
                                 (E, I, M)], E * X + I)
    want = moe_ref.moe_ffn_ref(_t(x), _t(wu), _t(wg), _t(wd), act).numpy()
    got = moe_ref.moe_ffn_split_ref(_t(x), _t(wu), _t(wg), _t(wd), act).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)
    if dt == "bfloat16":
        bf = torch.bfloat16
        ref = np.asarray(j_moe_ffn(_j(x), _j(wu), _j(wg), _j(wd), act), np.float32)
        split = moe_ref.moe_ffn_split_ref(_t(x, bf), _t(wu, bf), _t(wg, bf), _t(wd, bf), act)
        np.testing.assert_allclose(split.float().numpy(), ref,
                                   atol=2e-2 * float(np.abs(ref).max()), rtol=0)


@pytest.mark.parametrize("E,NB,bx,M,I,act,dt", RAGGED_CASES)
def test_ragged_ffn_split_h_plain_version(E, NB, bx, M, I, act, dt):
    """As the capacity-buffer test, for the ragged layout against the
    reference's ``ragged_ffn_kernel`` in interpret mode."""
    x, wu, wg, wd = _split_case([(NB * bx, M), (E, M, I), (E, M, I) if act == "swiglu" else None,
                                 (E, I, M)], E * NB + I)
    be = np.random.default_rng(E).integers(0, E, NB).astype(np.int32)
    tbe = torch.from_numpy(be)
    want = rag_ref.ragged_ffn_ref(_t(x), tbe, _t(wu), _t(wg), _t(wd), act).numpy()
    got = rag_ref.ragged_ffn_split_ref(_t(x), tbe, _t(wu), _t(wg), _t(wd), act).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * float(np.abs(want).max()), rtol=0)
    if dt == "bfloat16":
        bf = torch.bfloat16
        bi = I
        while bi > 1 and I % bi:
            bi //= 2
        ref = np.asarray(ragged_ffn_kernel(_j(x), jnp.asarray(be), _j(wu), _j(wg), _j(wd), act,
                                           block_x=bx, block_i=bi, interpret=True), np.float32)
        split = rag_ref.ragged_ffn_split_ref(_t(x, bf), tbe, _t(wu, bf), _t(wg, bf), _t(wd, bf),
                                             act)
        np.testing.assert_allclose(split.float().numpy(), ref,
                                   atol=2e-2 * float(np.abs(ref).max()), rtol=0)


# the m6 training shapes (B = 8, S = 144 and the learned-position limit 256,
# H = 16, D = 64, causal, bf16) and the card's further flash checks (D = 128
# with Hkv < Hq, S = 1, S = 17): every one takes the tensor cores
FLASH_M6_CASES = [(8, 144, 16, 16, 64, True, "bfloat16"), (8, 256, 16, 16, 64, True, "bfloat16")]
FLASH_CHIP_CASES = [(2, 80, 8, 2, 128, False, "bfloat16"), (2, 1, 4, 2, 64, True, "bfloat16"),
                    (2, 17, 4, 4, 64, False, "bfloat16")]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,dt",
                         FLASH_CASES + FLASH_M6_CASES + FLASH_CHIP_CASES)
def test_flash_attention_route(B, S, Hq, Hkv, D, causal, dt):
    """Which device code each shape takes (bf16 with D in 64, 128 the
    tensor cores, every m6 shape among them; f32 and D in 16, 32 the CUDA
    cores), and the wrapper's argument checks accept the shape."""
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    want = dt == "bfloat16" and D in (64, 128)
    assert common.flash_tensor_core_route(tdt, D) == want
    assert want or (B, S, Hq, Hkv, D, causal, dt) in FLASH_CASES
    q = torch.zeros(B, S, Hq, D, dtype=tdt)
    k = torch.zeros(B, S, Hkv, D, dtype=tdt)
    flash_ops._check(q, k, k.clone())


def test_flash_attention_tensor_core_route_needs_aligned_tensors():
    """The tensor-core kernel reads q, k, v through TMA, which takes
    16-byte-aligned addresses: a misaligned tensor raises (it does not
    switch routes); the CUDA-core route takes it."""
    def view(dt, shape, offset):
        n = int(np.prod(shape))
        return torch.zeros(n + offset, dtype=dt)[offset:].view(shape)

    shape = (1, 8, 2, 64)
    q = view(torch.bfloat16, shape, 0)
    flash_ops._check(q, q.clone(), q.clone())
    for name, args in (("q", (view(torch.bfloat16, shape, 1), q, q)),
                       ("k", (q, view(torch.bfloat16, shape, 4), q)),
                       ("v", (q, q, view(torch.bfloat16, shape, 7)))):
        with pytest.raises(ValueError, match=f"{name} is not 16-byte aligned"):
            flash_ops._check(*args)
    f = view(torch.float32, shape, 1)
    flash_ops._check(f, f.clone(), f.clone())                # f32: the CUDA cores


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,dt",
                         FLASH_CASES + [(2, 144, 16, 16, 64, True, "bfloat16")])
def test_flash_attention_split_plain_version(B, S, Hq, Hkv, D, causal, dt):
    """The tensor-core route's numerics (``attention_split_ref``: an online
    softmax over 64-key tiles in base 2, P as bf16 hi + lo): against the
    reference's ``flash_attention`` (its Pallas kernel in interpret mode)
    at the reference's flash tolerance (f32 3e-5, bf16 3e-2); and, on the
    same inputs in f32, within 2^-16 max |v| + 1e-6 of the f32
    ``attention_ref`` (the lo plane leaves p an error of at most 2^-16 |p|,
    and the output is a convex combination of v's rows; 1e-6 for the f32
    sums)."""
    (jq, jk, jv), (tq, tk, tv) = _grad_case(
        [(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)], B * S + D, dt, scale=1.0)
    want = np.asarray(j_flash(jq, jk, jv, causal=causal, block_q=64, block_kv=32), np.float32)
    got = flash_ref.attention_split_ref(tq, tk, tv, causal)
    tol = 3e-2 if dt == "bfloat16" else 3e-5
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)
    f32 = [t.float() for t in (tq, tk, tv)]
    split = flash_ref.attention_split_ref(*f32, causal).numpy()
    plain = flash_ref.attention_ref(*f32, causal).numpy()
    np.testing.assert_allclose(split, plain,
                               atol=2.0 ** -16 * float(f32[2].abs().max()) + 1e-6, rtol=0)


# (N, Hkv, G, D, bs, MB, element bytes, forced splits, longest length known on
# the host) -> (splits, stages) on a 132-SM H100
SPLIT_PLANS = [
    ((8, 16, 1, 64, 16, 16, 2, None, 112), (2, 4)),    # the m6 decode step as the engine runs it
    ((8, 16, 1, 64, 16, 16, 1, None, 112), (1, 7)),    # ... int8 / fp8: one pass covers 4 blocks
    ((8, 16, 1, 64, 16, 16, 2, None, 256), (4, 4)),    # 8 rows x 256 positions
    ((8, 16, 1, 64, 16, 16, 1, None, 256), (2, 8)),
    ((8, 16, 1, 64, 16, 16, 2, None, None), (4, 4)),   # no length known: the table's width
    ((40, 16, 1, 64, 16, 16, 2, None, 112), (1, 7)),   # the mixed step: 640 CTAs, no split
    ((8, 16, 1, 64, 16, 16, 2, None, 10), (1, 1)),     # one block: nothing to split
    ((8, 16, 1, 64, 16, 16, 2, 1, None), (1, 16)),     # forced: every block of a row in flight
    ((8, 16, 1, 64, 16, 16, 2, 8, None), (8, 2)),
    ((3, 16, 1, 64, 16, 64, 2, 1, None), (1, 16)),     # 64 blocks, 16 stages: the ring wraps
    ((5, 2, 8, 128, 16, 16, 4, None, None), (8, 2)),   # f32, G = 8, D = 128
    ((1, 1, 1, 32, 1, 64, 1, None, None), (1, 32)),    # one-position blocks: 32 stages
    ((1000, 16, 1, 64, 16, 16, 2, None, None), (1, 1)),  # many waves: the ring shrinks
]


@pytest.mark.parametrize("shape,want", SPLIT_PLANS)
def test_split_plan_per_shape(shape, want):
    """The paged kernels' cluster split and ring depth, from shapes and the
    host's longest length: a split only while the CTAs leave the card
    short of work and every split of the longest row keeps at least
    MIN_SPLIT_PASSES passes of the kernel's loop; stages cover a split's
    share of the longest row within the byte budget and the SM's shared
    memory for every CTA at once."""
    *dims, forced, longest = shape
    splits, stages = pda_ops.split_plan(*dims, sm_count=132, splits=forced,
                                        max_length=longest)
    assert (splits, stages) == want
    N, Hkv, G, D, bs, MB, eb = dims
    blocks = MB if longest is None else -(-longest // bs)
    assert 1 <= stages <= min(pda_ops.MAX_STAGES, -(-blocks // splits))
    assert 2 * bs * D * eb * stages <= pda_ops.STAGE_BUDGET or stages == 1
    if forced is None and splits > 1:
        rows = -(-blocks // splits) * bs
        assert rows >= pda_ops.MIN_SPLIT_PASSES * pda_ops._rows_per_pass(D, G, eb)


def test_split_plan_refuses_tiles_and_splits_it_cannot_take():
    with pytest.raises(ValueError, match="multiples of 16"):
        pda_ops.split_plan(1, 1, 1, 20, 3, 4, 2, sm_count=132)       # 120-byte tile
    with pytest.raises(ValueError, match="multiples of 16"):
        pda_ops.split_plan(1, 1, 1, 128, 1024, 4, 4, sm_count=132)   # 512 KB tile
    with pytest.raises(ValueError, match="splits"):
        pda_ops.split_plan(8, 16, 1, 64, 16, 16, 2, sm_count=132, splits=3)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_paged_split_plain_version(splits):
    """The kernel's split over ``splits`` CTAs (split r takes blocks r,
    r + splits, ...) and its merge, in plain PyTorch: against the
    reference's Pallas kernel in interpret mode and the unsplit plain
    version, f32 at 2e-5, on rows with more blocks than splits, fewer
    (some splits empty), lengths ending mid-block and on a boundary, and a
    length-0 row, which must come out exactly 0."""
    lengths = [0, 61, 5, 17, 16, 1, 64]
    q, kp, vp, tbl, lens = _paged_case(7, 2, 2, 16, 4, 16, lengths, seed=40 + splits)
    want = np.asarray(j_pda_kernel(jnp.asarray(q.reshape(7, 2, 2, 16)), jnp.asarray(kp),
                                   jnp.asarray(vp), jnp.asarray(tbl), jnp.asarray(lens),
                                   interpret=True)).reshape(7, 4, 16)
    args = list(map(torch.from_numpy, (q, kp, vp, tbl, lens)))
    got = pda_ref.paged_decode_attention_split_ref(*args, splits)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), pda_ref.paged_decode_attention_ref(*args).numpy(),
                               atol=TOL, rtol=TOL)
    assert (got[0] == 0).all()


def test_paged_kernels_refuse_misaligned_tensors_and_tiles():
    """What the bulk copies cannot take raises before a launch: a q or pool
    not 16-byte aligned, a tile the copy engine refuses (both kernels)."""
    from repro_torch.quant import get_kv_quant

    def view(dt, shape, offset):
        n = int(np.prod(shape))
        return torch.zeros(n + offset, dtype=dt)[offset:].view(shape)

    bf = torch.bfloat16
    q, pool = view(bf, (4, 16, 64), 0), view(bf, (9, 4, 16, 64), 0)
    tbl, lens = torch.zeros(4, 3, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)
    pda_ops._check(q, pool, pool, tbl, lens)
    for name, args in (("q", (view(bf, (4, 16, 64), 1), pool, pool)),
                       ("k_pool", (q, view(bf, (9, 4, 16, 64), 4), pool)),
                       ("v_pool", (q, pool, view(bf, (9, 4, 16, 64), 2)))):
        with pytest.raises(ValueError, match=f"{name} must be 16-byte aligned"):
            pda_ops._check(*args, tbl, lens)
    big = torch.zeros(2, 1, 1024, 128)                                # 512 KB tiles
    with pytest.raises(ValueError, match="tile"):
        pda_ops._check(torch.zeros(4, 1, 128), big, big, tbl, lens)

    int8 = get_kv_quant("int8")
    codes, sc = view(torch.int8, (9, 4, 16, 64), 0), torch.zeros(9, 4)
    pda_ops._check_quantized(q, codes, codes, sc, sc, tbl, lens, int8)
    for name, args in (("q", (view(bf, (4, 16, 64), 3), codes, codes)),
                       ("k_pool", (q, view(torch.int8, (9, 4, 16, 64), 8), codes)),
                       ("v_pool", (q, codes, view(torch.int8, (9, 4, 16, 64), 1)))):
        with pytest.raises(ValueError, match=f"{name} must be 16-byte aligned"):
            pda_ops._check_quantized(*args, sc, sc, tbl, lens, int8)
    big8 = torch.zeros(2, 1, 4096, 32, dtype=torch.int8)               # two 128 KB tiles a stage
    with pytest.raises(ValueError, match="tile"):
        pda_ops._check_quantized(torch.zeros(4, 1, 32), big8, big8, torch.zeros(2, 1),
                                 torch.zeros(2, 1), tbl, lens, int8)
