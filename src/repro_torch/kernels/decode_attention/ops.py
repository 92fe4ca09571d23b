"""Decode attention: the CUDA kernels' wrappers and the K/V writes
(``repro.kernels.decode_attention.ops``).

Three kernels, each beside its plain version in ``ref.py``:
``paged_decode_attention`` (``csrc/paged_decode_attention.cu``),
``quantized_paged_decode_attention`` over int8/fp8 code pools
(``csrc/quantized_paged_decode_attention.cu``) and the dense-cache
``decode_attention`` (``csrc/decode_attention.cu``).  On CPU tensors a
wrapper runs the plain version; on CUDA tensors it launches its kernel on
the current stream; on ``meta`` tensors (the dry run) it makes the
kernel's output and launches nothing; on any other device it raises.  Each wrapper's ``.launches`` counts its
kernel launches (and nothing else; the replays of a captured CUDA graph
add the launches of its capture, ``kernels/counters.py``).

The three kernels share one design (``kernels/csrc/decode_sm90.cuh``):
copies of whole tiles of one kv head into a ring of ``stages`` in shared
memory (the paged kernels' blocks by 1-D bulk copies, the dense cache's
tiles of ``DENSE_TILE_ROWS`` positions by TMA boxes of a tensor map), and a
split of each row's tiles over a thread-block cluster of ``splits`` CTAs;
:func:`split_plan` (:func:`dense_plan` for the dense cache) picks both from
the shapes and the longest length the host knows (the lengths stay on the
card).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
    quantized_paged_decode_attention_ref,
)
from repro_torch.quant.policy import quant_write_kv

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_C = ctypes.c_int
_P = ctypes.c_void_p
_L = ctypes.c_longlong
_FMT_CODE = {"int8": 0, "fp8": 1}
# the C signatures in csrc/: (codes..., pointers..., sizes..., strides..., stream)
_ARGTYPES = [_C] + [_P] * 6 + [_C] * 8 + [_P]
_QUANT_ARGTYPES = [_C, _C] + [_P] * 8 + [_C] * 8 + [_P]
_DENSE_ARGTYPES = [_C] + [_P] * 5 + [_C] * 5 + [_L] * 6 + [_C] * 3 + [ctypes.c_float] + [_P]

SPLITS = (1, 2, 4, 8)         # cluster sizes the paged kernels take (8: the portable limit)
GROUPS = (1, 2, 3, 4, 5, 8)   # GQA groups G = Hq / Hkv the kernels are instantiated for
MIN_SPLIT_PASSES = 2          # a split must keep at least this many passes of the loop
SPLIT_CTAS_PER_SM = 4         # splitting stops at this many CTAs an SM
STAGE_BUDGET = 64 * 1024      # bytes of K/V tiles a CTA keeps in flight, at most
MAX_STAGES = 32               # one thread a stage, eight in each of the four warps
MAX_STAGE_BYTES = 160 * 1024  # one stage (K and V tiles) fits beside the merges (<= 50 KB)
SMEM_PER_SM = 228 * 1024      # an H100 SM's shared memory, 1 KB of it reserved per CTA
DENSE_TILE_ROWS = 16          # positions of one dense-cache tile (a TMA box), as an engine block
TMA_ALIGN = 128               # shared-memory alignment of a TMA box: the dense launch's slack
DENSE_WIDE_D = 224            # the dense kernel's one other width, at G = 1 (zamba2-7b's
                              # shared attention: 2 x 3584 over 32 heads)


def _stage_bytes(bs: int, D: int, elem_bytes: int) -> int:
    """Shared memory of one stage: a K and a V tile, their two mbarriers
    and two scales (as ``paged_decode_sm90.cuh::smem_bytes`` counts them)."""
    return 2 * bs * D * elem_bytes + 2 * 8 + 2 * 4


def _merge_bytes(G: int, D: int, splits: int, slack: int = 0) -> int:
    """The kernel's shared memory beside its stages: the warps' states
    (static), the cluster merge's barrier and, with a split, one (m, l,
    acc) slot per rank (``smem_bytes``), plus the launch's alignment
    ``slack``."""
    return (4 * G * (D + 2) * 4 + 8 + (splits * G * (D + 2) * 4 if splits > 1 else 0)
            + slack)


def _check_tile(name: str, bs: int, D: int, elem_bytes: int) -> None:
    tile = bs * D * elem_bytes
    if tile % 16 or _stage_bytes(bs, D, elem_bytes) > MAX_STAGE_BYTES:
        raise ValueError(f"{name}: a (block, head) tile of bs={bs} x D={D} x {elem_bytes} B "
                         f"= {tile} B; the bulk copies take multiples of 16 B, two tiles a "
                         f"stage within {MAX_STAGE_BYTES} B")


def _ceil_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _rows_per_pass(D: int, G: int, elem_bytes: int) -> int:
    """Token rows the kernel's 4 warps read in one pass: two a lane
    (``decode_sm90.cuh::kRowsPerLane``), D / VEC lanes a row rounded up to
    a power of two (D = 224: 28 lanes of 8 and 4 idle, a whole warp), VEC
    elements a lane (``decode_common.cuh::vec_elems``: 16 bytes, at most
    32 / G rounded down to a power of two, at least D / 32 rounded up)."""
    vec = min(16 // elem_bytes, 1 << ((32 // G).bit_length() - 1))
    vec = min(max(vec, _ceil_pow2(-(-D // 32))), D)
    return 2 * 4 * (32 // _ceil_pow2(D // vec))


def split_plan(N: int, Hkv: int, G: int, D: int, bs: int, MB: int, elem_bytes: int,
               sm_count: int, splits: Optional[int] = None,
               max_length: Optional[int] = None, slack: int = 0) -> Tuple[int, int]:
    """``(splits, stages)`` of one paged decode launch, from shapes and what
    the host knows: the lengths live on the card and are not read, so the
    longest row is ``max_length`` when the caller knows it and the
    table's width, MB blocks, otherwise (the continuous engine's plan:
    static, so that its step can be captured as a CUDA graph).

    ``splits``: 1 unless the N x Hkv CTAs leave the card short of work;
    then the largest of (2, 4, 8) that keeps N x Hkv x splits within
    ``SPLIT_CTAS_PER_SM`` CTAs an SM and leaves every split of the longest
    row at least ``MIN_SPLIT_PASSES`` passes of the kernel's loop (below
    that, the cluster's merge costs more than the split saves).
    ``stages``: the longest row's blocks in a split, as far as the bytes
    allow: at most ``STAGE_BUDGET``, and no more than lets every CTA of
    the launch be resident at once (a second wave would cost a second
    round trip); at most ``MAX_STAGES`` (a longer row wraps the ring).  A
    given ``splits`` is taken as it is; ``slack`` is the shared memory
    the launch adds for alignment.  Raises ValueError for a tile the copy
    engine refuses (not a multiple of 16 bytes) or that does not fit."""
    _check_tile("paged decode", bs, D, elem_bytes)
    rows = _rows_per_pass(D, G, elem_bytes)
    longest = MB if max_length is None else max(1, min(MB, -(-max_length // bs)))
    if splits is None:
        splits = 1
        while (splits < SPLITS[-1] and N * Hkv * (splits * 2) <= SPLIT_CTAS_PER_SM * sm_count
               and -(-longest // (splits * 2)) * bs >= MIN_SPLIT_PASSES * rows):
            splits *= 2
    elif splits not in SPLITS:
        raise ValueError(f"paged decode: splits {splits} not in {SPLITS}")
    per_sm = -(-N * Hkv * splits // sm_count)
    resident = ((SMEM_PER_SM // per_sm - 1024 - _merge_bytes(G, D, splits, slack))
                // _stage_bytes(bs, D, elem_bytes))
    stages = min(-(-longest // splits), MAX_STAGES,
                 max(1, min(STAGE_BUDGET // (2 * bs * D * elem_bytes), resident)))
    return splits, stages


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def dense_plan(B: int, Hkv: int, G: int, D: int, T: int, elem_bytes: int, sm_count: int,
               splits: Optional[int] = None,
               max_length: Optional[int] = None) -> Tuple[int, int]:
    """``(splits, stages)`` of one dense decode launch: :func:`split_plan`
    over tiles of ``DENSE_TILE_ROWS`` positions, ceil(T / tile) of them a
    row, the longest row ``max_length`` where the caller knows it and T
    otherwise.  The dense kernel issues the tiles of its first pass before
    it reads the length (a row shorter than those fetches them and never
    reads them), the rest of its ``stages`` after."""
    rows = DENSE_TILE_ROWS
    return split_plan(B, Hkv, G, D, rows, -(-T // rows), elem_bytes, sm_count, splits,
                      max_length, slack=TMA_ALIGN)


def launch_plan(q: torch.Tensor, k_pool: torch.Tensor, block_tables: torch.Tensor,
                splits: Optional[int] = None) -> Tuple[int, int]:
    """:func:`split_plan` for a paged kernel's CUDA arguments (the card's
    SM count from its properties), from static shapes: the longest row is
    the table's width."""
    N, Hq, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    return split_plan(N, Hkv, Hq // Hkv, D, bs, block_tables.shape[1], k_pool.element_size(),
                      _sm_count(q.device.index), splits)


def _check_aligned(name: str, **tensors) -> None:
    for what, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned (bulk copies, vector "
                             f"loads)")


def _lib(name: str = "paged_decode_attention"):
    fn = getattr(build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = {"paged_decode_attention": _ARGTYPES,
                       "quantized_paged_decode_attention": _QUANT_ARGTYPES,
                       "decode_attention": _DENSE_ARGTYPES}[name]
        fn.restype = _C
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(q, k_pool, v_pool, block_tables, lengths):
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"paged_decode_attention: {name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention: q/pools must share bf16 or f32, got "
                        f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables and lengths must be int32")
    N, Hq, D = q.shape
    P, Hkv, bs, Dk = k_pool.shape
    if v_pool.shape != k_pool.shape or Dk != D:
        raise ValueError(f"paged_decode_attention: pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} vs q {tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != N or lengths.shape != (N,):
        raise ValueError("paged_decode_attention: block_tables (N, MB), lengths (N,)")
    if Hq % Hkv or Hq // Hkv not in GROUPS or D not in (32, 64, 128):
        raise ValueError(f"paged_decode_attention kernel takes G in {GROUPS} and "
                         f"D in (32, 64, 128); got Hq={Hq}, Hkv={Hkv}, D={D}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous")
    _check_aligned("paged_decode_attention", q=q, k_pool=k_pool, v_pool=v_pool)
    _check_tile("paged_decode_attention", k_pool.shape[2], D, k_pool.element_size())


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           block_tables: torch.Tensor, lengths: torch.Tensor, *,
                           splits: Optional[int] = None) -> torch.Tensor:
    """q: (N, Hq, D) one query per row; k_pool/v_pool: (P, Hkv, bs, D);
    block_tables: (N, MB) int32 pool block ids; lengths: (N,) int32 valid
    context per row (0 => output 0).  Returns (N, Hq, D).  ``splits``
    forces the kernel's cluster split (default: :func:`launch_plan`'s,
    from static shapes)."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"paged_decode_attention: no kernel for device {q.device}")
    _check(q, k_pool, v_pool, block_tables, lengths)
    out = torch.empty_like(q)
    if q.device.type == "meta":         # the dry run: the kernel's output, no launch
        return out
    N, Hq, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    splits, stages = launch_plan(q, k_pool, block_tables, splits)
    fn = _lib()
    with torch.cuda.device(q.device):
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 N, Hkv, Hq // Hkv, D, bs, block_tables.shape[1], splits, stages, _stream(q))
    if err:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: cudaError {err}")
    paged_decode_attention.launches += 1
    return out


counters.counted(paged_decode_attention, "launches")


def paged_update_attention(q, k, v, k_pool, v_pool, write_blocks, write_offsets,
                           block_tables, lengths):
    """One serving step's K/V write, then paged attention over it.

    The write is plain PyTorch and **in place**: ``k_pool[wb, :, wo] = k``
    (the reference returns new pools that its jit donates; here the pools
    are simply updated).  The two advanced indices separated by a slice
    follow NumPy's rule, as JAX does: the indexed view is ``(N, Hkv, D)``,
    the layout of ``k``.  Masked rows all write the garbage block at
    offset 0, which no row reads under a nonzero length, so the order in
    which those duplicate writes land does not matter.

    q: (N, Hq, D); k/v: (N, Hkv, D); pools: (P, Hkv, bs, D).  The kernel
    plans its launch from these shapes.  Returns ``(out, k_pool, v_pool)``.
    """
    wb, wo = write_blocks.long(), write_offsets.long()
    k_pool[wb, :, wo] = k.to(k_pool.dtype)
    v_pool[wb, :, wo] = v.to(v_pool.dtype)
    out = paged_decode_attention(q, k_pool, v_pool, block_tables, lengths)
    return out, k_pool, v_pool


def _check_quantized(q, k_pool, v_pool, k_scales, v_scales, block_tables, lengths, policy):
    name = "quantized_paged_decode_attention"
    dev = q.device
    for what, t in (("k_pool", k_pool), ("v_pool", v_pool), ("k_scales", k_scales),
                    ("v_scales", v_scales), ("block_tables", block_tables),
                    ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name}: {what} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if policy.name not in _FMT_CODE:
        raise ValueError(f"{name}: no kernel for kv_quant {policy.name!r}")
    if q.dtype not in _DTYPE_CODE or not q.is_contiguous():
        raise TypeError(f"{name}: q must be contiguous bf16 or f32, got {q.dtype}")
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise TypeError(f"{name}: code pools must be int8")
    if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
        raise TypeError(f"{name}: scales must be float32")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{name}: block_tables and lengths must be int32")
    N, Hq, D = q.shape
    P, Hkv, bs, Dk = k_pool.shape
    if (v_pool.shape != k_pool.shape or Dk != D or k_scales.shape != (P, Hkv)
            or v_scales.shape != (P, Hkv)):
        raise ValueError(f"{name}: pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}, "
                         f"scales {tuple(k_scales.shape)}/{tuple(v_scales.shape)} "
                         f"vs q {tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != N or lengths.shape != (N,):
        raise ValueError(f"{name}: block_tables (N, MB), lengths (N,)")
    if Hq % Hkv or Hq // Hkv not in GROUPS or D not in (32, 64, 128):
        raise ValueError(f"{name} kernel takes G in {GROUPS} and D in (32, 64, 128); "
                         f"got Hq={Hq}, Hkv={Hkv}, D={D}")
    _check_aligned(name, q=q, k_pool=k_pool, v_pool=v_pool)
    _check_tile(name, bs, D, 1)


def quantized_paged_decode_attention(q, k_pool, v_pool, k_scales, v_scales,
                                     block_tables, lengths, *, policy,
                                     splits: Optional[int] = None) -> torch.Tensor:
    """:func:`paged_decode_attention` over int8 code pools: k_pool/v_pool
    (P, Hkv, bs, D) codes, k_scales/v_scales (P, Hkv) float32 absmax scales
    keyed by the same block ids, ``value = policy.decode(code) * scale``;
    ``policy`` a quantized :class:`repro_torch.quant.KVQuantPolicy`.
    Returns (N, Hq, D) in q's dtype; length-0 rows exactly 0.  ``splits``
    as :func:`paged_decode_attention`'s."""
    if q.device.type == "cpu":
        return quantized_paged_decode_attention_ref(q, k_pool, v_pool, k_scales, v_scales,
                                                    block_tables, lengths, policy=policy)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"quantized_paged_decode_attention: no kernel for device {q.device}")
    _check_quantized(q, k_pool, v_pool, k_scales, v_scales, block_tables, lengths, policy)
    out = torch.empty_like(q)
    if q.device.type == "meta":         # the dry run: the kernel's output, no launch
        return out
    N, Hq, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    splits, stages = launch_plan(q, k_pool, block_tables, splits)
    fn = _lib("quantized_paged_decode_attention")
    with torch.cuda.device(q.device):
        err = fn(_DTYPE_CODE[q.dtype], _FMT_CODE[policy.name], q.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(), k_scales.data_ptr(),
                 v_scales.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), N, Hkv, Hq // Hkv, D, bs, block_tables.shape[1], splits,
                 stages, _stream(q))
    if err:
        raise RuntimeError(f"quantized_paged_decode_attention kernel launch failed: "
                           f"cudaError {err}")
    quantized_paged_decode_attention.launches += 1
    return out


counters.counted(quantized_paged_decode_attention, "launches")


def quantized_paged_update_attention(q, k, v, k_pool, v_pool, k_scales, v_scales,
                                     write_blocks, write_offsets, block_tables, lengths,
                                     *, policy):
    """Quantized :func:`paged_update_attention`: quantize-scatter this
    step's K/V into the code pools, maintaining the per-block scales
    (``repro_torch.quant.quant_write_kv``, in place), then attend through the
    block tables with dequantization in the kernel.  Returns
    ``(out, k_pool, v_pool, k_scales, v_scales)``."""
    quant_write_kv(k_pool, k_scales, k, write_blocks, write_offsets, policy=policy)
    quant_write_kv(v_pool, v_scales, v, write_blocks, write_offsets, policy=policy)
    out = quantized_paged_decode_attention(q, k_pool, v_pool, k_scales, v_scales,
                                           block_tables, lengths, policy=policy)
    return out, k_pool, v_pool, k_scales, v_scales


def _check_dense(q, k, v, lengths):
    dev = q.device
    for what, t in (("k", k), ("v", v), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"decode_attention: {what} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: q/k/v must share bf16 or f32, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise TypeError("decode_attention: lengths must be contiguous int32")
    B, Hq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"decode_attention: k/v {tuple(k.shape)}/{tuple(v.shape)} vs "
                         f"q {tuple(q.shape)}; want (B, T, Hkv, D)")
    Hkv = k.shape[2]
    if lengths.shape != (B,):
        raise ValueError("decode_attention: lengths (B,)")
    if k.shape[1] < 1:
        raise ValueError("decode_attention: an empty cache (T = 0) has no tensor map")
    widths = (16, 32, 64, 128) + ((DENSE_WIDE_D,) if Hq == Hkv else ())
    if Hq % Hkv or Hq // Hkv not in GROUPS or D not in widths:
        raise ValueError(f"decode_attention kernel takes G in {GROUPS} and D in "
                         f"(16, 32, 64, 128), or D = {DENSE_WIDE_D} at G = 1; got Hq={Hq}, "
                         f"Hkv={Hkv}, D={D}")
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    es = q.element_size()
    for what, t in (("k", k), ("v", v)):
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(st * es % 16 for st in _map_strides(t))):
            raise ValueError(f"decode_attention: {what} needs a contiguous last dim, a "
                             f"16-byte aligned base and strides of multiples of 16 bytes "
                             f"(TMA tensor maps); strides {t.stride()}")


def _map_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """The (b, t, h) element strides of a (B, T, Hkv, D) cache as its tensor
    map takes them: a dim of extent 1 is never stepped, so its stride (any
    number in PyTorch) becomes the extent of the dims inside it."""
    B, T, Hkv, D = t.shape
    sb, st, sh = t.stride()[:3]
    sh = sh if Hkv > 1 else D
    st = st if T > 1 else sh * Hkv
    sb = sb if B > 1 else st * T
    return sb, st, sh


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, splits: Optional[int] = None,
                     max_length: Optional[int] = None, softcap: float = 0.0) -> torch.Tensor:
    """Single-token GQA decode over a dense cache: q (B, Hq, D); k/v
    (B, T, Hkv, D), read through their strides; lengths (B,) int32 valid
    prefix (0 => output exactly 0).  Returns (B, Hq, D).  ``splits``
    forces the kernel's cluster split (default: :func:`dense_plan`'s);
    ``max_length``, the longest of ``lengths`` where the caller knows it
    on the host, informs that plan and nothing else; ``softcap`` c > 0
    caps each score s at c tanh(s / c) (the reference's ``_sdpa``)."""
    if softcap < 0:
        raise ValueError(f"decode_attention: softcap {softcap} < 0")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, softcap=softcap)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    _check_dense(q, k, v, lengths)
    out = torch.empty_like(q)
    if q.device.type == "meta":         # the dry run: the kernel's output, no launch
        return out
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    splits, stages = dense_plan(B, Hkv, Hq // Hkv, D, T, q.element_size(),
                                _sm_count(q.device.index), splits, max_length)
    fn = _lib("decode_attention")
    with torch.cuda.device(q.device):
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), B, T, Hkv, Hq // Hkv, D,
                 *_map_strides(k), *_map_strides(v), DENSE_TILE_ROWS, splits, stages,
                 float(softcap), _stream(q))
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err} (1: the "
                           f"copy engine refused a tensor map, or an argument)")
    decode_attention.launches += 1
    return out


counters.counted(decode_attention, "launches")


__all__ = ["decode_attention", "decode_attention_ref", "dense_plan",
           "paged_decode_attention", "paged_decode_attention_ref",
           "paged_update_attention", "quantized_paged_decode_attention",
           "quantized_paged_decode_attention_ref", "quantized_paged_update_attention"]


def _shard_rows(mesh, axis: str, *rows):
    """This rank's slice of each row-major operand: rows [d * per, (d + 1)
    * per) of N, d its index on ``axis`` (the engine lays a step's rows out
    shard-major, each shard's rows covering its own slots)."""
    D, d = mesh.shape[axis], mesh.coord[axis]
    N = rows[0].shape[0]
    if N % D:
        raise ValueError(f"{N} rows do not split over {D} {axis} shards")
    per = N // D
    return [r[d * per:(d + 1) * per] for r in rows]


def sharded_paged_update_attention(q, k, v, k_pool, v_pool, write_blocks, write_offsets,
                                   block_tables, lengths, *, mesh, axis: str = "data"):
    """:func:`paged_update_attention` over the mesh's ``axis``
    (``repro.kernels.decode_attention.ops.sharded_paged_update_attention``):
    this rank writes and attends its own rows (its slice of every row
    operand) through its shard's pool slice ``k_pool``/``v_pool``, by the
    shard-local block ids its rows carry, and the rows' outputs are
    all-gathered over the axis.  Returns ``(out (N, Hq, D), k_pool,
    v_pool)``."""
    from repro_torch.distributed.collectives import all_gather

    q, k, v, wb, wo, tables, lens = _shard_rows(mesh, axis, q, k, v, write_blocks,
                                                write_offsets, block_tables, lengths)
    out, k_pool, v_pool = paged_update_attention(q.contiguous(), k, v, k_pool, v_pool, wb, wo,
                                                 tables.contiguous(), lens.contiguous())
    return all_gather(out, mesh.group(axis)), k_pool, v_pool


def sharded_quantized_paged_update_attention(q, k, v, k_pool, v_pool, k_scales, v_scales,
                                             write_blocks, write_offsets, block_tables, lengths,
                                             *, policy, mesh, axis: str = "data"):
    """:func:`quantized_paged_update_attention` over the mesh's ``axis``, as
    :func:`sharded_paged_update_attention`, the scale pools this shard's
    alongside its code pools.  Returns ``(out, k_pool, v_pool, k_scales,
    v_scales)``."""
    from repro_torch.distributed.collectives import all_gather

    q, k, v, wb, wo, tables, lens = _shard_rows(mesh, axis, q, k, v, write_blocks,
                                                write_offsets, block_tables, lengths)
    out = quantized_paged_update_attention(q.contiguous(), k, v, k_pool, v_pool, k_scales,
                                           v_scales, wb, wo, tables.contiguous(),
                                           lens.contiguous(), policy=policy)[0]
    return all_gather(out, mesh.group(axis)), k_pool, v_pool, k_scales, v_scales
