"""Continuous-batching serving engine over a paged KV cache
(``repro.serving.continuous.ContinuousEngine``, paged mode).

The engine keeps a fixed pool of ``max_slots`` decode slots full: requests
are admitted as slots and KV blocks free up, prompts are ingested in
``prefill_chunk``-token chunks interleaved with one decode token for every
active slot, and finished requests are evicted at once.  Every step is one
forward over a flat batch of rows of two fixed shapes:

    rows = [max_slots decode rows] (+ [prefill_chunk chunk rows] when a
           request is prefilling)

Each row carries its token, absolute position, context length and KV
write coordinates.  K/V of every row are written into the pool *before*
the attention read, so a chunk row sees its same-step predecessors —
exact causal prefill — and prefill and decode share one kernel.  In every
layer that read is the paged decode attention kernel
(``repro_torch.kernels.decode_attention``) — its quantized variant over
int8/fp8 code pools and their scale pools when ``ServeConfig.kv_quant`` is
set — and in every MoE layer the expert FFN is the ragged grouped FFN
kernel behind the dropless dispatcher (``repro_torch.kernels.moe_dropless``).
With ``ServeConfig.prefix_cache`` admission binds cached prompt-prefix
blocks and every step publishes the running slots' newly full blocks
(``repro_torch.serving.prefix_cache``).

**Speculative decoding** (``ServeConfig.spec``): when no request is
prefilling, a drafter (``repro_torch.serving.speculative``) proposes up to
``gamma`` tokens per slot and a *verify* step scores ``gamma + 1`` rows per
slot, ``rows = max_slots * (gamma + 1)``: row ``slot * (gamma + 1) + j``
feeds draft token ``j`` at absolute position ``c + j``, exactly a chunk row,
so the verify step runs the same forward and the same kernels.  The
acceptance rule (``speculative.accept``) emits the accepted draft prefix
plus one token: at temperature 0 token-identical to non-speculative
decoding (given batch-invariant routing, i.e. dropless MoE), at
temperature > 0 distributed as the target.  Greedy verification ships the
rows' argmax ids to the host, sampled verification the (N, V_pad) logits
for the host's rejection sampling.  ``PagedKVCache.truncate_slot`` rewinds
the rejected positions; a round with no draft anywhere runs the ordinary
decode step instead.

**Sampling at temperature > 0** draws on the device, one Gumbel-max draw
per row over ``logits / T`` keyed by (engine seed, slot, absolute
position): independent across slots and reproducible under slot reuse.
The reference folds those keys into JAX's PRNG, which PyTorch cannot
reproduce, so the port's draws match the reference in distribution only.
Its uniforms come from an integer hash of (seed, slot, position, vocab
index) in int64 tensor ops, so the CPU and the card draw the same integers
and a sampled token differs between them only at a near-tie of the
perturbed scores.

**SLO scheduling** (``ServeConfig.slo``): each step first lets the
scheduler preempt lower-priority victims for an urgent arrival that cannot
be admitted (their KV blocks swap to a host pool, ``serving.slo.swap``),
then shed waiting requests whose deadline is provably unmeetable
(``SLOConfig.shed``), then admit, restoring a preempted pick's blocks so it
resumes at the exact token.  All of it happens between steps, never inside
a forward; the restored blocks are read back by the same decode kernels.

**Mixed dense/MoE stacks** (``moe_layer_period`` > 1) run the per-layer
list of blocks: the paged kernel in every layer, the ragged FFN in the MoE
layers.  MoE attention has no cached decode path and is refused, as the
reference refuses it.

**Recurrent families** (xLSTM) keep an O(1) state per slot instead of KV
pools: every step is one ``decode`` of shape ``(max_slots, 1)``, a
prefilling slot feeding prompt token ``prefill_pos`` at that position and
a decoding slot its last token at ``context_len``; a slot's state is zeroed
when a request is admitted to it.  Both are static forms
(:class:`repro_torch.serving.graphs.GraphForm`), as the reference jits
``rec_step`` and ``reset_slot``: the step stages every slot's token and
position in one pinned buffer, decodes, copies the new states into the
persistent ones and samples, all in one form; the reset zeroes the rows
of a slot given on the device.  No kernel runs on this path (see
``repro_torch.models.xlstm``).  Speculation, prefix caching, KV
quantization and preemption need the paged cache and are refused there, with
the reference's messages.

**Serving on a mesh** (``ServeConfig.mesh = (("data", D), ("expert",
E))``): one process a mesh rank (``repro_torch.launch.mesh``).  Every rank
runs this same host code (scheduler, block accounting, the step's rows)
and so holds the same state: the reference's single controller, run once a
rank; ``run`` agrees the ranks' step clock, and ``check_invariants``
all-gathers every step's sampled tokens and asserts that the ranks agree.
Slots and KV pools partition over ``data``
(:class:`~repro_torch.serving.kv_cache.ShardedPagedKVCache`: this rank's
pools are its shard's slice), and a step's rows are laid out shard-major,
shard d's rows ``[d * per, (d + 1) * per)`` its own slots' decode rows
then, on the prefilling slot's shard, the chunk rows.  Embedding, norms,
Q/K/V, unembedding and sampling run over all rows on every rank; each rank
writes and attends its own shard's rows through its pool slice
(``sharded_paged_update_attention``) and the outputs are all-gathered over
``data``.  Expert leaves shard over ``expert``
(``distributed.sharding.make_rules``; ``params`` is the rank's placement,
``sharding.shard_params(..., keep=("router",))``), and a dropless MoE
layer whose groups split over the mesh runs the ragged expert-parallel
``all_to_all`` (``core.dispatch.dropless.ragged_ep_dispatch``).  As in the
reference, recurrent families, speculation and SLO scheduling are refused
on a mesh.

**The compiled step** (the reference's ``jax.jit`` of the step over
static shapes): each step kind — ``decode`` (N = ``max_slots``), ``mixed``
(N = ``max_slots + data_shards * prefill_chunk``), ``verify`` (N =
``max_slots * (gamma + 1)``) — is a :class:`StepForm` that owns its
buffers for the engine's life: the rows in a pinned host staging buffer
that :meth:`ContinuousEngine.build_rows` fills, one device buffer they
are copied into (one ``copy_`` a step), and the step's outputs.  The body
reads only those buffers, the params and the pools, and no host value: the
paged kernels take their launch plan from static shapes (the table's
``blocks_per_slot``), sampling reads slots and positions from the device
buffer and the temperature from a 0-dim tensor.  On a CUDA device without a
mesh every form is captured as a ``torch.cuda.CUDAGraph`` when the engine
is built (after a warm-up on all-padding rows, which write only the
garbage block), the forms sharing one graph memory pool, and a step is the
copy, a replay and one device-to-host read of its tokens; a capture that
fails raises.  The kernels' launch counters count replays
(``repro_torch.kernels.counters``).  On the CPU, on ``meta`` and on a mesh
(whose collectives a graph cannot hold) a form runs its body eagerly and
is built at its first step, as the reference's jit compiles a shape at its
first call.  ``graphs=False`` runs the eager forms on the card too.  The
model drafter's forwards are a form of the drafter's own, captured on the
engine's pool beside the steps (``speculative.model``).  The
reference's census follows: :meth:`ContinuousEngine.compiled_variants`,
the ``engine_compiled_variants`` gauge, ``engine_recompiles_total`` and the
``recompile`` instant past ``_expected_variants`` (2, 3 when speculating, 1
for the recurrent step, whose slot reset the census does not count, as the
reference counts ``_step_fn`` alone).

Differences from the reference, by design of the port: the KV pools are
updated in place (the reference's jit donates them and adopts the
returned pools), and since a captured graph holds their addresses a step
raises if a pool was rebound.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.dispatch import get_dispatcher
from repro_torch.core.metrics import load_entropy
from repro_torch.core.moe import moe_ffn_apply
from repro_torch.core.routers import get_router
from repro_torch.core.routers.hashed import _M32, _mix32
from repro_torch.distributed.collectives import agree_max
from repro_torch.distributed.sharding import use_rules
from repro_torch.kernels import counters
from repro_torch.kernels.decode_attention import (
    paged_update_attention,
    quantized_paged_update_attention,
    sharded_paged_update_attention,
    sharded_quantized_paged_update_attention,
)
from repro_torch.models import layers as L
from repro_torch.models.attention import _project_qkv
from repro_torch.models.registry import get_family
from repro_torch.models.transformer import _is_moe_layer, unstack_layers
from repro_torch.obs import Observability
from repro_torch.serving.graphs import GraphForm, capture, copy_state, zero_state
from repro_torch.serving.kv_cache import PagedKVCache, make_kv_cache
from repro_torch.serving.request import Request, RequestState, Status
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.speculative.accept import accept_greedy_ids, accept_rejection
from repro_torch.serving.speculative.base import DraftItem
from repro_torch.serving.trace import latency_stats, slo_class_stats

_PAGED_FAMILIES = ("decoder_lm", "vlm", "m6")
_RECURRENT_FAMILIES = ("xlstm",)
# a step's rows, then its (N, blocks_per_slot) row tables, in one int32 buffer
_ROW_FIELDS = ("tokens", "ctx_ids", "positions", "lengths", "slots", "wb", "wo")


# ---------------------------------------------------------------------------
# Paged transformer forward (one mixed prefill/decode step)
# ---------------------------------------------------------------------------

def _layer_telemetry(aux, num_experts: int, device) -> dict:
    if aux is None:
        z = torch.zeros((), dtype=torch.float32, device=device)
        return {"expert_tokens": torch.zeros(num_experts, dtype=torch.float32, device=device),
                "gate_entropy": z, "dropped": z, "routed_choices": z}
    choices = aux["moe_routed_choices"]
    return {"expert_tokens": aux["moe_expert_tokens"],
            "gate_entropy": aux["moe_gate_entropy"],
            # drop count: summable across steps, exactly 0.0 when dropless
            "dropped": aux["moe_dropped_fraction"] * choices,
            "routed_choices": choices}


def _paged_block(bp, x, cfg: ModelConfig, *, moe_layer: bool, positions, lengths,
                 row_tables, wb, wo, kp, vp, ctx, ksc=None, vsc=None, policy=None,
                 mesh=None):
    """One pre-norm block over the flat row batch ``x: (1, N, d)``; writes
    this step's K/V into ``kp``/``vp`` in place before attending (quantized
    into the code pools, with the scale pools ``ksc``/``vsc``, when
    ``policy`` is set).  The attention kernel plans its launch from static
    shapes (every row as long as its table), so the step reads no host
    value.  With ``mesh`` the write and attention run over the ``data``
    axis: this rank's shard-major rows through its pool slice."""
    N = x.shape[1]
    h = L.norm_apply(bp["ln_attn"], x, cfg)
    q, k, v = _project_qkv(bp["attn"], h, cfg, positions)        # (1, N, H*, D)
    if policy is None and mesh is None:
        out, _, _ = paged_update_attention(q[0].contiguous(), k[0], v[0], kp, vp,
                                           wb, wo, row_tables, lengths)
    elif policy is None:
        out = sharded_paged_update_attention(q[0], k[0], v[0], kp, vp, wb, wo, row_tables,
                                             lengths, mesh=mesh)[0]
    elif mesh is None:
        out = quantized_paged_update_attention(q[0].contiguous(), k[0], v[0], kp, vp,
                                               ksc, vsc, wb, wo, row_tables, lengths,
                                               policy=policy)[0]
    else:
        out = sharded_quantized_paged_update_attention(
            q[0], k[0], v[0], kp, vp, ksc, vsc, wb, wo, row_tables, lengths, policy=policy,
            mesh=mesh)[0]
    x = x + L.dense_apply(bp["attn"]["wo"], out.reshape(1, N, -1), cfg)
    h = L.norm_apply(bp["ln_ffn"], x, cfg)
    if moe_layer:
        ffn_out, aux = moe_ffn_apply(bp["ffn"], h, cfg, ctx=ctx)
        telem = _layer_telemetry(aux, cfg.moe.num_experts, x.device)
    else:
        ffn_out = L.ffn_apply(bp["ffn"], h, cfg)
        telem = _layer_telemetry(None, cfg.moe.num_experts, x.device)
    return x + ffn_out, telem


def _paged_logits(params, layers, cfg: ModelConfig, rows, k_pools, v_pools,
                  k_scales=None, v_scales=None, policy=None, mesh=None):
    """Flat-row forward: embed -> blocks -> float32 logits (N, V_pad), plus
    the per-layer routing telemetry stacked ``(L, ...)`` ({} when dense).
    ``policy`` (a quantized ``KVQuantPolicy``) switches the K/V write and
    attention to the quantized ops over the (L, P, Hkv) scale pools;
    ``mesh`` shards them over its data axis (see :func:`_paged_block`)."""
    quantized = policy is not None
    tokens, positions = rows["tokens"].long(), rows["positions"].long()
    x = L.embedding_apply(params["embed"], tokens[None], cfg)    # (1, N, d)
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"].to(x.dtype)[positions][None]
    pos2 = positions[None]
    ctx = MoEContext(token_ids=rows["ctx_ids"][None], positions=pos2)
    telems = []
    for i, bp in enumerate(layers):
        x, tl = _paged_block(
            bp, x, cfg, moe_layer=_is_moe_layer(cfg, i), positions=pos2,
            lengths=rows["lengths"], row_tables=rows["row_tables"], wb=rows["wb"],
            wo=rows["wo"], kp=k_pools[i], vp=v_pools[i], ctx=ctx,
            ksc=k_scales[i] if quantized else None,
            vsc=v_scales[i] if quantized else None, policy=policy, mesh=mesh)
        telems.append(tl)
    telem = ({} if cfg.moe.num_experts == 0
             else {k: torch.stack([t[k] for t in telems]) for k in telems[0]})
    x = L.norm_apply(params["final_norm"], x, cfg)
    unembed = params.get("unembed", params["embed"])
    return L.unembed_apply(unembed, x, cfg)[0].float(), telem


def check_mesh_support(cfg: ModelConfig, serve: ServeConfig) -> None:
    """The reference's refusals of ``serve.mesh``, with its messages."""
    if serve.mesh is None:
        return
    if cfg.family not in _PAGED_FAMILIES:
        raise NotImplementedError(
            "mesh serving needs the paged KV cache (recurrent slot states have no "
            "block partition)")
    if serve.spec is not None:
        raise NotImplementedError(
            "speculative decoding is not supported with ServeConfig.mesh yet (the verify "
            "row layout is not shard-major)")
    if serve.slo is not None:
        raise NotImplementedError(
            "SLO scheduling is not supported with ServeConfig.mesh yet (KV swap-to-host "
            "assumes a single device pool)")


def _row_views(flat, N: int) -> dict:
    """The fields of a step's flat int32 row buffer (numpy or torch): each of
    ``_ROW_FIELDS`` over N rows, then ``row_tables`` (N, blocks_per_slot)."""
    views = {k: flat[i * N:(i + 1) * N] for i, k in enumerate(_ROW_FIELDS)}
    views["row_tables"] = flat[len(_ROW_FIELDS) * N:].reshape(N, -1)
    return views


def _addresses(tensors) -> Tuple[int, ...]:
    return tuple(t.data_ptr() for t in tensors)


def _copy_tree(dst: dict, src: dict) -> None:
    """Copy a step's outputs ``src`` into the persistent ``dst`` (same tree)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_tree(dst[k], v)
        else:
            dst[k].copy_(v)


class StepForm:
    """One static step form: the ``N``-row step of one kind (a variant of
    the reference's jit cache), with what it owns for its engine's life.

    ``host`` is the rows' staging buffer (pinned on a CUDA device), which
    ``buffers`` views as numpy arrays for :meth:`ContinuousEngine.build_rows`
    to fill; ``dev`` the device buffer that ``rows`` views and :meth:`stage`
    copies the staging buffer into; ``out`` the step's outputs (a replay
    overwrites them, an eager run copies into them); ``graph`` the captured
    step on the card (None where the body runs eagerly), ``launches`` the
    kernel launches one replay makes (``kernels.counters.since``) and
    ``graph_bytes`` what its capture added to the graphs' memory pool;
    ``pools`` the addresses of the KV pools and scales the body reads."""

    def __init__(self, kind: str, N: int, blocks_per_slot: int, garbage_block: int, device,
                 pools):
        self.kind, self.N, self.garbage_block = kind, N, garbage_block
        width = (len(_ROW_FIELDS) + blocks_per_slot) * N
        self.host = torch.empty(width, dtype=torch.int32, pin_memory=device.type == "cuda")
        self.dev = torch.empty(width, dtype=torch.int32, device=device)
        self.buffers = _row_views(self.host.numpy(), N)
        self.rows = _row_views(self.dev, N)
        self.pools = _addresses(pools)
        self.out: Optional[dict] = None
        self.graph = None
        self.launches: Tuple[int, ...] = ()
        self.graph_bytes = 0
        self.reset()

    def reset(self) -> Dict[str, np.ndarray]:
        """Mask every row of the staging buffer (token 0, no identity,
        length 0, writing into the garbage block) and return its views."""
        b = self.buffers
        for k in ("tokens", "positions", "lengths", "slots", "wo"):
            b[k].fill(0)
        b["ctx_ids"].fill(-1)
        b["wb"].fill(self.garbage_block)
        b["row_tables"].fill(self.garbage_block)
        return b

    def stage(self) -> None:
        """The step's one host-to-device copy of its rows."""
        self.dev.copy_(self.host, non_blocking=True)


def _fill_row(b, cache: PagedKVCache, r: int, slot: int, token: int, pos: int) -> None:
    b["tokens"][r] = b["ctx_ids"][r] = token
    b["positions"][r] = pos
    b["lengths"][r] = pos + 1
    b["slots"][r] = slot
    b["wb"][r], b["wo"][r] = cache.write_coords(slot, pos)
    b["row_tables"][r] = cache.row_table(slot)


def _int64(x, device) -> torch.Tensor:
    """``x`` (a host array or a tensor) as int64 on ``device``; a tensor on
    the device is read where it lies, never through the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x), dtype=torch.int64, device=device)


def _row_uniforms(seed: int, slots, positions, V: int, device) -> torch.Tensor:
    """(N, V) float64 uniforms in (0, 1), one per (seed, slot, position,
    vocab index): a counter-based hash, the same integers on any device."""
    slots, positions = _int64(slots, device), _int64(positions, device)
    row = _mix32(_mix32(_mix32(torch.full_like(slots, int(seed) & _M32)) ^ slots) ^ positions)
    col = _mix32(torch.arange(V, dtype=torch.int64, device=device))
    bits = _mix32(_mix32(row[:, None] ^ col[None, :]))
    return (bits.double() + 0.5) * 2.0 ** -32


def _sample_rows(logits, slots, positions, temperature: float, seed: int,
                 temperature_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy: each row's first maximum, as ``jnp.argmax``.  ``temperature``
    > 0: one Gumbel-max draw per row over ``logits / T`` (its padded vocab
    columns, ``finfo.min``, stay unreachable), keyed by (seed, slot,
    absolute position).  The division is by a 0-dim f32 tensor
    (``temperature_t``, the engine's own, else made here): on the card a
    Python-number divisor goes through its reciprocal.  Returns (N,)
    int32 on the logits' device."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    u = _row_uniforms(seed, slots, positions, logits.shape[-1], logits.device)
    t = (temperature_t if temperature_t is not None
         else torch.tensor(temperature, dtype=torch.float32, device=logits.device))
    scores = (logits.float() / t).double() - torch.log(-torch.log(u))
    return scores.argmax(dim=-1).to(torch.int32)


@dataclasses.dataclass
class StepRows:
    """One step's host-side rows and the bookkeeping to apply after it."""

    buffers: Dict[str, np.ndarray]
    sample_rows: List[Tuple[int, RequestState]]
    prefilling: Optional[RequestState]
    chunk: int
    kind: str
    live: int

    @property
    def num_rows(self) -> int:
        return int(self.buffers["tokens"].shape[0])


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class ContinuousEngine:
    """Continuous-batching engine over a fixed slot pool.

    ``temperature`` is engine-level (0: greedy); ``seed`` keys the sampled
    draws.  ``serve.spec`` switches on speculative decoding;
    ``draft_model=(cfg, params)`` hands the ``model`` drafter an explicit
    draft model.  Drive it with :meth:`run` (a trace of :class:`Request`,
    virtual clock, per-request latencies) or :meth:`generate` (a batch of
    prompts, all admitted at t=0).  ``params`` is the port's param tree
    (``repro_torch.nn``) on ``device``.  On a mesh (``serve.mesh``) it is
    this rank's placement of the tree; ``mesh`` is the rank's
    :class:`repro_torch.launch.mesh.Mesh` (made from ``serve.mesh`` and
    ``device`` when not given).  ``graphs`` (on a CUDA device without a mesh)
    captures the step forms (paged, or recurrent) as CUDA graphs here, before any clock
    starts, and the model drafter's forwards beside them; ``graphs=False`` runs them
    eagerly.
    """

    def __init__(self, cfg: ModelConfig, params, serve: ServeConfig = ServeConfig(),
                 *, temperature: float = 0.0, seed: int = 0, device="cuda",
                 draft_model: Optional[Tuple] = None, check_invariants: bool = False,
                 obs: Optional[Observability] = None,
                 logit_tap: Optional[Callable] = None, mesh=None, graphs: bool = True):
        if cfg.family in _PAGED_FAMILIES:
            self.mode = "paged"
            if cfg.attn_logit_softcap > 0:
                raise NotImplementedError(
                    "paged decode attention does not implement logit softcap")
            if cfg.moe.moe_attention:
                raise NotImplementedError("moe_attention has no cached decode path")
        elif cfg.family in _RECURRENT_FAMILIES:
            self.mode = "recurrent"
        else:
            # the reference's refusal and reason
            raise NotImplementedError(
                f"continuous batching not implemented for family "
                f"{cfg.family!r} (zamba's shared-attention cache keeps one "
                f"batch-wide length; encdec needs per-request encoder memory)")
        check_mesh_support(cfg, serve)
        if self.mode == "recurrent":
            for cond, msg in (
                    (serve.spec is not None, "speculative decoding needs the paged KV "
                     "cache (recurrent slot states have no cheap rollback)"),
                    (serve.prefix_cache, "prefix caching needs the paged KV cache "
                     "(recurrent slot states are not content-addressable blocks)"),
                    (serve.kv_quant != "none", "KV quantization needs the paged KV cache "
                     "(recurrent slot states are not block pools)"),
                    (serve.slo is not None and serve.slo.preemption,
                     "preemption needs the paged KV cache (recurrent slot states have no "
                     "block-level swap); use SLOConfig(preemption=False) for "
                     "priority/deadline ordering alone")):
                if cond:
                    raise NotImplementedError(msg)
        if cfg.moe.num_experts > 0:
            get_router(cfg.moe.routing)
            get_dispatcher(cfg.moe.impl)
        if cfg.pos_embed == "learned" and serve.max_len > cfg.max_seq_len:
            # the reference's gather clamps out-of-range positions silently;
            # PyTorch would fail on the card, so refuse the config up front
            raise ValueError(
                f"serve max_len {serve.max_len} exceeds the learned position "
                f"table ({cfg.max_seq_len} positions)")
        self.device = torch.empty(0, device=device).device    # "cuda" -> "cuda:0"
        table = params["embed"]["table"]
        if table.device != self.device:
            raise ValueError(f"params on {table.device}, engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.serve = serve
        self.temperature = float(temperature)
        self.seed = seed
        self.steps = 0
        self.check_invariants = check_invariants
        self.obs = obs if obs is not None else Observability()
        # read-only spy on each step's logits: called with host arrays
        # (logits (N, V_pad) f32, slots, positions, lengths), length 0 marking
        # a padding row (an idle slot in recurrent mode, where the reference
        # has no tap)
        self._logit_tap = logit_tap
        self._moe_acc = None        # device-side telemetry accumulator
        self._moe_rows = 0
        self._seen_variants = 0     # compiled-variant census (recompile detection)
        self._temperature = torch.tensor(self.temperature, dtype=torch.float32,
                                         device=self.device)
        self.spec = serve.spec
        self.drafter = None
        self.mesh = self.rules = None
        self.data_shards = serve.data_shards
        if serve.mesh is not None:
            self._setup_mesh(mesh)
        if self.mode == "recurrent":
            self.fam = get_family(cfg)
            self.cache = None
            self._state = self.fam.init_state(cfg, serve.max_slots, serve.max_len,
                                              device=self.device)
            self.scheduler = Scheduler(serve.max_slots, serve.max_len, None,
                                       policy=serve.sched_policy, slo=serve.slo, obs=self.obs)
            self._expected_variants = 1         # one (max_slots, 1) shape
            self._rec_forms: Dict[str, GraphForm] = {}
            self._graph_pool = None
            if graphs and self.device.type == "cuda":
                self._graph_pool = torch.cuda.graph_pool_handle()
                for kind in ("step", "reset"):
                    self._rec_form(kind)
            return
        self.layers = unstack_layers(params["blocks"], cfg.num_layers)
        self.cache = make_kv_cache(cfg, serve, device=self.device,
                                   shard=self.mesh.coord["data"] if self.mesh else 0)
        self.scheduler = Scheduler(serve.max_slots, serve.max_len, self.cache,
                                   policy=serve.sched_policy, slo=serve.slo, obs=self.obs)
        # the documented census: {mixed, decode}, plus verify when speculating
        kinds = ("decode", "mixed") + (("verify",) if self.spec is not None else ())
        self._expected_variants = len(kinds)
        self._forms: Dict[str, StepForm] = {}
        self._graph_pool = None
        if graphs and self.device.type == "cuda" and self.mesh is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        if self.spec is not None:
            from repro_torch.serving.speculative import make_drafter

            self.drafter = make_drafter(self.spec, cfg, serve, seed=seed,
                                        draft_model=draft_model, device=self.device)
            # a drafter with a form of its own (the model drafter's forwards)
            # is captured on the engine's pool; the census does not count it
            if self._graph_pool is not None and hasattr(self.drafter, "capture"):
                self.drafter.capture(self._graph_pool)
        if self._graph_pool is not None:
            for kind in kinds:
                self._form(kind)

    def _setup_mesh(self, mesh) -> None:
        """The rank's mesh and rules; ``params`` must be the rank's placement
        under them (the expert leaves its ``E / ne`` experts)."""
        from repro_torch.distributed.sharding import check_placed, make_rules
        from repro_torch.launch.mesh import make_serve_mesh

        if mesh is None:
            mesh = make_serve_mesh(self.serve.mesh, self.device)
        if tuple(mesh.shape.items()) != tuple((a, int(n)) for a, n in self.serve.mesh):
            raise ValueError(f"mesh {mesh.shape} is not serve.mesh {self.serve.mesh}")
        if mesh.device != self.device:
            raise ValueError(f"mesh rank on {mesh.device}, engine on {self.device}")
        self.mesh = mesh
        # data carries slots and groups, expert the FFN experts: what the
        # ragged expert-parallel dispatch wants
        self.rules = make_rules(self.cfg, mesh, expert_axis="expert")
        check_placed(self.params, self.rules, keep=("router",))

    # -- observability ------------------------------------------------------

    @property
    def spec_stats(self) -> Dict[str, int]:
        """Dict view over the speculative-decoding counters."""
        m = self.obs.metrics
        return {"verify_steps": int(m.get("spec_verify_steps_total")),
                "proposed": int(m.get("spec_proposed_total")),
                "accepted": int(m.get("spec_accepted_total")),
                "emitted": int(m.get("spec_emitted_total"))}

    def compiled_variants(self) -> int:
        """The engine's static step forms, the reference's jit-cache census:
        the graphs captured on the card; on the CPU, ``meta`` or a mesh the
        forms built so far (each at its kind's first step, as jit compiles a
        shape at its first call); the recurrent step's one once it ran."""
        if self.mode == "recurrent":
            return int("step" in self._rec_forms)
        return len(self._forms)

    @property
    def graph_pool_bytes(self) -> int:
        """Device bytes the captured graphs' shared memory pool holds, the
        model drafter's included (0 where the forms run eagerly)."""
        if self.mode != "paged":
            return 0
        return (sum(f.graph_bytes for f in self._forms.values())
                + getattr(self.drafter, "graph_bytes", 0))

    def _obs_step(self, kind: str, live_rows: int, total_rows: int) -> None:
        m = self.obs.metrics
        sched = self.scheduler
        m.counter("engine_steps_total", kind=kind).inc()
        m.counter("engine_rows_total", state="live").inc(live_rows)
        m.counter("engine_rows_total", state="padded").inc(total_rows - live_rows)
        m.gauge("queue_depth").set(len(sched.waiting))
        m.gauge("running_slots").set(len(sched.running))
        m.gauge("serve_peak_running").set_max(len(sched.running))
        for d, occ in enumerate(self.cache.occupancy() if self.cache is not None else ()):
            for state in ("free", "live", "cached"):
                m.gauge("kv_blocks", state=state, shard=d).set(occ[state])
            m.gauge("kv_reserved_blocks", shard=d).set(occ["reserved"])
            rows = occ["free"] + occ["live"] + occ["cached"] + 1
            m.gauge("kv_pool_bytes", shard=d).set(rows * occ["block_bytes"])
        if self.serve.prefix_cache:
            for k, v in self.cache.stats.items():
                m.counter(f"prefix_{k}_total").set_to(v)
        n = self.compiled_variants()
        if n != self._seen_variants:
            m.gauge("engine_compiled_variants").set(n)
            if n > self._expected_variants:
                m.counter("engine_recompiles_total").inc(
                    n - max(self._seen_variants, self._expected_variants))
                self.obs.tracer.instant("recompile", variants=n,
                                        expected=self._expected_variants)
            self._seen_variants = n
        self.obs.maybe_metrics_row(self.steps)

    # -- MoE routing telemetry: device-side sums, one host pull per run --------

    def _moe_reset(self) -> None:
        self._moe_acc = None
        self._moe_rows = 0

    def _moe_accum(self, telem, rows: int) -> None:
        if not telem:
            return
        add = {"expert_tokens": telem["expert_tokens"],
               "gate_entropy": telem["gate_entropy"] * float(rows),
               "dropped": telem["dropped"],
               "routed_choices": telem["routed_choices"]}
        if self._moe_acc is None:
            # the step's outputs are its form's, which the next step overwrites
            self._moe_acc = {k: v.clone() for k, v in add.items()}
        else:
            self._moe_acc = {k: self._moe_acc[k] + add[k] for k in add}
        self._moe_rows += rows

    def _moe_pull(self) -> Dict[str, float]:
        if self._moe_acc is None:
            return {}
        acc = {k: v.double().cpu().numpy() for k, v in self._moe_acc.items()}
        tok, ent = acc["expert_tokens"], acc["gate_entropy"]
        drop, choices = acc["dropped"], acc["routed_choices"]
        rows = max(self._moe_rows, 1)
        m = self.obs.metrics
        for layer in range(tok.shape[0]):
            if choices[layer] <= 0:
                continue
            tot = tok[layer].sum()
            for e in range(tok.shape[1]):
                m.gauge("moe_expert_load_share", layer=layer, expert=e).set(
                    tok[layer, e] / max(tot, 1.0))
            m.gauge("moe_load_entropy", layer=layer).set(load_entropy(tok[layer]))
            m.gauge("moe_gate_entropy", layer=layer).set(ent[layer] / rows)
            m.gauge("moe_dropped_fraction", layer=layer).set(drop[layer] / choices[layer])
        moe_layers = choices > 0
        loads = tok[moe_layers].sum(axis=0)
        mean = loads.mean() if loads.size else 0.0
        stats = {
            "moe_dropped_fraction": float(drop.sum() / max(choices.sum(), 1.0)),
            "moe_gate_entropy": float(ent[moe_layers].mean() / rows) if moe_layers.any() else 0.0,
            "moe_load_entropy": float(load_entropy(loads)),
            "moe_load_cv": float(loads.std() / (mean + 1e-9)),
        }
        m.gauge("moe_dropped_fraction_overall").set(stats["moe_dropped_fraction"])
        return stats

    # -- one engine step ----------------------------------------------------

    def step(self, clock_ms: float = 0.0) -> List[RequestState]:
        """Preempt and shed (``serve.slo``), admit, run one mixed
        prefill/decode (or speculative verify) step, process samples.
        Returns the requests that finished, after the ones shed this step."""
        self.scheduler.maybe_preempt(clock_ms)
        shed = self.scheduler.shed_unmeetable(clock_ms)
        admitted = self.scheduler.admit(clock_ms)
        if self.mode == "recurrent":
            for st in admitted:
                self._reset_slot(st.slot)
        if not self.scheduler.running:
            return shed
        if self.mode == "recurrent":
            finished = self._recurrent_host_step(clock_ms)
        # speculate only in decode-only steps: mid-prefill, the mixed step
        # makes prompt progress and decode slots emit one token
        elif self.spec is not None and self.scheduler.prefilling is None:
            finished = self._verify_host_step(clock_ms)
        else:
            finished = self._paged_host_step(clock_ms)
        self.steps += 1
        if self.check_invariants:
            self.scheduler.check_conservation()
        return shed + finished

    def build_rows(self) -> StepRows:
        """The next step's rows: every decoding slot's token, then the
        current chunk of the earliest-admitted prefilling request.  Grows
        the slots' KV blocks to cover the positions written.

        The layout is shard-major over the mesh's data axis (with D = 1 the
        S decode rows, then the chunk rows): shard d owns rows ``[d * per,
        (d + 1) * per)``, its own ``S / D`` slots' decode rows first, then,
        on the prefilling slot's shard, the chunk rows.  The buffers are the
        step form's staging buffer, which the next step's rows overwrite."""
        serve, cache, sched = self.serve, self.cache, self.scheduler
        S = serve.max_slots
        pre = sched.prefilling
        chunk = 0
        if pre is not None:
            stream, target = pre.confirmed_tokens, pre.prefill_target
            chunk = min(serve.prefill_chunk, target - pre.prefill_pos)
        D = self.data_shards
        spd = S // D
        per = spd + (serve.prefill_chunk if pre is not None else 0)
        kind = "mixed" if pre is not None else "decode"
        b = self._form(kind).reset()
        sample_rows: List[Tuple[int, RequestState]] = []
        for slot, st in sched.running.items():
            if st.status is not Status.DECODE:
                continue
            pos = st.context_len
            cache.ensure_capacity(slot, pos + 1)
            row = (slot // spd) * per + slot % spd
            _fill_row(b, cache, row, slot, st.last_token, pos)
            sample_rows.append((row, st))
        if pre is not None:
            cache.ensure_capacity(pre.slot, pre.prefill_pos + chunk)
            base = (pre.slot // spd) * per + spd
            for j in range(chunk):
                row, p = base + j, pre.prefill_pos + j
                _fill_row(b, cache, row, pre.slot, stream[p], p)
                # sample off the last prompt row only
                if p == pre.request.prompt_len - 1 and not pre.generated:
                    sample_rows.append((row, pre))
        live = len(sample_rows) + chunk
        if pre is not None and any(st is pre for _, st in sample_rows):
            live -= 1       # pre's sample row is one of its chunk rows
        return StepRows(b, sample_rows, pre, chunk, kind, live)

    def _forward(self, rows):
        """The forward over a form's device ``rows`` (K/V written in place):
        (float32 logits (N, V_pad), per-layer telemetry)."""
        cache = self.cache
        with use_rules(self.rules), torch.no_grad():
            return _paged_logits(self.params, self.layers, self.cfg, rows, cache.k_pool,
                                 cache.v_pool, cache.k_scales, cache.v_scales, cache.policy,
                                 mesh=self.mesh)

    # -- the static step forms ---------------------------------------------

    def _pools(self) -> Tuple[torch.Tensor, ...]:
        c = self.cache
        return tuple(t for t in (c.k_pool, c.v_pool, c.k_scales, c.v_scales) if t is not None)

    def _form(self, kind: str) -> StepForm:
        """The step form of ``kind``, built at its first use (on the card
        with graphs, all of them when the engine is built)."""
        form = self._forms.get(kind)
        if form is None:
            S, serve = self.serve.max_slots, self.serve
            N = (S * (self.spec.gamma + 1) if kind == "verify"
                 else S + self.data_shards * serve.prefill_chunk if kind == "mixed" else S)
            form = StepForm(kind, N, serve.blocks_per_slot, self.cache.garbage_block,
                            self.device, self._pools())
            if self._graph_pool is not None:
                self._capture(form)
            self._forms[kind] = form
        return form

    def _body(self, form: StepForm) -> dict:
        """The step over ``form``'s device rows: forward, then the sampled
        tokens (a verify step: the argmax ids, or the logits when sampling);
        reads no host value, so it can be captured."""
        rows = form.rows
        logits, telem = self._forward(rows)
        if form.kind == "verify":
            scores = logits.argmax(dim=-1).to(torch.int32) if self.temperature <= 0.0 else logits
            return {"scores": scores, "telem": telem}
        out = {"tokens": _sample_rows(logits, rows["slots"], rows["positions"],
                                      self.temperature, self.seed, self._temperature),
               "telem": telem}
        if self._logit_tap is not None:
            out["logits"] = logits
        return out

    def _capture(self, form: StepForm) -> None:
        """Capture ``form``'s step as a CUDA graph on the engine's pool
        (``serving.graphs.capture``), its warm-up over all-padding rows
        that write only the garbage block."""
        form.stage()
        form.graph, form.out, form.launches, form.graph_bytes = capture(
            lambda: self._body(form), self.device, self._graph_pool,
            f"the {form.kind} step ({form.N} rows)")[:4]

    def _run(self, form: StepForm) -> dict:
        """One step of ``form`` over its staging buffer: the copy, then the
        replay (or the eager body); returns the form's outputs."""
        if _addresses(self._pools()) != form.pools:
            raise RuntimeError(f"the KV pools were rebound: the {form.kind} step form holds "
                               f"their addresses (pools are written in place for the engine's "
                               f"life)")
        form.stage()
        if form.graph is not None:
            form.graph.replay()
            counters.add(form.launches)
        elif form.out is None:
            form.out = self._body(form)
        else:
            _copy_tree(form.out, self._body(form))
        return form.out

    def _shard_spans(self, sr: StepRows) -> None:
        """Per-shard child spans of a mesh step: each data shard's slice of
        the rows, with its own live-row census."""
        tr = self.obs.tracer
        if self.mesh is None or not tr.enabled:
            return
        per = sr.num_rows // self.data_shards
        for d in range(self.data_shards):
            live = int(np.count_nonzero(sr.buffers["lengths"][d * per:(d + 1) * per]))
            with tr.span("engine_step_shard", kind=sr.kind, step=self.steps, shard=d,
                         rows=per, live_rows=live):
                pass

    def _check_ranks_agree(self, tokens: torch.Tensor) -> None:
        """Every mesh rank sampled the same tokens (all-gathered, never
        broadcast: a rank that diverged is found, not overwritten)."""
        from repro_torch.distributed.collectives import all_gather

        every = all_gather(tokens[None], self.mesh.world, dim=0).cpu()
        if not bool((every == every[:1]).all()):
            bad = [r for r in range(every.shape[0]) if not torch.equal(every[r], every[0])]
            raise AssertionError(f"step {self.steps}: ranks {bad} sampled other tokens than "
                                 f"rank 0")

    def _paged_host_step(self, clock_ms: float) -> List[RequestState]:
        sr = self.build_rows()
        with self.obs.tracer.span("engine_step", kind=sr.kind, step=self.steps,
                                  rows=sr.num_rows, live_rows=sr.live):
            self._shard_spans(sr)
            out = self._run(self._forms[sr.kind])
            b = sr.buffers
            if self._logit_tap is not None:
                # copies: the form's buffers are the next step's
                self._logit_tap(out["logits"].to("cpu", copy=True).numpy(), b["slots"].copy(),
                                b["positions"].copy(), b["lengths"].copy())
            if self.mesh is not None and self.check_invariants:
                self._check_ranks_agree(out["tokens"])
            next_tok = out["tokens"].cpu().numpy()
        self._moe_accum(out["telem"], sr.num_rows)
        pre = sr.prefilling
        if pre is not None:
            pre.prefill_pos += sr.chunk
            if pre.prefill_pos == pre.prefill_target:
                pre.status = Status.DECODE
                self.obs.request_phase(pre.request.uid, "decode", slot=pre.slot)
        finished = self._collect_samples(next_tok, sr.sample_rows, clock_ms)
        self._commit_running()
        self._obs_step(sr.kind, sr.live, sr.num_rows)
        return finished

    def _commit_running(self) -> None:
        """Prefix caching: confirm every running slot's written tokens so
        newly full blocks publish into the index while the request runs
        (concurrent requests of one tenant then share them).  Finished
        slots were committed by ``Scheduler.finish``."""
        if not self.serve.prefix_cache:
            return
        bs, cache = self.cache.block_size, self.cache
        for slot, st in self.scheduler.running.items():
            stream = st.confirmed_tokens
            written = st.prefill_pos if st.status is Status.PREFILL else stream.size
            if written // bs > cache.committed_blocks(slot):
                cache.commit(slot, stream[:written])

    # -- speculative verify step --------------------------------------------

    def _host_rng(self, slot: int, position: int) -> np.random.Generator:
        """The generator of host-side acceptance sampling for (slot,
        position), the reference's own (numpy, bit for bit)."""
        return np.random.default_rng(
            np.random.SeedSequence(entropy=[self.seed, slot, position]))

    def _verify_host_step(self, clock_ms: float) -> List[RequestState]:
        serve, cache, sched = self.serve, self.cache, self.scheduler
        gamma = self.spec.gamma
        W = gamma + 1
        N = serve.max_slots * W
        items: List[DraftItem] = []
        for slot, st in sorted(sched.running.items()):
            # remaining >= 1 in decode (a drained budget evicts); clamping the
            # draft to it keeps every draft KV write below total_len, inside
            # the admission reservation
            remaining = st.request.max_new_tokens - len(st.generated)
            context = np.concatenate([st.request.prompt,
                                      np.asarray(st.generated, np.int32)]).astype(np.int32)
            items.append(DraftItem(slot=slot, context=context,
                                   max_tokens=min(gamma, remaining)))
        drafts = [np.asarray(d, np.int32).reshape(-1)[:it.max_tokens]
                  for it, d in zip(items, self.drafter.propose(items))]
        if all(d.size == 0 for d in drafts):
            # nothing to verify: an ordinary decode step costs 1/(gamma+1) of
            # the rows for the same one token per slot
            return self._paged_host_step(clock_ms)

        form = self._form("verify")
        b = form.reset()
        per_slot: Dict[int, Tuple[RequestState, np.ndarray, int]] = {}
        for it, d in zip(items, drafts):
            st = sched.running[it.slot]
            c = st.context_len
            cache.ensure_capacity(it.slot, c + d.size + 1)
            for j, tok in enumerate([st.last_token, *d.tolist()]):
                _fill_row(b, cache, it.slot * W + j, it.slot, tok, c + j)
            per_slot[it.slot] = (st, d, c)
        live = sum(int(d.size) + 1 for _, d, _ in per_slot.values())
        with self.obs.tracer.span("engine_step", kind="verify", step=self.steps, rows=N,
                                  live_rows=live):
            # greedy acceptance compares ids only: the form ships N int32
            # argmaxes, not the (N, V_pad) logits
            out = self._run(form)
            scores = out["scores"].cpu().numpy()
        self._moe_accum(out["telem"], N)

        finished = []
        m = self.obs.metrics
        for slot, (st, d, c) in per_slot.items():
            g = int(d.size)
            rows = scores[slot * W: slot * W + g + 1]
            if self.temperature <= 0.0:
                emitted, n_acc = accept_greedy_ids(d, rows)
            else:
                emitted, n_acc = accept_rejection(
                    d, rows, self.temperature,
                    lambda j, slot=slot, c=c: self._host_rng(slot, c + j))
            emitted = emitted[:st.request.max_new_tokens - len(st.generated)]
            eos = st.request.eos_id
            if eos is not None and eos in emitted:
                emitted = emitted[:emitted.index(eos) + 1]
            m.counter("spec_proposed_total").inc(g)
            # accepted = draft tokens actually used: an EOS or budget cut can
            # discard accepted drafts, which must not inflate the rate
            m.counter("spec_accepted_total").inc(min(len(emitted), n_acc))
            m.counter("spec_emitted_total").inc(len(emitted))
            st.generated.extend(int(t) for t in emitted)
            if st.first_token_ms is None:
                st.first_token_ms = clock_ms
            if st.done():
                sched.finish(st, clock_ms)
                finished.append(st)
            else:
                # positions [0, c + len(emitted)) stay written (row j wrote
                # draft token j at c + j, which for every kept row is the
                # fed-back token); the rejected rows' positions rewind
                cache.truncate_slot(slot, c + len(emitted))
        m.counter("spec_verify_steps_total").inc()
        self._commit_running()
        self._obs_step("verify", live, N)
        return finished

    # -- recurrent slots -----------------------------------------------------

    def _rec_form(self, kind: str) -> GraphForm:
        """The recurrent ``step`` (the reference's ``_step_fn``: one
        ``(max_slots, 1)`` decode of every slot's state, its new states
        copied into the persistent ones, then the sampled tokens) or the
        slot ``reset`` (its ``_reset_fn`` over a traced slot: the slot's
        rows of every state zeroed), built at first use (on the card with
        graphs, when the engine is built).  The step's input is the
        tokens, then the positions, of every slot (``_rec_host``, pinned on
        the card, stages them); the reset's the slot, on the device."""
        form = self._rec_forms.get(kind)
        if form is not None:
            return form
        S, dev = self.serve.max_slots, self.device
        # the bodies hold no reference to the engine (a dropped engine frees
        # its graphs without a collection)
        fam, cfg, params, state = self.fam, self.cfg, self.params, self._state
        if kind == "step":
            self._rec_host = torch.zeros(2 * S, dtype=torch.int64, pin_memory=dev.type == "cuda")
            rows = torch.zeros(2 * S, dtype=torch.int64, device=dev)
            slots = torch.arange(S, device=dev)
            temperature, seed, temperature_t = self.temperature, self.seed, self._temperature
            tap = self._logit_tap is not None

            def body():
                with torch.no_grad():
                    logits, new = fam.decode(params, rows[:S, None], state, cfg,
                                             ctx=MoEContext())
                    copy_state(state, new)
                    lg = logits[:, -1, :].float()
                    out = {"tokens": _sample_rows(lg, slots, rows[S:], temperature, seed,
                                                  temperature_t)}
                    if tap:
                        out["logits"] = lg
                    return out

            form = GraphForm(body, f"the recurrent step ({S} slots)", inputs=rows)
        else:
            slot = torch.zeros(1, dtype=torch.int64, device=dev)

            def body():
                for t in tree_leaves(state):
                    t.index_fill_(0, slot, 0)

            form = GraphForm(body, "the recurrent slot reset", inputs=slot)
        if self._graph_pool is not None:
            form.capture(dev, self._graph_pool)
            zero_state(self._state)         # the warm-up stepped every slot
        self._rec_forms[kind] = form
        return form

    def _reset_slot(self, slot: int) -> None:
        self._rec_form("reset").run(torch.tensor([slot]))

    def _recurrent_host_step(self, clock_ms: float) -> List[RequestState]:
        """One ``(max_slots, 1)`` step over every slot's state: a
        prefilling slot feeds its next prompt token, a decoding slot its
        last token; idle slots feed token 0 into a state nobody reads."""
        S = self.serve.max_slots
        form = self._rec_form("step")
        host = self._rec_host.numpy()
        host.fill(0)
        tokens, positions = host[:S], host[S:]
        sample_rows: List[Tuple[int, RequestState]] = []
        prefill_advanced: List[RequestState] = []
        for slot, st in self.scheduler.running.items():
            positions[slot] = st.context_len
            if st.status is Status.PREFILL:
                tokens[slot] = st.request.prompt[st.prefill_pos]
                positions[slot] = st.prefill_pos
                prefill_advanced.append(st)
                if st.prefill_pos + 1 == st.request.prompt_len:
                    sample_rows.append((slot, st))
            else:
                tokens[slot] = st.last_token
                sample_rows.append((slot, st))
        live = len(self.scheduler.running)
        with self.obs.tracer.span("engine_step", kind="decode", step=self.steps, rows=S,
                                  live_rows=live):
            out = form.run(self._rec_host)
            if self._logit_tap is not None:
                # copies: the form's buffers are the next step's
                lengths = np.zeros(S, np.int64)
                for slot in self.scheduler.running:
                    lengths[slot] = positions[slot] + 1
                self._logit_tap(out["logits"].to("cpu", copy=True).numpy(), np.arange(S),
                                positions.copy(), lengths)
            next_tok = out["tokens"].cpu().numpy()
        for st in prefill_advanced:
            st.prefill_pos += 1
            if st.prefill_pos == st.request.prompt_len:
                st.status = Status.DECODE
                self.obs.request_phase(st.request.uid, "decode", slot=st.slot)
        self._obs_step("decode", live, S)
        return self._collect_samples(next_tok, sample_rows, clock_ms)

    def _collect_samples(self, next_tok: np.ndarray, sample_rows, clock_ms: float
                         ) -> List[RequestState]:
        finished = []
        for row, st in sample_rows:
            st.generated.append(int(next_tok[row]))
            if st.first_token_ms is None:
                st.first_token_ms = clock_ms
            if st.done():
                self.scheduler.finish(st, clock_ms)
                finished.append(st)
        return finished

    # -- entry points -------------------------------------------------------

    def run(self, requests: List[Request], *,
            on_finish: Optional[Callable[[RequestState], None]] = None
            ) -> Tuple[Dict[int, List[int]], Dict[str, float]]:
        """Serve a trace to completion on a wall clock fast-forwarded over
        idle gaps; latency = finish - arrival.  Returns ({uid: tokens}, stats)."""
        m = self.obs.metrics
        for r in requests:
            self.scheduler.add(r)
        t0 = time.perf_counter()
        mark = m.mark()
        m.gauge("serve_peak_running").set(0.0)
        self._moe_reset()
        clock = 0.0
        done: List[RequestState] = []
        while self.scheduler.has_work():
            clock = max(clock, (time.perf_counter() - t0) * 1e3)
            if self.mesh is not None:   # the ranks admit alike on one clock
                clock = agree_max(clock, self.mesh.world, self.device)
            if not self.scheduler.running:
                nxt = self.scheduler.next_arrival_ms()
                if nxt is not None and nxt > clock:
                    clock = nxt                      # idle: jump to next arrival
            finished = self.step(clock)
            # shed requests never ran: they do not count toward the peak
            ran = sum(st.status is not Status.SHED for st in finished)
            m.gauge("serve_peak_running").set_max(len(self.scheduler.running) + ran)
            for st in finished:
                done.append(st)
                if on_finish is not None:
                    on_finish(st)
        total_ms = max(clock, (time.perf_counter() - t0) * 1e3)
        sched = self.scheduler
        sched.check_conservation()
        # a shed request resolved without a token: kept out of the latency
        # and goodput stats, so "met its deadline" means "was served by it"
        served = [st for st in done if st.status is not Status.SHED]
        stats = latency_stats([st.latency_ms() for st in served], total_ms,
                              sum(len(st.generated) for st in served))
        stats["steps"] = m.delta(mark, "engine_steps_total")
        stats["peak_running"] = m.get("serve_peak_running")
        stats.update(slo_class_stats(served))
        if self.serve.slo is not None and self.serve.slo.shed:
            stats["requests_shed"] = m.delta(mark, "requests_shed_total")
        if sched.swap is not None:
            for key, counter in (("preemptions", "sched_preemptions_total"),
                                 ("restore_tokens", "sched_restore_tokens_total"),
                                 ("recompute_tokens", "sched_recompute_tokens_total"),
                                 ("swapped_blocks", "swap_swapped_blocks_total"),
                                 ("restored_blocks", "swap_restored_blocks_total")):
                stats[key] = m.delta(mark, counter)
        if self.serve.prefix_cache:
            cached = m.delta(mark, "prefix_cached_tokens_total")
            prompt = m.delta(mark, "prefix_prompt_tokens_total")
            stats["cached_tokens"] = cached
            stats["prompt_tokens"] = prompt
            stats["cached_token_ratio"] = cached / max(prompt, 1)
        if self.spec is not None:
            proposed = m.delta(mark, "spec_proposed_total")
            stats["acceptance_rate"] = m.delta(mark, "spec_accepted_total") / max(proposed, 1)
            stats["spec_tokens_per_step"] = (m.delta(mark, "spec_emitted_total")
                                             / max(m.delta(mark, "spec_verify_steps_total"), 1))
        stats.update(self._moe_pull())
        return {st.request.uid: list(st.generated) for st in done}, stats

    def generate(self, prompts, num_tokens: int, seed: int = 0):
        """(B, S) prompts, all admitted at t=0, each generating
        ``num_tokens``.  Returns ((B, num_tokens) int32 numpy, stats)."""
        del seed  # sampling keys are engine-level (seed, slot, position)
        prompts = np.asarray(prompts)
        reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=num_tokens)
                for i in range(prompts.shape[0])]
        out, stats = self.run(reqs)
        return np.stack([out[i] for i in range(prompts.shape[0])]).astype(np.int32), stats
