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

Differences from the reference, by design of the port:

* the KV pools are updated in place (the reference's jit donates them
  and adopts the returned pools);
* PyTorch runs the step eagerly, so there is no compiled-variant census;
* meshes, SLO scheduling and recurrent families are not ported and raise
  NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.dispatch import get_dispatcher
from repro_torch.core.metrics import load_entropy
from repro_torch.core.moe import moe_ffn_apply
from repro_torch.core.routers import get_router
from repro_torch.kernels.decode_attention import (
    paged_update_attention,
    quantized_paged_update_attention,
)
from repro_torch.models import layers as L
from repro_torch.models.attention import _project_qkv
from repro_torch.models.transformer import _is_moe_layer, unstack_layers
from repro_torch.obs import Observability
from repro_torch.serving.kv_cache import PagedKVCache, make_kv_cache
from repro_torch.serving.request import Request, RequestState, Status
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.speculative.accept import accept_greedy_ids, accept_rejection
from repro_torch.serving.speculative.base import DraftItem
from repro_torch.serving.trace import latency_stats

_PAGED_FAMILIES = ("decoder_lm", "vlm", "m6")
_ROW_FIELDS = ("tokens", "ctx_ids", "positions", "lengths", "wb", "wo")  # sent to the device


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
                 max_length=None):
    """One pre-norm block over the flat row batch ``x: (1, N, d)``; writes
    this step's K/V into ``kp``/``vp`` in place before attending (quantized
    into the code pools, with the scale pools ``ksc``/``vsc``, when
    ``policy`` is set).  ``max_length``, the rows' longest context known on
    the host, only informs the attention kernel's launch plan."""
    N = x.shape[1]
    h = L.norm_apply(bp["ln_attn"], x, cfg)
    q, k, v = _project_qkv(bp["attn"], h, cfg, positions)        # (1, N, H*, D)
    if policy is None:
        out, _, _ = paged_update_attention(q[0].contiguous(), k[0], v[0], kp, vp,
                                           wb, wo, row_tables, lengths, max_length)
    else:
        out = quantized_paged_update_attention(q[0].contiguous(), k[0], v[0], kp, vp,
                                               ksc, vsc, wb, wo, row_tables, lengths,
                                               policy=policy, max_length=max_length)[0]
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
                  k_scales=None, v_scales=None, policy=None, max_length=None):
    """Flat-row forward: embed -> blocks -> float32 logits (N, V_pad), plus
    the per-layer routing telemetry stacked ``(L, ...)`` ({} when dense).
    ``policy`` (a quantized ``KVQuantPolicy``) switches the K/V write and
    attention to the quantized ops over the (L, P, Hkv) scale pools."""
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
            vsc=v_scales[i] if quantized else None, policy=policy, max_length=max_length)
        telems.append(tl)
    telem = ({} if cfg.moe.num_experts == 0
             else {k: torch.stack([t[k] for t in telems]) for k in telems[0]})
    x = L.norm_apply(params["final_norm"], x, cfg)
    unembed = params.get("unembed", params["embed"])
    return L.unembed_apply(unembed, x, cfg)[0].float(), telem


def _row_buffers(N: int, blocks_per_slot: int, garbage_block: int):
    """Host-side rows for one step, every row masked: token 0, no identity,
    length 0, writing into the garbage block."""
    return dict(
        tokens=np.zeros(N, np.int32),
        ctx_ids=np.full(N, -1, np.int32),
        positions=np.zeros(N, np.int32),
        lengths=np.zeros(N, np.int32),
        slots=np.zeros(N, np.int32),
        wb=np.full(N, garbage_block, np.int32),
        wo=np.zeros(N, np.int32),
        row_tables=np.full((N, blocks_per_slot), garbage_block, np.int32),
    )


def _fill_row(b, cache: PagedKVCache, r: int, slot: int, token: int, pos: int) -> None:
    b["tokens"][r] = b["ctx_ids"][r] = token
    b["positions"][r] = pos
    b["lengths"][r] = pos + 1
    b["slots"][r] = slot
    b["wb"][r], b["wo"][r] = cache.write_coords(slot, pos)
    b["row_tables"][r] = cache.row_table(slot)


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for ``x`` in [0, 2**32), with ``c`` split into
    16-bit halves so that no product leaves int64 (< 2**49)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A bijection of [0, 2**32) with full avalanche (the "lowbias32" integer
    hash); ``x`` an int64 tensor or a Python int."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _row_uniforms(seed: int, slots, positions, V: int, device) -> torch.Tensor:
    """(N, V) float64 uniforms in (0, 1), one per (seed, slot, position,
    vocab index): a counter-based hash, the same integers on any device."""
    slots = torch.as_tensor(np.asarray(slots), dtype=torch.int64, device=device)
    positions = torch.as_tensor(np.asarray(positions), dtype=torch.int64, device=device)
    row = _mix32(_mix32(_mix32(torch.full_like(slots, int(seed) & _M32)) ^ slots) ^ positions)
    col = _mix32(torch.arange(V, dtype=torch.int64, device=device))
    bits = _mix32(_mix32(row[:, None] ^ col[None, :]))
    return (bits.double() + 0.5) * 2.0 ** -32


def _sample_rows(logits, slots, positions, temperature: float, seed: int) -> torch.Tensor:
    """Greedy: each row's first maximum, as ``jnp.argmax``.  ``temperature``
    > 0: one Gumbel-max draw per row over ``logits / T`` (its padded vocab
    columns, ``finfo.min``, stay unreachable), keyed by (seed, slot,
    absolute position).  The division is by a 0-dim f32 tensor: on the card
    a Python-number divisor goes through its reciprocal.  Returns (N,)
    int32 on the logits' device."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    u = _row_uniforms(seed, slots, positions, logits.shape[-1], logits.device)
    t = torch.tensor(temperature, dtype=torch.float32, device=logits.device)
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
    (``repro_torch.nn``) on ``device``.
    """

    def __init__(self, cfg: ModelConfig, params, serve: ServeConfig = ServeConfig(),
                 *, temperature: float = 0.0, seed: int = 0, device="cuda",
                 draft_model: Optional[Tuple] = None, check_invariants: bool = False,
                 obs: Optional[Observability] = None,
                 logit_tap: Optional[Callable] = None):
        if cfg.family not in _PAGED_FAMILIES:
            raise NotImplementedError(
                f"continuous batching for family {cfg.family!r} is not ported "
                f"(paged families: {_PAGED_FAMILIES})")
        if cfg.attn_logit_softcap > 0:
            raise NotImplementedError("paged decode attention does not implement logit softcap")
        if cfg.moe.moe_attention:
            raise NotImplementedError("moe_attention has no cached decode path")
        for what, value in (("mesh serving (serve.mesh)", serve.mesh),
                            ("SLO scheduling (serve.slo)", serve.slo)):
            if value is not None:
                raise NotImplementedError(f"{what} is not ported")
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
        self.layers = unstack_layers(params["blocks"], cfg.num_layers)
        self.serve = serve
        self.temperature = float(temperature)
        self.seed = seed
        self.steps = 0
        self.check_invariants = check_invariants
        self.obs = obs if obs is not None else Observability()
        # read-only spy on each step's logits: called with host arrays
        # (logits (N, V_pad) f32, slots, positions, lengths), length 0 marking
        # a padding row
        self._logit_tap = logit_tap
        self._moe_acc = None        # device-side telemetry accumulator
        self._moe_rows = 0
        self.cache = make_kv_cache(cfg, serve, device=self.device)
        self.scheduler = Scheduler(serve.max_slots, serve.max_len, self.cache,
                                   policy=serve.sched_policy, obs=self.obs)
        self.spec = serve.spec
        self.drafter = None
        if self.spec is not None:
            from repro_torch.serving.speculative import make_drafter

            self.drafter = make_drafter(self.spec, cfg, serve, seed=seed,
                                        draft_model=draft_model, device=self.device)

    # -- observability ------------------------------------------------------

    @property
    def spec_stats(self) -> Dict[str, int]:
        """Dict view over the speculative-decoding counters."""
        m = self.obs.metrics
        return {"verify_steps": int(m.get("spec_verify_steps_total")),
                "proposed": int(m.get("spec_proposed_total")),
                "accepted": int(m.get("spec_accepted_total")),
                "emitted": int(m.get("spec_emitted_total"))}

    def _obs_step(self, kind: str, live_rows: int, total_rows: int) -> None:
        m = self.obs.metrics
        sched = self.scheduler
        m.counter("engine_steps_total", kind=kind).inc()
        m.counter("engine_rows_total", state="live").inc(live_rows)
        m.counter("engine_rows_total", state="padded").inc(total_rows - live_rows)
        m.gauge("queue_depth").set(len(sched.waiting))
        m.gauge("running_slots").set(len(sched.running))
        m.gauge("serve_peak_running").set_max(len(sched.running))
        for d, occ in enumerate(self.cache.occupancy()):
            for state in ("free", "live", "cached"):
                m.gauge("kv_blocks", state=state, shard=d).set(occ[state])
            m.gauge("kv_reserved_blocks", shard=d).set(occ["reserved"])
            rows = occ["free"] + occ["live"] + occ["cached"] + 1
            m.gauge("kv_pool_bytes", shard=d).set(rows * occ["block_bytes"])
        if self.serve.prefix_cache:
            for k, v in self.cache.stats.items():
                m.counter(f"prefix_{k}_total").set_to(v)
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
            self._moe_acc = add
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
        """Admit, run one mixed prefill/decode (or speculative verify) step,
        process samples.  Returns the requests that finished."""
        self.scheduler.admit(clock_ms)
        if not self.scheduler.running:
            return []
        # speculate only in decode-only steps: mid-prefill, the mixed step
        # makes prompt progress and decode slots emit one token
        if self.spec is not None and self.scheduler.prefilling is None:
            finished = self._verify_host_step(clock_ms)
        else:
            finished = self._paged_host_step(clock_ms)
        self.steps += 1
        if self.check_invariants:
            self.scheduler.check_conservation()
        return finished

    def build_rows(self) -> StepRows:
        """The next step's rows: every decoding slot's token, then the
        current chunk of the earliest-admitted prefilling request.  Grows
        the slots' KV blocks to cover the positions written."""
        serve, cache, sched = self.serve, self.cache, self.scheduler
        S = serve.max_slots
        pre = sched.prefilling
        chunk = 0
        if pre is not None:
            stream, target = pre.confirmed_tokens, pre.prefill_target
            chunk = min(serve.prefill_chunk, target - pre.prefill_pos)
        N = S + (serve.prefill_chunk if pre is not None else 0)
        b = _row_buffers(N, serve.blocks_per_slot, cache.garbage_block)
        sample_rows: List[Tuple[int, RequestState]] = []
        for slot, st in sched.running.items():
            if st.status is not Status.DECODE:
                continue
            pos = st.context_len
            cache.ensure_capacity(slot, pos + 1)
            _fill_row(b, cache, slot, slot, st.last_token, pos)
            sample_rows.append((slot, st))
        if pre is not None:
            cache.ensure_capacity(pre.slot, pre.prefill_pos + chunk)
            for j in range(chunk):
                row, p = S + j, pre.prefill_pos + j
                _fill_row(b, cache, row, pre.slot, stream[p], p)
                # sample off the last prompt row only
                if p == pre.request.prompt_len - 1 and not pre.generated:
                    sample_rows.append((row, pre))
        live = len(sample_rows) + chunk
        if pre is not None and any(st is pre for _, st in sample_rows):
            live -= 1       # pre's sample row is one of its chunk rows
        return StepRows(b, sample_rows, pre, chunk,
                        "mixed" if pre is not None else "decode", live)

    def forward_rows(self, buffers: Dict[str, np.ndarray]):
        """One forward over host row buffers (K/V written in place):
        returns (float32 logits (N, V_pad), per-layer telemetry)."""
        N = buffers["tokens"].shape[0]
        flat = np.concatenate([buffers[k] for k in _ROW_FIELDS]
                              + [buffers["row_tables"].reshape(-1)])
        dev = torch.from_numpy(flat).to(self.device)      # one host->device copy
        rows = {k: dev[i * N:(i + 1) * N] for i, k in enumerate(_ROW_FIELDS)}
        rows["row_tables"] = dev[len(_ROW_FIELDS) * N:].reshape(N, -1)
        cache = self.cache
        return _paged_logits(self.params, self.layers, self.cfg, rows, cache.k_pool,
                             cache.v_pool, cache.k_scales, cache.v_scales, cache.policy,
                             max_length=int(buffers["lengths"].max()))

    def _paged_host_step(self, clock_ms: float) -> List[RequestState]:
        sr = self.build_rows()
        with self.obs.tracer.span("engine_step", kind=sr.kind, step=self.steps,
                                  rows=sr.num_rows, live_rows=sr.live):
            logits, telem = self.forward_rows(sr.buffers)
            b = sr.buffers
            if self._logit_tap is not None:
                self._logit_tap(logits.cpu().numpy(), b["slots"], b["positions"],
                                b["lengths"])
            next_tok = _sample_rows(logits, b["slots"], b["positions"], self.temperature,
                                    self.seed).cpu().numpy()
        self._moe_accum(telem, sr.num_rows)
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

        b = _row_buffers(N, serve.blocks_per_slot, cache.garbage_block)
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
            logits, telem = self.forward_rows(b)
            # greedy acceptance compares ids only: ship N int32 argmaxes, not
            # the (N, V_pad) logits
            scores = (logits.argmax(dim=-1).to(torch.int32)
                      if self.temperature <= 0.0 else logits).cpu().numpy()
        self._moe_accum(telem, N)

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
            if not self.scheduler.running:
                nxt = self.scheduler.next_arrival_ms()
                if nxt is not None and nxt > clock:
                    clock = nxt                      # idle: jump to next arrival
            finished = self.step(clock)
            m.gauge("serve_peak_running").set_max(
                len(self.scheduler.running) + len(finished))
            for st in finished:
                done.append(st)
                if on_finish is not None:
                    on_finish(st)
        total_ms = max(clock, (time.perf_counter() - t0) * 1e3)
        self.scheduler.check_conservation()
        stats = latency_stats([st.latency_ms() for st in done], total_ms,
                              sum(len(st.generated) for st in done))
        stats["steps"] = m.delta(mark, "engine_steps_total")
        stats["peak_running"] = m.get("serve_peak_running")
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
