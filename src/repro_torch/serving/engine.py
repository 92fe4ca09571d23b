"""The static lockstep serving engine (``repro.serving.engine.ServingEngine``):
one prefill of the whole batch into dense KV caches, then one decode step
a token for every row at once, greedy or sampled.

It is the baseline the continuous engine is measured against and the
oracle of the greedy parity tests.  Every decode step runs, in every
layer, the dense decode attention kernel over the caches
(``repro_torch.kernels.decode_attention.decode_attention``), with every
row at the cache's length, which lives on the device; the
expert FFN is the dispatcher's (``MoEConfig.impl``: the ragged FFN kernel
under ``dropless``, the grouped FFN kernel under ``pallas``).  The caches
are written in place under ``torch.inference_mode()``.

Sampling at temperature > 0 is the continuous engine's Gumbel-max over
an integer hash, keyed by (seed, row, absolute position), so the CPU and
the card draw the same integers.  The reference draws from JAX's PRNG
instead, which PyTorch cannot reproduce: parity at T > 0 is in
distribution only.

Differences from the reference, by design of the port:

* a ``max_len`` past the learned position table is refused at
  construction, and a ``generate`` whose prompt and tokens do not fit
  ``max_len`` is refused (the reference clamps both silently);
* MoE attention (``moe_attention``) is refused at construction: it has no
  cached decode path, and the reference's cached path would run dense
  attention over the expert weights.

A logit softcap (``attn_logit_softcap``) is applied as the reference's
``_sdpa`` applies it: in the prefill's attention and, inside the dense
decode kernel, in every decode step's.

A family with no ``prefill`` (xLSTM, zamba) takes its prompt token by
token through ``decode`` from a zero state, as the reference's does.
xLSTM runs no kernel, and its O(1) state has no length, so ``max_len``
bounds nothing there.  Zamba's state holds a ``max_len`` cache for each
application of its shared attention, whose every step (prompt tokens
too) is the dense decode kernel; a ``generate`` past ``max_len`` is
refused as a decoder LM's is (the reference clamps the cache write
silently).  Encdec has no ``prefill`` either, and its ``init_state``
refuses with the reference's message (a decode state needs the encoder's
memory), so ``generate`` fails there, as the reference's does.

**The compiled steps** (the reference's ``jax.jit`` of ``_decode`` and
``_prefill``): the decode step of a batch of B rows and the prefill of a
(B, S) prompt are each a static step form
(:class:`repro_torch.serving.graphs.GraphForm`) that owns, for the
engine's life, its token input buffer and its logits output; both forms
of B rows update one state of B rows that the engine keeps (the caches
with their device length, zamba's Mamba2 states and caches, or xLSTM's
states, copied back in place).  A step's body reads no host value: the
cache length lives on the device, and the dense decode kernel plans its
launch from the cache's static T.  On a CUDA device without ``rules``
(``graphs=True``, the default) each form is captured as a
``torch.cuda.CUDAGraph`` at its first use, on one graph memory pool an
engine, and reused by every later ``generate`` of its shape; a capture
that fails raises.  ``generate`` first zeroes the state on the device
(the reference's fresh ``init_state`` and prefill), then feeds the
prompt (one prefill, or token by token through the decode form), then
decodes; a sampled token is copied device to device into the decode
form's input.  Sampling stays outside the forms, as the reference's
``_sample`` stays outside its jit, and takes the host loop's position.
The kernels' launch counters count replays
(``repro_torch.kernels.counters``).  On the CPU, on ``meta``, under
``rules`` (whose collectives a graph cannot hold) and with
``graphs=False`` the forms run eagerly.  :meth:`ServingEngine.
compiled_variants` counts the forms built so far, the reference's
``_decode._cache_size() + _prefill._cache_size()``.

On a mesh (``rules``: ``make_rules(cfg, mesh)``, the reference's
``ServingEngine(..., rules=)``), each rank runs the engine on its blocks
of the params (``sharding.shard_params(..., keep=("router",))``; any
other placement is refused) with ``prefill``, ``decode`` and
``init_state`` under the rules: tensor parallelism over "model" as the
models write it out, every rank holding the whole batch.  Its logits are
its vocab columns; before sampling they are all-gathered over the vocab's
axis, so every rank samples from the same whole logits and draws the same
token.  The serve CLI refuses ``--mesh`` with the static engine, as the
reference's does.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context import MoEContext
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import Rules, check_placed, tensor_parallel, use_rules
from repro_torch.models.registry import get_family
from repro_torch.nn.spec import padded_vocab
from repro_torch.serving.continuous import _sample_rows
from repro_torch.serving.graphs import GraphForm, copy_state, zero_state


class ServingEngine:
    """``params`` is the port's param tree (``repro_torch.nn``), or a mesh
    rank's blocks of it under ``rules``; the engine runs on its device.
    ``graphs`` (on a CUDA device without ``rules``) captures each step
    form as a CUDA graph at its first use; ``graphs=False`` runs them
    eagerly."""

    def __init__(self, cfg: ModelConfig, params, max_len: int, rules: Optional[Rules] = None,
                 graphs: bool = True):
        self.fam = get_family(cfg)
        if cfg.moe.moe_attention:
            raise NotImplementedError("moe_attention has no cached decode path")
        if cfg.pos_embed == "learned" and max_len > cfg.max_seq_len:
            raise ValueError(f"static engine max_len {max_len} exceeds the learned "
                             f"position table ({cfg.max_seq_len} positions)")
        if rules is not None:
            check_placed(params, rules, keep=("router",))
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.rules = rules
        self.device = params["embed"]["table"].device
        # serving-side MoE context: the family fills in token ids and the
        # absolute positions, so identity and position routing agree
        # between prefill and decode
        self.ctx = MoEContext(is_training=False)
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if graphs and self.device.type == "cuda" and rules is None else None)
        self._states: Dict[int, object] = {}                        # B -> its state
        self._decode_forms: Dict[int, GraphForm] = {}               # B
        self._prefill_forms: Dict[Tuple[int, int], GraphForm] = {}  # (B, S)

    def compiled_variants(self) -> int:
        """The step forms built so far (captured graphs on the card): the
        reference's ``_decode._cache_size() + _prefill._cache_size()``."""
        return len(self._decode_forms) + len(self._prefill_forms)

    # -- the static step forms ---------------------------------------------

    def _state(self, B: int):
        """The state of B rows the engine keeps for its life."""
        if B not in self._states:
            self._states[B] = self.fam.init_state(self.cfg, B, self.max_len, device=self.device)
        return self._states[B]

    def _build(self, tokens: torch.Tensor, step, what: str) -> GraphForm:
        """A form over the input buffer ``tokens`` whose body is ``step``
        (params, tokens, state) -> (logits, new state), the new state
        copied into the kept one; captured on the card from a zeroed state
        (the warm-up runs the body).  The body holds no reference to the
        engine, so a dropped engine frees its graphs without a collection."""
        state, params = self._state(tokens.shape[0]), self.params

        def body():
            logits, new = step(params, tokens, state)
            copy_state(state, new)
            return logits

        form = GraphForm(body, what, inputs=tokens)
        if self._graph_pool is not None:
            zero_state(state)
            form.capture(self.device, self._graph_pool)
        return form

    def _decode_form(self, B: int) -> GraphForm:
        if B not in self._decode_forms:
            fam, cfg, ctx = self.fam, self.cfg, self.ctx
            tokens = torch.zeros((B, 1), dtype=torch.long, device=self.device)
            self._decode_forms[B] = self._build(
                tokens, lambda p, t, st: fam.decode(p, t, st, cfg, ctx=ctx),
                f"the decode step ({B} rows)")
        return self._decode_forms[B]

    def _prefill_form(self, B: int, S: int) -> GraphForm:
        if (B, S) not in self._prefill_forms:
            fam, cfg, ctx, max_len = self.fam, self.cfg, self.ctx, self.max_len
            tokens = torch.zeros((B, S), dtype=torch.long, device=self.device)
            self._prefill_forms[B, S] = self._build(
                tokens, lambda p, t, st: fam.prefill(p, {"tokens": t}, cfg, max_len=max_len,
                                                     ctx=ctx, state=st),
                f"the prefill of {B} x {S}")
        return self._prefill_forms[B, S]

    # -- generate -------------------------------------------------------------

    def _sample(self, logits, position: int, temperature: float, seed: int) -> torch.Tensor:
        """(B, 1) int token per row from the last position's f32 logits
        (all-gathered over the vocab's axis where they are a rank's columns)."""
        last = logits[:, -1, :].float()
        if last.shape[-1] != padded_vocab(self.cfg.vocab_size):
            last = collectives.all_gather(last, tensor_parallel("vocab")[0], dim=-1)
        B = last.shape[0]
        tok = _sample_rows(last, np.arange(B), np.full(B, position), temperature, seed)
        return tok.long()[:, None]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts, num_tokens: int, temperature: float = 0.0, seed: int = 0):
        """prompts: (B, S) ints.  Returns ((B, num_tokens) int32 numpy, stats)."""
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=self.device)
        B, S = prompts.shape
        recurrent = self.fam.prefill is None
        n_decode = max(num_tokens - 1, 0)
        # the host's step count guards the cache's end before any step: the
        # length lives on the device, and the reference clamps silently
        if self.fam.kv_cache and S + n_decode > self.max_len:
            raise ValueError(f"prompt {S} + {num_tokens} tokens exceed max_len {self.max_len}")
        with torch.inference_mode(), use_rules(self.rules):
            t0 = time.perf_counter()
            decode = self._decode_form(B) if recurrent or n_decode else None
            prefill = None if recurrent else self._prefill_form(B, S)
            zero_state(self._state(B))
            if recurrent:           # the prompt, token by token
                for i in range(S):
                    logits = decode.run(prompts[:, i:i + 1])
            else:
                logits = prefill.run(prompts)
            tok = self._sample(logits, S - 1, temperature, seed)
            self._sync()
            t_prefill = time.perf_counter() - t0
            out = [tok]
            t0 = time.perf_counter()
            for i in range(n_decode):
                logits = decode.run(tok)
                tok = self._sample(logits, S + i, temperature, seed)
                out.append(tok)
            toks = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
            t_decode = time.perf_counter() - t0
        stats = {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            # num_tokens == 1 runs no decode step: 0.0, not 0 over a timer's noise
            "decode_tokens_per_s": n_decode * B / max(t_decode, 1e-9) if n_decode else 0.0,
        }
        return toks, stats
