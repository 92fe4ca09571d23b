"""Config dataclasses: the port's copies of ``repro.configs.base``.

Field names and defaults are identical to the reference, and dtypes stay
strings ("bfloat16", "float32"); :func:`torch_dtype` is the one place
they map to ``torch`` dtypes.  Validation consults the port's own
registries (routers, dispatchers, admission policies).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

# KV-pool representations the reference knows; only "none" is ported
# (the engine raises NotImplementedError for the quantized ones).
KV_QUANTS = ("none", "int8", "fp8")


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts configuration (``repro.configs.base.MoEConfig``)."""

    num_experts: int = 0                 # 0 => dense FFN
    routing: str = "topk"                # key into repro_torch.core.routers
    top_k: int = 1
    num_prototypes: int = 1
    prototype_top_k: int = 1
    capacity_mode: str = "k"             # "k" | "one"
    capacity_factor: Optional[float] = 1.25   # None => dropless
    aux_loss_coef: float = 0.01
    router_z_loss_coef: float = 0.0
    router_dtype: str = "float32"
    normalize_gates: bool = False
    group_size: int = 2048
    combine_dtype: str = "auto"          # "auto": activation dtype
    impl: str = "einsum"                 # key into repro_torch.core.dispatch
    moe_attention: bool = False
    expert_axis: str = "model"

    def __post_init__(self):
        if self.num_experts > 0:
            # Names the reference registers but the port does not (e.g. the
            # default impl "einsum") are valid configs; using one raises
            # NotImplementedError at get_router / get_dispatcher.
            from repro_torch.core import dispatch, routers

            if self.routing not in routers.UNPORTED:
                routers.get_router(self.routing)
            supports_dropless = False
            if self.impl not in dispatch.UNPORTED:
                supports_dropless = getattr(dispatch.get_dispatcher(self.impl),
                                            "supports_dropless", False)
            if self.capacity_factor is None and not supports_dropless:
                capable = [n for n in dispatch.available_dispatchers() if getattr(
                    dispatch.get_dispatcher(n), "supports_dropless", False)]
                raise ValueError(
                    f"capacity_factor=None (dropless) needs a capacity-free "
                    f"execution backend, but impl={self.impl!r} allocates "
                    f"(E, C) buffers; dropless-capable dispatchers: "
                    f"{', '.join(capable) or '(none registered)'}")
            if self.capacity_factor is None and self.moe_attention:
                raise ValueError(
                    "capacity_factor=None (dropless) is incompatible with "
                    "moe_attention=True")

    @property
    def active_k(self) -> int:
        if self.num_experts == 0:
            return 0
        if self.routing == "prototype":
            return self.num_prototypes * self.prototype_top_k
        return self.top_k

    @property
    def experts_per_prototype(self) -> int:
        if self.routing != "prototype":
            return self.num_experts
        if self.num_experts % self.num_prototypes:
            raise ValueError(f"num_experts={self.num_experts} not divisible by "
                             f"num_prototypes={self.num_prototypes}")
        return self.num_experts // self.num_prototypes

    def capacity(self, tokens_per_shard: int) -> int:
        """Per-expert capacity C = k*T/N*gamma (Eq. 2); T when dropless."""
        if self.capacity_factor is None:
            return max(tokens_per_shard, 1)
        k_eff = 1 if self.capacity_mode == "one" else max(self.active_k, 1)
        c = int(k_eff * tokens_per_shard / max(self.num_experts, 1) * self.capacity_factor)
        return max(c, 1)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "decoder_lm"
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0            # 0 => d_model // num_heads
    d_ff: int = 512
    vocab_size: int = 1024
    max_seq_len: int = 8192
    qk_norm: bool = False
    qkv_bias: bool = False
    pos_embed: str = "rope"      # rope | learned
    rope_theta: float = 1e6
    attn_logit_softcap: float = 0.0
    attention_impl: str = "auto"
    attention_block: int = 512
    ffn_activation: str = "swiglu"   # swiglu | geglu | gelu | relu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    moe_layer_period: int = 1
    num_encoder_layers: int = 0
    xlstm_slstm_period: int = 0
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    zamba_shared_period: int = 6
    num_image_tokens: int = 0
    dtype: str = "bfloat16"      # activation/compute dtype
    param_dtype: str = "float32"
    initializer_range: float = 0.02
    remat: bool = True
    scan_layers: bool = True
    fsdp: bool = False
    dropout: float = 0.0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def replace_moe(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, moe=dataclasses.replace(self.moe, **kw))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer and step settings (``repro.configs.base.TrainConfig``).
    The port implements ``optimizer="adamw"``, ``grad_compression="none"``
    and no ZeRO sharding; ``zero1`` is carried for parity and unused on
    one device."""

    learning_rate: float = 8e-5      # paper: AdamW 8e-5
    optimizer: str = "adamw"         # adamw | adafactor (adafactor not ported)
    warmup_steps: int = 500          # paper Table 5
    weight_decay: float = 0.01
    grad_clip_norm: float = 1.0
    zero1: bool = True
    grad_compression: str = "none"   # none | bf16 | int8 (only none ported)
    microbatches: int = 1            # grad accumulation
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding (``repro_torch.serving.speculative``).

    A drafter proposes up to ``gamma`` continuation tokens per decode slot;
    the engine scores all ``gamma + 1`` positions in one verify step and
    accepts a prefix of the drafts under the greedy or rejection-sampling
    rule: temperature 0 stays token-identical to non-speculative decoding,
    temperature > 0 keeps the target distribution.
    """

    # a key into the repro_torch.serving.speculative registry; built-ins
    # "ngram" (prompt lookup in the slot's own context) and "model" (a
    # draft model sharing the target's vocab)
    drafter: str = "ngram"
    gamma: int = 4               # max draft tokens per slot per verify step
    draft: Optional[str] = None  # registered config id of the model drafter's model
    max_ngram: int = 3           # longest context suffix the ngram drafter matches

    def __post_init__(self):
        if self.gamma < 1:
            raise ValueError("SpecConfig.gamma must be >= 1")
        if self.max_ngram < 1:
            raise ValueError("SpecConfig.max_ngram must be >= 1")
        # lazy: the drafter registry sits above configs, and plugins must
        # be able to register before validation
        from repro_torch.serving.speculative import get_drafter_cls

        get_drafter_cls(self.drafter)


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """SLO scheduling settings, carried for API parity only: the port's
    engine raises NotImplementedError when one is set."""

    preemption: bool = True
    host_blocks: Optional[int] = None
    max_preemptions: int = 8
    preempt_threshold: int = 0
    shed: bool = False

    def __post_init__(self):
        if self.host_blocks is not None and self.host_blocks < 1:
            raise ValueError("SLOConfig.host_blocks must be >= 1")
        if self.max_preemptions < 0:
            raise ValueError("SLOConfig.max_preemptions must be >= 0")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Continuous-batching serving shapes (``repro_torch.serving.continuous``)."""

    max_slots: int = 8
    kv_block_size: int = 16
    prefill_chunk: int = 32
    max_len: int = 256
    num_blocks: Optional[int] = None
    spec: Optional[SpecConfig] = None
    sched_policy: str = "fcfs"
    prefix_cache: bool = False
    slo: Optional[SLOConfig] = None
    kv_quant: str = "none"
    mesh: Optional[Tuple[Tuple[str, int], ...]] = None

    def __post_init__(self):
        if self.max_slots < 1 or self.kv_block_size < 1 or self.prefill_chunk < 1:
            raise ValueError("max_slots, kv_block_size, prefill_chunk must be >= 1")
        if self.max_len < 2:
            raise ValueError("max_len must be >= 2 (one prompt + one generated)")
        if self.mesh is not None:
            names = tuple(a for a, _ in self.mesh)
            if names != ("data", "expert"):
                raise ValueError(
                    f"ServeConfig.mesh axes must be ('data', 'expert'), got {names}")
        from repro_torch.serving.scheduler import get_policy

        get_policy(self.sched_policy)
        if self.kv_quant not in KV_QUANTS:
            raise ValueError(f"unknown kv_quant {self.kv_quant!r}; known: {KV_QUANTS}")

    @property
    def blocks_per_slot(self) -> int:
        return -(-self.max_len // self.kv_block_size)

    @property
    def resolved_num_blocks(self) -> int:
        return self.num_blocks if self.num_blocks is not None else (
            self.max_slots * self.blocks_per_slot)
