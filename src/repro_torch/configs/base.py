"""Architecture config schema + input-shape registry.

Every assigned architecture gets one ``ArchConfig`` in its own module; the
``reduced()`` helper derives the CPU smoke-test variant (2 layers,
d_model <= 512, <= 4 experts) from the same definition. The port's copy
of the JAX package's schema: the fields are the same, and ``dtype()``
returns a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned input shapes.
SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3)."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    group_size: int = 512          # GShard dispatch group size (tokens)
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD."""

    state_dim: int
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1

    def num_heads(self, d_model: int) -> int:
        return self.expand * d_model // self.head_dim

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    source: str                    # citation tag
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    # attention flavor
    attention: str = "gqa"         # "gqa" | "mla" | "none"
    mla: Optional[MLAConfig] = None
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    # mlp flavor
    activation: str = "silu"       # "silu" (gated) | "geglu" | "gelu"
    # mixture of experts
    moe: Optional[MoEConfig] = None
    # state-space
    ssm: Optional[SSMConfig] = None
    hybrid: bool = False           # parallel attn + ssm heads (hymba)
    # sliding window (tokens); None = full attention
    sliding_window: Optional[int] = None
    global_attn_every: Optional[int] = None  # hybrid: 1 global layer every k
    # long-context carve-in: window used ONLY for the long_500k shape when
    # the arch is otherwise full-attention (see DESIGN.md §4)
    long_context_window: Optional[int] = 8_192
    # encoder-decoder
    encoder_layers: int = 0        # >0 => enc-dec (seamless)
    # modality frontend stubs
    frontend: Optional[str] = None  # "vision" | "audio"
    frontend_dim: int = 1024        # stub embedding dim
    frontend_tokens: int = 2880     # patch/frame tokens per example
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"            # "none" | "dots" | "full"
    tie_embeddings: bool = False
    # unroll the layer stack instead of lax.scan (used by the dry-run's
    # L=1/L=2 cost probes: XLA cost_analysis counts loop bodies once)
    unroll_layers: bool = False
    # SSM: split the fused in-projection into per-component params (z, x,
    # B, C, dt) so channels shard cleanly on the model axis (§Perf pair 2)
    ssm_split_in_proj: bool = False
    # cross-entropy implementation: "onehot" (sharding-friendly masked
    # reduce) or "gather" (take_along_axis — forces SPMD logits
    # replication; kept for the §Perf before/after record)
    ce_impl: str = "onehot"

    # ---- derived -------------------------------------------------------
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS and g_i)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim()
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_layer = 0
        if self.attention == "gqa":
            per_layer += d * self.num_heads * hd          # q
            per_layer += 2 * d * self.num_kv_heads * hd   # k, v
            per_layer += self.num_heads * hd * d          # o
        elif self.attention == "mla":
            m = self.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_layer += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk_hd
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            per_layer += self.num_heads * m.v_head_dim * d
        if self.ssm is not None:
            di = self.ssm.d_inner(d)
            nh = self.ssm.num_heads(d)
            g = self.ssm.n_groups
            per_layer += d * (2 * di + 2 * g * self.ssm.state_dim + nh)  # in_proj
            per_layer += di * d                                           # out_proj
            per_layer += (di + 2 * g * self.ssm.state_dim) * self.ssm.conv_width
        if self.moe is not None:
            e = self.moe
            per_layer += d * e.num_experts                                # router
            per_layer += e.num_experts * 3 * d * e.expert_d_ff
            if e.num_shared_experts:
                per_layer += e.num_shared_experts * 3 * d * e.shared_d_ff
        elif self.d_ff > 0:
            per_layer += 3 * d * self.d_ff                                # gated mlp
        n += L * per_layer
        n += self.encoder_layers * per_layer  # encoder reuses decoder shape
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        e = self.moe
        full = self.param_count()
        all_experts = L * e.num_experts * 3 * d * e.expert_d_ff
        active = L * e.top_k * 3 * d * e.expert_d_ff
        return full - all_experts + active

    def reduced(self) -> "ArchConfig":
        """2-layer, d_model<=512, <=4-expert smoke variant (same family)."""
        d = min(self.d_model, 256)
        hd = 32
        heads = max(2, min(4, self.num_heads))
        kv = heads if self.num_kv_heads >= self.num_heads else max(1, heads // 2)
        changes: Dict = dict(
            num_layers=2,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            param_dtype="float32",
            compute_dtype="float32",
            remat="none",
            frontend_tokens=min(self.frontend_tokens, 16),
            frontend_dim=min(self.frontend_dim, 64),
            encoder_layers=2 if self.encoder_layers else 0,
        )
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                q_lora_rank=64, kv_lora_rank=32,
                qk_nope_head_dim=hd, qk_rope_head_dim=16, v_head_dim=hd,
            )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                expert_d_ff=128,
                shared_d_ff=128 if self.moe.num_shared_experts else 0,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                group_size=64,
            )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_dim=min(self.ssm.state_dim, 16), head_dim=32,
            )
        if self.sliding_window is not None:
            changes["sliding_window"] = min(self.sliding_window, 64)
        return dataclasses.replace(self, **changes)

    def dtype(self, kind: str = "compute"):
        name = self.compute_dtype if kind == "compute" else self.param_dtype
        return getattr(torch, name)
