"""DeepSeek-V2 236B [arXiv:2405.04434] — MLA (kv_lora=512) + MoE with
2 shared + 160 routed experts, top-6.

Deviation noted in DESIGN.md: the HF model keeps layer 0 dense
(d_ff 12288); here every layer is MoE + shared experts so the layer stack
stays homogeneous for lax.scan.  Active-parameter count is preserved to
within 0.3%.
"""
from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5_120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=1_536,                  # per-expert FF
    vocab_size=102_400,
    attention="mla",
    mla=MLAConfig(
        q_lora_rank=1_536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        expert_d_ff=1_536,
        num_shared_experts=2,
        shared_d_ff=1_536,
    ),
    activation="silu",
    rope_theta=10_000.0,
    param_dtype="bfloat16",      # 236B total params
    compute_dtype="bfloat16",
)
