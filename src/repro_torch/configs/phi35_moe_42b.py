"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct] —
16 experts, top-2 routing, GQA."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="phi3.5-moe-42b-a6.6b",
    family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6_400,                  # per-expert FF
    vocab_size=32_064,
    attention="gqa",
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=6_400),
    activation="silu",
    rope_theta=10_000.0,
)
