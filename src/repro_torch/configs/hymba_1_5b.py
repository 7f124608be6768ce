"""Hymba-1.5B [arXiv:2411.13676] — hybrid: parallel attention + Mamba heads
in every layer; sliding-window attention with a few global layers."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    attention="gqa",
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, conv_width=4),
    hybrid=True,
    sliding_window=1_024,
    global_attn_every=16,       # layers 0, 16, (and implicitly last) global
    activation="silu",
    rope_theta=10_000.0,
)
