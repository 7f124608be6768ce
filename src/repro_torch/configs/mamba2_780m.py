"""Mamba2-780m [arXiv:2405.21060] — attention-free SSD (state-space
duality); 48 layers, d_model 1536, state 128."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="mamba2-780m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=1_536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                      # attention-free, no MLP (SSD block only)
    vocab_size=50_280,
    attention="none",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4),
    tie_embeddings=True,
)
