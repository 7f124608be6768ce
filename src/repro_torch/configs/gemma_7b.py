"""Gemma-7B [arXiv:2403.08295] — dense, GeGLU, head_dim=256, big vocab."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma-7b",
    family="dense",
    source="arXiv:2403.08295",
    num_layers=28,
    d_model=3_072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    vocab_size=256_000,
    attention="gqa",
    activation="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
