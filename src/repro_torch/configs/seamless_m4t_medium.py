"""SeamlessM4T-medium [arXiv:2308.11596] — encoder-decoder; speech frontend
is a stub supplying precomputed frame embeddings (DESIGN.md §5)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596",
    num_layers=12,               # decoder layers
    encoder_layers=12,
    d_model=1_024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4_096,
    vocab_size=256_206,
    attention="gqa",
    activation="gelu",
    rope_theta=10_000.0,
    frontend="audio",
    frontend_dim=1_024,          # w2v-BERT frame embedding dim
    frontend_tokens=1_600,       # ~32 s of speech at 50 fps
)
