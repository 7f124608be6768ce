"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B] — dense with multi-head latent
attention (MLA)."""
from .base import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    arch_id="minicpm3-4b",
    family="dense",
    source="hf:openbmb/MiniCPM3-4B",
    num_layers=62,
    d_model=2_560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6_400,
    vocab_size=73_448,
    attention="mla",
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    activation="silu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
