"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

VLM: anyres tiling gives 2880 precomputed patch embeddings (frontend stub,
see DESIGN.md §5); the 2-layer projector and the Mistral decoder ARE real.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llava-next-mistral-7b",
    family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    attention="gqa",
    activation="silu",
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_dim=1_024,          # CLIP ViT-L/14 hidden
    frontend_tokens=2_880,       # anyres: base 576 + 4 tiles x 576
)
