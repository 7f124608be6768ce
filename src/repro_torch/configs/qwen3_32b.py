"""Qwen3-32B [hf:Qwen/Qwen3-8B scaled per assignment] — dense GQA with
QK-norm."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-32b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=64,
    d_model=5_120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25_600,
    vocab_size=151_936,
    attention="gqa",
    qk_norm=True,
    activation="silu",
    rope_theta=1_000_000.0,
)
