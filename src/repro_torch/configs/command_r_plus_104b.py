"""Command-R-Plus-104B [hf:CohereForAI/c4ai-command-r-v01] — dense GQA,
no-bias, large vocab."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="command-r-plus-104b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    num_layers=64,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33_792,
    vocab_size=256_000,
    attention="gqa",
    activation="silu",
    rope_theta=75_000_000.0,
    param_dtype="bfloat16",       # 104B: fp32 master state would not fit 256xv5e
    compute_dtype="bfloat16",
)
