"""The model zoo's dense decoder (GQA/MHA, qk-norm, RoPE, gated MLP) in
torch, serving path: ``build_model(cfg)`` -> ``Model``. Attention and
RMSNorm go through the hand-written CUDA kernels on the card."""
from .api import Model, build_model

__all__ = ["Model", "build_model"]
