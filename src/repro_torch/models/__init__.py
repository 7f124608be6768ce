"""The model zoo's serving path in torch: ``build_model(cfg)`` ->
``Model`` over the decoder-only ``lm`` (dense, MoE, MLA, Mamba-2 SSD,
Hymba hybrid, vision-language) and the ``encdec`` backbone
(SeamlessM4T). Attention and RMSNorm go through the hand-written CUDA
kernels on the card; the SSD (``ssm``) is plain torch, as the
reference's is jnp. The dry run's spec helpers (``input_specs``,
``serve_state_specs``, ``Model.init_abstract``) work on meta tensors."""
from . import encdec, lm, ssm
from .api import (
    Model,
    build_model,
    concrete_batch,
    decode_window,
    input_specs,
    serve_state_specs,
)

__all__ = [
    "Model", "build_model", "concrete_batch", "decode_window",
    "input_specs", "serve_state_specs", "encdec", "lm", "ssm",
]
