"""The system under test: the PyTorch and CUDA port, ``repro_torch``.

Everything the harness takes from the program goes through here: its
configuration type, its parameter module filled with the benchmark's
weights, its serving engine and its train step. The port's package is
imported on first use and never at module import, so the CPU tests and a
checkout without ``src`` can import the rest of the harness.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import blocks
from .layout import Dims

#: the port's RMSNorm has this eps, fixed in its code
PORT_EPS = 1e-6


def configs():
    """The port's configuration types (``repro_torch.configs.base``), for
    a block's ``arch_config``."""
    from repro_torch.configs import base
    return base


def common(m: Dims, cfg: Dict, name: str, remat: str) -> Dict:
    """The ``ArchConfig`` keys every block sets alike."""
    return dict(arch_id=name, source=cfg["source"], num_layers=m.layers,
                d_model=m.d, num_heads=m.heads, vocab_size=m.vocab,
                rope_theta=m.rope_theta, activation="silu",
                param_dtype=cfg["torch_dtype"],
                compute_dtype=cfg["compute_dtype"], remat=remat,
                tie_embeddings=m.tied)


def arch_config(m: Dims, cfg: Dict, name: str, remat: str = "none"):
    """The port's ``ArchConfig`` for a configuration file: its block's
    ``arch_config``. Its norms' eps has to be the configuration's: the
    ``norm_eps`` the ``ArchConfig`` states, else ``PORT_EPS``."""
    arch = blocks.load(m.block).arch_config(m, cfg, name, remat)
    eps = getattr(arch, "norm_eps", PORT_EPS)
    if m.eps != eps:
        raise ValueError(f"the port's norms use eps {eps}, the "
                         f"configuration states {m.eps}")
    return arch


def params_from(arch, leaves: Dict[str, torch.Tensor]):
    """The port's parameter module holding ``leaves`` themselves (no
    copy): every name, shape and dtype must be the port's."""
    from repro_torch.models import lm
    shell = lm.LM(arch, device="meta")
    want = {n: (tuple(t.shape), t.dtype) for n, t in shell.state_dict().items()}
    got = {n: (tuple(t.shape), t.dtype) for n, t in leaves.items()}
    if want != got:
        diff = sorted(map(str, set(want.items()) ^ set(got.items())))
        raise ValueError(f"the benchmark's weights are not the port's: "
                         f"{diff[:6]}")
    shell.load_state_dict(leaves, assign=True)
    return shell


def serve_engine(arch, params, max_batch: int, cache_len: int, seed: int):
    from repro_torch.serve import ServeEngine
    return ServeEngine(arch, params, max_batch=max_batch,
                       cache_len=cache_len, seed=seed)


def request(rid: int, prompt, new_tokens: int):
    from repro_torch.serve import Request
    return Request(rid, prompt, max_new_tokens=new_tokens, temperature=0.0)


def train_step(arch, params, opt: Dict, total_steps: int, warmup: int):
    """(state, step): the port's train state over ``params`` and its
    ``make_train_step``."""
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step, train_state
    cfg = AdamWConfig(**opt)
    return train_state(params, cfg), make_train_step(
        build_model(arch), cfg, total_steps=total_steps, warmup=warmup)
