"""The training loop: data -> train_step -> metrics / checkpoints, the
port of the JAX package's ``train/trainer.py`` on one torch device.

Checkpoints hold the params in the reference's tree
(``convert.lm_params_to_jax`` / ``encdec_params_to_jax``), in its
``checkpoint`` layout, so either package can load them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from ..backend.torch_backend import resolve_device
from ..checkpoint import save_checkpoint
from ..configs.base import ArchConfig, InputShape
from ..convert import encdec_params_to_jax, lm_params_to_jax
from ..data import make_source
from ..models import build_model
from ..optim import AdamWConfig
from .train_step import make_train_state, make_train_step


@dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 0          # 0 = only at the end
    checkpoint_dir: Optional[str] = None
    seed: int = 0
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    device: Optional[str] = None       # None = the CUDA card


#: ``on_step(step, state, metrics)``, called after every step
StepHook = Callable[[int, Dict, Dict], None]


class Trainer:
    def __init__(self, arch_cfg: ArchConfig, shape: InputShape,
                 cfg: TrainerConfig):
        self.arch_cfg = arch_cfg
        self.shape = shape
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.model = build_model(arch_cfg)
        self.source = make_source(arch_cfg, shape, seed=cfg.seed)
        self.history: List[Dict] = []

    def save(self, step: int, state: Dict) -> str:
        """Write ``state``'s params as the reference's tree at ``step``."""
        to_jax = encdec_params_to_jax if self.model.is_encdec \
            else lm_params_to_jax
        return save_checkpoint(self.cfg.checkpoint_dir, step,
                               to_jax(self.arch_cfg, state["params"]))

    def run(self, on_step: Optional[StepHook] = None) -> List[Dict]:
        """Train ``cfg.steps`` steps from fresh params; a logged step
        (every ``log_every`` and the last) reads its loss and grad norm
        back to the host. ``on_step`` sees each step's state (its
        gradients still on the params) and metrics."""
        cfg = self.cfg
        state = make_train_state(self.model, cfg.seed, cfg.opt, self.device)
        step_fn = make_train_step(self.model, cfg.opt, total_steps=cfg.steps)
        t0 = time.time()
        for step in range(cfg.steps):
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.source.batch(step).items()}
            state, metrics = step_fn(state, batch)
            if on_step is not None:
                on_step(step, state, metrics)
            if step % cfg.log_every == 0 or step == cfg.steps - 1:
                rec = {
                    "step": step,
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "wall": time.time() - t0,
                }
                self.history.append(rec)
            if (cfg.checkpoint_dir and cfg.checkpoint_every
                    and step and step % cfg.checkpoint_every == 0):
                self.save(step, state)
        if cfg.checkpoint_dir:
            self.save(cfg.steps, state)
        self.final_state = state
        return self.history
