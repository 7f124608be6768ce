"""Train step factory: loss -> grad -> AdamW update over a train state
{"params": the model's params module, "opt": {"m", "v", "step"}}, the
port of the JAX package's ``train/train_step.py``.

The gradient is autograd's through the model's training forward
(``Model.train_loss``): on the card every norm runs the rmsnorm kernel
forward and backward (``kernels.rmsnorm.RMSNormFn``). The update is
``optim.adamw_update``, in place. ``abstract_train_state`` is the same
state on the meta device: the dry run's shapes without allocation. A step
records the spans ``train.step`` > {``train.forward``, ``train.backward``,
``train.adamw``} (``obs.trace``) when tracing is on.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..models import Model
from ..obs import trace as _trace
from ..optim import AdamWConfig, adamw_init, adamw_update, \
    linear_warmup_cosine


def train_state(params: torch.nn.Module, opt_cfg: AdamWConfig) -> Dict:
    """The train state over ``params``: zero AdamW state beside them."""
    return {"params": params,
            "opt": adamw_init(dict(params.named_parameters()), opt_cfg)}


def make_train_state(model: Model, seed: int, opt_cfg: AdamWConfig,
                     device=None) -> Dict:
    """Random params from ``seed`` on ``device`` (None = the CUDA card)
    and zero AdamW state beside them."""
    return train_state(model.init(seed, device), opt_cfg)


def abstract_train_state(model: Model, opt_cfg: AdamWConfig) -> Dict:
    """The train state on the meta device: params (``Model.init_abstract``)
    and AdamW's moments and step counter, every shape and dtype, no
    storage."""
    return train_state(model.init_abstract(), opt_cfg)


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    total_steps: int = 10_000,
    warmup: int = 200,
) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradient, then one AdamW step at the warm-up-cosine ``lr_scale`` of the
    state's step counter before the increment. The gradient stays on
    ``param.grad`` until the next step (a param the forward never reads
    has ``grad`` None and is updated as the reference updates its zero
    gradient). Metrics are 0-d tensors on the device: nothing syncs."""
    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        with _trace.span("train.step", tokens=batch["tokens"].numel()):
            params = state["params"]
            params.zero_grad(set_to_none=True)
            with _trace.span("train.forward"):
                loss, metrics = model.train_loss(params, batch)
            with _trace.span("train.backward"):
                loss.backward()
            named = dict(params.named_parameters())
            grads = {name: p.grad if p.grad is not None
                     else torch.zeros_like(p) for name, p in named.items()}
            lr_scale = linear_warmup_cosine(state["opt"]["step"], warmup,
                                            total_steps)
            _, opt, opt_metrics = adamw_update(named, grads, state["opt"],
                                               opt_cfg, lr_scale)
            metrics = {k: v.detach() for k, v in metrics.items()}
        return {"params": params, "opt": opt}, \
            {"loss": loss.detach(), **metrics, **opt_metrics}

    return train_step
