"""Batched serving engine: prefill + lock-step decode over a request queue.

The port of the JAX package's ``serve/engine.py``. A request is (prompt
tokens, max_new_tokens). The engine batches up to ``max_batch`` requests
of one prompt length, prefills them together, then decodes lock-step with
greedy or temperature sampling. This is the serving counterpart the
paper's inference-type jobs map onto.

The engine runs on the device its params live on. It keeps the params
the forward reads (``lm.compute_params``: weights cast once to the
compute dtype), samples with its own generator on that device, and
synchronizes the device before each reading of the clock, so
``prefill_ms`` and ``decode_ms`` are the device's time, not the enqueue.
A batch records the spans ``serve.batch`` > {``serve.prefill``,
``serve.decode_step``} (``obs.trace``) when tracing is on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models import build_model, lm
from ..obs import trace as _trace


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: np.ndarray
    prefill_ms: float
    decode_ms: float


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: lm.LM, max_batch: int = 8,
                 cache_len: int = 512, seed: int = 0):
        self.cfg = cfg
        self.model = build_model(cfg)
        self.params = lm.compute_params(cfg, params)
        self.device = lm.param_device(params)
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits: torch.Tensor,
                temperature: float) -> torch.Tensor:
        """(B, V) logits -> (B,) int64 tokens."""
        if temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0]

    def run_batch(self, requests: List[Request]) -> List[Completion]:
        """Serve one batch of equal-length-prompt requests lock-step."""
        if len(requests) > self.max_batch:
            raise ValueError(f"{len(requests)} requests exceed max_batch "
                             f"{self.max_batch}")
        if len({len(r.prompt) for r in requests}) != 1:
            raise ValueError("batch must have equal prompt lengths")
        prompts = np.stack([r.prompt for r in requests]).astype(np.int64)
        max_new = max(r.max_new_tokens for r in requests)
        temperature = requests[0].temperature
        with _trace.span("serve.batch", batch=len(requests),
                         prompt_len=prompts.shape[1], new_tokens=max_new):
            self._sync()
            t0 = time.perf_counter()
            with _trace.span("serve.prefill", tokens=prompts.size):
                batch = {"tokens": torch.from_numpy(prompts).to(self.device)}
                logits, state = self.model.prefill(self.params, batch,
                                                   self.cache_len)
                self._sync()
                t1 = time.perf_counter()
                tok = self._sample(logits[:, -1], temperature)[:, None]
            out = [tok]
            for step in range(1, max_new):
                with _trace.span("serve.decode_step", step=step):
                    logits, state = self.model.decode(self.params, tok, state)
                    tok = self._sample(logits[:, 0], temperature)[:, None]
                out.append(tok)
            tokens = torch.cat(out, dim=1)
            self._sync()
            t2 = time.perf_counter()
            toks = tokens.cpu().numpy().astype(np.int32)
        return [
            Completion(r.request_id, toks[i, : r.max_new_tokens],
                       prefill_ms=(t1 - t0) * 1e3,
                       decode_ms=(t2 - t1) * 1e3)
            for i, r in enumerate(requests)
        ]

    def serve(self, requests: List[Request]) -> List[Completion]:
        """Group by prompt length, then batch FIFO within groups."""
        by_len: Dict[int, List[Request]] = {}
        for r in requests:
            by_len.setdefault(len(r.prompt), []).append(r)
        done: List[Completion] = []
        for _, group in sorted(by_len.items()):
            for i in range(0, len(group), self.max_batch):
                done.extend(self.run_batch(group[i : i + self.max_batch]))
        return done
