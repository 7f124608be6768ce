"""Deterministic synthetic data pipeline, the port of the JAX package's
``data/pipeline.py`` (its numpy generator, copied: the port's batches are
the reference's bit for bit).

Produces reproducible token streams with a simple Zipf-ish unigram
mixture + induced n-gram structure so small models can demonstrably
learn (loss decreases), without any external dataset. Batches are numpy
arrays on the host; the trainer moves them to its device, and
``shard_batch`` places one on a device mesh, batch dim sharded.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ArchConfig, InputShape


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # structure: tokens follow a noisy repeat-k pattern => learnable
    repeat_k: int = 4
    noise: float = 0.1
    # tokens are drawn from the first `active_vocab` ids so even a tiny
    # model's unigram stats give fast, testable loss improvements
    active_vocab: int = 64


class SyntheticLM:
    """Reproducible structured token stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._epoch = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 1_000_003 + step)
        B, S = cfg.global_batch, cfg.seq_len
        V = min(cfg.active_vocab, cfg.vocab_size)
        base = rng.integers(0, V, size=(B, cfg.repeat_k))
        reps = int(np.ceil(S / cfg.repeat_k))
        toks = np.tile(base, (1, reps))[:, :S]
        flip = rng.random((B, S)) < cfg.noise
        toks = np.where(flip, rng.integers(0, V, size=(B, S)), toks)
        return {
            "tokens": toks.astype(np.int32),
            "labels": toks.astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_source(cfg: ArchConfig, shape: InputShape, seed: int = 0) -> SyntheticLM:
    return SyntheticLM(
        DataConfig(
            vocab_size=cfg.vocab_size,
            seq_len=shape.seq_len,
            global_batch=shape.global_batch,
            seed=seed,
        )
    )


def shard_batch(batch: Dict, mesh, batch_axes=("data",)) -> Dict:
    """Place a host-global batch (numpy arrays or tensors) onto ``mesh``
    as DTensors, the batch dim ``Shard(0)`` on each of ``batch_axes`` and
    replicated on the other mesh dims."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from ..parallel import placements

    pl = placements((tuple(batch_axes),), mesh)
    return {k: distribute_tensor(torch.as_tensor(v, device=mesh.device_type),
                                 mesh, pl)
            for k, v in batch.items()}
