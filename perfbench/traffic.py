"""The one generator of traffic: requests and training batches from a
traffic file's parameters and ``--seed``.

A serving traffic file gives ``max_batch``, ``prompt_len``,
``new_tokens`` and ``cache_len``, and may give ``warmup_seconds``, the
set-up's time of warm-up batches after the first. The load is a closed loop: the
window's clients send batch k + 1 of ``max_batch`` requests when batch k
returns, so a request is sent when the engine takes it. A training
traffic file gives ``batch`` and ``seq_len``. Token ids are uniform over
the vocabulary. Batch k of seed s is drawn from its own stream, keyed by
(s, k), so every seed gives the same sizes, only other tokens, and the
batches of a run all differ.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import numpy as np

#: the stream of the warm-up batch, which the window never draws
WARMUP = -1


def rng(seed: int, what: str, k: int) -> np.random.Generator:
    digest = hashlib.sha256(f"{seed}:{what}:{k}".encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:16], "little"))


def tokens(seed: int, what: str, k: int, shape: Tuple[int, ...],
           vocab: int) -> np.ndarray:
    return rng(seed, what, k).integers(0, vocab, size=shape,
                                        dtype=np.int64).astype(np.int32)


def prompts(traffic: Dict, seed: int, k: int, vocab: int) -> np.ndarray:
    """The prompts of serving batch k: (max_batch, prompt_len)."""
    return tokens(seed, "prompt", k, (traffic["max_batch"],
                                      traffic["prompt_len"]), vocab)


def train_batch(traffic: Dict, seed: int, k: int, vocab: int) -> np.ndarray:
    """Training batch k: (batch, seq_len) token ids."""
    return tokens(seed, "train", k, (traffic["batch"], traffic["seq_len"]),
                  vocab)
