"""Tree checkpoints to .npz, the port of the JAX package's
``checkpoint/checkpoint.py`` in its layout: ``<dir>/step_<N>.npz`` (one
array per leaf, keyed by the slash-joined path of its dict keys, sorted)
plus ``step_<N>.json``, a manifest of the tree's structure, the keys and
each leaf's dtype. bfloat16 leaves are stored as float32 with
"bfloat16" in the manifest, as the reference stores them. So a
checkpoint written by either package loads in the other; the trainer
saves its params in the reference's tree (``convert.lm_params_to_jax``:
layers stacked on a leading L axis).

Leaves are torch tensors (any device) or numpy arrays on save; loaded
leaves are torch tensors on the requested device. bfloat16 leaves are
read back through torch (the card's host has no ``ml_dtypes``); the cast
from float32 is exact, since the values were bfloat16.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..backend.torch_backend import resolve_device


def _flatten_with_paths(tree) -> Dict[str, Any]:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def _unflatten(flat: Dict[str, Any], structure) -> Any:
    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}/{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            t = [walk(f"{prefix}/{i}", v) for i, v in enumerate(node)]
            return type(node)(t)
        return flat[prefix]

    return walk("", structure)


def _structure_of(tree):
    if isinstance(tree, dict):
        return {k: _structure_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure_of(v) for v in tree]
    return None


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """(the array as stored, the dtype the manifest names)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy(), name
    a = np.asarray(leaf)
    name = str(a.dtype)
    if a.dtype.isbuiltin != 1:  # ml_dtypes (bf16, fp8, ...): store as f32
        a = a.astype(np.float32)
    return a, name


def save_checkpoint(directory: str, step: int, tree) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten_with_paths(tree)
    arrays, dtypes = {}, {}
    for k, v in flat.items():
        arrays[k], dtypes[k] = _host_array(v)
    path = os.path.join(directory, f"step_{step:08d}.npz")
    np.savez(path, **arrays)
    manifest = os.path.join(directory, f"step_{step:08d}.json")
    with open(manifest, "w") as f:
        json.dump({"step": step, "structure": _structure_of(tree),
                   "keys": sorted(arrays), "dtypes": dtypes}, f)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for f in os.listdir(directory)
        if (m := re.match(r"step_(\d+)\.npz$", f))
    ]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: Optional[int] = None,
                    device=None) -> Tuple[Any, int]:
    """(the tree of torch tensors on ``device`` (None = the CUDA card),
    its step); the latest step when ``step`` is None."""
    device = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}.npz")
    manifest = os.path.join(directory, f"step_{step:08d}.json")
    with open(manifest) as f:
        meta = json.load(f)
    dtypes = meta.get("dtypes", {})
    flat = {}
    with np.load(path) as data:
        for k in meta["keys"]:
            a = data[k]
            want = dtypes.get(k, str(a.dtype))
            if want == "bfloat16":
                t = torch.from_numpy(a).to(torch.bfloat16)
            else:
                t = torch.from_numpy(a.astype(np.dtype(want), copy=False))
            flat[k] = t.to(device)
    return _unflatten(flat, meta["structure"]), step
