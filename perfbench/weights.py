"""Weights made from ``--seed`` on the device, a group at a time.

Each group of ``layout.groups`` is drawn into one flat buffer by a
generator on the device seeded from (seed, group name): one ``normal_``
call a slab of ``DRAW_CHUNK`` elements, then each leaf's view is scaled
in place. So a group is drawn by a few large calls, any group can be
drawn again alone and comes out bit for bit the same on the same device,
and the reference reads the weights the program was given without
taking them from the program.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Tuple

import torch

from .layout import NORMAL, Dims, Leaf, groups

#: elements drawn by one call
DRAW_CHUNK = 1 << 28


def group_seed(seed: int, group: str) -> int:
    digest = hashlib.sha256(f"{seed}:{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def _draw(buf: torch.Tensor, gen: torch.Generator) -> None:
    for part in buf.split(DRAW_CHUNK):
        part.normal_(0.0, 1.0, generator=gen)


def draw_group(seed: int, name: str, leaves: List[Leaf], device,
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The group's leaves as views of one buffer in ``dtype`` (a float32
    leaf of its own buffer, drawn after the others)."""
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, name))
    out: Dict[str, torch.Tensor] = {}
    for f32 in (False, True):
        part = [leaf for leaf in leaves if leaf.float32 == f32]
        if not part:
            continue
        buf = torch.empty(sum(leaf.numel for leaf in part),
                          dtype=torch.float32 if f32 else dtype,
                          device=device)
        _draw(buf, gen)
        at = 0
        for leaf in part:
            view = buf[at:at + leaf.numel].view(leaf.shape)
            at += leaf.numel
            if leaf.kind == NORMAL:
                view.mul_(leaf.std)
            else:
                view.mul_(0.1).add_(1.0)
            out[leaf.name] = view
    return out


def group_pieces(seed: int, name: str, leaves: List[Leaf], device,
                 dtype=torch.bfloat16
                 ) -> Iterable[Tuple[str, int, torch.Tensor]]:
    """The group drawn again a ``DRAW_CHUNK`` at a time, bit for bit as
    ``draw_group`` draws it: (leaf name, offset into the leaf's flat view,
    that piece of the leaf), so only one chunk is alive at a time."""
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, name))
    for f32 in (False, True):
        part = [leaf for leaf in leaves if leaf.float32 == f32]
        starts, at = [], 0
        for leaf in part:
            starts.append(at)
            at += leaf.numel
        for lo in range(0, at, DRAW_CHUNK):
            hi = min(lo + DRAW_CHUNK, at)
            chunk = torch.empty(hi - lo, dtype=torch.float32 if f32
                                else dtype, device=device)
            chunk.normal_(0.0, 1.0, generator=gen)
            for leaf, a in zip(part, starts):
                s, e = max(lo, a), min(hi, a + leaf.numel)
                if s >= e:
                    continue
                piece = chunk[s - lo:e - lo]
                if leaf.kind == NORMAL:
                    piece.mul_(leaf.std)
                else:
                    piece.mul_(0.1).add_(1.0)
                yield leaf.name, s - a, piece


def dtype_of(cfg: Dict) -> torch.dtype:
    """The dtype the configuration's parameters are served in."""
    return getattr(torch, cfg["torch_dtype"])


def draw_all(seed: int, m: Dims, device,
             dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, leaves in groups(m):
        out.update(draw_group(seed, name, leaves, device, dtype))
    return out
