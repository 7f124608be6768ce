"""Activation-sharding context, the port of the JAX package's
``parallel/context.py``.

With d_model sharded on the data axis (FSDP-style), the sharding that
propagates from the weights onto activations can collide with the batch
sharding and replicate the batch dim. The dry run installs this context;
the model pins the residual stream back to batch-sharded at the
embedding, at every block boundary and before the logits. Without a
context, and on a plain tensor (every run on the card or the CPU), it is
the identity.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Tuple

import torch

from .sharding import mesh_axes, placements

_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "act_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, batch_axes: Tuple[str, ...]):
    token = _ctx.set((mesh, tuple(batch_axes)))
    try:
        yield
    finally:
        _ctx.reset(token)


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """A (B, ...) DTensor redistributed to ``Shard(0)`` on the context's
    batch axes and replicated on the others; ``x`` itself without a
    context, for a plain tensor, or when the batch axes do not divide
    B."""
    ctx = _ctx.get()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    mesh, batch_axes = ctx
    if not batch_axes or not isinstance(x, DTensor):
        return x
    sizes = mesh_axes(mesh)
    size = 1
    for a in batch_axes:
        size *= sizes[a]
    if x.shape[0] % size != 0:
        return x
    return x.redistribute(mesh, placements((batch_axes,), mesh))



def write_slice_(dst: torch.Tensor, dim: int, start: int,
                 src: torch.Tensor) -> None:
    """``dst[start:start + n] = src`` along ``dim`` (n = src's size
    there), in place.

    On a plain tensor this is the slice assignment. A DTensor sharded
    along ``dim`` (a decode cache whose length is split on the model
    axis) cannot take it: DTensor gathers the sharded dim to slice it,
    and the write lands in that copy. So each device writes, in its own
    shard, the part of [start, start + n) that the shard holds, as XLA's
    ``dynamic_update_slice`` does (``src`` laid out as ``dst`` but whole
    along ``dim``)."""
    from torch.distributed.tensor import DTensor, Replicate

    n = src.shape[dim]
    if not isinstance(dst, DTensor):
        dst.narrow(dim, start, n).copy_(src)
        return
    mesh = dst.device_mesh
    whole = [Replicate() if p.is_shard(dim) else p for p in dst.placements]
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    src = src.redistribute(mesh, whole)._local_tensor
    lo, size = 0, dst.shape[dim]
    coord = mesh.get_coordinate()
    for i, p in enumerate(dst.placements):
        if p.is_shard(dim):
            size //= mesh.size(i)
            lo += coord[i] * size
    a, b = max(start, lo), min(start + n, lo + size)
    if a < b:
        dst._local_tensor.narrow(dim, a - lo, b - a).copy_(
            src.narrow(dim, a - start, b - a))



def unsplit(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` whole along ``dim``: a DTensor split there (or holding a
    partial sum) is replicated along it; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or not any(
            p.is_shard(dim) or p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard(dim) or p.is_partial() else p
        for p in x.placements])


def _even(x, dim: int, lead: int):
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            n *= mesh.size(i)
    if x.shape[dim] % n == 0 and lead % n == 0 \
            and not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(mesh, [
        Replicate() if p.is_shard(dim) or p.is_partial() else p
        for p in x.placements])


class _SplitEvenly(torch.autograd.Function):
    """``_even`` forward, and on the gradient backward."""

    @staticmethod
    def forward(ctx, x, dim, lead):
        ctx.dim, ctx.lead = dim, lead
        return _even(x, dim, lead)

    @staticmethod
    def backward(ctx, g):
        return _even(g, ctx.dim, ctx.lead), None, None


def split_evenly(x: torch.Tensor, dim: int, lead: int) -> torch.Tensor:
    """``x``, ready for a view that splits ``dim`` into ``lead`` leading
    parts or merges it, as the leading part, with the dims after it; and
    its gradient ready for the view's own gradient (so a view is wrapped
    on both sides: ``split_evenly(split_evenly(x, d, k).reshape(...),
    d, k)``).

    DTensor views a sharded dim only when its n shards divide both the
    dim and ``lead``; a DTensor sharded otherwise (8 kv heads of 32 query
    heads on a 16-way axis; 40 heads sharded unevenly) is replicated
    along ``dim`` first, and a partial sum is reduced (DTensor's view
    would otherwise reduce-scatter it onto ``dim``, evenly or not). A
    plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return _SplitEvenly.apply(x, dim, lead)


# ------------------------------------------------------------ shard-local
# Some DTensor versions cannot run a product whose batch dims are split
# over two mesh dims (an attention over batch-split and head-split q, k,
# v; the expert products over group-split and expert-split tensors): they
# refuse to flatten the dims. These compute such a function on each
# device's own shard (``local_map``) where the function is independent
# across the split; on a plain tensor they call it.
class _Contiguous(torch.autograd.Function):
    """``contiguous()`` forward, and on the gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return x.contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _local(fn):
    """``fn`` for ``local_map``, its tensors kept contiguous both ways: a
    local shard wrapped as a DTensor (the output forward, an input's
    gradient backward) gets the global strides of a contiguous tensor,
    and a later view of a shard laid out otherwise would fail."""
    def run(*args):
        args = [_Contiguous.apply(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        return _Contiguous.apply(fn(*args))
    return run


def heads_parallel(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   *args):
    """``fn(q, k, v, *args)``: attention over q (B, S_q, H, D) and k, v
    (B, S_k, KV, D_*) giving (B, S_q, H, D_v); ``args`` are plain
    (positions).

    On the dry run's DTensors it runs on each device's shard, since
    attention is independent across the batch and across heads: the
    batch split as q's, the heads split as q's, k and v split alike (each
    kv head repeated for its H // KV query heads first where the kv heads
    do not split that way); any other split is undone first."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(q, DTensor):
        return fn(q, k, v, *args)
    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    heads = 1
    for i, p in enumerate(q.placements):
        if p.is_shard(2):
            heads *= mesh.size(i)
    if KV % heads:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    # a list is one tensor's placements; a tuple, one entry per output
    pl = [Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(2)
          else Replicate() for p in q.placements]
    return local_map(_local(fn), out_placements=pl,
                     in_placements=(pl, pl, pl) + (None,) * len(args),
                     device_mesh=mesh, redistribute_inputs=True)(
                         q, k, v, *args)


def experts_parallel(fn, xg: torch.Tensor, dispatch: torch.Tensor,
                     combine: torch.Tensor, *weights: torch.Tensor):
    """``fn(xg, dispatch, combine, *weights)``: the expert FFNs over the
    grouped tokens xg (G, S_g, d) with the (G, S_g, E, C) dispatch and
    combine tensors and expert weights (E, ...), giving (G, S_g, d).

    On the dry run's DTensors it runs on each device's shard: groups
    split as xg's, experts split as the weights' expert dim; each device
    sums its experts' share, so the result is a partial sum over the
    expert split."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(xg, DTensor):
        return fn(xg, dispatch, combine, *weights)
    mesh = xg.device_mesh
    x_pl, r_pl, w_pl, out = [], [], [], []
    for px, pw in zip(xg.placements, weights[0].placements):
        if pw.is_shard(0):
            x_pl.append(Replicate())
            r_pl.append(Shard(2))
            w_pl.append(Shard(0))
            out.append(Partial())
        elif px.is_shard(0):
            x_pl.append(Shard(0))
            r_pl.append(Shard(0))
            w_pl.append(Replicate())
            out.append(Shard(0))
        else:
            x_pl.append(Replicate())
            r_pl.append(Replicate())
            w_pl.append(Replicate())
            out.append(Replicate())
    return local_map(_local(fn), out_placements=out,
                     in_placements=(x_pl, r_pl, r_pl)
                     + (w_pl,) * len(weights),
                     device_mesh=mesh, redistribute_inputs=True)(
                         xg, dispatch, combine, *weights)


def rows_of(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``. On the dry run's DTensors each device looks its
    own ids up in the whole table (gathered first), the rows split as
    the ids are."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(ids, DTensor):
        return table[ids]
    mesh = ids.device_mesh
    whole = [Replicate()] * mesh.ndim
    return local_map(lambda t, i: t[i], out_placements=list(ids.placements),
                     in_placements=(whole, list(ids.placements)),
                     device_mesh=mesh, redistribute_inputs=True)(table, ids)



class _GatherLast(torch.autograd.Function):
    """``torch.gather(x, -1, idx)`` whose gradient (g at idx, zero
    elsewhere) is built elementwise, ``where(arange == idx, g, 0)``."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.width = x.shape[-1]
        ctx.save_for_backward(idx)
        return torch.gather(x, -1, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        cols = torch.arange(ctx.width, device=idx.device)
        return torch.where(cols == idx, g, 0.0), None


def gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, idx)``. On a DTensor its gradient keeps x's
    sharding: autograd's (``grad.new_zeros(x.shape).scatter_add_``) makes
    the whole tensor on every device, (B, S, V) log-probabilities for the
    loss. The same values (autograd's 0 + g differs only where g is
    -0.0)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return torch.gather(x, -1, idx)
    return _GatherLast.apply(x, idx)
