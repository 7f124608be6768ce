"""Production and host meshes, as ``torch.distributed`` DeviceMeshes.

A DeviceMesh needs a process group, which is process-global: each mesh
is made inside a context that creates its group and destroys it, so
meshes of 256, 512 and 4 ranks can follow each other in one process.

  * ``fake_world(n)``: a fake process group of world size n (this process
    is rank 0; its collectives do nothing). The production meshes are
    built over it: the dry run traces on meta tensors, so a 256-GPU mesh
    needs no GPU and no memory.
  * ``host_world(device)``: a real process group of world size 1 over
    this process's device (nccl on the card, gloo on the CPU).

The mesh's device type follows the port's rule: the CUDA card by
default (raising without one), the CPU only when asked for.
"""
from __future__ import annotations

import contextlib
import math

from ..backend.torch_backend import resolve_device


def _require_no_group():
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this "
                           "process; leave its world first")


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks for the duration."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    _require_no_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def host_world(device=None):
    """A process group of this one process over ``device`` (None = the
    CUDA card) for the duration."""
    import torch.distributed as dist

    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    _require_no_group()
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_shape(multi_pod: bool = False, model_split: int = 0):
    """(mesh shape, axis names): 16x16 = 256 devices a pod; multi-pod adds
    a leading 2-pod axis. ``model_split`` > 0 re-factorizes the 16-way
    model axis into (model=16//model_split, model2=model_split) over the
    same devices, for head counts (40, 25, ...) that 16 does not
    divide."""
    if model_split:
        if 16 % model_split:
            raise ValueError(f"model_split {model_split} does not divide 16")
        if multi_pod:
            return ((2, 16, 16 // model_split, model_split),
                    ("pod", "data", "model", "model2"))
        return (16, 16 // model_split, model_split), \
            ("data", "model", "model2")
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _mesh(device, shape, axes):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} "
                           f"ranks (fake_world({n}) or host_world)")
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(multi_pod: bool = False, model_split: int = 0,
                         device=None):
    """The production mesh (``production_shape``) on ``device``'s type
    (None = the CUDA card), inside ``fake_world`` of its size."""
    return _mesh(device, *production_shape(multi_pod, model_split))


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A (data, model) mesh over this process's devices, inside
    ``host_world``: one process holds one device, so data * model is
    1."""
    return _mesh(device, (data, model), ("data", "model"))
