"""The port's sharding rules (``repro_torch.parallel``) and meshes
(``repro_torch.launch.mesh``) against the JAX package's.

Specs: for every config at full size, on the canonical, multi-pod and
re-factored meshes and under each rule variant (``fsdp_over_pod``,
``tp_over_pod``, ``pure_fsdp``), train and serve, each of the port's
per-layer params gets the reference's ``spec_for`` of its stacked path
over a ``jax.sharding.AbstractMesh`` with the leading (layer) entry
dropped; batch and per-layer cache specs likewise. Shard shapes: each
param's DTensor on a fake mesh holds the local shape that
``NamedSharding(AbstractMesh, spec).shard_shape`` gives. Every
comparison is exact. No test leaves a process group behind."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.models import serve_state_specs as jax_serve_state_specs
from repro.parallel.sharding import MeshRules as JMeshRules
from repro.parallel.sharding import serve_state_shardings as jax_state_sh
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, host_world, \
    make_host_mesh, make_production_mesh, production_shape
from repro_torch.models import build_model, serve_state_specs
from repro_torch.parallel import MeshRules, MeshShape, placements
from repro_torch.parallel.context import activation_sharding, \
    constrain_batch, heads_parallel, rows_of, split_evenly, unsplit, \
    write_slice_
from repro_torch.parallel.sharding import ref_path, serve_state_spec
from repro_torch.data import shard_batch

#: (sizes, axis names): the small meshes, the production 16x16 and
#: 2x16x16, and the model axis re-factored by model_split 2 and 4
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "16x16": production_shape(False),
    "2x16x16": production_shape(True),
    "split2": production_shape(False, 2),
    "split4": production_shape(False, 4),
    "pods_split2": production_shape(True, 2),
}
VARIANTS = ({}, {"fsdp_over_pod": True}, {"tp_over_pod": True},
            {"pure_fsdp": True})


def _rules(sizes, names, **kw):
    return (MeshRules(MeshShape(names, sizes), **kw),
            JMeshRules(AbstractMesh(sizes, names), **kw))


def _params(cfg):
    """{(reference path, per-layer?): (port name, shape)} of the port's
    params, one per distinct (path, shape)."""
    out = {}
    for name, p in build_model(cfg).init_abstract().named_parameters():
        out.setdefault(ref_path(name), (name, tuple(p.shape)))
    return out


def _stacked(cfg, path):
    return {"layers": cfg.num_layers, "decoder": cfg.num_layers,
            "encoder": cfg.encoder_layers}[path.split("/")[0]]


def _ref_spec(jrules, cfg, path, per_layer, shape, serve=False):
    if per_layer:
        spec = tuple(jrules.spec_for(path, (_stacked(cfg, path),) + shape,
                                     serve=serve))
        assert spec == () or spec[0] is None
        return spec[1:]
    return tuple(jrules.spec_for(path, shape, serve=serve))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh):
    cfg = get_config(arch)
    params = _params(cfg)
    sizes, names = MESHES[mesh]
    for kw in VARIANTS:
        rules, jrules = _rules(sizes, names, **kw)
        for serve in (False, True):
            for (path, per_layer), (name, shape) in params.items():
                want = _ref_spec(jrules, cfg, path, per_layer, shape, serve)
                assert rules.spec_for(name, shape, serve=serve) == want, \
                    (name, kw, serve)
                assert rules.spec_for(path, ((_stacked(cfg, path),) + shape)
                                      if per_layer else shape, serve=serve) \
                    == (((None,) + want) if per_layer and want else want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(arch):
    """``batch_spec`` of every input shape's batch and ``cache_spec`` of
    every per-layer serve-state tensor (decode_32k, long_500k) equal the
    reference's (its stacked (L, B, ...) cache spec without L)."""
    cfg = get_config(arch)
    jcfg = jax_config(arch)
    states = {}
    for sname in ("decode_32k", "long_500k"):
        shape = SHAPES[sname]
        jstate = jax_serve_state_specs(jcfg, shape)
        state = serve_state_specs(cfg, shape)
        states[sname] = (jstate, state)
    for sizes, names in MESHES.values():
        for kw in VARIANTS:
            rules, jrules = _rules(sizes, names, **kw)
            for shape in SHAPES.values():
                for b in (shape.global_batch, 4, 6):
                    dims = (b, shape.seq_len, 3)
                    assert rules.batch_spec(dims) == tuple(
                        jrules.batch_spec(dims))
            for jstate, state in states.values():
                jsh = jax_state_sh(jrules, jstate)
                for path, t in dryrun_named(state):
                    parts = path.split(".")
                    if parts[0] == "cache":
                        key, i = parts[2:], int(parts[1])
                        assert 0 <= i < cfg.num_layers
                        want = _get(jsh["cache"], key).spec
                        want = tuple(want)[1:] if len(want) else ()
                    else:
                        want = tuple(jsh[parts[0]].spec)
                    got = serve_state_spec(rules, path, tuple(t.shape))
                    assert got == want, (path, kw)


def dryrun_named(state, prefix=""):
    if isinstance(state, dict):
        for k, v in state.items():
            yield from dryrun_named(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(state, list):
        for i, v in enumerate(state):
            yield from dryrun_named(v, f"{prefix}.{i}")
    elif isinstance(state, torch.Tensor):
        yield prefix, state


def _get(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mesh", ["2x2", "16x16", "2x16x16"])
def test_shard_shapes_equal_named_sharding(mesh):
    """Each param's meta DTensor on a fake mesh (the dry run's
    ``_place``) holds ``NamedSharding(AbstractMesh, spec).shard_shape``
    of its stacked global shape, per layer; batch tensors too."""
    sizes, names = MESHES[mesh]
    amesh = AbstractMesh(sizes, names)
    with fake_world(int(np.prod(sizes))):
        dmesh = make_production_mesh(multi_pod=mesh == "2x16x16",
                                     device="cpu") if mesh != "2x2" else \
            dryrun_mesh(sizes, names)
        for kw in ({}, {"pure_fsdp": True}):
            rules = MeshRules(dmesh, **kw)
            jrules = JMeshRules(amesh, **kw)
            for arch in ARCH_IDS:
                cfg = get_config(arch)
                for (path, per_layer), (name, shape) in _params(cfg).items():
                    spec = rules.spec_for(name, shape)
                    t = dryrun._place(torch.empty(shape, device="meta"),
                                      dmesh, spec)
                    if per_layer:
                        full = (_stacked(cfg, path),) + shape
                        want = NamedSharding(amesh, P(*jrules.spec_for(
                            path, full))).shard_shape(full)[1:]
                    else:
                        want = NamedSharding(amesh, P(*jrules.spec_for(
                            path, shape))).shard_shape(shape)
                    assert tuple(t._local_tensor.shape) == tuple(want), name
            for b, s in ((256, 4096), (32, 8), (3, 5)):
                spec = rules.batch_spec((b, s))
                t = dryrun._place(torch.empty((b, s), device="meta"), dmesh,
                                  spec)
                want = NamedSharding(amesh, P(*jrules.batch_spec((b, s)))) \
                    .shard_shape((b, s))
                assert tuple(t._local_tensor.shape) == tuple(want)
    assert not dist.is_initialized()


def dryrun_mesh(sizes, names):
    from repro_torch.launch.mesh import _mesh
    return _mesh("cpu", sizes, names)


def test_placements():
    """Each spec entry shards its dim on the mesh dims it names, in mesh
    order; a size-1 mesh dim replicates; an entry out of mesh order
    raises."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshShape(("pod", "data", "model"), (2, 16, 1))
    assert placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Replicate())
    assert placements((None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        placements((("data", "pod"),), mesh)


def test_shardings_by_name():
    """``param_shardings`` / ``batch_shardings`` / ``serve_state_shardings``
    / ``replicated`` give each tensor by name the placements of its spec:
    the params of a module and of a moments dict alike, the serve state's
    tensors by dotted path (host ints left out)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.parallel import batch_shardings, param_shardings, \
        replicated, serve_state_shardings

    cfg = get_config("gemma-7b")
    mesh = MeshShape(("data", "model"), (16, 16))
    rules = MeshRules(mesh)
    params = build_model(cfg).init_abstract()
    named = dict(params.named_parameters())
    got = param_shardings(rules, params)
    assert got.keys() == named.keys()
    for name, t in named.items():
        assert got[name] == placements(
            rules.spec_for(name, tuple(t.shape)), mesh)
    assert param_shardings(rules, named) == got
    batch = {"tokens": torch.empty(256, 4096, device="meta")}
    assert batch_shardings(rules, batch) == {"tokens": placements(
        ("data", None), mesh)}
    state = serve_state_specs(cfg, SHAPES["decode_32k"])
    sh = serve_state_shardings(rules, state)
    assert sh.keys() == {p for p, _ in dryrun_named(state)}
    assert sh["cache.0.attn.k"] == placements(
        rules.cache_spec("cache.0.attn.k", (128, 32768, 16, 256)), mesh)
    assert sh["cache.3.attn.positions"] == (Replicate(), Replicate())
    assert set(replicated(rules, batch)["tokens"]) == {Replicate()}


def test_production_and_host_meshes():
    """The production meshes' shapes and axis names, each built over a
    fake world of its size and destroyed after; a host mesh over a
    one-process gloo group; none without its group."""
    for multi_pod, split, want in ((False, 0, (16, 16)),
                                   (True, 0, (2, 16, 16)),
                                   (False, 4, (16, 4, 4)),
                                   (True, 2, (2, 16, 8, 2))):
        dims, names = production_shape(multi_pod, split)
        assert dims == want
        with fake_world(int(np.prod(dims))):
            mesh = make_production_mesh(multi_pod, split, device="cpu")
            assert tuple(mesh.mesh.shape) == want
            assert mesh.mesh_dim_names == names
            assert mesh.device_type == "cpu"
        assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError):
        production_shape(False, 3)
    with host_world("cpu"):
        mesh = make_host_mesh(device="cpu")
        assert tuple(mesh.mesh.shape) == (1, 1)
        with pytest.raises(RuntimeError):
            make_host_mesh(2, 1, device="cpu")
        with pytest.raises(RuntimeError):
            with fake_world(4):
                pass
    assert not dist.is_initialized()


# ---------------------------------------------------------------- context
def test_constrain_batch_is_the_identity_off_the_dry_run():
    """Without a context, and on a plain tensor under one, constrain_batch
    returns its input; so do the other DTensor repairs on plain tensors,
    and write_slice_ is the slice assignment."""
    x = torch.randn(4, 3, 2)
    assert constrain_batch(x) is x
    with activation_sharding(MeshShape(("data",), (2,)), ("data",)):
        assert constrain_batch(x) is x
    assert split_evenly(x, 1, 3) is x and unsplit(x, 1) is x
    assert rows_of(x, torch.tensor([2, 0])).equal(x[torch.tensor([2, 0])])
    got = heads_parallel(lambda q, k, v, p: q + k + v + p, x, x, x, x)
    assert torch.equal(got, 4 * x)
    cache = torch.zeros(4, 6, 2)
    want = cache.clone()
    want[:, 2:5] = x
    write_slice_(cache, 1, 2, x)
    assert torch.equal(cache, want)


def test_forward_with_a_context_is_bit_identical():
    """The CPU training forward with an activation-sharding context
    installed is bit-identical to the forward without one, loss and
    gradients."""
    cfg = get_config("gemma-7b", reduced=True)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                            .astype(np.int32))
    batch = {"tokens": toks, "labels": toks}

    def run():
        params.zero_grad(set_to_none=True)
        loss, _ = model.train_loss(params, batch)
        loss.backward()
        return loss.detach(), {n: p.grad.clone()
                               for n, p in params.named_parameters()}

    loss0, grads0 = run()
    with activation_sharding(MeshShape(("data", "model"), (2, 1)),
                             ("data",)):
        loss1, grads1 = run()
    assert torch.equal(loss0, loss1)
    for n in grads0:
        assert torch.equal(grads0[n], grads1[n]), n


def test_constrain_batch_shards_a_dtensor():
    """Under a context, a DTensor comes back Shard(0) on the batch axes
    and replicated elsewhere; a batch the axes do not divide stays as it
    is; ``shard_batch`` places a host batch by the same placements."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with fake_world(4):
        mesh = dryrun_mesh((2, 2), ("data", "model"))
        x = distribute_tensor(torch.empty(8, 3, 4, device="meta"), mesh,
                              [Replicate(), Shard(2)], src_data_rank=None)
        with activation_sharding(mesh, ("data",)):
            y = constrain_batch(x)
            assert y.placements == (Shard(0), Replicate())
            odd = distribute_tensor(torch.empty(3, 2, device="meta"), mesh,
                                    [Replicate(), Replicate()],
                                    src_data_rank=None)
            assert constrain_batch(odd) is odd
        with activation_sharding(mesh, ("data", "model")):
            assert constrain_batch(x).placements == (Shard(0), Shard(0))
        assert constrain_batch(x) is x
    with host_world("cpu"):
        mesh = make_host_mesh(device="cpu")
        batch = {"tokens": np.arange(12, dtype=np.int32).reshape(4, 3)}
        got = shard_batch(batch, mesh, ("data",))["tokens"]
        # one device: the size-1 axes replicate
        assert got.placements == (Replicate(), Replicate())
        assert np.array_equal(got.full_tensor().numpy(), batch["tokens"])
    assert not dist.is_initialized()


def test_write_slice_writes_each_shard():
    """A length-sharded DTensor cache takes a write shard by shard: on
    rank 0 of a 2-way split only the positions its shard holds land, at
    their local offsets."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with fake_world(2):
        mesh = dryrun_mesh((2,), ("model",))
        local = torch.zeros(2, 4, 3)
        cache = DTensor.from_local(local, mesh, [Shard(1)], run_check=False,
                                   shape=torch.Size((2, 8, 3)),
                                   stride=(24, 3, 1))
        src = torch.arange(18, dtype=torch.float32).reshape(2, 3, 3)
        write_slice_(cache, 1, 2, src)          # positions 2, 3, 4
        want = torch.zeros(2, 4, 3)
        want[:, 2:4] = src[:, :2]
        assert torch.equal(cache._local_tensor, want)
        write_slice_(cache, 1, 5, src[:, :1])   # rank 1's position only
        assert torch.equal(cache._local_tensor, want)
        assert cache.placements == (Shard(1),)
        rep = DTensor.from_local(torch.zeros(4), mesh, [Replicate()],
                                 run_check=False)
        write_slice_(rep, 0, 1, torch.ones(2))
        assert torch.equal(rep._local_tensor, torch.tensor([0., 1, 1, 0]))
    assert not dist.is_initialized()
