"""The port's dry run (``repro_torch.launch.dryrun``) and its spec
helpers against the JAX package's, on the CPU with fake meshes.

  * ``input_specs``, ``serve_state_specs`` and ``abstract_train_state``
    match the reference's ``eval_shape`` trees in shape and dtype, every
    per-layer tensor stacked on the reference's leading L axis;
  * on the fake 16x16 mesh the plan's ``argument_bytes`` is the sum of
    ``NamedSharding.shard_shape`` bytes over the reference's abstract
    train state and batch, exactly;
  * the reference's six reduced dry-run cases plan on a fake 2x2 mesh;
  * the per-device FLOPs are exact: on 1x1 they equal the unsharded
    count (``FlopCounterMode`` on plain meta tensors), and under
    ``pure_fsdp`` on 2x2 four times the per-device count equals it; the
    L = 1 / L = 2 probes extrapolate to the direct count;
  * ``launch.train``'s default path plans and prints its line.
No test leaves a process group behind."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES as JSHAPES
from repro.models import build_model as jax_build
from repro.models import input_specs as jax_input_specs
from repro.models import serve_state_specs as jax_serve_state_specs
from repro.optim import AdamWConfig as JAdamWConfig
from repro.parallel.sharding import MeshRules as JMeshRules
from repro.parallel.sharding import batch_shardings as jax_batch_sh
from repro.parallel.sharding import param_shardings as jax_param_sh
from repro.train import abstract_train_state as jax_abstract_state
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import _mesh, fake_world, make_production_mesh
from repro_torch.models import build_model, concrete_batch, decode_window, \
    input_specs, serve_state_specs
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import MeshRules
from repro_torch.parallel.sharding import ref_path
from repro_torch.train import abstract_train_state, make_train_step


def _dt(x) -> str:
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    return np.dtype(x).name


def _ref_leaves(tree):
    """{path: (shape, dtype name)} of a reference ``eval_shape`` tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = (tuple(leaf.shape), _dt(leaf.dtype))
    return out


def _stacked_leaves(named, cfg):
    """The port's (name, tensor) pairs as the reference's stacked tree:
    per-layer names gathered on a leading L axis (every layer present,
    alike)."""
    out, count = {}, {}
    for name, t in named:
        path, per_layer = ref_path(name)
        leaf = (tuple(t.shape), _dt(t.dtype))
        if per_layer:
            count[path] = count.get(path, 0) + 1
            assert out.setdefault(path, leaf) == leaf, name
        else:
            out[path] = leaf
    L = {"layers": cfg.num_layers, "decoder": cfg.num_layers,
         "encoder": cfg.encoder_layers}
    for path, n in count.items():
        assert n == L[path.split("/")[0]], path
        shape, dt = out[path]
        out[path] = ((n,) + shape, dt)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_abstract_state_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    state = abstract_train_state(build_model(cfg), AdamWConfig())
    jstate = jax_abstract_state(jax_build(jcfg), JAdamWConfig())
    assert all(p.device.type == "meta" for p in state["params"].parameters())
    params = _stacked_leaves(state["params"].named_parameters(), cfg)
    assert params == _ref_leaves(jstate["params"])
    for k in ("m", "v"):
        assert _stacked_leaves(state["opt"][k].items(), cfg) == \
            _ref_leaves(jstate["opt"][k])
    assert (tuple(state["opt"]["step"].shape), _dt(state["opt"]["step"]
                                                   .dtype)) == \
        _ref_leaves({"s": jstate["opt"]["step"]})["s"]

    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        got = {k: (tuple(v.shape), _dt(v.dtype))
               for k, v in input_specs(cfg, shape).items()}
        assert got == _ref_leaves(jax_input_specs(jcfg, jshape)), name
        assert decode_window(cfg, shape) == \
            (jcfg.long_context_window if name == "long_500k" else None)
        if shape.kind != "decode":
            continue
        st = serve_state_specs(cfg, shape)
        jst = _ref_leaves(jax_serve_state_specs(jcfg, jshape))
        named = []
        for i, layer in enumerate(st["cache"]):
            for part, c in layer.items():
                for key, t in c.items():
                    if isinstance(t, torch.Tensor):
                        assert t.device.type == "meta"
                        named.append((f"layers.{i}.{part}.{key}", t))
                    else:
                        assert key == "pos" and t == 0
        want = {p.replace("cache/", "layers/"): v for p, v in jst.items()
                if p.startswith("cache/") and not p.endswith("/pos")}
        assert _stacked_leaves(named, cfg) == want, name
        assert st["pos"] == 0
        if "enc" in st:
            assert (tuple(st["enc"].shape), _dt(st["enc"].dtype)) == \
                jst["enc"]


def test_concrete_batch():
    """A batch of ``input_specs``' shapes and dtypes from an explicit
    generator: token ids in [0, vocab), the same batch for the same
    seed."""
    cfg = get_config("llava-next-mistral-7b", reduced=True)
    shape = InputShape("t", 64, 2, "train")
    a = concrete_batch(cfg, shape, 3, "cpu")
    b = concrete_batch(cfg, shape, 3, "cpu")
    specs = input_specs(cfg, shape)
    assert a.keys() == specs.keys() == {"tokens", "labels", "image_embeds"}
    for k in a:
        assert a[k].shape == specs[k].shape and a[k].dtype == specs[k].dtype
        assert torch.equal(a[k], b[k])
    assert 0 <= int(a["tokens"].min()) and \
        int(a["tokens"].max()) < cfg.vocab_size


@pytest.mark.parametrize("arch", ["gemma-7b", "phi3.5-moe-42b-a6.6b"])
def test_argument_bytes_equal_the_reference_shards(arch):
    """On the fake 16x16 mesh the plan's arguments (params, moments, step
    and batch, each its local shard) hold exactly the bytes of the
    reference's abstract train state and batch under its shardings."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    shape, jshape = SHAPES["train_4k"], JSHAPES["train_4k"]
    jrules = JMeshRules(AbstractMesh((16, 16), ("data", "model")))
    jstate = jax_abstract_state(jax_build(jcfg), JAdamWConfig())
    jbatch = jax_input_specs(jcfg, jshape)

    def nbytes(tree, shardings):
        return sum(int(np.prod(sh.shard_shape(x.shape))) * x.dtype.itemsize
                   for x, sh in zip(jax.tree.leaves(tree),
                                    jax.tree.leaves(shardings,
                                                    is_leaf=lambda s:
                                                    isinstance(
                                                        s, NamedSharding))))

    want = (nbytes(jstate["params"], jax_param_sh(jrules, jstate["params"]))
            + sum(nbytes(jstate["opt"][k],
                         jax_param_sh(jrules, jstate["opt"][k]))
                  for k in ("m", "v"))
            + jstate["opt"]["step"].dtype.itemsize
            + nbytes(jbatch, jax_batch_sh(jrules, jbatch)))
    with fake_world(256):
        rules = MeshRules(make_production_mesh(device="cpu"))
        _, args = dryrun._step_and_args(cfg, shape, rules, AdamWConfig())
        got = dryrun._nbytes(dryrun._local_tensors(args))
    assert not dist.is_initialized()
    assert got == want


#: the reference's dry-run integration cases (tests/test_dryrun_integration.py)
SMALL_CASES = [
    ("qwen3-32b", InputShape("t", 256, 8, "train")),
    ("phi3.5-moe-42b-a6.6b", InputShape("t", 256, 8, "train")),
    ("mamba2-780m", InputShape("d", 256, 8, "decode")),
    ("hymba-1.5b", InputShape("d", 512, 4, "decode")),
    ("seamless-m4t-medium", InputShape("p", 256, 4, "prefill")),
    ("minicpm3-4b", InputShape("d", 256, 8, "decode")),
]


def test_dryrun_small_mesh_all_families():
    """Every family plans on a fake 2x2 mesh (train, prefill and decode
    kinds), with finite, positive counts and a peak at least its
    arguments."""
    with fake_world(4):
        mesh = _mesh("cpu", (2, 2), ("data", "model"))
        for arch, shape in SMALL_CASES:
            r = dryrun.dryrun_one(arch, shape.name, reduced=True,
                                  mesh_override=mesh, shape_override=shape,
                                  extrapolate=False, verbose=False)
            mem = r["memory"]
            assert r["devices"] == 4 and r["mesh"] == "2x2"
            assert r["flops"] > 0 and np.isfinite(r["flops"]), arch
            assert 0 < mem["argument_bytes"] <= mem["peak_bytes"], arch
            assert r["collective_bytes"], arch
    assert not dist.is_initialized()


def _unsharded_flops(cfg, shape):
    """FlopCounterMode over the train step on plain meta tensors."""
    model = build_model(cfg)
    state = abstract_train_state(model, AdamWConfig())
    batch = input_specs(cfg, shape)
    with FlopCounterMode(display=False) as fc:
        make_train_step(model, AdamWConfig())(state, batch)
    return fc.get_total_flops()


def test_per_device_flops_are_exact():
    """Reduced Gemma, B = 4, S = 64: 1x1 equals the unsharded count;
    pure_fsdp on 2x2 computes a quarter of it on each device; the
    probes' extrapolation equals the direct count."""
    cfg = get_config("gemma-7b", reduced=True)
    shape = InputShape("t", 64, 4, "train")
    total = _unsharded_flops(cfg, shape)
    assert total == 1_862_270_976
    with fake_world(1):
        mesh = _mesh("cpu", (1, 1), ("data", "model"))
        r = dryrun.dryrun_one("gemma-7b", "t", cfg_override=cfg,
                              shape_override=shape, mesh_override=mesh,
                              verbose=False)
        assert r["flops"] == total
        assert r["extrapolation_gap"] == 0.0
        assert r["collective_bytes"] == {}
    with fake_world(4):
        mesh = _mesh("cpu", (2, 2), ("data", "model"))
        r = dryrun.dryrun_one("gemma-7b", "t", cfg_override=cfg,
                              shape_override=shape, mesh_override=mesh,
                              pure_fsdp=True, verbose=False)
        assert 4 * r["flops"] == total
        assert r["extrapolation_gap"] is not None
    assert not dist.is_initialized()


def test_extrapolate_is_the_references_without_its_clamp():
    cfg = dataclasses.replace(get_config("gemma-7b", reduced=True),
                              num_layers=5)
    m1 = {"flops": 10.0, "hlo_bytes": 7.0,
          "collective_bytes": {"all-gather": 4.0, "reduce-scatter": 1.0}}
    m2 = {"flops": 16.0, "hlo_bytes": 9.0,
          "collective_bytes": {"all-gather": 6.0, "reduce-scatter": 8.0}}
    got = dryrun._extrapolate(cfg, m1, m2)
    assert got["flops"] == 4 + 5 * 6 and got["hlo_bytes"] == 5 + 5 * 2
    assert got["collective_bytes"] == {"all-gather": 2.0 + 5 * 2,
                                       "reduce-scatter": -6.0 + 5 * 7}
    with pytest.raises(AssertionError):
        dryrun._extrapolation_gap(got, {**got, "flops": 1.0})
    assert dryrun._extrapolation_gap(got, got) == 0.0


def test_launch_train_default_path_plans(capsys):
    """``launch.train``'s default path plans the full-size config on the
    production mesh (here the CPU's type) and prints its line."""
    from repro_torch.launch import train as launch_train
    assert launch_train.main(["--arch", "mamba2-780m", "--shape",
                              "decode_32k", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[dryrun] mamba2-780m x decode_32k mesh=16x16" in out
    assert "roofline: compute=" in out and "planned OK" in out
    assert not dist.is_initialized()
