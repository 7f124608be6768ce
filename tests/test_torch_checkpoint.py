"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's ``repro.checkpoint`` on the CPU: each package reads what the
other writes, leaf for leaf, in the reference's layout (``step_<N>.npz``
and its JSON manifest; slash-joined keys of the JAX param tree, layers
stacked on L; bfloat16 leaves stored as float32 and named "bfloat16").
``convert.*_params_to_jax`` is the inverse of ``*_params_from_jax``.
Serving from a checkpoint (``launch.serve --ckpt-dir``) gives the greedy
tokens of the reference's engine on the same checkpoint. Every
comparison is exact."""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_leaves(v, name))
        else:
            out[name] = v
    return out


def _np(t):
    """A port leaf as numpy, bfloat16 as ml_dtypes' bfloat16 (by bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _jax_tree(arch, seed=0, **changes):
    jcfg = dataclasses.replace(jax_config(arch, reduced=True), **changes)
    cfg = dataclasses.replace(get_config(arch, reduced=True), **changes)
    tree = jax.tree.map(np.asarray,
                        jax_build(jcfg).init(jax.random.PRNGKey(seed)))
    return jcfg, cfg, tree


@pytest.mark.parametrize("arch,changes", [
    ("gemma-7b", {}), ("hymba-1.5b", {}), ("minicpm3-4b", {}),
    ("deepseek-v2-236b", {"param_dtype": "bfloat16"})])
def test_params_to_jax_inverts_params_from_jax(arch, changes):
    """The reference tree, through the port's params and back: the same
    paths, shapes, dtypes and bits."""
    _, cfg, tree = _jax_tree(arch, **changes)
    params = convert.lm_params_from_jax(cfg, tree, device="cpu")
    back = _leaves(convert.lm_params_to_jax(cfg, params))
    want = _leaves(tree)
    assert set(back) == set(want)
    for name, w in want.items():
        assert back[name].device.type == "cpu"
        _bits_equal(_np(back[name]), w)


def test_encdec_params_to_jax_inverts_params_from_jax():
    _, cfg, tree = _jax_tree("seamless-m4t-medium")
    params = convert.encdec_params_from_jax(cfg, tree, device="cpu")
    back = _leaves(convert.encdec_params_to_jax(cfg, params))
    want = _leaves(tree)
    assert set(back) == set(want)
    for name, w in want.items():
        _bits_equal(_np(back[name]), w)


@pytest.mark.parametrize("arch,changes", [
    ("gemma-7b", {}), ("deepseek-v2-236b", {"param_dtype": "bfloat16"})])
def test_port_checkpoint_loads_in_the_reference(tmp_path, arch, changes):
    """Port params saved by the port, read by ``repro.checkpoint``: the
    tree of ``lm_params_to_jax`` leaf for leaf, bfloat16 leaves exact."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), **changes)
    params = build_model(cfg).init(3, "cpu")
    tree = convert.lm_params_to_jax(cfg, params)
    path = ckpt.save_checkpoint(str(tmp_path), 7, tree)
    assert path.endswith("step_00000007.npz")
    loaded, step = jckpt.load_checkpoint(str(tmp_path))
    assert step == 7
    want = _leaves(tree)
    got = _leaves(loaded)
    assert set(got) == set(want)
    for name, w in want.items():
        _bits_equal(got[name], _np(w))
    if changes:
        assert any(np.asarray(v).dtype == ml_dtypes.bfloat16
                   for v in got.values())
    # the manifest names bfloat16 leaves and stores them as float32
    meta = json.loads((tmp_path / "step_00000007.json").read_text())
    with np.load(path) as data:
        for k in meta["keys"]:
            if meta["dtypes"][k] == "bfloat16":
                assert data[k].dtype == np.float32


@pytest.mark.parametrize("arch,changes", [
    ("gemma-7b", {}), ("deepseek-v2-236b", {"param_dtype": "bfloat16"}),
    ("seamless-m4t-medium", {})])
def test_reference_checkpoint_loads_in_the_port(tmp_path, arch, changes):
    """A reference tree saved by ``repro.checkpoint``, read by the port:
    the same leaves bit for bit, and the same params as
    ``*_params_from_jax`` of the tree itself."""
    _, cfg, tree = _jax_tree(arch, seed=4, **changes)
    jckpt.save_checkpoint(str(tmp_path), 12, tree)
    loaded, step = ckpt.load_checkpoint(str(tmp_path), device="cpu")
    assert step == 12
    got = _leaves(loaded)
    want = _leaves(tree)
    assert set(got) == set(want)
    for name, w in want.items():
        assert isinstance(got[name], torch.Tensor)
        _bits_equal(_np(got[name]), w)
    to_port = convert.encdec_params_from_jax if cfg.encoder_layers \
        else convert.lm_params_from_jax
    a = to_port(cfg, loaded, device="cpu").state_dict()
    b = to_port(cfg, tree, device="cpu").state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_nested_lists_and_latest_step(tmp_path):
    """The reference's manifest structure round-trips lists and scalars;
    ``latest_step`` picks the largest step."""
    tree = {"a": [torch.arange(3, dtype=torch.int32),
                  {"b": torch.tensor(2.5)}], "c": np.float32(1.0)}
    for step in (3, 10, 4):
        ckpt.save_checkpoint(str(tmp_path), step, tree)
    assert ckpt.latest_step(str(tmp_path)) == 10
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    got, step = ckpt.load_checkpoint(str(tmp_path), device="cpu")
    assert step == 10
    assert torch.equal(got["a"][0], tree["a"][0])
    assert float(got["a"][1]["b"]) == 2.5 and float(got["c"]) == 1.0
    ref, _ = jckpt.load_checkpoint(str(tmp_path), 4)
    np.testing.assert_array_equal(ref["a"][0], [0, 1, 2])
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "none"), device="cpu")


def test_trainer_checkpoint_serves_like_the_reference(tmp_path, capsys):
    """A port ``Trainer`` checkpoint served by ``launch.serve --ckpt-dir``
    on the CPU and by the reference's engine on ``repro.checkpoint``'s
    read of it: identical greedy tokens."""
    from repro_torch.configs.base import InputShape
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_config("gemma-7b", reduced=True)
    Trainer(cfg, InputShape("local", 32, 4, "train"),
            TrainerConfig(steps=3, checkpoint_dir=str(tmp_path),
                          opt=AdamWConfig(lr=1e-2), device="cpu")).run()
    jtree, step = jckpt.load_checkpoint(str(tmp_path))
    assert step == 3
    params, pstep = launcher.load_params(cfg, str(tmp_path), "cpu")
    assert pstep == 3
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
               for _ in range(4)]
    want = JServeEngine(jax_config("gemma-7b", reduced=True),
                        jax.tree.map(jnp.asarray, jtree), max_batch=4,
                        cache_len=40).serve(
        [JRequest(i, p, max_new_tokens=8) for i, p in enumerate(prompts)])
    got = ServeEngine(cfg, params, max_batch=4, cache_len=40).serve(
        [Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))

    # the launcher itself, on the reference engine's own requests
    assert launcher.main(["--device", "cpu", "--ckpt-dir", str(tmp_path),
                          "--requests", "4", "--prompt-len", "16",
                          "--max-new", "8"]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint step 3" in out
    rng = np.random.default_rng(0)
    reqs = [JRequest(i, rng.integers(0, cfg.vocab_size, 16).astype(np.int32),
                     max_new_tokens=8) for i in range(4)]
    want = JServeEngine(jax_config("gemma-7b", reduced=True),
                        jax.tree.map(jnp.asarray, jtree), max_batch=4,
                        cache_len=16 + 8 + 8).serve(reqs)
    for c in want:
        assert f"-> {np.asarray(c.tokens)[:6]}" in out, (c.request_id, out)
