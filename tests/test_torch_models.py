"""The port's dense decoder (``repro_torch.models``) against the JAX
package's ``repro.models`` on the CPU, on the same weights.

Weights are made by the JAX package's own init and carried across as
numpy (``repro_torch.convert.lm_params_from_jax`` for whole models,
``load_state_dict`` for single layers); other inputs are made with numpy
from a seed. Everything is float32. Tolerances: 1e-5 for single layers,
1e-4 for logits of whole models (the frameworks sum in other orders)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, REGISTRY, get_config
from repro_torch.models import build_model, lm
from repro_torch.models.attention import GQA, init_gqa_cache
from repro_torch.models.blocks import BIG_WINDOW, layer_windows
from repro_torch.models.layers import MLP, Embedding, apply_rope, \
    init_params_
from repro_torch.models.moe import MoE, group_tokens, route


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = torch.from_numpy(np.array(val))
    return out


def _x(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- configs
def test_registry_matches_the_jax_package():
    for arch in ARCH_IDS:
        for reduced in (False, True):
            ours = dataclasses.asdict(get_config(arch, reduced))
            theirs = dataclasses.asdict(jax_config(arch, reduced))
            assert ours == theirs, arch
    cfg = REGISTRY["gemma-7b"]
    assert cfg.param_count() == 8_537_505_792
    assert cfg.dtype("param") == torch.float32
    assert cfg.dtype() == torch.bfloat16


# ---------------------------------------------------------------- layers
def test_rope_matches():
    x = _x(0, (2, 12, 3, 16))
    pos = np.arange(12, dtype=np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("activation", ["geglu", "silu"])
def test_mlp_matches(activation):
    jp = _np_tree(jlayers.init_mlp(jax.random.PRNGKey(1), 32, 64, activation))
    mlp = MLP(32, 64, activation)
    mlp.load_state_dict(_flat(jp))
    x = _x(1, (2, 5, 32))
    want = jlayers.mlp(jp, jnp.asarray(x), activation)
    with torch.no_grad():
        got = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_embed_unembed_match():
    jp = _np_tree(jlayers.init_embedding(jax.random.PRNGKey(2), 50, 16))
    emb = Embedding(50, 16)
    emb.load_state_dict(_flat(jp))
    tokens = np.array([[3, 0, 49], [7, 7, 1]], dtype=np.int32)
    want = jlayers.embed(jp, jnp.asarray(tokens), jnp.float32)
    with torch.no_grad():
        got = emb.embed(torch.from_numpy(tokens).long(), torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        x = _x(3, (2, 1, 16))
        want = jlayers.unembed(jp, jnp.asarray(x), softcap=30.0)
        got = emb.unembed(torch.from_numpy(x), softcap=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------- attention
def _gqa_pair(arch="qwen3-32b"):
    jcfg = jax_config(arch, reduced=True)
    jp = _np_tree(jattn.init_gqa(jcfg, jax.random.PRNGKey(0)))
    cfg = get_config(arch, reduced=True)
    attn = GQA(cfg)
    attn.load_state_dict(_flat(jp))
    return jcfg, jp, cfg, attn


@pytest.mark.parametrize("window", [None, 5])
def test_gqa_without_cache_matches(window):
    jcfg, jp, cfg, attn = _gqa_pair()
    x = _x(4, (2, 12, cfg.d_model))
    pos = np.arange(12, dtype=np.int32)
    want, _ = jattn.apply_gqa(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                              window=window)
    with torch.no_grad():
        got, cache = attn(torch.from_numpy(x), torch.from_numpy(pos),
                          window=window)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch,window,cache_len", [
    ("qwen3-32b", None, 16), ("gemma-7b", None, 16), ("qwen3-32b", 4, 6)])
def test_gqa_with_cache_matches(arch, window, cache_len):
    """Prefill (the flash route) then decode steps through the ring
    buffer, against the reference's cache path step for step."""
    jcfg, jp, cfg, attn = _gqa_pair(arch)
    S, steps = 5, 6
    x = _x(5, (2, S + steps, cfg.d_model))
    jc = jattn.init_gqa_cache(jcfg, 2, cache_len, jnp.float32)
    tc = init_gqa_cache(cfg, 2, cache_len, torch.float32)
    pos = np.arange(S, dtype=np.int32)
    want, jc = jattn.apply_gqa(jcfg, jp, jnp.asarray(x[:, :S]),
                               jnp.asarray(pos), window=window, cache=jc)
    with torch.no_grad():
        got, tc = attn(torch.from_numpy(x[:, :S]), torch.from_numpy(pos),
                       window=window, cache=tc, prefill=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for t in range(S, S + steps):
        p = np.array([t], dtype=np.int32)
        want, jc = jattn.apply_gqa(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                   jnp.asarray(p), window=window, cache=jc)
        with torch.no_grad():
            got, tc = attn(torch.from_numpy(x[:, t:t + 1]),
                           torch.from_numpy(p), window=window, cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert tc["pos"] == int(jc["pos"])
    np.testing.assert_array_equal(tc["positions"].numpy(),
                                  np.asarray(jc["positions"]))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               rtol=1e-5, atol=1e-5)


def test_prefill_route_needs_an_empty_cache_that_holds_the_prompt():
    _, _, cfg, attn = _gqa_pair()
    x = torch.from_numpy(_x(6, (1, 4, cfg.d_model)))
    pos = torch.arange(4, dtype=torch.int32)
    with torch.no_grad():
        with pytest.raises(ValueError, match="empty"):
            cache = init_gqa_cache(cfg, 1, 8, torch.float32)
            cache["pos"] = 2
            attn(x, pos, cache=cache, prefill=True)
        with pytest.raises(ValueError, match="exceeds"):
            attn(x, pos, cache=init_gqa_cache(cfg, 1, 3, torch.float32),
                 prefill=True)


def test_layer_windows_match():
    from repro.models.blocks import layer_windows as jwin
    cfg = get_config("hymba-1.5b")
    want = np.asarray(jwin(jax_config("hymba-1.5b"), 20))
    assert layer_windows(cfg, 20) == want.tolist()
    assert layer_windows(cfg, 20)[0] == BIG_WINDOW
    assert layer_windows(get_config("gemma-7b"), 28) is None
    assert layer_windows(get_config("gemma-7b"), 3, 8) == [8, 8, 8]


# ---------------------------------------------------------------- whole model
@pytest.mark.parametrize("arch", ["gemma-7b", "qwen3-32b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "command-r-plus-104b"])
def test_prefill_and_decode_match(arch):
    """Prefill, then decode steps through the cache, against the JAX
    ``Model`` step by step. The MoE config runs at its default capacity
    with a batch of 4, where the reference's grouping drops slots both in
    prefill (one group of 64 tokens, C = 40) and in decode (a group of 4,
    C = 3); the drops are counted by re-running ``route`` on each MoE
    layer's input."""
    jcfg = jax_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = convert.lm_params_from_jax(cfg, _np_tree(jp), device="cpu")
    model = build_model(cfg)
    B = 4 if cfg.moe else 2
    drops = []

    def count_drops(layer, args):
        r = route(cfg, layer.router, group_tokens(cfg.moe, args[0]))
        drops.append(r.top_idx.numel() - int(r.keep.sum()))

    if cfg.moe:
        for block in params.layers:
            block.moe.register_forward_pre_hook(count_drops)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, 32)
    tl, ts = model.prefill(params, {"tokens": torch.from_numpy(tokens).long()},
                           32)
    assert tl.shape == (B, 1, cfg.vocab_size) and ts["pos"] == 16
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, js = jm.decode(jp, jnp.asarray(nxt), js)
        tl, ts = model.decode(params, torch.from_numpy(nxt).long(), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    assert ts["pos"] == int(js["pos"]) == 19
    if cfg.moe:
        L = cfg.num_layers
        assert len(drops) == 4 * L
        assert sum(drops[:L]) > 0 and sum(drops[L:]) > 0


def test_init_distributions():
    cfg = get_config("gemma-7b", reduced=True)
    params = lm.init(cfg, seed=0, device="cpu")
    again = lm.init(cfg, seed=0, device="cpu")
    for (name, p), (_, q) in zip(params.named_parameters(),
                                 again.named_parameters()):
        assert torch.equal(p, q), name
    table = params.embed.table
    assert table.abs().max() <= 2 * 0.02 and 0.015 < table.std() < 0.02
    wq = params.layers[0].attn.wq          # fan_in = d_model
    assert wq.abs().max() <= 2 / cfg.d_model ** 0.5
    wo = params.layers[0].attn.wo          # fan_in = num_heads (in_axis 0)
    assert wo.abs().max() <= 2 / cfg.num_heads ** 0.5
    assert 0.7 / cfg.num_heads ** 0.5 < wo.std() < 1 / cfg.num_heads ** 0.5
    assert torch.equal(params.final_norm.scale, torch.ones(cfg.d_model))
    n = sum(p.numel() for p in params.parameters())
    norms = (2 * cfg.num_layers + 1) * cfg.d_model   # not in param_count
    assert n == cfg.param_count() + norms


def test_full_width_gemma_builds_without_memory():
    """The full-width Gemma-7B module on the meta device: the real run
    allocates these 8.5 B parameters on the card."""
    cfg = get_config("gemma-7b")
    params = lm.LM(cfg, device="meta")
    assert len(params.layers) == 28
    norms = (2 * 28 + 1) * 3072               # not in param_count
    assert sum(p.numel() for p in params.parameters()) == \
        cfg.param_count() + norms == 8_537_505_792 + norms
    assert params.layers[0].attn.wq.shape == (3072, 16, 256)
    assert params.layers[0].mlp.w_down.shape == (24576, 3072)


def test_full_width_phi_moe_builds_without_memory():
    """The full-width Phi-3.5-MoE module on the meta device: 32 layers of
    16 experts, 41.9 B parameters."""
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    params = lm.LM(cfg, device="meta")
    assert len(params.layers) == 32
    norms = (2 * 32 + 1) * 4096               # not in param_count
    assert sum(p.numel() for p in params.parameters()) == \
        cfg.param_count() + norms == 41_872_261_120 + norms
    layer = params.layers[0].moe
    assert layer.router.shape == (4096, 16)
    assert layer.router.dtype == torch.float32
    assert layer.w_gate.shape == layer.w_up.shape == (16, 4096, 6400)
    assert layer.w_down.shape == (16, 6400, 4096)
    assert not hasattr(layer, "shared") and not hasattr(params.layers[0],
                                                        "mlp")
    assert params.layers[0].attn.wk.shape == (4096, 8, 128)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"])
def test_moe_init_distributions(arch):
    """Experts drawn at 1/sqrt(fan-in) on their second axis (d for
    w_gate/w_up, f for w_down; the reference's ``in_axis=1``), not their
    first (E); the router at 1/sqrt(d) in float32; shared experts as a
    dense MLP."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              num_layers=1, param_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=16))
    layer = init_params_(MoE(cfg), torch.Generator().manual_seed(0))
    d, f = cfg.d_model, cfg.moe.expert_d_ff
    for w, fan_in in ((layer.w_gate, d), (layer.w_up, d), (layer.w_down, f),
                      (layer.router, d)):
        w = w.float()
        assert w.abs().max() <= 2 / fan_in ** 0.5
        assert 0.8 / fan_in ** 0.5 < w.std() < 0.95 / fan_in ** 0.5
    assert layer.router.dtype == torch.float32
    assert layer.w_gate.dtype == torch.bfloat16
    if cfg.moe.num_shared_experts:
        w = layer.shared.w_down.float()        # fan-in: its first axis
        fan_in = w.shape[0]
        assert 0.8 / fan_in ** 0.5 < w.std() < 0.95 / fan_in ** 0.5


def test_compute_params_keeps_the_router_in_float32():
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b",
                                         reduced=True),
                              compute_dtype="bfloat16")
    params = lm.init(cfg, seed=1, device="cpu")
    cast = lm.compute_params(cfg, params)
    layer = cast.layers[0].moe
    assert layer.router.dtype == torch.float32
    assert torch.equal(layer.router, params.layers[0].moe.router)
    assert layer.w_gate.dtype == layer.w_down.dtype == torch.bfloat16
    model = build_model(cfg)
    tokens = {"tokens": torch.arange(64).reshape(2, 32) % cfg.vocab_size}
    a, sa = model.prefill(params, tokens, 40)
    b, sb = model.prefill(cast, tokens, 40)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, b)
    tok = torch.tensor([[5], [9]])
    assert torch.equal(model.decode(params, tok, sa)[0],
                       model.decode(cast, tok, sb)[0])


@pytest.mark.parametrize("shared", [0, 1])
def test_convert_carries_the_moe_tree(shared):
    """``lm_params_from_jax`` maps ``layers/moe/{router,w_gate,w_up,
    w_down}`` (stacked on L, the expert axis second) and
    ``layers/moe/shared/*`` onto ``layers.{i}.moe.*`` name for name."""
    def with_shared(c):
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, num_shared_experts=shared, shared_d_ff=128 * shared))
    jcfg = with_shared(jax_config("phi3.5-moe-42b-a6.6b", reduced=True))
    cfg = with_shared(get_config("phi3.5-moe-42b-a6.6b", reduced=True))
    tree = _np_tree(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    params = convert.lm_params_from_jax(cfg, tree, device="cpu")
    stacked = _flat(tree["layers"]["moe"])
    assert sorted(stacked) == sorted(
        ["router", "w_gate", "w_up", "w_down"]
        + ["shared.w_gate", "shared.w_up", "shared.w_down"] * shared)
    for i in range(cfg.num_layers):
        got = dict(params.layers[i].moe.named_parameters())
        for name, arr in stacked.items():
            assert torch.equal(got[name], arr[i]), (i, name)
        assert got["router"].dtype == torch.float32
    assert params.layers[1].moe.w_gate.shape == \
        (cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff)


def test_compute_params_casts_weights_once_and_keeps_the_numbers():
    cfg = dataclasses.replace(get_config("gemma-7b", reduced=True),
                              compute_dtype="bfloat16")
    params = lm.init(cfg, seed=1, device="cpu")
    cast = lm.compute_params(cfg, params)
    assert cast.layers[0].attn.wq.dtype == torch.bfloat16
    assert cast.embed.table.dtype == torch.bfloat16
    assert cast.layers[0].attn_norm.scale.dtype == torch.float32
    assert params.layers[0].attn.wq.dtype == torch.float32
    model = build_model(cfg)
    tokens = {"tokens": torch.arange(6).reshape(1, 6)}
    a, sa = model.prefill(params, tokens, 8)
    b, sb = model.prefill(cast, tokens, 8)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, b)
    tok = torch.tensor([[5]])
    assert torch.equal(model.decode(params, tok, sa)[0],
                       model.decode(cast, tok, sb)[0])
    f32 = get_config("gemma-7b", reduced=True)
    same = lm.init(f32, seed=1, device="cpu")
    assert lm.compute_params(f32, same) is same


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b",
                                  "seamless-m4t-medium"])
def test_later_slices_raise(arch):
    """These families' training loss, once a later slice, is ported: it
    is finite on a batch and raises on a batch without its inputs
    (``tests/test_torch_train.py`` holds it to the reference)."""
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    with pytest.raises(KeyError):
        model.train_loss(params, {})
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.encoder_layers:
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(2, 16, cfg.frontend_dim)).astype(np.float32))
    loss, metrics = model.train_loss(params, batch)
    assert loss.shape == () and np.isfinite(float(loss.detach()))
    assert set(metrics) == {"ce", "aux", "tokens"}
