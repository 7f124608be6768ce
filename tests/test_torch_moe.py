"""The port's mixture-of-experts layer (``repro_torch.models.moe``)
against the JAX package's ``repro.models.moe`` on the CPU, on the same
weights.

The weights are the JAX package's own ``init_moe`` tree, carried across
as numpy with ``load_state_dict``; inputs are made with numpy from a
seed. Tolerances: float32 y 1e-5 and aux 1e-6 (the frameworks sum in
other orders); bfloat16 two bf16 ulps of the largest |y| (one rounding
of each product's output on either side); the float64 per-token
reference 2e-4, as ``tests/test_moe.py`` holds the JAX layer."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe

ARCHS = ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"]   # deepseek: shared
SHAPES = [(2, 16), (1, 64), (4, 1), (3, 1), (1, 128)]


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = torch.from_numpy(np.array(val))
    return out


def _with(cfg, **moe_changes):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, **moe_changes))


def _pair(arch, **moe_changes):
    """(JAX config, JAX params as numpy, port config, port layer) on the
    JAX package's init."""
    jcfg = _with(jax_config(arch, reduced=True), **moe_changes)
    cfg = _with(get_config(arch, reduced=True), **moe_changes)
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jcfg, jax.random.PRNGKey(0)))
    layer = moe.MoE(cfg)
    layer.load_state_dict(_flat(jp))
    return jcfg, jp, cfg, layer


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _run(jcfg, jp, layer, x):
    want_y, want_aux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    with torch.no_grad():
        got_y, got_aux = layer(torch.from_numpy(x))
    return (got_y, got_aux), (np.asarray(want_y), float(want_aux))


def _kept(cfg, layer, x):
    """(kept, all) (token, k) slots of the port's routing of x."""
    xg = moe.group_tokens(cfg.moe, torch.from_numpy(x))
    r = moe.route(cfg, layer.router, xg)
    return int(r.keep.sum()), r.top_idx.numel()


def test_capacity_matches():
    for experts, top_k in [(4, 2), (16, 2), (160, 6), (8, 1)]:
        for factor in (0.25, 1.0, 1.25, 2.0, 8.0):
            ours = MoEConfig(experts, top_k, 64, capacity_factor=factor)
            theirs = JMoEConfig(experts, top_k, 64, capacity_factor=factor)
            for group in (1, 2, 3, 4, 7, 64, 100, 512):
                assert moe.capacity(ours, group) == \
                    jmoe._capacity(theirs, group), (experts, factor, group)
    full = get_config("phi3.5-moe-42b-a6.6b").moe
    assert moe.capacity(full, 512) == 80 and moe.capacity(full, 4) == 1


@pytest.mark.parametrize("B,S", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches(arch, B, S):
    jcfg, jp, cfg, layer = _pair(arch)
    x = _x(B * S, (B, S, cfg.d_model))
    (y, aux), (want_y, want_aux) = _run(jcfg, jp, layer, x)
    assert y.shape == x.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - want_aux) <= 1e-6


@pytest.mark.parametrize("B,S", [(2, 16), (1, 64), (4, 1), (1, 128)])
@pytest.mark.parametrize("changes", [dict(capacity_factor=0.25),
                                     dict(num_experts=16)],
                         ids=["capacity_0.25", "16_experts"])
def test_moe_layer_matches_under_drops(changes, B, S):
    jcfg, jp, cfg, layer = _pair("phi3.5-moe-42b-a6.6b", **changes)
    x = _x(B * S + 7, (B, S, cfg.d_model))
    kept, slots = _kept(cfg, layer, x)
    assert kept < slots                     # this input drops slots
    (y, aux), (want_y, want_aux) = _run(jcfg, jp, layer, x)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - want_aux) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_in_bfloat16(arch):
    jcfg, jp, cfg, layer = _pair(arch)
    x = _x(3, (2, 32, cfg.d_model))
    want_y, _ = jmoe.apply_moe(jcfg, jp, jnp.asarray(x, jnp.bfloat16))
    want = np.asarray(want_y.astype(jnp.float32))
    with torch.no_grad():
        y, _ = layer(torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(y.float().numpy() - want).max() <= 2 * ulp


def _naive(cfg, sd, x):
    """Loop over tokens in float64, no capacity drops."""
    e = cfg.moe
    p = {k: v.double().numpy() for k, v in sd.items()}
    xt = x.astype(np.float64).reshape(-1, cfg.d_model)
    logits = xt @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        idx = np.argsort(-probs[t], kind="stable")[:e.top_k]
        w = probs[t, idx] / probs[t, idx].sum()
        for j, ex in enumerate(idx):
            h = xt[t] @ p["w_gate"][ex]
            act = h / (1.0 + np.exp(-h))                      # silu
            out[t] += w[j] * ((act * (xt[t] @ p["w_up"][ex]))
                              @ p["w_down"][ex])
    if e.num_shared_experts:
        g = xt @ p["shared.w_gate"]
        out += ((g / (1.0 + np.exp(-g))) * (xt @ p["shared.w_up"])) \
            @ p["shared.w_down"]
    return out.reshape(x.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_naive_reference(arch):
    cfg = get_config(arch, reduced=True)
    no_drop = cfg.moe.num_experts / cfg.moe.top_k
    _, _, cfg, layer = _pair(arch, capacity_factor=no_drop)
    x = _x(1, (2, 16, cfg.d_model))
    assert _kept(cfg, layer, x) == (64, 64)
    with torch.no_grad():
        y, aux = layer(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), _naive(cfg, layer.state_dict(), x),
                               rtol=2e-4, atol=2e-4)
    assert np.isfinite(float(aux))


def test_top_k_ties_take_the_lower_index():
    """The collapsed router of ``tests/test_moe.py``: expert 0 wins every
    token and the other experts tie exactly; the second choice is the
    lowest tied index, as ``jax.lax.top_k`` orders it, and aux ~ E."""
    jcfg, jp, cfg, layer = _pair("phi3.5-moe-42b-a6.6b")
    E = cfg.moe.num_experts
    x = np.abs(_x(3, (1, 64, cfg.d_model)))
    router = np.zeros_like(jp["router"])
    router[:, 0] = 50.0
    xg = moe.group_tokens(cfg.moe, torch.from_numpy(x))
    r = moe.route(cfg, torch.from_numpy(router), xg)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(1, 64, -1)) @ router, -1)
    _, want_idx = jax.lax.top_k(probs, cfg.moe.top_k)
    np.testing.assert_array_equal(r.top_idx.numpy(), np.asarray(want_idx))
    assert (r.top_idx[..., 1] == 1).all()
    _, want_aux = jmoe.apply_moe(jcfg, dict(jp, router=router),
                                 jnp.asarray(x))
    assert float(r.aux) == pytest.approx(float(want_aux), abs=1e-6)
    assert float(r.aux) == pytest.approx(E * 1.0, rel=0.2)


def test_token_count_the_group_does_not_divide_raises():
    jcfg, jp, cfg, layer = _pair("phi3.5-moe-42b-a6.6b")
    x = _x(4, (1, 96, cfg.d_model))           # 96 tokens, groups of 64
    with pytest.raises(AssertionError, match="not divisible"):
        jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    with pytest.raises(ValueError, match="not divisible"):
        layer(torch.from_numpy(x))


def test_stack_sums_the_layers_aux():
    """The MoE blocks through ``apply_stack`` without a cache: x and the
    summed aux loss as the reference's scan gives them."""
    from repro.models import blocks as jblocks
    from repro.models import build_model as jax_build
    from repro_torch import convert
    from repro_torch.models import blocks
    arch = "phi3.5-moe-42b-a6.6b"
    jcfg = jax_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jp = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(0)))
    params = convert.lm_params_from_jax(cfg, jp, device="cpu")
    x = _x(5, (2, 32, cfg.d_model))
    pos = np.arange(32, dtype=np.int32)
    want_x, want_aux, _ = jblocks.apply_stack(
        jcfg, jp["layers"], jnp.asarray(x), jnp.asarray(pos), None)
    with torch.no_grad():
        got_x, aux, _ = blocks.apply_stack(params.layers, torch.from_numpy(x),
                                           torch.from_numpy(pos), None)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    assert float(aux) > 0
