"""The port's multi-head latent attention (``repro_torch.models.attention.
MLA``) and the two MLA configs (MiniCPM3-4B, DeepSeek-V2) against the JAX
package on the CPU, on the same weights.

Weights are made by the JAX package's own init and carried across as
numpy (``load_state_dict`` for one layer, ``convert.lm_params_from_jax``
for whole models); other inputs are made with numpy from a seed.
Everything is float32 at the reduced configs. Tolerances: 1e-5 for one
layer, 1e-4 for logits of whole models (the frameworks sum in other
orders), identical greedy tokens."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model, lm
from repro_torch.models.attention import MLA, init_attention_cache, \
    init_mla_cache, make_attention
from repro_torch.models.layers import init_params_
from repro_torch.models.moe import group_tokens, route
from repro_torch.serve import Request, ServeEngine

MLA_ARCHS = ["minicpm3-4b", "deepseek-v2-236b"]


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


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def _mla_pair(arch):
    jcfg = jax_config(arch, reduced=True)
    jp = _np_tree(jattn.init_mla(jcfg, jax.random.PRNGKey(0)))
    cfg = get_config(arch, reduced=True)
    attn = MLA(cfg)
    attn.load_state_dict(_flat(jp))
    return jcfg, jp, cfg, attn


# ---------------------------------------------------------------- the layer
def test_mla_params_are_the_references():
    jcfg, jp, cfg, attn = _mla_pair("deepseek-v2-236b")
    ours = {n: tuple(p.shape) for n, p in attn.named_parameters()}
    theirs = {n: tuple(t.shape) for n, t in _flat(jp).items()}
    assert ours == theirs
    assert isinstance(make_attention(cfg, "meta"), MLA)
    cache = init_attention_cache(cfg, 2, 8, torch.float32)
    m = cfg.mla
    assert cache["c_kv"].shape == (2, 8, m.kv_lora_rank)
    assert cache["k_rope"].shape == (2, 8, m.qk_rope_head_dim)
    assert cache["pos"] == 0 and (cache["positions"] == -1).all()


@pytest.mark.parametrize("arch", MLA_ARCHS)
@pytest.mark.parametrize("window", [None, 5])
def test_mla_expanded_branch_matches(arch, window):
    """No cache: per-head K/V through ``grouped_attention``."""
    jcfg, jp, cfg, attn = _mla_pair(arch)
    x = _x(1, (2, 12, cfg.d_model))
    pos = np.arange(12, dtype=np.int32)
    want, _ = jattn.apply_mla(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                              window=window)
    with torch.no_grad():
        got, cache = attn(torch.from_numpy(x), torch.from_numpy(pos),
                          window=window)
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("arch", MLA_ARCHS)
@pytest.mark.parametrize("window,cache_len", [(None, 16), (4, 6)])
def test_mla_absorbed_prefill_and_decode_match(arch, window, cache_len):
    """Prefill (``prefill=True``), a 3-token chunk (at cache_len 6 its
    write start is clamped, as ``dynamic_update_slice`` clamps it), then
    decode steps through the latent cache, ring buffer included, against
    the reference's absorbed branch step for step; the caches agree
    after every step."""
    jcfg, jp, cfg, attn = _mla_pair(arch)
    chunks = [(0, 5), (5, 8)] + [(t, t + 1) for t in range(8, 13)]
    x = _x(2, (2, 13, cfg.d_model))
    jc = jattn.init_mla_cache(jcfg, 2, cache_len, jnp.float32)
    tc = init_mla_cache(cfg, 2, cache_len, torch.float32)
    for lo, hi in chunks:
        p = np.arange(lo, hi, dtype=np.int32)
        want, jc = jattn.apply_mla(jcfg, jp, jnp.asarray(x[:, lo:hi]),
                                   jnp.asarray(p), window=window, cache=jc)
        with torch.no_grad():
            got, tc = attn(torch.from_numpy(x[:, lo:hi]),
                           torch.from_numpy(p), window=window, cache=tc,
                           prefill=lo == 0)
        _close(got, want)
        assert tc["pos"] == int(jc["pos"])
        np.testing.assert_array_equal(tc["positions"].numpy(),
                                      np.asarray(jc["positions"]))
        for name in ("c_kv", "k_rope"):
            _close(tc[name], jc[name])


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_absorbed_decode_matches_expanded_at_every_position(arch):
    """The port's own two branches: decoding token by token through the
    latent cache gives the expanded no-cache output at every position
    (the counterpart of ``tests/test_attention.py``'s absorbed test, at
    this file's module tolerance)."""
    _, _, cfg, attn = _mla_pair(arch)
    B, S = 2, 10
    x = torch.from_numpy(_x(3, (B, S, cfg.d_model)))
    pos = torch.arange(S, dtype=torch.int32)
    cache = init_mla_cache(cfg, B, S, torch.float32)
    with torch.no_grad():
        full, _ = attn(x, pos)
        steps = [attn(x[:, t:t + 1], pos[t:t + 1], cache=cache)[0]
                 for t in range(S)]
    torch.testing.assert_close(torch.cat(steps, dim=1), full, rtol=1e-5,
                               atol=1e-5)


def test_mla_rounds_where_the_reference_rounds():
    """bf16 compute, read before ``wo`` (``wo`` set to the identity into
    the first H * v features, an exact bf16 product): the absorbed
    branch rounds where the reference rounds (q_abs in bf16, scores in
    float32, the context cast to bf16 before ``w_uv``), so at most 2 % of
    the features differ from the reference's, by at most one bf16 ulp of
    the largest. Keeping the context in float32 through ``w_uv`` moves
    half of them."""
    arch = "minicpm3-4b"
    jcfg = dataclasses.replace(jax_config(arch, reduced=True),
                               compute_dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="bfloat16")
    jp = _np_tree(jattn.init_mla(jcfg, jax.random.PRNGKey(4)))
    H, v, d = cfg.num_heads, cfg.mla.v_head_dim, cfg.d_model
    jp["wo"] = np.eye(H * v, d, dtype=np.float32).reshape(H, v, d)
    attn = MLA(cfg)
    attn.load_state_dict(_flat(jp))
    x = _x(5, (2, 7, d))
    pos = np.arange(7, dtype=np.int32)
    jc = jattn.init_mla_cache(jcfg, 2, 8, jnp.bfloat16)
    want, _ = jattn.apply_mla(jcfg, jp, jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(pos), cache=jc)
    with torch.no_grad():
        got, _ = attn(torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(pos),
                      cache=init_mla_cache(cfg, 2, 8, torch.bfloat16),
                      prefill=True)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))[..., :H * v]
    got = got.float().numpy()[..., :H * v]
    assert (got != want).mean() <= 0.02
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())


# ---------------------------------------------------------------- convert
def test_convert_carries_the_mla_tree():
    """``lm_params_from_jax`` maps ``layers/attn/{w_dq, q_norm/scale,
    w_uq, w_dkv, kv_norm/scale, w_uk, w_uv, wo}`` onto
    ``layers.{i}.attn.*`` name for name; a missing name raises."""
    arch = "minicpm3-4b"
    cfg = get_config(arch, reduced=True)
    tree = _np_tree(jax_build(jax_config(arch, reduced=True))
                    .init(jax.random.PRNGKey(0)))
    params = convert.lm_params_from_jax(cfg, tree, device="cpu")
    stacked = _flat(tree["layers"]["attn"])
    assert sorted(stacked) == sorted(
        ["w_dq", "q_norm.scale", "w_uq", "w_dkv", "kv_norm.scale", "w_uk",
         "w_uv", "wo"])
    for i in range(cfg.num_layers):
        got = dict(params.layers[i].attn.named_parameters())
        for name, arr in stacked.items():
            assert torch.equal(got[name], arr[i]), (i, name)
    del tree["layers"]["attn"]["w_uk"]
    with pytest.raises(RuntimeError, match="w_uk"):
        convert.lm_params_from_jax(cfg, tree, device="cpu")


def test_convert_carries_bf16_params_bit_for_bit():
    """DeepSeek-V2 keeps its bf16 ``param_dtype``: the JAX tree's bf16
    arrays cross by their bits, and ``compute_params`` (bf16 compute)
    makes no second copy."""
    arch = "deepseek-v2-236b"
    jcfg = dataclasses.replace(jax_config(arch, reduced=True),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    tree = _np_tree(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    params = convert.lm_params_from_jax(cfg, tree, device="cpu")
    w = params.layers[1].attn.w_uk
    assert w.dtype == torch.bfloat16
    want = tree["layers"]["attn"]["w_uk"][1].astype(np.float32)
    np.testing.assert_array_equal(w.detach().float().numpy(), want)
    assert params.layers[0].moe.router.dtype == torch.float32
    assert lm.compute_params(cfg, params) is params


# ---------------------------------------------------------------- whole model
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_prefill_and_decode_match(arch):
    """Prefill, then 4 decode steps through the latent cache, against the
    JAX ``Model`` step by step (DeepSeek-V2 at a batch of 4, where its
    MoE drops slots in prefill and in decode)."""
    jcfg = jax_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = convert.lm_params_from_jax(cfg, _np_tree(jp), device="cpu")
    model = build_model(cfg)
    B = 4
    drops = []
    if cfg.moe:
        def count_drops(layer, args):
            r = route(cfg, layer.router, group_tokens(cfg.moe, args[0]))
            drops.append(r.top_idx.numel() - int(r.keep.sum()))
        for block in params.layers:
            block.moe.register_forward_pre_hook(count_drops)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, 32)
    tl, ts = model.prefill(params, {"tokens": torch.from_numpy(tokens).long()},
                           32)
    assert tl.shape == (B, 1, cfg.vocab_size) and ts["pos"] == 16
    _close(tl, jl, 1e-4)
    for _ in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, js = jm.decode(jp, jnp.asarray(nxt), js)
        tl, ts = model.decode(params, torch.from_numpy(nxt).long(), ts)
        _close(tl, jl, 1e-4)
    assert ts["pos"] == int(js["pos"]) == 20
    for i, cache in enumerate(ts["cache"]):
        _close(cache["attn"]["c_kv"], js["cache"]["attn"]["c_kv"][i], 1e-4)
    if cfg.moe:
        L = cfg.num_layers
        assert len(drops) == 5 * L
        assert sum(drops[:L]) > 0 and sum(drops[L:]) > 0


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_greedy_tokens_match_the_jax_engine(arch):
    """``ServeEngine.serve``: 8 requests of 16 prompt tokens, 8 new,
    ``max_batch`` 4, greedy; identical tokens."""
    jcfg = jax_config(arch, reduced=True)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config(arch, reduced=True)
    params = convert.lm_params_from_jax(cfg, _np_tree(jparams), device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
               for _ in range(8)]
    want = JServeEngine(jcfg, jparams, max_batch=4, cache_len=32).serve(
        [JRequest(i, p, max_new_tokens=8) for i, p in enumerate(prompts)])
    got = ServeEngine(cfg, params, max_batch=4, cache_len=32).serve(
        [Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts)])
    assert [c.request_id for c in got] == [c.request_id for c in want]
    for g, w in zip(got, want):
        assert g.tokens.shape == (8,)
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_launcher_serves_the_mla_family_on_the_cpu(arch, capsys):
    assert launcher.main(["--arch", arch, "--requests", "2", "--prompt-len",
                          "8", "--max-new", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "cpu" in out


# ---------------------------------------------------------------- full width
def test_full_width_mla_models_build_without_memory():
    """MiniCPM3-4B whole and DeepSeek-V2 per layer, on the meta device:
    the sizes the card cells allocate."""
    cfg = get_config("minicpm3-4b")
    params = lm.LM(cfg, device="meta")
    L, d = 62, 2560
    norms = (2 * L + 1) * d + L * (768 + 256)     # not in param_count
    n = sum(p.numel() for p in params.parameters())
    assert n == cfg.param_count() + norms
    assert 4.0e9 < n < 4.1e9
    attn = params.layers[0].attn
    assert attn.w_uq.shape == (768, 40, 96)
    assert attn.w_dkv.shape == (2560, 288)
    assert attn.wo.shape == (40, 64, 2560)
    ds = dataclasses.replace(get_config("deepseek-v2-236b"), num_layers=6)
    layer = lm.LM(ds, device="meta").layers[0]
    per_layer = sum(p.numel() for p in layer.parameters())
    assert 3.9e9 < per_layer < 4.0e9
    assert layer.attn.w_uk.shape == (512, 128, 128)
    assert layer.moe.w_gate.dtype == torch.bfloat16


def test_bf16_params_are_float32_draws_cast():
    """A bf16 param is drawn in float32 and cast, as the reference's
    ``dense_init`` casts: the same seed gives the float32 model's
    weights rounded to bf16."""
    arch = "deepseek-v2-236b"
    f32 = get_config(arch, reduced=True)
    bf16 = dataclasses.replace(f32, param_dtype="bfloat16")
    a = lm.init(f32, seed=3, device="cpu")
    b = lm.init(bf16, seed=3, device="cpu")
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        want = p if name.endswith("router") else p.to(torch.bfloat16)
        assert q.dtype == want.dtype and torch.equal(q, want), name


def test_bf16_draw_is_chunked(monkeypatch):
    """Past ``DRAW_CHUNK`` elements the float32 draw goes a chunk at a
    time and stays a truncated normal."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "DRAW_CHUNK", 1000)
    w = torch.nn.Linear(64, 256, bias=False).to(torch.bfloat16)
    layers.init_params_(w, torch.Generator().manual_seed(0))
    x = w.weight.float()
    fan_in = x.shape[0]                 # the first axis, as dense_init's
    assert x.abs().max() <= 2 / fan_in ** 0.5
    assert 0.8 / fan_in ** 0.5 < x.std() < 0.95 / fan_in ** 0.5
    assert len(torch.unique(x)) > 1000
    first = layers.trunc_normal_(torch.empty(1000), 1 / fan_in ** 0.5,
                                 torch.Generator().manual_seed(0))
    assert torch.equal(x.view(-1)[:1000], first.to(torch.bfloat16).float())
