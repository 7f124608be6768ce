"""The port's SSM-only (Mamba-2) and hybrid (Hymba) blocks and models
against the JAX package's ``repro.models`` on the CPU, on the same
weights: the blocks against ``apply_block`` (a window smaller than S so
it bites, and a global layer; prefill through the flash route, then
decode; caches too), the whole models against the JAX ``Model`` (prefill
plus 4 decode steps) and ``ServeEngine`` (greedy tokens), the launcher,
``convert`` and the full-width sizes. Inputs are made with numpy from a
seed; everything is float32 at the reduced configs. Tolerances: 1e-5 for
blocks, 1e-4 for logits, identical greedy tokens."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import blocks as jblocks
from repro.models import build_model as jax_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import blocks, build_model, lm
from repro_torch.serve import Request, ServeEngine

MAMBA, HYMBA = "mamba2-780m", "hymba-1.5b"
#: reduced Hymba with three layers and a window of 8: layers 0 and 2 are
#: global, layer 1 slides, so a 20-token prompt is cut by the window
HYMBA_CUT = dict(num_layers=3, sliding_window=8)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = torch.from_numpy(np.array(val))
    return out


def _configs(arch, **changes):
    return (dataclasses.replace(jax_config(arch, reduced=True), **changes),
            dataclasses.replace(get_config(arch, reduced=True), **changes))


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------- blocks
def _block(arch, seed=0):
    jcfg, cfg = _configs(arch)
    jp = jax.tree.map(np.asarray,
                      jblocks.init_block(jcfg, jax.random.PRNGKey(seed)))
    block = blocks.Block(cfg, "cpu")
    block.load_state_dict(_flat(jp))
    return jcfg, jp, cfg, block


def test_block_params_follow_the_family():
    """SSM-only: no attention, no MLP; hybrid: both branches, the two
    output norms, the MLP, and the ``ssm_norm`` its branch never reads."""
    _, _, cfg, mamba = _block(MAMBA)
    assert {n for n, _ in mamba.named_children()} == {"ssm_norm", "ssm"}
    _, _, cfg, hymba = _block(HYMBA)
    assert {n for n, _ in hymba.named_children()} == {
        "attn_norm", "attn", "ssm_norm", "ssm", "attn_out_norm",
        "ssm_out_norm", "ffn_norm", "mlp"}
    assert blocks.has_ssm(cfg) and blocks.has_attention(cfg)
    assert not blocks.has_attention(get_config(MAMBA))


@pytest.mark.parametrize("arch,window", [(MAMBA, None), (HYMBA, 5),
                                         (HYMBA, blocks.BIG_WINDOW),
                                         (HYMBA, None)])
def test_block_without_cache_matches(arch, window):
    jcfg, jp, cfg, block = _block(arch, seed=1)
    x = _x(2, (2, 12, cfg.d_model))
    pos = np.arange(12, dtype=np.int32)
    want, _, _ = jblocks.apply_block(jcfg, jp, jnp.asarray(x),
                                     jnp.asarray(pos), window)
    with torch.no_grad():
        got, aux, cache = block(torch.from_numpy(x), torch.from_numpy(pos),
                                window)
    assert aux == 0.0 and cache is None
    _close(got, want, 1e-5)


@pytest.mark.parametrize("arch,window", [(MAMBA, None), (HYMBA, 5),
                                         (HYMBA, blocks.BIG_WINDOW)])
def test_block_prefill_and_decode_match(arch, window):
    """A 12-token prefill (the flash route; the window of 5 bites), then 4
    decode steps over the ring-free cache; the block's output and both
    caches against ``apply_block``'s at every step."""
    jcfg, jp, cfg, block = _block(arch, seed=3)
    x = _x(4, (2, 16, cfg.d_model))
    jc = jblocks.init_block_cache(jcfg, 2, 20, jnp.float32)
    tc = blocks.init_block_cache(cfg, 2, 20, torch.float32, "cpu")
    assert set(tc) == set(jc)
    for lo, hi in ((0, 12), (12, 13), (13, 14), (14, 15), (15, 16)):
        pos = np.arange(lo, hi, dtype=np.int32)
        want, _, jc = jblocks.apply_block(jcfg, jp, jnp.asarray(x[:, lo:hi]),
                                          jnp.asarray(pos), window, cache=jc)
        with torch.no_grad():
            got, _, same = block(torch.from_numpy(x[:, lo:hi]),
                                 torch.from_numpy(pos), window, cache=tc,
                                 prefill=lo == 0)
        assert same is tc
        _close(got, want, 1e-5)
        _close(tc["ssm"]["state"], jc["ssm"]["state"], 1e-5)
        _close(tc["ssm"]["conv"], jc["ssm"]["conv"], 1e-5)
        if "attn" in tc:
            _close(tc["attn"]["k"], jc["attn"]["k"], 1e-5)
            assert tc["attn"]["pos"] == int(jc["attn"]["pos"])


def test_hybrid_fuses_the_mean_of_the_normed_branches():
    """x + 0.5 (attn_out_norm(a) + ssm_out_norm(s)), both branches fed
    attn_norm(x): with the attention's output projection zeroed and the
    MLP's down projection zeroed, the block adds 0.5 ssm_out_norm(s) (the
    zero attention output normalizes to zero)."""
    _, _, cfg, block = _block(HYMBA, seed=5)
    with torch.no_grad():
        block.attn.wo.zero_()
        block.mlp.w_down.zero_()
        block.ssm_out_norm.scale.mul_(3.0)
        x = torch.from_numpy(_x(6, (1, 8, cfg.d_model)))
        pos = torch.arange(8, dtype=torch.int32)
        got, _, _ = block(x, pos, None)
        s, _ = block.ssm(block.attn_norm(x))
        want = x + 0.5 * block.ssm_out_norm(s)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- models
@pytest.fixture(scope="module", params=[MAMBA, HYMBA])
def model_pair(request):
    arch = request.param
    jcfg, cfg = _configs(arch, **(HYMBA_CUT if arch == HYMBA else {}))
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = convert.lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                        device="cpu")
    return arch, jcfg, jm, jp, cfg, params


def test_hymba_cut_has_a_sliding_and_a_global_layer():
    _, cfg = _configs(HYMBA, **HYMBA_CUT)
    assert blocks.layer_windows(cfg, cfg.num_layers) == [
        blocks.BIG_WINDOW, 8, blocks.BIG_WINDOW]


def test_prefill_and_decode_match(model_pair):
    """A 20-token prefill, then 4 decode steps, against the JAX ``Model``
    step by step (logits 1e-4); every layer's SSM state too."""
    _, _, jm, jp, cfg, params = model_pair
    model = build_model(cfg)
    B, S, cache_len = 2, 20, 32
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, cache_len)
    tl, ts = model.prefill(params, {"tokens": torch.from_numpy(tokens).long()},
                           cache_len)
    assert tl.shape == (B, 1, cfg.vocab_size)
    assert ts["pos"] == int(js["pos"]) == S
    _close(tl, jl, 1e-4)
    rng = np.random.default_rng(2)
    for _ in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, js = jm.decode(jp, jnp.asarray(nxt), js)
        tl, ts = model.decode(params, torch.from_numpy(nxt).long(), ts)
        _close(tl, jl, 1e-4)
    for i, layer in enumerate(ts["cache"]):
        _close(layer["ssm"]["state"], js["cache"]["ssm"]["state"][i], 1e-4)


def test_attention_free_prompt_is_not_held_to_the_cache(model_pair):
    """Mamba-2 keeps no KV cache (the reference's ``_cache_len`` is 1), so
    a prompt longer than ``cache_len`` is served; Hymba's is checked."""
    arch, _, _, _, cfg, params = model_pair
    model = build_model(cfg)
    tokens = {"tokens": torch.zeros((1, 16), dtype=torch.long)}
    if arch == MAMBA:
        logits, state = model.prefill(params, tokens, 1)
        assert state["pos"] == 16 and set(state["cache"][0]) == {"ssm"}
    else:
        with pytest.raises(ValueError, match="exceeds the cache"):
            model.prefill(params, tokens, 15)


def test_greedy_tokens_match_the_jax_engine(model_pair):
    """8 prompts of 16 tokens, 8 new, ``max_batch`` 4: identical greedy
    tokens."""
    _, jcfg, _, jp, cfg, params = model_pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
               for _ in range(8)]
    want = JServeEngine(jcfg, jp, max_batch=4, cache_len=32).serve(
        [JRequest(i, p, max_new_tokens=8) for i, p in enumerate(prompts)])
    got = ServeEngine(cfg, params, max_batch=4, cache_len=32).serve(
        [Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


def test_convert_carries_every_leaf(model_pair):
    arch, _, _, jp, cfg, params = model_pair
    tree = jax.tree.map(np.asarray, jp)
    for i in range(cfg.num_layers):
        layer = params.layers[i]
        for name in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "w_in",
                     "w_out"):
            want = tree["layers"]["ssm"][name][i]
            assert torch.equal(getattr(layer.ssm, name),
                               torch.from_numpy(want.copy())), name
        norms = ["ssm_norm"] + (["attn_out_norm", "ssm_out_norm"]
                                if arch == HYMBA else [])
        for name in norms:
            assert torch.equal(getattr(layer, name).scale, torch.from_numpy(
                tree["layers"][name]["scale"][i].copy())), name
    del tree["layers"]["ssm"]["dt_bias"]
    with pytest.raises(RuntimeError, match="dt_bias"):
        convert.lm_params_from_jax(cfg, tree, device="cpu")


def test_convert_carries_the_split_in_projection():
    jcfg, cfg = _configs(MAMBA, ssm_split_in_proj=True)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    params = convert.lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                        device="cpu")
    assert not hasattr(params.layers[0].ssm, "w_in")
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, 16)
    got, _ = build_model(cfg).prefill(
        params, {"tokens": torch.from_numpy(tokens).long()}, 16)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", [MAMBA, HYMBA])
def test_launcher_serves_on_the_cpu(arch, capsys):
    assert launcher.main(["--arch", arch, "--requests", "2", "--prompt-len",
                          "8", "--max-new", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "cpu" in out


def _extra(cfg, norms_per_layer):
    """Params ``param_count`` leaves out: the block norms, the SSM's
    gated norm, conv bias, A_log, D and dt_bias, and the final norm."""
    s, d = cfg.ssm, cfg.d_model
    conv_ch = s.d_inner(d) + 2 * s.n_groups * s.state_dim
    per_layer = (norms_per_layer * d + s.d_inner(d) + conv_ch
                 + 3 * s.num_heads(d))
    return cfg.num_layers * per_layer + d


def test_full_width_models_build_without_memory():
    """Mamba2-780m (48 layers, d 1536, state 128, tied) and Hymba-1.5B (32
    layers, d 1600, 25 x 64 heads over 5 kv, state 16) on the meta
    device, at the sizes the card cells allocate."""
    cfg = get_config(MAMBA)
    params = lm.LM(cfg, device="meta")
    n = sum(p.numel() for p in params.parameters())
    assert n == cfg.param_count() + _extra(cfg, 1)
    assert 7.7e8 < n < 7.9e8
    assert not hasattr(params, "unembed")
    assert params.layers[0].ssm.w_in.shape == (1536, 2 * 3072 + 2 * 128 + 48)
    assert params.layers[0].ssm.A_log.dtype == torch.float32
    cfg = get_config(HYMBA)
    params = lm.LM(cfg, device="meta")
    n = sum(p.numel() for p in params.parameters())
    assert n == cfg.param_count() + _extra(cfg, 5)
    assert 1.5e9 < n < 1.7e9
    assert params.layers[0].attn.wk.shape == (1600, 5, 64)
    assert params.layers[0].ssm.w_in.shape == (1600, 2 * 3200 + 2 * 16 + 50)
