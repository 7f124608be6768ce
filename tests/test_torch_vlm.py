"""The port's vision-language path (LLaVA-NeXT on Mistral): the projector
and ``lm._embed_inputs`` against ``repro.models.lm``, the whole model
with image embeddings against the JAX ``Model``, on the CPU, on the
same weights (``convert.lm_params_from_jax``). Inputs are made with
numpy from a seed; everything is float32 at the reduced config.
Tolerances: 1e-5 for the projector, 1e-4 for logits, identical greedy
tokens."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model, lm
from repro_torch.serve import Request, ServeEngine

ARCH = "llava-next-mistral-7b"


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def llava():
    jcfg = jax_config(ARCH, reduced=True)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, reduced=True)
    params = convert.lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                        device="cpu")
    return jcfg, jm, jp, cfg, params


def _batch(cfg, B, S, n_img, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    img = rng.normal(size=(B, n_img, cfg.frontend_dim)).astype(np.float32)
    return ({"tokens": jnp.asarray(tokens), "image_embeds": jnp.asarray(img)},
            {"tokens": torch.from_numpy(tokens).long(),
             "image_embeds": torch.from_numpy(img)})


def test_projector_and_embed_inputs_match(llava):
    """``gelu(img @ w1) @ w2`` with the tanh gelu, image tokens first;
    without ``image_embeds`` the tokens alone."""
    jcfg, _, jp, cfg, params = llava
    jb, tb = _batch(cfg, 2, 5, cfg.frontend_tokens, 1)
    want = jlm._embed_inputs(jcfg, jp, jb)
    with torch.no_grad():
        got = lm._embed_inputs(cfg, params, tb)
        proj = params.projector(tb["image_embeds"])
    assert got.shape == (2, cfg.frontend_tokens + 5, cfg.d_model)
    _close(got, want, 1e-5)
    torch.testing.assert_close(got[:, :cfg.frontend_tokens], proj)
    text = {"tokens": tb["tokens"]}
    with torch.no_grad():
        got = lm._embed_inputs(cfg, params, text)
    _close(got, jlm._embed_inputs(jcfg, jp, {"tokens": jb["tokens"]}), 1e-5)


def test_projector_gelu_is_the_tanh_approximation(llava):
    """The exact erf gelu would differ from ``jax.nn.gelu``'s default by
    more than the tolerance at these inputs."""
    jcfg, _, jp, cfg, params = llava
    img = np.random.default_rng(2).normal(
        size=(1, 4, cfg.frontend_dim)).astype(np.float32) * 3
    w1 = np.asarray(jp["projector"]["w1"])
    h = jnp.asarray(img) @ jnp.asarray(w1)
    tanh_gelu = np.asarray(jax.nn.gelu(h))
    erf_gelu = np.asarray(jax.nn.gelu(h, approximate=False))
    assert np.abs(tanh_gelu - erf_gelu).max() > 1e-4
    want = tanh_gelu @ np.asarray(jp["projector"]["w2"])
    with torch.no_grad():
        got = params.projector(torch.from_numpy(img))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("images", [True, False])
def test_prefill_and_decode_match(llava, images):
    """Prefill with (or without) image embeddings, then 4 decode steps,
    against the JAX ``Model`` step by step; ``pos`` counts the image
    tokens."""
    _, jm, jp, cfg, params = llava
    model = build_model(cfg)
    B, S, n_img = 2, 12, cfg.frontend_tokens
    jb, tb = _batch(cfg, B, S, n_img, 3)
    if not images:
        jb, tb = {"tokens": jb["tokens"]}, {"tokens": tb["tokens"]}
    cache_len = 40
    jl, js = jm.prefill(jp, jb, cache_len)
    tl, ts = model.prefill(params, tb, cache_len)
    start = S + (n_img if images else 0)
    assert tl.shape == (B, 1, cfg.vocab_size)
    assert ts["pos"] == int(js["pos"]) == start
    _close(tl, jl, 1e-4)
    rng = np.random.default_rng(4)
    for _ in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, js = jm.decode(jp, jnp.asarray(nxt), js)
        tl, ts = model.decode(params, torch.from_numpy(nxt).long(), ts)
        _close(tl, jl, 1e-4)
    assert ts["pos"] == int(js["pos"]) == start + 4
    positions = ts["cache"][0]["attn"]["positions"]
    assert positions[:start + 4].tolist() == list(range(start + 4))


def test_prefill_needs_the_image_tokens_in_the_cache(llava):
    _, _, _, cfg, params = llava
    _, tb = _batch(cfg, 1, 8, cfg.frontend_tokens, 5)
    model = build_model(cfg)
    with pytest.raises(ValueError, match="exceeds the cache"):
        model.prefill(params, tb, 8 + cfg.frontend_tokens - 1)
    logits, state = model.prefill(params, tb, 8 + cfg.frontend_tokens)
    assert state["pos"] == 8 + cfg.frontend_tokens


def test_convert_carries_the_projector(llava):
    _, _, jp, cfg, params = llava
    for name in ("w1", "w2"):
        want = np.asarray(jp["projector"][name])
        assert torch.equal(getattr(params.projector, name),
                           torch.from_numpy(want.copy()))
    assert params.projector.w1.shape == (cfg.frontend_dim, cfg.d_model)
    tree = jax.tree.map(np.asarray, jp)
    del tree["projector"]["w2"]
    with pytest.raises(RuntimeError, match="projector.w2"):
        convert.lm_params_from_jax(cfg, tree, device="cpu")


def test_compute_params_casts_the_projector(llava):
    _, _, _, cfg, _ = llava
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    params = lm.init(cfg, seed=1, device="cpu")
    cast = lm.compute_params(cfg, params)
    assert cast.projector.w1.dtype == cast.projector.w2.dtype == \
        torch.bfloat16
    assert params.projector.w1.dtype == torch.float32
    _, tb = _batch(cfg, 2, 6, cfg.frontend_tokens, 6)
    model = build_model(cfg)
    a, _ = model.prefill(params, tb, 32)
    b, _ = model.prefill(cast, tb, 32)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_greedy_tokens_match_the_jax_engine(llava):
    """The engines take tokens only: text-only requests, 8 of 16 tokens,
    8 new, ``max_batch`` 4; identical greedy tokens."""
    jcfg, _, jp, cfg, params = llava
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
               for _ in range(8)]
    want = JServeEngine(jcfg, jp, max_batch=4, cache_len=32).serve(
        [JRequest(i, p, max_new_tokens=8) for i, p in enumerate(prompts)])
    got = ServeEngine(cfg, params, max_batch=4, cache_len=32).serve(
        [Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


def test_launcher_serves_the_vision_config_on_the_cpu(capsys):
    assert launcher.main(["--arch", ARCH, "--requests", "2", "--prompt-len",
                          "8", "--max-new", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "cpu" in out


def test_full_width_llava_builds_without_memory():
    """The full-width LLaVA-NeXT (Mistral-7B) on the meta device: the
    7.26 B parameters the card cell allocates."""
    cfg = get_config(ARCH)
    params = lm.LM(cfg, device="meta")
    norms = (2 * 32 + 1) * 4096                 # not in param_count
    projector = 1024 * 4096 + 4096 * 4096       # not in param_count
    n = sum(p.numel() for p in params.parameters())
    assert n == cfg.param_count() + norms + projector
    assert 7.2e9 < n < 7.3e9
    assert params.projector.w1.shape == (1024, 4096)
    assert params.layers[0].attn.wk.shape == (4096, 8, 128)
