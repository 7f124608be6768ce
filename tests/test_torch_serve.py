"""The port's serving engine (``repro_torch.serve``) and launcher against
the JAX package's engine on the CPU, on the same weights.

The setting is ``examples/serve_demo.py``'s: reduced Gemma-7B (float32),
8 requests of 24 prompt tokens, 12 new tokens each, ``max_batch`` 4,
``cache_len`` 128, greedy. Greedy tokens must be identical."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model, lm
from repro_torch.serve import Request, ServeEngine


def _prompts(vocab, n=8, length=24, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, length).astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def gemma():
    jcfg = jax_config("gemma-7b", reduced=True)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config("gemma-7b", reduced=True)
    params = convert.lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def test_greedy_tokens_match_the_jax_engine(gemma):
    jcfg, jparams, cfg, params = gemma
    prompts = _prompts(cfg.vocab_size)
    want = JServeEngine(jcfg, jparams, max_batch=4, cache_len=128).serve(
        [JRequest(i, p, max_new_tokens=12) for i, p in enumerate(prompts)])
    got = ServeEngine(cfg, params, max_batch=4, cache_len=128).serve(
        [Request(i, p, max_new_tokens=12) for i, p in enumerate(prompts)])
    assert [c.request_id for c in got] == [c.request_id for c in want]
    for g, w in zip(got, want):
        assert g.tokens.dtype == np.int32 and g.tokens.shape == (12,)
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
        assert g.prefill_ms > 0 and g.decode_ms > 0


def test_moe_greedy_tokens_match_the_jax_engine():
    """Reduced Phi-3.5-MoE (float32) from the JAX package's weights: 8
    requests of 32 prompt tokens, 12 new, ``max_batch`` 4, so prefill
    routes groups of 64 tokens and decode groups of 4, at the default
    capacity (drops included)."""
    arch = "phi3.5-moe-42b-a6.6b"
    jcfg = jax_config(arch, reduced=True)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config(arch, reduced=True)
    params = convert.lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    prompts = _prompts(cfg.vocab_size, length=32)
    want = JServeEngine(jcfg, jparams, max_batch=4, cache_len=64).serve(
        [JRequest(i, p, max_new_tokens=12) for i, p in enumerate(prompts)])
    got = ServeEngine(cfg, params, max_batch=4, cache_len=64).serve(
        [Request(i, p, max_new_tokens=12) for i, p in enumerate(prompts)])
    assert [c.request_id for c in got] == [c.request_id for c in want]
    for g, w in zip(got, want):
        assert g.tokens.shape == (12,)
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


def test_groups_by_prompt_length_and_honours_max_new(gemma):
    _, _, cfg, params = gemma
    engine = ServeEngine(cfg, params, max_batch=2, cache_len=64)
    reqs = [Request(0, _prompts(cfg.vocab_size, 1, 10)[0], 5),
            Request(1, _prompts(cfg.vocab_size, 1, 6, 1)[0], 3),
            Request(2, _prompts(cfg.vocab_size, 1, 10, 2)[0], 7)]
    done = engine.serve(reqs)
    assert [c.request_id for c in done] == [1, 0, 2]
    assert [len(c.tokens) for c in done] == [3, 5, 7]
    with pytest.raises(ValueError, match="equal prompt lengths"):
        engine.run_batch(reqs[:2])
    with pytest.raises(ValueError, match="max_batch"):
        engine.run_batch([reqs[0], reqs[2], reqs[0]])


def test_temperature_sampling_uses_the_engines_generator(gemma):
    _, _, cfg, params = gemma
    prompts = _prompts(cfg.vocab_size, 2, 8)

    def run(seed):
        engine = ServeEngine(cfg, params, max_batch=2, cache_len=32,
                             seed=seed)
        return engine.serve([Request(i, p, 6, temperature=1.0)
                             for i, p in enumerate(prompts)])

    a, b = run(3), run(3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)
        assert ((x.tokens >= 0) & (x.tokens < cfg.vocab_size)).all()


def test_entry_points_default_to_the_card():
    model = build_model(get_config("gemma-7b", reduced=True))
    if torch.cuda.is_available():
        assert lm.param_device(model.init(0)).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init(0)


def test_launcher_serves_on_the_cpu(capsys):
    assert launcher.main(["--requests", "2", "--prompt-len", "8",
                          "--max-new", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "cpu" in out


def test_launcher_serves_the_moe_family_on_the_cpu(capsys):
    assert launcher.main(["--arch", "phi3.5-moe-42b-a6.6b", "--requests",
                          "2", "--prompt-len", "8", "--max-new", "3",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "cpu" in out
