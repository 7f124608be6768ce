"""The port's encoder-decoder (SeamlessM4T: ``repro_torch.models.encdec``)
against the JAX package's ``repro.models.encdec`` on the CPU, on the same
weights (``convert.encdec_params_from_jax``): ``encode``, the
cross-attention on both of its routes against ``apply_gqa(kv_source=...,
use_rope=False, causal=False)``, a decoder block against
``apply_block``, and the whole model through ``Model.prefill`` /
``decode`` against the JAX ``Model`` (logits and greedy tokens). Inputs
are made with numpy from a seed; everything is float32 at the reduced
config. Tolerances: 1e-5 for the encoder and layers, 1e-4 for logits,
identical greedy tokens."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import build_model as jax_build
from repro.models import encdec as jencdec
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import blocks, build_model, encdec, lm
from repro_torch.models.attention import GQA

ARCH = "seamless-m4t-medium"


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


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def seamless():
    jcfg = jax_config(ARCH, reduced=True)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, reduced=True)
    params = convert.encdec_params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                            device="cpu")
    return jcfg, jm, jp, cfg, params


def _batch(cfg, B, S_src, S_tgt, seed):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, S_src, cfg.frontend_dim)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S_tgt)).astype(np.int32)
    return ({"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)},
            {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(tokens).long()})


def test_encode_matches(seamless):
    """The frontend projection, the non-causal encoder stack (through the
    flash route's plain version here) and the encoder norm."""
    jcfg, _, jp, cfg, params = seamless
    jb, tb = _batch(cfg, 2, cfg.frontend_tokens, 4, 1)
    want = jencdec.encode(jcfg, jp, jb["frames"])
    with torch.no_grad():
        got = encdec.encode(cfg, params, tb["frames"])
    assert got.shape == (2, cfg.frontend_tokens, cfg.d_model)
    _close(got, want, 1e-5)


def test_encoder_is_not_causal(seamless):
    """The first frame's encoding moves when only the last frame does."""
    _, _, _, cfg, params = seamless
    _, tb = _batch(cfg, 1, 8, 4, 2)
    frames = tb["frames"].clone()
    frames[:, -1] += 1.0
    with torch.no_grad():
        a = encdec.encode(cfg, params, tb["frames"])
        b = encdec.encode(cfg, params, frames)
    assert not torch.allclose(a[:, 0], b[:, 0])


@pytest.mark.parametrize("prefill", [True, False])
def test_cross_attention_matches(prefill, seamless):
    """q at S_q = 6 target positions over S_k = 16 encoder frames, no RoPE,
    nothing masked: the flash route (``prefill=True``, as the prefill
    takes it) and ``grouped_attention`` (the decode's route) against
    ``apply_gqa(kv_source=..., use_rope=False, causal=False)``."""
    jcfg, _, _, cfg, _ = seamless
    jp = jax.tree.map(np.asarray, jattn.init_gqa(jcfg, jax.random.PRNGKey(4)))
    attn = GQA(cfg, "cpu")
    attn.load_state_dict(_flat(jp))
    x = _x(5, (2, 6, cfg.d_model))
    enc = _x(6, (2, 16, cfg.d_model))
    pos = np.arange(3, 9, dtype=np.int32)
    kpos = np.arange(16, dtype=np.int32)
    want, _ = jattn.apply_gqa(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                              causal=False, kv_source=jnp.asarray(enc),
                              kv_positions=jnp.asarray(kpos), use_rope=False)
    with torch.no_grad():
        got, cache = attn(torch.from_numpy(x), torch.from_numpy(pos),
                          prefill=prefill, causal=False,
                          kv_source=torch.from_numpy(enc),
                          kv_positions=torch.from_numpy(kpos),
                          use_rope=False)
    assert cache is None
    _close(got, want, 1e-5)


def test_decoder_block_matches(seamless):
    """One decoder block (self-attention, cross-attention, MLP): a 6-token
    prefill, then 2 decode steps, against ``apply_block`` with
    ``encoder_out``."""
    jcfg, _, _, cfg, _ = seamless
    jp = jax.tree.map(np.asarray, jblocks.init_block(
        jcfg, jax.random.PRNGKey(7), cross_attention=True))
    block = blocks.Block(cfg, "cpu", cross_attention=True)
    block.load_state_dict(_flat(jp))
    x = _x(8, (2, 8, cfg.d_model))
    enc = _x(9, (2, 16, cfg.d_model))
    kpos = np.arange(16, dtype=np.int32)
    jc = jblocks.init_block_cache(jcfg, 2, 12, jnp.float32)
    tc = blocks.init_block_cache(cfg, 2, 12, torch.float32, "cpu")
    for lo, hi in ((0, 6), (6, 7), (7, 8)):
        pos = np.arange(lo, hi, dtype=np.int32)
        want, _, jc = jblocks.apply_block(
            jcfg, jp, jnp.asarray(x[:, lo:hi]), jnp.asarray(pos), None,
            cache=jc, encoder_out=jnp.asarray(enc),
            encoder_positions=jnp.asarray(kpos))
        with torch.no_grad():
            got, _, _ = block(torch.from_numpy(x[:, lo:hi]),
                              torch.from_numpy(pos), None, cache=tc,
                              prefill=lo == 0,
                              encoder_out=torch.from_numpy(enc),
                              encoder_positions=torch.from_numpy(kpos))
        _close(got, want, 1e-5)
    _close(tc["attn"]["v"], jc["attn"]["v"], 1e-5)


def test_prefill_and_decode_match(seamless):
    """Prefill (16 frames, 6 target tokens), then 4 decode steps, against
    the JAX ``Model`` step by step; ``pos`` counts the target tokens only,
    and ``enc`` is the encoder's output."""
    _, jm, jp, cfg, params = seamless
    model = build_model(cfg)
    assert model.is_encdec
    jb, tb = _batch(cfg, 2, cfg.frontend_tokens, 6, 3)
    cache_len = 16
    jl, js = jm.prefill(jp, jb, cache_len)
    tl, ts = model.prefill(params, tb, cache_len)
    assert tl.shape == (2, 1, cfg.vocab_size)
    assert ts["pos"] == int(js["pos"]) == 6
    _close(tl, jl, 1e-4)
    _close(ts["enc"], js["enc"], 1e-5)
    rng = np.random.default_rng(4)
    for _ in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, js = jm.decode(jp, jnp.asarray(nxt), js)
        tl, ts = model.decode(params, torch.from_numpy(nxt).long(), ts)
        _close(tl, jl, 1e-4)
    assert ts["pos"] == int(js["pos"]) == 10
    positions = ts["cache"][0]["attn"]["positions"]
    assert positions[:10].tolist() == list(range(10))


def _greedy(prefill, decode, batch, steps):
    logits, state = prefill(batch)
    out = [np.asarray(logits[:, -1]).argmax(-1)]
    for _ in range(steps):
        logits, state = decode(out[-1][:, None], state)
        out.append(np.asarray(logits[:, 0]).argmax(-1))
    return np.stack(out, axis=1)


def test_greedy_tokens_match_the_jax_model(seamless):
    """4 requests of 16 frames + 8 target tokens, 8 new tokens, greedy
    through ``Model.prefill`` / ``decode`` on both sides."""
    _, jm, jp, cfg, params = seamless
    model = build_model(cfg)
    jb, tb = _batch(cfg, 4, cfg.frontend_tokens, 8, 5)
    want = _greedy(lambda b: jm.prefill(jp, b, 24),
                   lambda t, s: jm.decode(jp, jnp.asarray(t, jnp.int32), s),
                   jb, 7)
    got = _greedy(lambda b: model.prefill(params, b, 24),
                  lambda t, s: model.decode(params, torch.from_numpy(t).long(),
                                            s),
                  tb, 7)
    np.testing.assert_array_equal(got, want)


def test_convert_carries_every_leaf(seamless):
    _, _, jp, cfg, params = seamless
    tree = jax.tree.map(np.asarray, jp)
    state = params.state_dict()
    flat = _flat(tree)
    n_leaves = 0
    for name, want in flat.items():
        top, rest = name.split(".", 1)
        if top in ("encoder", "decoder"):
            for i in range(want.shape[0]):
                assert torch.equal(state[f"{top}.{i}.{rest}"], want[i]), name
                n_leaves += 1
        else:
            assert torch.equal(state[name], want), name
            n_leaves += 1
    assert n_leaves == len(state)
    assert "decoder.0.cross_attn.wq" in state
    assert "encoder.0.cross_attn.wq" not in state
    assert params.unembed.table.data_ptr() != params.embed.table.data_ptr()
    del tree["frontend_proj"]["w"]
    with pytest.raises(RuntimeError, match="frontend_proj.w"):
        convert.encdec_params_from_jax(cfg, tree, device="cpu")


def test_compute_params_casts_the_encdec(seamless):
    _, _, _, cfg, _ = seamless
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    params = encdec.init(cfg, seed=1, device="cpu")
    cast = lm.compute_params(cfg, params)
    assert isinstance(cast, encdec.EncDec)
    assert cast.frontend_proj.w.dtype == torch.bfloat16
    assert cast.decoder[0].cross_attn.wq.dtype == torch.bfloat16
    assert cast.enc_norm.scale.dtype == torch.float32
    _, tb = _batch(cfg, 2, 8, 4, 6)
    model = build_model(cfg)
    a, sa = model.prefill(params, tb, 8)
    b, sb = model.prefill(cast, tb, 8)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert sa["enc"].dtype == torch.bfloat16


def test_launcher_refuses_the_encdec_config():
    with pytest.raises(ValueError, match="frames"):
        launcher.main(["--arch", ARCH, "--device", "cpu"])


def test_full_width_seamless_builds_without_memory():
    """SeamlessM4T-medium (12 + 12 layers, d 1024, 16 x 64 heads, vocab
    256,206, untied) on the meta device."""
    cfg = get_config(ARCH)
    params = encdec.EncDec(cfg, device="meta")
    d, L = cfg.d_model, cfg.num_layers
    layer = 4 * d * d + 3 * d * cfg.d_ff
    n = sum(p.numel() for p in params.parameters())
    want = (2 * cfg.vocab_size * d + cfg.frontend_dim * d
            + cfg.encoder_layers * (layer + 2 * d)
            + L * (layer + 4 * d * d + 3 * d) + 2 * d)
    assert n == want
    assert 9.7e8 < n < 1.0e9
    assert params.decoder[0].cross_attn.wk.shape == (1024, 16, 64)
    assert not hasattr(params.encoder[0], "cross_attn")
