"""The port's Mamba-2 SSD mixer (``repro_torch.models.ssm``) against the
JAX package's ``repro.models.ssm`` on the CPU: ``ssd_chunked`` at several
(S, chunk) with and without an initial state, the recurrent decode step
against the chunked form token by token, the causal conv with and
without its state, and ``SSM.forward`` against ``apply_ssm`` (fused and
split in-projection; prefill, a 3-token chunk after the prefill, then
decode; the caches too), on the same weights (``init_ssm``'s, carried by
name). Inputs are made with numpy from a seed; everything is float32 at
the reduced Mamba-2 config. Tolerance 1e-5."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import lm, ssm

ARCH = "mamba2-780m"
TOL = 1e-5


def _close(got, want, tol=TOL):
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


def _ssd_inputs(seed, b=2, S=32, H=4, P=8, G=2, N=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(b, S, H)).astype(np.float32)
    A = -rng.uniform(0.1, 1.0, size=(H,)).astype(np.float32)
    B = rng.normal(size=(b, S, G, N)).astype(np.float32)
    C = rng.normal(size=(b, S, G, N)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("S,chunk", [(32, 32), (32, 8), (32, 4), (24, 8),
                                     (16, 1), (1, 1)])
@pytest.mark.parametrize("initial", [False, True])
def test_ssd_chunked_matches(S, chunk, initial):
    """S == chunk (one chunk) and several chunks (nc > 1), from a zero or
    a given state: y and the final state."""
    x, dt, A, B, C = _ssd_inputs(S + chunk, S=S)
    b, _, H, P = x.shape
    N = B.shape[-1]
    init = (np.random.default_rng(7).normal(size=(b, H, P, N))
            .astype(np.float32) if initial else None)
    y_want, st_want = jssm.ssd_chunked(
        *map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk,
        initial_state=None if init is None else jnp.asarray(init))
    y, st = ssm.ssd_chunked(
        *map(torch.from_numpy, (x, dt, A, B, C)), chunk=chunk,
        initial_state=None if init is None else torch.from_numpy(init))
    assert y.shape == (b, S, H, P) and st.shape == (b, H, P, N)
    _close(y, y_want)
    _close(st, st_want)


def test_ssd_chunked_rejects_a_chunk_that_does_not_divide_s():
    x, dt, A, B, C = _ssd_inputs(0, S=12)
    with pytest.raises(ValueError, match="not a multiple"):
        ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=8)


def test_segsum_is_the_cumsum_difference():
    x = np.random.default_rng(3).normal(size=(2, 3, 6)).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    got = ssm._segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)
    assert (got[np.isinf(got)] < 0).all()


@pytest.fixture(scope="module")
def mamba():
    return jax_config(ARCH, reduced=True), get_config(ARCH, reduced=True)


def _layer(jcfg, cfg, split, seed=0):
    jcfg = dataclasses.replace(jcfg, ssm_split_in_proj=split)
    cfg = dataclasses.replace(cfg, ssm_split_in_proj=split)
    jp = jax.tree.map(np.asarray, jssm.init_ssm(jcfg, jax.random.PRNGKey(seed)))
    # A_log, D and dt_bias off their constant init, so each one counts
    rng = np.random.default_rng(seed + 1)
    H = cfg.ssm.num_heads(cfg.d_model)
    jp = dict(jp, A_log=rng.normal(size=H).astype(np.float32) * 0.5,
              D=rng.normal(size=H).astype(np.float32),
              dt_bias=rng.normal(size=H).astype(np.float32) * 0.5,
              conv_b=rng.normal(size=jp["conv_b"].shape).astype(np.float32))
    layer = ssm.SSM(cfg, "cpu")
    layer.load_state_dict(_flat(jp))
    return jcfg, jp, cfg, layer


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("split", [False, True])
def test_ssm_without_cache_matches(mamba, split):
    jcfg, jp, cfg, layer = _layer(*mamba, split)
    x = _x(1, (2, 16, cfg.d_model))
    want, _ = jssm.apply_ssm(jcfg, jp, jnp.asarray(x), chunk=8)
    with torch.no_grad():
        got, cache = layer(torch.from_numpy(x), chunk=8)
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("split", [False, True])
def test_ssm_prefill_chunk_and_decode_match(mamba, split):
    """Prefill 8 tokens (chunks of 4), a 3-token chunk after it (the
    chunked branch from the cached state: S != 1), then 4 decode steps
    (the recurrent branch); output and both caches at every step."""
    jcfg, jp, cfg, layer = _layer(*mamba, split, seed=2)
    x = _x(3, (2, 15, cfg.d_model))
    jc = jssm.init_ssm_cache(jcfg, 2, jnp.float32)
    tc = ssm.init_ssm_cache(cfg, 2, torch.float32)
    assert tc["state"].dtype == torch.float32
    for lo, hi in ((0, 8), (8, 11), (11, 12), (12, 13), (13, 14), (14, 15)):
        want, jc = jssm.apply_ssm(jcfg, jp, jnp.asarray(x[:, lo:hi]),
                                  cache=jc, chunk=4)
        with torch.no_grad():
            got, same = layer(torch.from_numpy(x[:, lo:hi]), cache=tc,
                              chunk=4)
        assert same is tc
        _close(got, want)
        _close(tc["state"], jc["state"])
        _close(tc["conv"], jc["conv"])


def test_ssm_decode_step_equals_the_chunked_form(mamba):
    """Token by token through the recurrent branch == the whole sequence
    through ``ssd_chunked`` from a zero state (the port against itself)."""
    _, _, cfg, layer = _layer(*mamba, False, seed=4)
    x = torch.from_numpy(_x(5, (2, 8, cfg.d_model)))
    with torch.no_grad():
        whole, _ = layer(x, chunk=4)
        cache = ssm.init_ssm_cache(cfg, 2, torch.float32)
        steps = [layer(x[:, t:t + 1], cache=cache)[0] for t in range(8)]
        full_cache = ssm.init_ssm_cache(cfg, 2, torch.float32)
        layer(x, cache=full_cache, chunk=4)
    torch.testing.assert_close(torch.cat(steps, dim=1), whole, rtol=TOL,
                               atol=TOL)
    torch.testing.assert_close(cache["state"], full_cache["state"],
                               rtol=TOL, atol=TOL)
    torch.testing.assert_close(cache["conv"], full_cache["conv"])


def test_ssm_rejects_a_prompt_its_chunk_does_not_divide(mamba):
    _, _, cfg, layer = _layer(*mamba, False)
    x = torch.from_numpy(_x(6, (1, 12, cfg.d_model)))
    with torch.no_grad(), pytest.raises(ValueError, match="not a multiple"):
        layer(x, chunk=8)


@pytest.mark.parametrize("state", [False, True])
def test_causal_conv_matches(state):
    rng = np.random.default_rng(8)
    xBC = rng.normal(size=(2, 5, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    cs = rng.normal(size=(2, 3, 12)).astype(np.float32) if state else None
    want = jssm._causal_conv(jnp.asarray(xBC), jnp.asarray(w), jnp.asarray(b),
                             None if cs is None else jnp.asarray(cs))
    got = ssm._causal_conv(torch.from_numpy(xBC), torch.from_numpy(w),
                           torch.from_numpy(b),
                           None if cs is None else torch.from_numpy(cs))
    _close(got, want)


def test_split_proj_matches(mamba):
    jcfg, cfg = mamba
    s = cfg.ssm
    di, GN = s.d_inner(cfg.d_model), s.n_groups * s.state_dim
    width = 2 * di + 2 * GN + s.num_heads(cfg.d_model)
    proj = _x(9, (2, 3, width))
    for got, want in zip(ssm._split_proj(cfg, torch.from_numpy(proj)),
                         jssm._split_proj(jcfg, jnp.asarray(proj))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_matches_the_reference_distributions(mamba):
    """``A_log`` 0, ``D`` 1, ``dt_bias`` 0, ``conv_b`` 0, norm scale 1, the
    weights truncated normal over their fan-in; the float32 params stay
    float32 under a bf16 param dtype."""
    _, cfg = mamba
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    params = lm.init(cfg, seed=0, device="cpu")
    layer = params.layers[0].ssm
    for name, val in (("A_log", 0.0), ("D", 1.0), ("dt_bias", 0.0)):
        t = getattr(layer, name)
        assert t.dtype == torch.float32 and bool((t == val).all()), name
    assert bool((layer.conv_b == 0).all())
    assert layer.conv_b.dtype == torch.bfloat16
    assert bool((layer.norm.scale == 1).all())
    w = layer.w_in.float()
    assert 0 < w.abs().max() <= 2.0 / cfg.d_model ** 0.5 + 1e-3


def test_compute_params_keeps_the_ssm_float32_params(mamba):
    _, cfg = mamba
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    params = lm.init(cfg, seed=1, device="cpu")
    cast = lm.compute_params(cfg, params)
    for block in cast.layers:
        for name in ("A_log", "D", "dt_bias"):
            assert getattr(block.ssm, name).dtype == torch.float32, name
        assert block.ssm.w_in.dtype == torch.bfloat16
        assert block.ssm.conv_w.dtype == torch.bfloat16
        assert block.ssm.norm.scale.dtype == torch.float32
    assert cast.embed.table.dtype == torch.bfloat16
    assert lm.UNCAST >= {"A_log", "D", "dt_bias"}
    # a leaf merely ending in "D" is cast: the match is on the whole name
    assert not {"w_dt", "w_in"} & lm.UNCAST


def test_bf16_cache_keeps_a_float32_state(mamba):
    """In bf16 the conv rows are bf16 and the state float32, as the
    reference's cache."""
    jcfg, _, cfg, layer = _layer(*mamba, False, seed=5)
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    tc = ssm.init_ssm_cache(cfg16, 1, torch.bfloat16)
    jc = jssm.init_ssm_cache(jcfg, 1, jnp.bfloat16)
    assert tc["conv"].dtype == torch.bfloat16
    assert str(jc["conv"].dtype) == "bfloat16"
    assert tc["state"].dtype == torch.float32 == \
        torch.from_numpy(np.array(jc["state"])).dtype
    x = torch.from_numpy(_x(6, (1, 4, cfg.d_model))).to(torch.bfloat16)
    with torch.no_grad():
        y, _ = layer(x, cache=tc)
        y1, _ = layer(x[:, :1], cache=tc)
    assert y.dtype == y1.dtype == torch.bfloat16
    assert tc["state"].dtype == torch.float32
    assert tc["conv"].dtype == torch.bfloat16
