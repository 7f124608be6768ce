"""The port's training path (``repro_torch.models.lm.forward`` /
``encdec.forward`` through ``Model.train_loss``, ``optim``, ``data``,
``train``) against the JAX package's on the CPU.

Weights are made by the JAX package's own init and carried across as
numpy (``convert.lm_params_from_jax``); the JAX gradient tree is carried
across the same way and compared name for name with autograd's. Every
other input is made with numpy from a seed. Tolerances: the loss 1e-5,
each gradient 1e-4 of its tensor's largest magnitude (float32, the
frameworks sum in other orders), the optimizer and schedules 1e-6.
Trajectories are compared by each step's loss, never by params after
steps: AdamW's first update is +-lr wherever |g| >> eps, so a near-zero
gradient whose sign differs moves a param by 2 lr."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import SyntheticLM as JSyntheticLM, DataConfig as JDataConfig
from repro.models import build_model as jax_build
from repro.models import attention as jattn
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro.optim import linear_warmup_cosine as jwarmup_cosine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data import DataConfig, SyntheticLM, make_source
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import build_model, lm
from repro_torch.models.attention import grouped_attention
from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
    linear_warmup_cosine,
)
from repro_torch.train import Trainer, TrainerConfig, make_train_state, \
    make_train_step

#: per family: config changes (both packages), batch (B, S), and the
#: params the reference's forward never reads (zero JAX gradient, no
#: torch gradient): Hymba's ``ssm_norm``
FAMILIES = {
    "gemma-7b": ({}, (2, 16), ()),
    # QK-norm: the norm's gradient over rows of the head width
    "qwen3-32b": ({}, (2, 16), ()),
    "command-r-plus-104b": ({}, (2, 16), ()),
    # capacity 8 of 16 expected tokens an expert a group: slots drop
    "phi3.5-moe-42b-a6.6b": ({"moe_capacity_factor": 0.5}, (2, 16), ()),
    "minicpm3-4b": ({}, (2, 16), ()),
    "deepseek-v2-236b": ({"moe_capacity_factor": 0.5}, (2, 16), ()),
    "llava-next-mistral-7b": ({}, (2, 12), ()),
    "mamba2-780m": ({}, (2, 16), ()),
    # three layers, window 8: the middle layer slides over 16 tokens
    "hymba-1.5b": ({"num_layers": 3, "sliding_window": 8}, (2, 16),
                   ("ssm_norm.scale",)),
    "seamless-m4t-medium": ({}, (2, 12), ()),
}


def _configs(arch, changes):
    changes = dict(changes)
    out = []
    for cfg in (jax_config(arch, reduced=True), get_config(arch, reduced=True)):
        ch = dict(changes)
        factor = ch.pop("moe_capacity_factor", None)
        if factor is not None:
            ch["moe"] = dataclasses.replace(cfg.moe, capacity_factor=factor)
        out.append(dataclasses.replace(cfg, **ch))
    return out


def _batch(cfg, B, S, seed):
    """numpy inputs of both packages: tokens, labels with some IGNORE,
    image embeddings (vision) or frames (enc-dec)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = tokens.copy()
    labels[rng.random((B, S)) < 0.2] = lm.IGNORE
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "vision":
        batch["image_embeds"] = rng.normal(
            size=(B, 4, cfg.frontend_dim)).astype(np.float32)
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(
            size=(B, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _from_jax(cfg, tree):
    to_port = convert.encdec_params_from_jax if cfg.encoder_layers \
        else convert.lm_params_from_jax
    return to_port(cfg, jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """(arch, the reference's loss, metrics and grads as port params, the
    port's params after backward, its loss and metrics)."""
    arch = request.param
    changes, (B, S), _ = FAMILIES[arch]
    jcfg, cfg = _configs(arch, changes)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = _batch(cfg, B, S, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jm.train_loss(p, jb), has_aux=True)(jp)
    params = _from_jax(cfg, jp)
    loss, metrics = build_model(cfg).train_loss(params, _torch_batch(batch))
    loss.backward()
    return (arch, cfg, float(jloss), jmetrics, _from_jax(cfg, jgrads),
            params, loss, metrics)


def test_loss_matches_reference(family):
    arch, cfg, jloss, jmetrics, _, _, loss, metrics = family
    assert np.isfinite(jloss)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()),
                               float(jmetrics["ce"]),
                               rtol=1e-5, atol=1e-5)
    assert int(metrics["tokens"]) == int(jmetrics["tokens"])
    np.testing.assert_allclose(float(metrics["aux"].detach()),
                               float(jmetrics["aux"]),
                               rtol=1e-5, atol=1e-6)
    if cfg.moe is not None:
        assert float(metrics["aux"].detach()) > 0.0


def test_every_gradient_matches_reference(family):
    """Every param, name for name, within 1e-4 of its tensor's largest
    JAX gradient; a param the reference never reads has an all-zero JAX
    gradient and no torch gradient."""
    arch, _, _, _, jgrads, params, _, _ = family
    unread = FAMILIES[arch][2]
    want = dict(jgrads.named_parameters())
    got = dict(params.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        w = want[name].detach()
        if name.endswith(unread) and unread:
            assert p.grad is None, name
            assert torch.count_nonzero(w) == 0, name
            continue
        assert p.grad is not None, name
        scale = float(w.abs().max())
        assert scale > 0.0, name
        err = float((p.grad - w).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)
    if unread:
        assert any(name.endswith(unread) for name in got)


def test_moe_family_drops_slots():
    """The MoE cut of ``FAMILIES`` really drops (token, k) slots, so the
    gradient test covers the reference's drops."""
    from repro_torch.models import moe
    _, cfg = _configs("phi3.5-moe-42b-a6.6b",
                      FAMILIES["phi3.5-moe-42b-a6.6b"][0])
    B, S = FAMILIES["phi3.5-moe-42b-a6.6b"][1]
    params = lm.init(cfg, seed=0, device="cpu")
    x = torch.randn((1, B * S, cfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    r = moe.route(cfg, params.layers[0].moe.router, x)
    assert 0 < int(r.keep.sum()) < B * S * cfg.moe.top_k


# ---------------------------------------------------------------- the loss
def test_gather_equals_onehot_bit_for_bit():
    """The reference's one-hot contraction, written out in torch, is the
    gather the port computes, bit for bit; and the port's loss is the
    same under both ``ce_impl`` values."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(
        (rng.normal(size=(3, 9, 50)) * 4).astype(np.float32))
    tgt = torch.from_numpy(rng.integers(0, 50, (3, 8)))
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    onehot = -torch.sum(logp * torch.nn.functional.one_hot(tgt, 50).to(
        logp.dtype), dim=-1)
    gather = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    assert torch.equal(onehot, gather)

    cfg = get_config("gemma-7b", reduced=True)
    params = lm.init(cfg, seed=0, device="cpu")
    batch = _torch_batch(_batch(cfg, 2, 8, seed=4))
    with torch.no_grad():
        losses = [lm.forward(dataclasses.replace(cfg, ce_impl=impl), params,
                             batch)[0] for impl in ("onehot", "gather")]
    assert torch.equal(losses[0], losses[1])


def test_reference_onehot_and_gather_agree():
    """The reference's two ``ce_impl`` routes give the port's loss."""
    jcfg, cfg = _configs("gemma-7b", {})
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(5))
    batch = _batch(cfg, 2, 8, seed=5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _from_jax(cfg, jp)
    with torch.no_grad():
        loss, _ = lm.forward(cfg, params, _torch_batch(batch))
    for impl in ("onehot", "gather"):
        jl, _ = jax_build(dataclasses.replace(jcfg, ce_impl=impl)) \
            .train_loss(jp, jb)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)


def test_all_labels_ignored_counts_one_token():
    """The denominator is at least 1: a batch with every label IGNORE has
    loss 0, as in the reference."""
    cfg = get_config("gemma-7b", reduced=True)
    params = lm.init(cfg, seed=0, device="cpu")
    batch = _torch_batch(_batch(cfg, 2, 8, seed=6))
    batch["labels"][:] = lm.IGNORE
    loss, metrics = lm.forward(cfg, params, batch)
    assert float(loss) == 0.0 and int(metrics["tokens"]) == 1


# ---------------------------------------------------------------- remat
@pytest.mark.parametrize("arch", ["gemma-7b", "phi3.5-moe-42b-a6.6b",
                                  "hymba-1.5b", "seamless-m4t-medium"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_equals_none(arch, policy):
    """``remat`` "full" and "dots" give the loss and every gradient of
    "none" exactly: recomputing a block changes no value."""
    changes, (B, S), _ = FAMILIES[arch]
    _, cfg = _configs(arch, changes)
    batch = _torch_batch(_batch(cfg, B, S, seed=7))
    params = build_model(cfg).init(0, "cpu")
    out = {}
    for remat in ("none", policy):
        params.zero_grad(set_to_none=True)
        loss, _ = build_model(dataclasses.replace(cfg, remat=remat)) \
            .train_loss(params, batch)
        loss.backward()
        out[remat] = (loss.detach(), {n: None if p.grad is None
                                      else p.grad.clone()
                                      for n, p in params.named_parameters()})
    assert torch.equal(out["none"][0], out[policy][0])
    for name, g in out["none"][1].items():
        h = out[policy][1][name]
        assert (g is None) == (h is None), name
        if g is not None:
            assert torch.equal(g, h), name


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_remat_reruns_each_norm_once(monkeypatch, remat):
    """A checkpointed block runs its norms again in the backward: "full"
    and "dots" make 2 L n + 1 norm calls a step, "none" L n + 1 (n = 2
    norms a Gemma block). ``chip_smoke.py`` counts the kernel's launches
    by this rule."""
    calls = []
    plain = rn.rmsnorm_torch

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(rn, "rmsnorm_torch", counted)
    cfg = dataclasses.replace(get_config("gemma-7b", reduced=True),
                              remat=remat)
    params = lm.init(cfg, seed=0, device="cpu")
    loss, _ = lm.forward(cfg, params, _torch_batch(_batch(cfg, 2, 8, 8)))
    forward_calls = len(calls)
    loss.backward()
    L = cfg.num_layers
    assert forward_calls == 2 * L + 1
    assert len(calls) == (2 * L + 1) + (0 if remat == "none" else 2 * L)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5)])
def test_q_chunks_equal_one_piece(causal, window):
    """``grouped_attention`` with q_chunk 4 over 16 queries equals the
    single piece (q_chunk >= S) and the reference's chunked version, with
    the gradient of the chunks equal to the single piece's."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8)))
    pos = np.arange(16, dtype=np.int32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    one = grouped_attention(tq, tk, tv, tpos, tpos, causal, window,
                            q_chunk=16)
    grads_one = torch.autograd.grad(one.square().sum(), (tq, tk, tv))
    chunked = grouped_attention(tq, tk, tv, tpos, tpos, causal, window,
                                q_chunk=4)
    grads_chunked = torch.autograd.grad(chunked.square().sum(), (tq, tk, tv))
    torch.testing.assert_close(chunked, one, rtol=1e-6, atol=1e-6)
    for a, b in zip(grads_chunked, grads_one):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    want = jattn.grouped_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   jnp.asarray(pos), jnp.asarray(pos),
                                   causal, window, q_chunk=4)
    np.testing.assert_allclose(chunked.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_q_chunk_must_divide_the_sequence():
    x = torch.zeros((1, 12, 2, 8))
    pos = torch.arange(12, dtype=torch.int32)
    with pytest.raises(AssertionError, match="q_chunk"):
        grouped_attention(x, x, x, pos, pos, q_chunk=5)


# ---------------------------------------------------------------- optimizer
def _opt_case(seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 2, 4)}
    p = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    g = {n: (rng.normal(size=s) * 0.5).astype(np.float32)
         for n, s in shapes.items()}
    g["b"][::3] = 1e-12           # |g| ~ eps: the update's sign is fragile
    return p, g


@pytest.mark.parametrize("fp32_moments", [False, True])
@pytest.mark.parametrize("grad_clip", [1.0, 100.0])
def test_adamw_matches_reference(fp32_moments, grad_clip):
    """Three steps on identical params, grads and state, at a moving
    lr_scale: params, moments, step, grad norm and lr to 1e-6."""
    p, g = _opt_case(0, np.float32)
    jcfg = JAdamWConfig(grad_clip=grad_clip, fp32_moments=fp32_moments)
    cfg = AdamWConfig(grad_clip=grad_clip, fp32_moments=fp32_moments)
    jparams = {n: jnp.asarray(a) for n, a in p.items()}
    jstate = {"m": {n: jnp.zeros_like(a) for n, a in jparams.items()},
              "v": {n: jnp.zeros_like(a) for n, a in jparams.items()},
              "step": jnp.zeros((), jnp.int32)}
    params = {n: torch.from_numpy(a.copy()) for n, a in p.items()}
    state = adamw_init(params, cfg)
    for step in range(3):
        grads = {n: a * (step + 1) for n, a in g.items()}
        scale = 0.5 + 0.25 * step
        jparams, jstate, jm = jadamw_update(
            jparams, {n: jnp.asarray(a) for n, a in grads.items()}, jstate,
            jcfg, jnp.float32(scale))
        params, state, m = adamw_update(
            params, {n: torch.from_numpy(a) for n, a in grads.items()},
            state, cfg, torch.tensor(scale))
        for n in p:
            for got, want in ((params[n], jparams[n]),
                              (state["m"][n], jstate["m"][n]),
                              (state["v"][n], jstate["v"][n])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-6)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        # the global-norm clip engages at grad_clip 1
        assert (float(m["grad_norm"]) > grad_clip) == (grad_clip == 1.0)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)


def test_adamw_bf16_params_keep_bf16_moments():
    """bf16 params: moments in bf16 (cast back after float32 math), as the
    reference stores them; values to 1e-6 of the reference's."""
    p, g = _opt_case(1, np.float32)
    jparams = {n: jnp.asarray(a, jnp.bfloat16) for n, a in p.items()}
    jstate = {"m": {n: jnp.zeros_like(a) for n, a in jparams.items()},
              "v": {n: jnp.zeros_like(a) for n, a in jparams.items()},
              "step": jnp.zeros((), jnp.int32)}
    params = {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in p.items()}
    state = adamw_init(params, AdamWConfig())
    assert all(m.dtype == torch.bfloat16 for m in state["m"].values())
    jparams, jstate, _ = jadamw_update(
        jparams, {n: jnp.asarray(a) for n, a in g.items()}, jstate,
        JAdamWConfig())
    params, state, _ = adamw_update(
        params, {n: torch.from_numpy(a) for n, a in g.items()}, state,
        AdamWConfig())
    for n in p:
        for got, want in ((params[n], jparams[n]), (state["m"][n],
                                                    jstate["m"][n])):
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=1e-6, atol=1e-6)


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([[4.0]])}
    assert float(global_norm(t)) == 5.0


def _one_piece_norm(tensors):
    """``global_norm`` before the slabs: each tensor's squares summed in
    one piece."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tensors.values()))


def _slab_case(seed, dtype):
    """Params and grads whose sizes no slab of 7 divides (221 = 31 x 7 +
    4), one of a slab or less, and a 0-d one."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (13, 17), "b": (5,), "c": (2, 3, 4), "d": ()}
    p = {n: torch.from_numpy(np.asarray(rng.normal(size=s), np.float32))
         .to(dtype) for n, s in shapes.items()}
    g = {n: torch.from_numpy(np.asarray(rng.normal(size=s) * 0.5, np.float32))
         for n, s in shapes.items()}
    return p, g


@pytest.mark.parametrize("chunk", [1, 7])
@pytest.mark.parametrize("dtype,fp32_moments", [
    (torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True),
    (torch.float32, True)])
@pytest.mark.parametrize("grad_clip", [1.0, 100.0])
def test_adamw_slabs_equal_one_piece(monkeypatch, chunk, dtype, fp32_moments,
                                     grad_clip):
    """Three steps of the update in slabs of ``chunk`` elements write the
    params and both moments of the one-piece update bit for bit, given
    the same grad norm (the one-piece sum; the slabbed norm is held
    below)."""
    cfg = AdamWConfig(grad_clip=grad_clip, fp32_moments=fp32_moments)
    monkeypatch.setattr(adamw_mod, "global_norm", _one_piece_norm)
    runs = []
    for size in (adamw_mod.UPDATE_CHUNK, chunk):
        monkeypatch.setattr(adamw_mod, "UPDATE_CHUNK", size)
        params, g = _slab_case(3, dtype)
        state = adamw_init(params, cfg)
        for step in range(3):
            grads = {n: (a * (step + 1)).to(dtype) for n, a in g.items()}
            params, state, m = adamw_update(params, grads, state, cfg,
                                            torch.tensor(0.5 + 0.25 * step))
        runs.append((params, state, m))
    (p1, s1, m1), (p2, s2, m2) = runs
    assert (float(m1["grad_norm"]) > grad_clip) == (grad_clip == 1.0)
    for n in p1:
        for a, b in ((p1[n], p2[n]), (s1["m"][n], s2["m"][n]),
                     (s1["v"][n], s2["v"][n])):
            assert a.dtype == b.dtype and torch.equal(a, b), n
    assert int(s1["step"]) == int(s2["step"]) == 3


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_global_norm_in_slabs(monkeypatch, chunk):
    """The norm summed slab by slab is the one-piece norm within rel 1e-6,
    and equal to it where every tensor fits one slab."""
    rng = np.random.default_rng(4)
    tensors = {"a": torch.from_numpy(rng.normal(size=(13, 17))
                                     .astype(np.float32)),
               "b": torch.from_numpy(rng.normal(size=(5,)).astype(np.float32)),
               "c": torch.from_numpy(rng.normal(size=(40,))
                                     .astype(np.float32)).to(torch.bfloat16),
               "d": torch.tensor(2.5)}
    want = _one_piece_norm(tensors)
    monkeypatch.setattr(adamw_mod, "UPDATE_CHUNK", chunk)
    got = global_norm(tensors)
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)
    small = {n: t for n, t in tensors.items() if t.numel() <= chunk}
    assert small and torch.equal(global_norm(small), _one_piece_norm(small))


def test_adamw_refuses_a_non_contiguous_gradient(monkeypatch):
    """A slab is a view: a gradient of more than one slab that has no
    flat view raises, uncopied."""
    monkeypatch.setattr(adamw_mod, "UPDATE_CHUNK", 5)
    params = {"a": torch.zeros((3, 4))}
    grads = {"a": torch.ones((4, 3)).t()}
    state = adamw_init(params, AdamWConfig())
    with pytest.raises(ValueError, match="not contiguous"):
        adamw_update(params, grads, state, AdamWConfig())


@pytest.mark.parametrize("total,warmup,final", [(100, 10, 0.1), (7, 0, 0.0),
                                                (50, 60, 0.3)])
def test_schedules_match_reference(total, warmup, final):
    for step in range(0, total + 5):
        s = torch.tensor(step, dtype=torch.int32)
        js = jnp.int32(step)
        np.testing.assert_allclose(float(cosine_schedule(s, total, final)),
                                   float(jcosine(js, total, final)),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            float(linear_warmup_cosine(s, warmup, total, final)),
            float(jwarmup_cosine(js, warmup, total, final)),
            rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("seed,B,S,V", [(0, 4, 32, 512), (3, 2, 17, 40),
                                        (7, 8, 128, 256000)])
def test_synthetic_batches_equal_reference(seed, B, S, V):
    ours = SyntheticLM(DataConfig(V, S, B, seed=seed))
    theirs = JSyntheticLM(JDataConfig(V, S, B, seed=seed))
    for step in (0, 1, 5, 1000):
        a, b = ours.batch(step), theirs.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_make_source_reads_the_shape():
    cfg = get_config("gemma-7b", reduced=True)
    src = make_source(cfg, InputShape("t", 24, 3, "train"), seed=2)
    b = src.batch(0)
    assert b["tokens"].shape == (3, 24)
    assert b["tokens"].max() < min(src.cfg.active_vocab, cfg.vocab_size)


# ---------------------------------------------------------------- trainer
def test_train_step_updates_every_param_and_the_step():
    cfg = get_config("gemma-7b", reduced=True)
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3)
    state = make_train_state(model, 0, opt, "cpu")
    before = {n: p.detach().clone()
              for n, p in state["params"].named_parameters()}
    step_fn = make_train_step(model, opt, total_steps=10, warmup=2)
    batch = _torch_batch(_batch(cfg, 2, 8, seed=10))
    state, metrics = step_fn(state, batch)
    assert int(state["opt"]["step"]) == 1
    # lr_scale is read before the increment: step 0 of the warm-up is 0
    assert float(metrics["lr"]) == 0.0
    state, metrics = step_fn(state, batch)
    assert float(metrics["lr"]) == pytest.approx(1e-3 * 0.5 * (
        0.1 + 0.9 * 0.5 * (1 + np.cos(0.0))), rel=1e-6)
    for n, p in state["params"].named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
        assert not torch.equal(p.detach(), before[n]), n
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))


def test_reduced_trainer_loss_falls(tmp_path):
    cfg = get_config("gemma-7b", reduced=True)
    tr = Trainer(cfg, InputShape("local", 32, 4, "train"),
                 TrainerConfig(steps=25, log_every=1, seed=0,
                               checkpoint_dir=str(tmp_path),
                               opt=AdamWConfig(lr=3e-2, weight_decay=0.01),
                               device="cpu"))
    seen = []
    hist = tr.run(on_step=lambda step, state, m: seen.append(step))
    assert seen == list(range(25))
    losses = [h["loss"] for h in hist]
    assert len(losses) == 25 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < losses[0] - 0.3
    assert (tmp_path / "step_00000025.npz").exists()


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_config("gemma-7b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, InputShape("local", 8, 2, "train"), TrainerConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_state(build_model(cfg), 0, AdamWConfig())


def test_launch_train_local_on_cpu(capsys):
    from repro_torch.launch import train as launch_train
    assert launch_train.main(["--local", "--device", "cpu", "--steps", "4",
                              "--arch", "gemma-7b"]) == 0
    out = capsys.readouterr().out
    assert "step     3  loss" in out and "on cpu" in out
    if not torch.cuda.is_available():
        # the default path plans on the card's mesh type: none here
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_train.main(["--arch", "gemma-7b"])


def test_import_train_leaves_jax_out():
    import subprocess
    import sys
    code = ("import sys; import repro_torch.train, repro_torch.optim, "
            "repro_torch.data, repro_torch.checkpoint, "
            "repro_torch.launch.train; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)
