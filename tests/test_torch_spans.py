"""The port's spans (``repro_torch.obs.trace``) on the serve, model and
train paths, on the CPU.

Spans record on an installed tracer or, with none, while a torch profiler
session records; they stamp ``time.time_ns()``, the clock the profiler's
events are converted to, so a span encloses the profiler's record of the
work inside it. Reduced Gemma-7B (2 layers, float32) serves a batch and
takes training steps; spans change no token, loss or param."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_config
from repro_torch.models import build_model, lm
from repro_torch.obs import trace
from repro_torch.optim import AdamWConfig
from repro_torch.optim import adamw as adamw_mod
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import make_train_step, train_state

B, S, NEW, CACHE = 2, 16, 5, 32


@pytest.fixture
def no_tracer():
    """No tracer installed, and no spans left from an earlier session."""
    with trace.activate(None):
        trace.session_spans()
        yield


def _cfg(remat="none"):
    return dataclasses.replace(get_config("gemma-7b", reduced=True),
                               remat=remat)


def _requests(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size, S).astype(np.int32),
                    max_new_tokens=NEW) for i in range(B)]


def _serve(cfg, params):
    engine = ServeEngine(cfg, params, max_batch=B, cache_len=CACHE)
    return np.stack([c.tokens for c in engine.run_batch(_requests(cfg))])


def _train(cfg, steps=2):
    """Losses and final params of ``steps`` steps from seed 0."""
    params = lm.init(cfg, seed=0, device="cpu")
    opt = AdamWConfig(lr=1e-3)
    state = train_state(params, opt)
    step = make_train_step(build_model(cfg), opt, total_steps=10, warmup=1)
    rng = np.random.default_rng(1)
    losses = []
    for _ in range(steps):
        t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
        state, metrics = step(state, {"tokens": t, "labels": t})
        losses.append(float(metrics["loss"]))
    return losses, {n: p.detach().clone()
                    for n, p in state["params"].named_parameters()}


def _children(spans, parent):
    return [sp for sp in spans if sp.parent == parent.index]


def test_span_is_the_shared_null_span_when_off(no_tracer):
    assert not torch.autograd.profiler._is_profiler_enabled
    before = list(trace.session_spans())
    sp = trace.span("model.block", layer=0)
    assert sp is trace._NULL_SPAN
    with sp as inner:
        assert inner.add("elements", 3) is sp
    assert trace.session_spans() == before


def test_a_profiler_session_records_spans_on_its_own_clock(no_tracer):
    """Under a CPU profiler session with no tracer installed, spans go to
    the session tracer and are read after the session stops; a span
    around a ``record_function`` encloses the profiler's record of it."""
    x = torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with trace.span("outer", i=i):
                with record_function(f"probe{i}"):
                    x = x + 1
    spans = trace.session_spans()
    assert [(sp.name, sp.attrs["i"]) for sp in spans] == \
        [("outer", i) for i in range(3)]
    events = {ev.name(): ev for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("probe")}
    for i, sp in enumerate(spans):
        ev = events[f"probe{i}"]
        assert sp.t0 <= ev.start_ns()
        assert ev.start_ns() + ev.duration_ns() <= sp.t1
    # closed once read after the stop: a later session starts afresh
    assert trace.session_spans() is spans
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("again"):
            pass
    assert [sp.name for sp in trace.session_spans()] == ["again"]
    assert trace.span("off") is trace._NULL_SPAN


def test_sessions_not_read_between_share_one_read(no_tracer):
    """Two sessions with no read between come back together; a read after
    them closes their spans, and the next session's stand alone."""
    trace.session_spans()
    for name in ("first", "second"):
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span(name):
                pass
    assert [sp.name for sp in trace.session_spans()] == ["first", "second"]
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("third"):
            pass
    assert [sp.name for sp in trace.session_spans()] == ["third"]


def test_an_installed_tracer_takes_the_spans_of_a_session(no_tracer):
    tracer = trace.Tracer()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.activate(tracer):
            with trace.span("mine"):
                trace.add("n", 2)
    assert [(sp.name, sp.attrs) for sp in tracer.spans] == \
        [("mine", {"n": 2})]
    assert "mine" not in [sp.name for sp in trace.session_spans()]


def test_exports_on_the_new_clock():
    """Stamps are ``time.time_ns()`` ints; the Chrome export is in µs from
    the tracer's origin and self-times partition the roots' time."""
    tracer = trace.Tracer()
    before = time.time_ns()
    with trace.activate(tracer):
        with trace.span("a"):
            with trace.span("b"):
                time.sleep(0.002)
            with trace.span("b"):
                pass
    after = time.time_ns()
    a, b1, b2 = tracer.spans
    assert before <= a.t0 <= b1.t0 <= b1.t1 <= b2.t0 <= b2.t1 <= a.t1 <= after
    assert b1.dur == pytest.approx((b1.t1 - b1.t0) * 1e-9) and b1.dur >= 0.002
    assert tracer.well_formed()
    events = tracer.chrome_trace()["traceEvents"]
    assert events[1]["ts"] == pytest.approx((b1.t0 - tracer.origin) / 1e3)
    assert events[1]["dur"] == pytest.approx(b1.dur * 1e6)
    table = tracer.phase_table()
    assert table["b"]["count"] == 2
    assert sum(r["self_s"] for r in table.values()) == pytest.approx(a.dur)


def test_a_served_batch_gives_the_span_tree(no_tracer):
    """``run_batch`` under a profiler session: one ``serve.batch`` root,
    its prefill and one ``serve.decode_step`` a step after the first, each
    with ``model.block`` x layers (attention with its core, ffn) and one
    ``model.head``."""
    cfg = _cfg()
    params = lm.init(cfg, seed=0, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(cfg, params)
    spans = trace.session_spans()
    (root,) = [sp for sp in spans if sp.parent < 0]
    assert root.name == "serve.batch"
    assert root.attrs == {"batch": B, "prompt_len": S, "new_tokens": NEW}
    phases = _children(spans, root)
    assert [sp.name for sp in phases] == \
        ["serve.prefill"] + ["serve.decode_step"] * (NEW - 1)
    assert phases[0].attrs == {"tokens": B * S}
    assert [sp.attrs["step"] for sp in phases[1:]] == list(range(1, NEW))
    for phase in phases:
        route = "flash" if phase.name == "serve.prefill" else "cache"
        kids = _children(spans, phase)
        assert [sp.name for sp in kids] == \
            ["model.block"] * cfg.num_layers + ["model.head"]
        assert [sp.attrs["layer"] for sp in kids[:-1]] == \
            list(range(cfg.num_layers))
        for block in kids[:-1]:
            attn, ffn = _children(spans, block)
            assert (attn.name, ffn.name) == ("model.attention", "model.ffn")
            (core,) = _children(spans, attn)
            assert (core.name, core.attrs) == \
                ("model.attention.core", {"route": route})
    assert all(sp.t1 is not None for sp in spans)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_a_train_step_gives_the_span_tree(monkeypatch, remat):
    """``train_step``: forward, backward and the update under one
    ``train.step``; the slabs' ``elements`` sum to the param count; under
    full remat the recomputed forward's spans open in the backward."""
    monkeypatch.setattr(adamw_mod, "UPDATE_CHUNK", 5000)
    cfg = _cfg(remat)
    tracer = trace.Tracer()
    with trace.activate(tracer):
        _, params = _train(cfg, steps=1)
    spans = tracer.spans
    assert tracer.well_formed()
    (root,) = [sp for sp in spans if sp.parent < 0]
    assert (root.name, root.attrs) == ("train.step", {"tokens": B * S})
    fwd, bwd, opt = _children(spans, root)
    assert (fwd.name, bwd.name, opt.name) == \
        ("train.forward", "train.backward", "train.adamw")
    assert [sp.name for sp in _children(spans, fwd)] == \
        ["model.block"] * cfg.num_layers + ["model.head"]
    again = [sp for sp in _children(spans, bwd)
             if sp.name == "model.attention"]
    assert len(again) == (cfg.num_layers if remat == "full" else 0)
    cores = [sp for sp in spans if sp.name == "model.attention.core"]
    assert {sp.attrs["route"] for sp in cores} == {"fresh"}
    slabs = _children(spans, opt)
    n_params = sum(p.numel() for p in params.values())
    assert {sp.name for sp in slabs} == {"train.adamw.slab"}
    assert sum(sp.attrs["elements"] for sp in slabs) == n_params
    assert opt.attrs == {"elements": n_params, "slabs": len(slabs)}
    assert len(slabs) > len(params)


def test_spans_change_no_token_loss_or_param(no_tracer):
    """Served tokens and two training steps' losses and params are bit
    for bit the same with no tracing, a tracer, and a profiler session."""
    cfg = _cfg("full")
    params = lm.init(cfg, seed=0, device="cpu")
    runs = [(_serve(cfg, params), *_train(cfg))]
    with trace.activate(trace.Tracer()) as tracer:
        runs.append((_serve(cfg, params), *_train(cfg)))
    assert tracer.spans
    with profile(activities=[ProfilerActivity.CPU]):
        runs.append((_serve(cfg, params), *_train(cfg)))
    assert trace.session_spans()
    (tok0, loss0, p0) = runs[0]
    for tok, loss, p in runs[1:]:
        np.testing.assert_array_equal(tok, tok0)
        assert loss == loss0
        for n in p0:
            assert torch.equal(p[n], p0[n]), n
