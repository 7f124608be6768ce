"""``spans.py`` on planted traces and spans: calls paired with ops past the
pads, ``cu*`` launches inside ``cuda*`` ones counted once, nothing read
where the pairing fails, the four span readers, idle gaps by span; and
the port's own spans read back from a CPU profiler session."""
import numpy as np
import pytest
import torch

from perfbench import harness, layout, spans, testing, trace
from perfbench.spans import SpanRec

def planted(calls, ops, window=(0.0, 20.0), clock=lambda t: t):
    """A trace of ``ops`` and ``calls`` (the window's, on the host's clock),
    the pads' launches around them, counted as ``trace.read`` counts; the
    ops' stamps put on the device's clock by ``clock``."""
    lo, hi = window
    head = [("cudaLaunchKernel", lo - (trace.PAD_HEAD - i) * 1e-6,
             lo - (trace.PAD_HEAD - i) * 1e-6 + 5e-7)
            for i in range(trace.PAD_HEAD)]
    tail = [("cudaLaunchKernel", hi + i * 1e-6, hi + i * 1e-6 + 5e-7)
            for i in range(trace.PAD_TAIL)]
    every = sorted(head + calls + tail, key=lambda c: c[1])
    ran = sum(not n.startswith(("Memcpy", "Memset")) for n, _, _ in ops)
    on_device = sorted(((n, clock(s), clock(e)) for n, s, e in ops),
                       key=lambda o: o[1])
    return trace.Trace(ops=on_device, calls=every,
                       launched=trace._launches(every) - trace.PAD_HEAD
                       - trace.PAD_TAIL, ran=ran,
                       window=(clock(lo), clock(hi)))


def stream(work, latency=1e-5):
    """Launch calls at the given host times and the ops one stream runs
    for them: each ``(call, seconds)`` starts a launch latency after its
    call or when the op before it ends, whichever is later."""
    calls, ops, end = [], [], float("-inf")
    for k, (t, dur) in enumerate(work):
        calls.append(("cudaLaunchKernel", t, t + 2e-6))
        start = max(t + latency, end)
        end = start + dur
        ops.append((f"k{k}", start, end))
    return calls, ops


#: three launches (a ``cu*`` launch inside a ``cuda*`` one, a ``cu*``
#: launch alone) and a copy
CALLS = [("cudaLaunchKernel", 1.0, 1.2), ("cuLaunchKernel", 1.05, 1.1),
         ("cudaMemcpyAsync", 2.0, 2.1), ("cuLaunchKernelEx", 3.0, 3.1),
         ("cudaLaunchKernel", 4.0, 4.1)]
OPS = [("k1", 1.5, 2.5), ("Memcpy HtoD", 2.6, 2.8), ("k2", 3.5, 5.0),
       ("k3", 5.0, 6.0)]


def test_calls_pair_with_ops_past_the_pads():
    tr = planted(CALLS, OPS)
    assert tr.complete
    assert spans.pair_calls(tr) == [1.0, 2.0, 3.0, 4.0]


@pytest.mark.parametrize("clock", [
    lambda t: t - 1e-3 - 3e-4 * t,            # off, drifting down
    lambda t: t + 2e-3 + 1.2e-3 * t,          # off, drifting up fast
    lambda t: t - (5e-3 if t > 1.04 else 0.0),  # a jump of 5 ms
], ids=["drift_down", "drift_up", "jump"])
def test_the_device_clocks_offset_is_held_locally(clock):
    """Device stamps milliseconds off the host's, drifting or jumping: ops
    started on an idle card pair with their calls, while an op 2 x TOL_S
    earlier against its call than its neighbours, or a stretch of ops
    each paired with the next op's call, reads nothing."""
    # 2 ms apart, and a 20 ms wait on the host after the 16th (the jump's)
    work = [(1.0 + 2e-3 * k + (0.02 if k >= 16 else 0.0), 1e-3)
            for k in range(24)]
    calls, ops = stream(work)
    at = [c[1] for c in calls]
    assert spans.pair_calls(planted(calls, ops, clock=clock)) == at
    assert spans.early_s(planted(calls, ops, clock=clock), at) < 1e-6
    early = list(ops)
    n, s0, e0 = ops[9]
    early[9] = (n, s0 - 2 * spans.TOL_S - 1e-5, e0 - 2 * spans.TOL_S)
    assert spans.pair_calls(planted(calls, early, clock=clock)) is None
    # one launch lost inside the stretch and one extra after it: the
    # counts agree, but ops 6-11 pair with their successors' calls
    shifted = calls[:6] + calls[7:12] + [("cudaLaunchKernel", 1.0235,
                                          1.0236)]
    assert spans.pair_calls(planted(shifted, ops, clock=clock)) is None


@pytest.mark.parametrize("fault", ["extra_copy_call", "op_before_call",
                                   "lost_launch"])
def test_a_failed_pairing_reads_nothing(fault):
    calls, ops = list(CALLS), list(OPS)
    if fault == "extra_copy_call":
        calls.append(("cudaMemsetAsync", 7.0, 7.1))
    elif fault == "op_before_call":
        ops[2] = ("k2", 3.0 - 2 * spans.TOL_S, 5.0)
    tr = planted(calls, ops)
    if fault == "lost_launch":
        tr.launched += 1
        assert not tr.complete
    assert spans.pair_calls(tr) is None
    assert spans.place(tr, [SpanRec("s", 0.0, 10.0, -1, {})]) is None


def test_each_op_goes_to_the_innermost_span_open_at_its_call():
    ss = [SpanRec("a", 0.5, 4.5, -1, {}), SpanRec("b", 0.9, 1.3, 0, {}),
          SpanRec("c", 2.5, 3.05, 0, {}), SpanRec("d", 2.6, 2.7, 2, {})]
    placed = spans.place(planted(CALLS, OPS), ss)
    assert placed.owner == [1, 0, 2, 0]
    assert placed.path(2) == "a > c"
    assert spans.innermost(ss, [0.1, 2.65, 4.5, 4.6]) == [-1, 3, 0, -1]


def test_idle_gaps_go_to_the_span_of_the_call_that_ended_them():
    ss = [SpanRec("a", 0.5, 4.5, -1, {}), SpanRec("b", 2.9, 3.2, 0, {})]
    placed = spans.place(planted(CALLS, OPS, window=(0.0, 7.0)), ss)
    gaps = dict(placed.idle_gaps())
    # 0-1.5 before k1 (called in a), 2.8-3.5 before k2 (called in b),
    # 6-7 at the window's end
    assert gaps == pytest.approx({"a": 1.5 + 0.1, "a > b": 0.7,
                                  "(window end)": 1.0})


def _steps_run(monkeypatch, traffic, ss, calls, ops):
    monkeypatch.setattr(spans, "program_spans", lambda: ss)
    monkeypatch.setattr(spans, "_memo", [None, None])
    m = layout.dims(testing.GQA)
    return harness.Run({}, testing.GQA, traffic, m, 20.0,
                       trace=planted(calls, ops))


def _launches(times):
    return [("cudaLaunchKernel", t, t + 0.01) for t in times]


def test_adamw_share_and_roofline(monkeypatch):
    """Two steps: forward 1 s and AdamW 3 s of device time each; the
    span's elements the configuration's param count."""
    n = layout.param_count(layout.dims(testing.GQA))
    ss, t_calls, ops = [], [], []
    for k in range(2):
        base = 10.0 * k
        root = len(ss)
        ss += [SpanRec("train.step", base, base + 9, -1, {"tokens": 64}),
               SpanRec("train.forward", base + 0.1, base + 1, root, {}),
               SpanRec("train.adamw", base + 2, base + 8, root,
                       {"elements": n, "slabs": 1}),
               SpanRec("train.adamw.slab", base + 3, base + 7, root + 2,
                       {"elements": n})]
        t_calls += [base + 0.5, base + 2.5, base + 4]
        ops += [("fwd", base + 0.6, base + 1.6), ("norm", base + 2.6,
                                                  base + 3.6),
                ("upd", base + 4.1, base + 6.1)]
    ops.append(("loss", 9.5, 9.6))
    run = _steps_run(monkeypatch, testing.TRAIN, ss,
                     _launches(t_calls + [9.4]), ops)
    share = harness.reader("adamw_share.train")(run)
    assert share == pytest.approx(100.0 * 3.0 / 4.0)
    assert 0 < share <= 100
    roof = harness.reader("adamw_roofline.train")(run)
    from perfbench import counts
    assert roof == pytest.approx(100.0 * 14 * n / counts.HBM_BYTES / 3.0)
    assert 0 < roof <= 100
    wrong = [sp if sp.name != "train.adamw" else
             SpanRec(sp.name, sp.t0, sp.t1, sp.parent, {"elements": n - 1})
             for sp in ss]
    run = _steps_run(monkeypatch, testing.TRAIN, wrong,
                     _launches(t_calls + [9.4]), ops)
    assert harness.reader("adamw_roofline.train")(run) is None
    assert harness.reader("adamw_share.train")(run) == pytest.approx(75.0)


def test_decode_readers(monkeypatch):
    """A prefill and 20 decode steps of known device intervals, each step
    with 1 ms of attention core in 4 ms of ops, each op on an idle card."""
    ss = [SpanRec("serve.batch", 0.0, 19.0, -1, {}),
          SpanRec("serve.prefill", 0.0, 0.9, 0, {})]
    work = [(0.1, 0.6)]
    lengths = [5e-3 + 1e-4 * i for i in range(20)]
    for i, length in enumerate(lengths):
        t = 1.0 + 0.5 * i
        step = len(ss)
        ss += [SpanRec("serve.decode_step", t, t + 0.4, 0, {"step": i + 1}),
               SpanRec("model.block", t + 0.01, t + 0.3, step, {"layer": 0}),
               SpanRec("model.attention", t + 0.012, t + 0.0172, step + 1,
                       {}),
               SpanRec("model.attention.core", t + 0.0165, t + 0.0171,
                       step + 2, {"route": "cache"})]
        # the projection at t + 0.015, the core 2 ms later, the head
        # ending the step ``length`` after the projection's start
        work += [(t + 0.015, 1.5e-3), (t + 0.017, 1e-3),
                 (t + 0.015 + length - 1.5e-3, 1.5e-3)]
    calls, ops = stream(work)
    run = _steps_run(monkeypatch, testing.CHAT, ss, calls, ops)
    share = harness.reader("decode_attn_share.chat")(run)
    assert share == pytest.approx(100.0 * 1e-3 / 4e-3)
    assert 0 < share <= 100
    p95 = harness.reader("decode_step_p95_ms.chat")(run)
    assert p95 == pytest.approx(np.percentile(np.array(lengths) * 1e3, 95))


def test_readers_read_nothing_without_spans(monkeypatch):
    run = _steps_run(monkeypatch, testing.CHAT, None, CALLS, OPS)
    for name in ("adamw_share.train", "adamw_roofline.train",
                 "decode_attn_share.chat", "decode_step_p95_ms.chat"):
        assert harness.reader(name)(run) is None
    run.trace = None
    monkeypatch.setattr(spans, "program_spans", lambda: [
        SpanRec("train.step", 0.0, 1.0, -1, {})])
    assert harness.reader("adamw_share.train")(run) is None


def test_the_ports_spans_read_back_from_a_profiler_session():
    """A small served batch under a CPU profiler session: the port's spans
    come back in start order, and every softmax the profiler records
    (the attention's: the flash kernel's plain version in the prefill,
    ``grouped_attention`` over the cache in the decode) falls in a
    ``model.attention.core`` span on the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench import port
    from repro_torch.obs import trace as obs_trace
    cfg, tr = testing.GQA, testing.CHAT
    m = layout.dims(cfg)
    arch = port.arch_config(m, cfg, "test")
    from perfbench.weights import draw_all
    params = port.params_from(arch, draw_all(5, m, "cpu", torch.float32))
    engine = port.serve_engine(arch, params, tr["max_batch"],
                               tr["cache_len"], 5)
    rng = np.random.default_rng(0)
    reqs = [port.request(i, rng.integers(0, m.vocab, tr["prompt_len"]),
                         tr["new_tokens"]) for i in range(tr["max_batch"])]
    with obs_trace.activate(None):
        obs_trace.session_spans()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            engine.run_batch(reqs)
        ss = spans.program_spans()
    assert ss[0].name == "serve.batch" and ss[0].parent == -1
    assert [s.t0 for s in ss] == sorted(s.t0 for s in ss)
    steps = [s for s in ss if s.name == "serve.decode_step"]
    assert len(steps) == tr["new_tokens"] - 1
    soft = [ev.start_ns() * 1e-9
            for ev in prof.profiler.kineto_results.events()
            if ev.name() == "aten::softmax"]
    assert len(soft) == m.layers * tr["new_tokens"]
    assert {ss[i].name for i in spans.innermost(ss, soft)} == \
        {"model.attention.core"}
