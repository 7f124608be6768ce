"""End-to-end metrics over all the work and time of a window, and the
per-layer readers' arithmetic on planted records."""
import numpy as np
import pytest

from perfbench import harness, layout, readers, serve_cell, testing, trace


def batches(returns, per_batch=4, new=8, calls=None):
    out = []
    for i, r in enumerate(returns):
        out.append({"ids": list(range(per_batch)),
                    "tokens": np.zeros((per_batch, new), np.int32),
                    "call_s": calls[i] if calls else 0.0,
                    "return_s": r})
    return out


def test_a_planted_stall_lowers_the_rate():
    even = serve_cell.serve_metrics(batches([1.0, 2.0, 3.0, 4.0]))
    stalled = serve_cell.serve_metrics(batches([1.0, 2.0, 3.5, 4.5]))
    assert even["serve_tokens_per_s"] == 4 * 4 * 8 / 4.0
    assert stalled["serve_tokens_per_s"] < even["serve_tokens_per_s"]


def test_p95_is_over_every_request():
    calls = [0.5 * i for i in range(50)]
    rets = [0.5 * i + 0.1 for i in range(50)]
    rets[10] += 1.0               # one slow batch: 4 of 200 requests
    rets[20] += 1.0
    rets[30] += 1.0               # 12 of 200, over 5 %
    got = serve_cell.serve_metrics(batches(rets, calls=calls))["ttft_p95_ms"]
    every = [(r - c) * 1e3 for r, c in zip(rets, calls) for _ in range(4)]
    assert len(every) == 200
    assert got == pytest.approx(np.percentile(every, 95))
    assert got > 1000.0


def fake_trace(ops, window=(0.0, 10.0)):
    return trace.Trace(ops=sorted(ops, key=lambda o: o[1]), calls=[],
                       launched=len(ops), ran=len(ops), window=window)


def test_busy_is_the_union_of_intervals():
    tr = fake_trace([("a", 1.0, 3.0), ("b", 2.0, 4.0), ("c", 6.0, 7.0),
                     ("Memcpy", 8.0, 8.5)])
    assert tr.busy_s() == pytest.approx(3.0 + 1.0 + 0.5)
    run = harness.Run({}, {}, {}, None, 10.0, trace=tr)
    assert readers.idle_pct(run) == pytest.approx(55.0)
    gaps = dict(tr.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(5.5)


def test_readers_read_nothing_without_a_whole_trace():
    run = harness.Run({}, {}, testing.PREFILL, None, 10.0)
    assert readers.idle_pct(run) is None
    assert readers.kernel_times(run, "rmsnorm_kernel") == []
    lost = fake_trace([("x", 1.0, 2.0)])
    lost.launched += 1
    run.trace = lost
    assert readers.idle_pct(run) is None
    assert harness.reader("flash_roofline.prefill")(run) is None


def test_rmsnorm_share_matches_launches_to_the_plan():
    """QK-norm's launches on each head's rows lie between a layer's two
    norms: only the launches at (B S, d) are read."""
    m = layout.dims(testing.GQA)
    assert m.qk_norm
    tr = dict(testing.PREFILL)
    run = harness.Run({}, {}, tr, m, 1.0,
                      batches=[{"ids": [0, 1, 2, 3]}] * 2)
    plan = readers.norm_launches(run)
    rows = 4 * tr["prompt_len"]
    assert plan[:4] == [(rows, m.d), (rows * m.heads, m.head_dim),
                        (rows * m.kv_heads, m.head_dim), (rows, m.d)]
    assert len(plan) == 2 * (4 * m.layers + 1) and plan[-1] == (4, m.d)
    ops, t = [], 0.0
    for shape in plan:
        dur = 1e-3 if shape == (rows, m.d) else 1e-6
        ops.append(("void rmsnorm_kernel<float>", t, t + dur))
        t += 0.01
    run.trace = fake_trace(ops, (0.0, t))
    from perfbench import counts
    want = 100 * counts.rmsnorm_bytes(rows, m.d) / counts.HBM_BYTES / 1e-3
    assert readers.rmsnorm_share(run, rows) == pytest.approx(want)
    run.trace = fake_trace(ops[:-1], (0.0, t))
    assert readers.rmsnorm_share(run, rows) is None
    assert readers.share_pct(0.0, 1.0) is None


def test_training_norm_plan_and_backward_pairs():
    """A training step's forward norms, final norm and remat's second
    forward; the backward's wide calls paired with their column pass."""
    m = layout.dims(testing.GQA)
    tr = dict(testing.TRAIN)
    N = tr["batch"] * tr["seq_len"]
    run = harness.Run({}, {}, tr, m, 1.0, steps=[{}] * 2)
    plan = readers.norm_launches(run)
    assert len(plan) == 2 * (8 * m.layers + 1)
    assert plan.count((N, m.d)) == 2 * (4 * m.layers + 1)
    ops, t = [], 0.0
    for _ in range(2 * (2 * m.layers + 1)):
        ops.append(("void rmsnorm_bwd_wide<bf16, 8, 2, true>", t, t + 3e-3))
        ops.append(("rmsnorm_bwd_cols", t + 3e-3, t + 4e-3))
        ops.append(("void rmsnorm_bwd_narrow<bf16, 8>", t + 5e-3, t + 6e-3))
        ops.append(("rmsnorm_bwd_cols", t + 6e-3, t + 6.5e-3))
        t += 0.01
    run.trace = fake_trace(ops, (0.0, t))
    pairs = readers.rmsnorm_bwd_pairs(run, "rmsnorm_bwd_wide")
    assert pairs == pytest.approx([4e-3] * (2 * (2 * m.layers + 1)))
    from perfbench import counts
    want = 100 * counts.rmsnorm_bwd_bytes(N, m.d) / counts.HBM_BYTES / 4e-3
    got = harness.reader("rmsnorm_bwd_roofline.train")(run)
    assert got == pytest.approx(want)
    run.trace = fake_trace(ops[:-1], (0.0, t))
    assert readers.rmsnorm_bwd_pairs(run, "rmsnorm_bwd_wide") == []


def test_every_per_layer_metric_has_its_reader():
    spec = testing.spec()
    for entry in spec["per_layer"]:
        assert callable(harness.reader(entry["name"]))
