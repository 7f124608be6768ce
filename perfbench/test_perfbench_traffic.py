"""The traffic generator: the same seed gives the same inputs, every seed
the same sizes and arrivals, and a run's batches all differ."""
import numpy as np

from perfbench import testing, traffic

BIG = 2**31 + 12345


def test_prompts_repeat_for_a_seed_and_differ_across_seeds():
    tr = testing.CHAT
    a = traffic.prompts(tr, BIG, 0, 512)
    assert a.shape == (tr["max_batch"], tr["prompt_len"])
    assert np.array_equal(a, traffic.prompts(tr, BIG, 0, 512))
    assert not np.array_equal(a, traffic.prompts(tr, BIG + 1, 0, 512))
    assert not np.array_equal(a, traffic.prompts(tr, BIG, 1, 512))
    assert a.min() >= 0 and a.max() < 512


def test_arrivals_are_the_same_for_every_seed():
    """Every seed sends batches of the same sizes; only the tokens
    differ."""
    tr = testing.PREFILL
    for k in range(3):
        a, b = traffic.prompts(tr, BIG, k, 512), traffic.prompts(tr, 7, k, 512)
        assert a.shape == b.shape == (tr["max_batch"], tr["prompt_len"])
        assert not np.array_equal(a, b)


def test_backlog_is_due_at_the_start(monkeypatch):
    """A closed loop: each batch is sent when the last returns, the first
    at the window's start, none after its end, and a request's time to
    first token runs from its batch's call (an engine that takes 20 ms a
    batch stands in for the port's)."""
    import time
    from types import SimpleNamespace
    from perfbench import port, serve_cell

    class Engine:
        def run_batch(self, reqs):
            time.sleep(0.02)
            return [SimpleNamespace(tokens=np.zeros(1, np.int32),
                                    prefill_ms=20.0, decode_ms=0.0)
                    for _ in reqs]
    monkeypatch.setattr(port, "serve_engine", lambda *a: Engine())
    got = serve_cell.run("cmdr-prefill", testing.files("cmdr-prefill"), BIG,
                         0.2, False, "cpu", time.perf_counter())["run"]
    calls = [b["call_s"] for b in got.batches]
    rets = [b["return_s"] for b in got.batches]
    assert len(calls) >= 3 and calls[0] < 0.02 and calls[-1] < 0.2
    assert all(c >= r_ for c, r_ in zip(calls[1:], rets))
    assert [b["ids"][0] for b in got.batches] == \
        [16 * k for k in range(len(calls))]
    ttft = serve_cell.serve_metrics(got.batches)["ttft_p95_ms"]
    assert 20.0 <= ttft <= 1e3 * max(r_ - c for c, r_ in zip(calls, rets))


def test_warmup_seconds_are_set_up(monkeypatch):
    """The traffic's ``warmup_seconds`` of warm-up batches run before the
    window and count in ``setup_s``; without the key one batch warms up."""
    import time
    from types import SimpleNamespace
    from perfbench import port, serve_cell

    calls = []

    class Engine:
        def run_batch(self, reqs):
            calls.append((time.perf_counter(), reqs[0].request_id))
            time.sleep(0.01)
            return [SimpleNamespace(tokens=np.zeros(1, np.int32),
                                    prefill_ms=10.0, decode_ms=0.0)
                    for _ in reqs]
    monkeypatch.setattr(port, "serve_engine", lambda *a: Engine())
    for warmup, least in ((None, 1), (0.1, 5)):
        files = testing.files("cmdr-prefill")
        if warmup is not None:
            files["traffic"]["warmup_seconds"] = warmup
        calls.clear()
        t0 = time.perf_counter()
        got = serve_cell.run("cmdr-prefill", files, BIG, 0.05, False, "cpu",
                             t0)
        warm = [t for t, rid in calls if rid < 0]
        window = [t for t, rid in calls if rid >= 0]
        assert len(warm) >= least and (warmup is not None or len(warm) == 1)
        assert max(warm) < min(window)
        assert got["e2e"]["setup_s"] >= (warmup or 0.0)


def test_training_batches_repeat_and_differ_step_to_step():
    tr = testing.TRAIN
    a = traffic.train_batch(tr, BIG, 0, 512)
    assert a.shape == (tr["batch"], tr["seq_len"])
    assert np.array_equal(a, traffic.train_batch(tr, BIG, 0, 512))
    assert not np.array_equal(a, traffic.train_batch(tr, BIG, 1, 512))
    warm = traffic.prompts(testing.CHAT, BIG, traffic.WARMUP, 512)
    assert not np.array_equal(warm, traffic.prompts(testing.CHAT, BIG, 0,
                                                    512))


def test_a_sample_of_requests_is_judged():
    """judge_requests rows of a judged batch, drawn from the seed; a
    mixture of experts is judged whole."""
    import pytest
    from perfbench import layout, serve_cell
    tr = dict(testing.CHAT, judge_requests=2)
    m = layout.dims(testing.GQA)
    rows = serve_cell.judged_rows(m, tr, BIG, 0)
    assert len(rows) == 2 and list(rows) == sorted(set(rows.tolist()))
    assert np.array_equal(rows, serve_cell.judged_rows(m, tr, BIG, 0))
    assert list(serve_cell.judged_rows(m, testing.CHAT, BIG, 0)) == \
        list(range(testing.CHAT["max_batch"]))
    with pytest.raises(ValueError):
        serve_cell.judged_rows(layout.dims(testing.MLA_MOE), tr, BIG, 0)
    r = testing.run("cmdr-chat", seed=BIG, limits={
        "token_gap": {"limit": 1e-3}}, traffic=tr)
    assert r["correct"] and r["readings"]["tokens_judged"] == \
        2 * tr["new_tokens"]

