"""The result line's keys, the refusals without a card or without the
port, and BENCHMARK.json's shape."""
import json
import os
import re
import shutil
import subprocess
import sys

from perfbench import harness, testing

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_line_has_exactly_its_keys():
    line = harness.result_line(testing.run("cmdr-chat"))
    assert list(line) == KEYS
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {"serve_tokens_per_s", "setup_s"}
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(line)


def _run(cwd, env):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "cmdr-chat",
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(harness.ROOT, env)
    assert p.returncode != 0 and p.stdout == ""


def test_alone_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run(tmp_path, env)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_json_shape():
    spec = testing.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["perfbench"]
    assert 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        names.add(c["name"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert set(e2e) == {"serve_tokens_per_s", "ttft_p95_ms",
                        "train_tokens_per_s", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (harness.HERE / "limits" / f"{w['name']}.json").exists()
        reported = {m["name"] for m in harness.metrics_of(spec, w["name"],
                                                          False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.metrics_of(spec, w["name"], True)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in
                                  harness.metrics_of(spec, w, False)}
