"""One run of one cell of the benchmark, printed as one JSON line.

``main`` reads ``BENCHMARK.json``, the cell's configuration file
(``configs/<config>.json`` as the entry names it), its traffic file
(``traffic/<traffic>.json``) and its limits (``limits/<cell>.json``),
checks for the cards the cell asks for, and hands them to the module of
the traffic's kind (``serve_cell`` or ``train_cell``). With ``--trace 0``
the line's metrics are the cell's end-to-end metrics; with ``--trace 1``
its per-layer metrics, each read by ``metrics/<name>.py`` from the run's
records and device trace. Every run judges what its measured window
produced against the plain reference (``judge``), and prints each number
compared beside its limit, last, on standard error and in the line.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


def cell_files(spec: Dict, workload: str) -> Dict:
    """The cell's entry, configuration, traffic and limits by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"cells: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return {"cell": cell, "config": cfg, "traffic": traffic,
            "limits": limits}


def metrics_of(spec: Dict, workload: str, trace: bool) -> List[Dict]:
    """The metric entries a run of ``workload`` reports: with ``trace``
    the per-layer metrics that list it (or, listing no cells, move an
    end-to-end metric it reports), else its end-to-end metrics."""
    def has(entry: Dict) -> bool:
        return "workloads" not in entry or workload in entry["workloads"]
    e2e = [m for m in spec["end_to_end"] if has(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def listed(entry: Dict) -> bool:
        if "workloads" in entry:
            return workload in entry["workloads"]
        return entry["moves"] in names
    return [m for m in spec["per_layer"] if listed(m)]


def reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What a run hands the per-layer readers: the cell, its sizes, the
    window's records and, in a traced run, the device trace."""
    cell: Dict
    cfg: Dict
    traffic: Dict
    m: object                    # layout.Dims
    window_s: float
    batches: List[Dict] = field(default_factory=list)   # serving
    steps: List[Dict] = field(default_factory=list)     # training
    trace: Optional[object] = None                      # trace.Trace


def forbidden_modules(names=None) -> List[str]:
    """The top-level names of ``names`` (default: the loaded modules)
    that are forbidden, each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def set_env() -> None:
    """Fixed cache directories inside the checkout, and no JAX through a
    library that would load it by itself."""
    cache = ROOT / ".perfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def device_info(torch, device: str, chips: int) -> Dict:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def free_device(torch, device: str) -> None:
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(name: str, files: Dict, spec: Dict, seed: int, seconds: float,
             trace: bool, device: str, t_start: float) -> Dict:
    """One run of the cell on ``device``: the result as a dict (``checks``
    last)."""
    from . import serve_cell, train_cell
    kind = {"serve": serve_cell, "train": train_cell}[
        files["traffic"]["kind"]]
    out = kind.run(name, files, seed, seconds, trace, device, t_start)
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": {}, "device": out["device"]}
    for entry in metrics_of(spec, name, trace):
        if not trace:
            value = out["e2e"][entry["name"]]
        else:
            value = reader(entry["name"])(out["run"])
        if value is not None and math.isfinite(value):
            result["metrics"][entry["name"]] = {"value": value,
                                               "unit": entry["unit"]}
    if trace and out["run"].trace is not None:
        tr = out["run"].trace
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.by_name(10),
                               "idle_gaps": tr.idle_gaps(10)}
    result["readings"] = out.get("readings", {})
    result["sides"] = out.get("sides", {})
    result["checks"] = out["checks"]
    return result


def check_lines(result: Dict) -> List[str]:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r} "
            f"({'ok' if v['ok'] else 'FAILED'})"
            for k, v in result["checks"].items()]


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_env()
    spec = load_json(ROOT / "BENCHMARK.json")
    files = cell_files(spec, args.workload)
    try:
        import repro_torch  # noqa: F401  (the system under test)
    except ImportError as exc:
        print(f"the port is not importable from {ROOT / 'src'}: {exc}",
              file=sys.stderr)
        return 3
    import torch
    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, files, spec, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that no run may hold: {bad}", file=sys.stderr)
        return 4
    print(f"readings {json.dumps(result['readings'])}", file=sys.stderr)
    for line in check_lines(result):
        print(line, file=sys.stderr)
    sys.stdout.write(json.dumps(result_line(result)) + "\n")
    sys.stdout.flush()
    return 0


def result_line(result: Dict) -> Dict:
    """The printed line: its fixed keys, ``checks`` last with each
    number compared and its limit."""
    out = {k: v for k, v in result.items()
           if k not in ("readings", "sides", "checks")}
    out["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                     for k, v in result["checks"].items()}
    return out
