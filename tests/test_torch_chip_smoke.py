"""``chip_smoke.py``'s rmsnorm launch plan held to the port on the CPU.

The card run splits a profiled serve's rmsnorm device time by phase and
launch shape from the order ``norm_plan`` gives, and holds its launches
to ``expected_launches``. Here one served batch of each family's reduced
config runs through the same servers on the CPU, every norm's (rows,
width) recorded in call order, and the record must be the plan, launch
for launch (QK-norm's and MLA's rows of their own width among them).
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get_config
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # its dataclass looks itself up
    spec.loader.exec_module(mod)
    return mod


#: a served batch of two requests; image embeddings and frames where the
#: family's server takes them
POINT = dict(requests=2, max_batch=2, prompt_len=8, max_new=3, seed=0)
ARCHS = {
    "gemma-7b": {}, "qwen3-32b": {}, "command-r-plus-104b": {},
    "phi3.5-moe-42b-a6.6b": {}, "minicpm3-4b": {}, "deepseek-v2-236b": {},
    "llava-next-mistral-7b": {"images": 4}, "mamba2-780m": {},
    "hymba-1.5b": {}, "seamless-m4t-medium": {"frames": 6},
}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_norm_plan_is_the_served_batchs_norms(monkeypatch, cs, arch):
    p = dict(POINT, arch=arch, **ARCHS[arch])
    cfg = get_config(arch, reduced=True)
    params = build_model(cfg).init(0, "cpu")
    key, _ = cs._frontend_key(p)
    if key:
        engine = cs._frontend_server(key)(cfg, params,
                                          max_batch=p["max_batch"],
                                          cache_len=cs._cache_len(p))
        reqs = cs._frontend_requests(cfg, p)
    else:
        engine = ServeEngine(cfg, params, max_batch=p["max_batch"],
                             cache_len=cs._cache_len(p))
        reqs = cs._requests(Request, cfg.vocab_size, p["requests"],
                            p["prompt_len"], p["max_new"], p["seed"])
    seen = []
    plain = rn.rmsnorm_torch

    def record(x, scale, *args, **kw):
        seen.append(tuple(x.shape))
        return plain(x, scale, *args, **kw)

    monkeypatch.setattr(rn, "rmsnorm_torch", record)
    engine.serve(reqs)
    plan = cs.norm_plan(cfg, p)
    assert seen == [(rows, width) for _, rows, width in plan]
    assert len(plan) == cs.expected_launches(cfg, 1, p["max_new"])["rmsnorm"]
