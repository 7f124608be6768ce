"""AdamW's routes and the host side of its kernels (``kernels.adamw``), on
the CPU: the route picked from the tensors alone, the build flags that
keep the update's rounding that of the plain route, and refusals before
any launch. The kernels themselves, and their bits against the plain
route, run in ``tests/test_torch_cuda.py``."""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import adamw as kadamw
from repro_torch.obs import trace
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import adamw as adamw_mod

BF16, F32 = torch.bfloat16, torch.float32


def _state(dtype=F32, fp32_moments=False, device="cpu"):
    shapes = {"a": (13, 17), "b": (5,), "c": ()}
    gen = torch.Generator().manual_seed(0)
    params = {n: torch.randn(s, generator=gen).to(dtype).to(device)
              for n, s in shapes.items()}
    grads = {n: (torch.randn(s, generator=gen) * 0.5).to(dtype).to(device)
             for n, s in shapes.items()}
    cfg = AdamWConfig(fp32_moments=fp32_moments)
    return params, grads, adamw_init(params, cfg), cfg


def test_sources_name_adamw_with_exact_rounding():
    """The update is held bit for bit to the plain route: no contracted
    multiply-adds, IEEE division and sqrt."""
    flags = _build.SOURCES["adamw"]
    assert "--fmad=false" in flags
    assert "--prec-div=true" in flags and "--prec-sqrt=true" in flags
    assert (_build.CSRC / "adamw.cu").is_file()


def test_a_cpu_step_launches_nothing_and_takes_the_plain_route():
    params, grads, state, cfg = _state()
    launches = kadamw.LAUNCHES
    tracer = trace.Tracer()
    with trace.activate(tracer):
        adamw_update(params, grads, state, cfg)
    assert kadamw.LAUNCHES == launches
    (opt,) = [sp for sp in tracer.spans if sp.name == "train.adamw"]
    n = sum(p.numel() for p in params.values())
    assert opt.attrs == {"route": "plain", "elements": n, "slabs": 3}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_route_is_plain_off_the_card(device):
    params, grads, state, _ = _state(device=device)
    assert adamw_mod.route(params, grads, state) == "plain"


@pytest.mark.parametrize("dtype,fp32_moments", [
    (BF16, False), (BF16, True), (F32, True), (F32, False)])
def test_route_is_the_kernels_where_they_take_the_dtypes(
        monkeypatch, dtype, fp32_moments):
    """Tensors the route takes for card tensors (``_plain`` patched to
    say none is plain) go to the kernels; on these CPU tensors the
    kernels then refuse them, before any launch: nothing falls back."""
    monkeypatch.setattr(adamw_mod, "_plain", lambda t: False)
    params, grads, state, cfg = _state(dtype, fp32_moments)
    assert adamw_mod.route(params, grads, state) == "kernel"
    launches = kadamw.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        adamw_update(params, grads, state, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        adamw_mod.global_norm(grads)
    assert kadamw.LAUNCHES == launches


@pytest.mark.parametrize("case", ["float16", "grad_dtype", "moment_dtypes",
                                  "mixed_devices"])
def test_route_refuses_what_the_kernels_do_not_take(monkeypatch, case):
    monkeypatch.setattr(adamw_mod, "_plain",
                        lambda t: t.device.type == "meta")
    params, grads, state, cfg = _state(torch.float16 if case == "float16"
                                       else BF16)
    if case == "grad_dtype":
        grads["a"] = grads["a"].float()
    elif case == "moment_dtypes":
        state["v"]["b"] = state["v"]["b"].float()
    elif case == "mixed_devices":
        grads["b"] = grads["b"].to("meta")
    with pytest.raises(ValueError):
        adamw_mod.route(params, grads, state)
    with pytest.raises(ValueError):
        adamw_update(params, grads, state, cfg)


@pytest.mark.parametrize("p,g,m,v,ok", [
    (BF16, BF16, BF16, BF16, True),
    (BF16, BF16, F32, F32, True),
    (F32, F32, F32, F32, True),
    (F32, F32, BF16, BF16, False),
    (BF16, F32, BF16, BF16, False),
    (BF16, BF16, BF16, F32, False),
    (torch.float16, torch.float16, torch.float16, torch.float16, False),
    (torch.float64, torch.float64, torch.float64, torch.float64, False),
])
def test_supported_dtypes(p, g, m, v, ok):
    assert kadamw.supported(p, g, m, v) is ok


def test_wrappers_refuse_cpu_tensors_before_any_launch(monkeypatch):
    def no_entry(*a, **k):
        raise AssertionError("no kernel may be resolved")

    monkeypatch.setattr(_build, "entry", no_entry)
    t = torch.zeros(16)
    s = torch.ones(())
    launches = kadamw.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        kadamw.adamw_cuda(t, t, t, t, s, s, s, s, 0.9, 0.95, 1e-8, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        kadamw.global_norm_cuda([t])
    with pytest.raises(ValueError, match="gradient"):
        kadamw.global_norm_cuda([])
    assert kadamw.LAUNCHES == launches
