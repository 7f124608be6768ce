"""Test-suite bootstrap.

The container image does not ship ``hypothesis`` and nothing may be pip
installed (see ROADMAP constraints), yet seven test modules use
``@given``-style property tests. When the real library is importable we use
it untouched; otherwise we register a minimal, deterministic stand-in under
``sys.modules["hypothesis"]`` *before* test modules are collected.

The stand-in covers exactly the API surface this repo uses:
    given, settings(max_examples=, deadline=), HealthCheck,
    strategies.integers / floats / sampled_from
Each ``@given`` test is executed ``max_examples`` times with samples drawn
from a seed derived from the test's qualified name (stable across runs), and
the first draws are the strategy's boundary values so the classic edge cases
are always exercised.
"""
from __future__ import annotations

import functools
import inspect
import sys
import types
import zlib


def _install_hypothesis_stub() -> None:
    try:
        import hypothesis  # noqa: F401  (real library wins when present)
        return
    except ImportError:
        pass

    import numpy as np

    class _Strategy:
        def __init__(self, boundary, sample):
            self.boundary = list(boundary)  # always-tried edge cases
            self.sample = sample            # rng -> value

    def integers(min_value, max_value):
        return _Strategy(
            [min_value, max_value],
            lambda rng: int(rng.integers(min_value, max_value + 1)),
        )

    def floats(min_value, max_value, **_kw):
        return _Strategy(
            [min_value, max_value],
            lambda rng: float(rng.uniform(min_value, max_value)),
        )

    def sampled_from(elements):
        elements = list(elements)
        return _Strategy(
            elements[:1],
            lambda rng: elements[int(rng.integers(0, len(elements)))],
        )

    _DEFAULTS = {"max_examples": 25}

    def settings(**kw):
        def deco(fn):
            fn._stub_settings = {**_DEFAULTS, **kw}
            return fn
        return deco

    def given(*strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                cfg = {**_DEFAULTS, **getattr(wrapper, "_stub_settings", {})}
                n = int(cfg.get("max_examples") or _DEFAULTS["max_examples"])
                seed = zlib.crc32(
                    f"{fn.__module__}.{fn.__qualname__}".encode()
                )
                rng = np.random.default_rng(seed)
                cases = []
                width = max(len(s.boundary) for s in strategies)
                for i in range(width):  # boundary combinations first
                    cases.append(tuple(
                        s.boundary[min(i, len(s.boundary) - 1)]
                        for s in strategies
                    ))
                while len(cases) < n:
                    cases.append(tuple(s.sample(rng) for s in strategies))
                for case in cases[:n]:
                    fn(*args, *case, **kwargs)

            # pytest must not see the strategy-filled parameters (it would
            # try to resolve them as fixtures): expose a stripped signature
            # and drop the __wrapped__ breadcrumb functools.wraps left.
            sig = inspect.signature(fn)
            params = list(sig.parameters.values())
            kept = params[: len(params) - len(strategies)]
            wrapper.__signature__ = sig.replace(parameters=kept)
            if hasattr(wrapper, "__wrapped__"):
                del wrapper.__wrapped__
            return wrapper
        return deco

    mod = types.ModuleType("hypothesis")
    mod.given = given
    mod.settings = settings
    mod.assume = lambda cond: None if cond else (_ for _ in ()).throw(
        _Unsatisfied()
    )
    mod.HealthCheck = types.SimpleNamespace(
        too_slow=None, filter_too_much=None, data_too_large=None
    )
    strategies_mod = types.ModuleType("hypothesis.strategies")
    strategies_mod.integers = integers
    strategies_mod.floats = floats
    strategies_mod.sampled_from = sampled_from
    mod.strategies = strategies_mod
    mod.__stub__ = True
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = strategies_mod


class _Unsatisfied(Exception):
    """Raised by the stub's assume(); tests here never hit it."""


_install_hypothesis_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped where there is none")
