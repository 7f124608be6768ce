"""The port stands alone: importing every module of ``repro_torch`` loads
neither jax nor any module of the JAX package ``repro`` (nor
``torch.testing._internal.distributed``, whose fake process group the
dry run loads only when it plans), and no source of
the port, ``chip_smoke.py`` or the port's timing scripts imports either;
``repro_torch.sim`` exports
what ``repro.sim`` does."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_repro():
    mods = list(_port_modules())
    for name in ("repro_torch.kernels.pricing",
                 "repro_torch.kernels.rmsnorm",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.ops",
                 "repro_torch.configs", "repro_torch.configs.gemma_7b",
                 "repro_torch.models.layers", "repro_torch.models.attention",
                 "repro_torch.models.moe", "repro_torch.models.ssm",
                 "repro_torch.models.encdec",
                 "repro_torch.models.blocks", "repro_torch.models.lm",
                 "repro_torch.models.api", "repro_torch.serve.engine",
                 "repro_torch.launch.serve", "repro_torch.convert",
                 "repro_torch.sim", "repro_torch.sim.engine",
                 "repro_torch.core.baselines", "repro_torch.core._reference",
                 "repro_torch.launch.sim", "repro_torch.sim.faults",
                 "repro_torch.sim.service", "repro_torch.parallel",
                 "repro_torch.parallel.sharding",
                 "repro_torch.parallel.context", "repro_torch.roofline",
                 "repro_torch.roofline.analysis", "repro_torch.launch.mesh",
                 "repro_torch.launch.dryrun", "repro_torch.launch.train",
                 "repro_torch.launch.cluster"):
        assert name in mods, name
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'repro' or m.startswith('repro.')"
        " or m.startswith('torch.testing._internal.distributed'))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "offer_kernels_ab.py",
        ROOT / "scripts" / "rmsnorm_bwd_ab.py",
        ROOT / "scripts" / "flash_ab.py",
        ROOT / "scripts" / "profiler_sessions.py"]
    offenders = [(str(p.relative_to(ROOT)), name) for p in files
                 for name in _imported_roots(p)
                 if name in ("jax", "jaxlib", "repro")]
    assert offenders == []


def test_sim_alone_loads_no_jax_and_exports_what_repro_sim_does():
    code = (
        "import sys, repro_torch.sim as s\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(repr(bad))\n"
        "print(repr(sorted(s.__all__)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    bad, names = out.stdout.strip().splitlines()[-2:]
    assert bad == "[]"
    import repro.sim
    assert ast.literal_eval(names) == sorted(repro.sim.__all__)
