"""No run holds a module named jax, jaxlib, flax or repro (compared by the
whole top-level name: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""
import ast
import subprocess
import sys

from perfbench import harness

REFERENCE = ("reference.py", "reference_train.py", "layout.py", "weights.py",
             "judge.py", "counts.py")


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_port():
    for name in REFERENCE:
        assert not _top_level_imports(harness.HERE / name) & {
            "repro_torch", "repro", "jax", "jaxlib", "flax"}, name


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for path in harness.HERE.rglob("*.py"):
        assert not _top_level_imports(path) & {"repro", "jax", "jaxlib",
                                               "flax"}, path


def test_a_run_holds_no_forbidden_module():
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from perfbench import testing, harness, judge, reference;"
        "r = testing.run('dsv2-chat');"
        "assert r['correct'];"
        "bad = harness.forbidden_modules();"
        "held = {m.split('.')[0] for m in sys.modules};"
        "assert not bad, bad;"
        "assert 'repro_torch' in held and 'repro' not in held;"
        "print('ok')")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip().endswith("ok"), p.stderr


def test_forbidden_names_are_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models",
                                      "reprox", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.sub", "jax.numpy", "flax",
                                      "jaxlib.xla"]) == ["flax", "jax",
                                                         "jaxlib", "repro"]
