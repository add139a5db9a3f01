"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program. Top-level names are compared whole: the
port's name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import launcher, spec

HERE = Path(__file__).resolve().parents[1]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "monte_carlo_retirement_tpu_torch_x", sys)
    found = launcher.forbidden_modules()
    assert "monte_carlo_retirement_tpu_torch_x" not in found
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in launcher.forbidden_modules()


def test_the_run_and_the_server_load_no_jax():
    code = (
        "import sys, torch\n"
        "import benchmark.run, benchmark.control, benchmark.opcount\n"
        "from benchmark import launcher\n"
        "launcher.install_spans(launcher.Tracer())\n"
        "launcher.build_app('cpu', True, None)\n"
        "for m in [w['name'] for w in benchmark.spec.benchmark()['per_layer']]:\n"
        "    benchmark.spec.reader(m)\n"
        "print(launcher.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in ("torch", "numpy", "math", "typing", "__future__"), (path, name)
