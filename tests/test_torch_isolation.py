"""The port stands alone: ``dgraph_tpu_torch``, ``chip_smoke.py`` and the
test inputs it imports (``tests/torch_cases.py``) import neither JAX nor
anything of the ``dgraph_tpu`` package."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "dgraph_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "dgraph_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.lineno, node.module.split(".")[0]


def test_static_scan_finds_no_forbidden_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests" / "torch_cases.py"]
    assert len(files) > 20
    bad = [
        f"{f.relative_to(ROOT)}:{line}: {mod}"
        for f in files
        for line, mod in _imported_roots(f)
        if mod in FORBIDDEN
    ]
    assert not bad, bad


def test_importing_every_subpackage_loads_no_jax():
    subpackages = sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], "dgraph_tpu_torch.")
    )
    for m in ("query.engine", "query.joinplan", "ops.kway"):
        assert f"dgraph_tpu_torch.{m}" in subpackages
    code = (
        "import sys, importlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import dgraph_tpu_torch\n"
        f"for m in {subpackages!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'dgraph_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    # -I: isolated mode — no site hooks, no PYTHONPATH, no user site, so
    # nothing outside the port can pull JAX in behind its back
    r = subprocess.run(
        [sys.executable, "-I", "-c", code],
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr
