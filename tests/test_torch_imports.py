"""The PyTorch port stands alone: no module of ``src/repro_torch`` and
nothing in ``chip_smoke.py`` imports JAX or the JAX package, and importing
the serving facade loads neither."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_files_found():
    assert len(PORT_FILES) > 30


def test_serving_import_loads_no_jax():
    code = ("import sys, repro_torch.serving.api, repro_torch.bridge, "
            "repro_torch.launch.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
