"""The port stands alone: no file of ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or anything of ``repro``, and importing
every module of the port leaves ``jax`` out of ``sys.modules``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("package", ["dist", "launch"])
def test_distribution_packages_are_covered(package):
    """The distribution packages (the stand-ins for ``repro.dist`` and
    ``repro.launch.mesh``) are among the files held above, and import
    ``torch.distributed``, never JAX's sharding."""
    files = [p for p in FILES if p.parent == PORT / package]
    assert {p.name for p in files} >= (
        {"__init__.py", "mesh.py", "cells.py", "dryrun.py", "roofline.py",
         "report.py"} if package == "launch" else {"__init__.py", "api.py"})
    roots = set()
    for p in files:
        roots |= set(_imported_roots(p))
    assert not roots & set(FORBIDDEN), roots
    assert "torch" in roots or package == "launch"


def test_importing_the_port_leaves_jax_unloaded():
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(mods) >= 20
    assert {"repro_torch.dist.api", "repro_torch.dist.collectives",
            "repro_torch.launch.mesh", "repro_torch.launch.cells",
            "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
            "repro_torch.launch.report"} <= set(mods)
