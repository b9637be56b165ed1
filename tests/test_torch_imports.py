"""The port stands alone: no module of ``neuraludf_tpu_torch/``, no script
of the port (``scripts/torch_*``) and not ``chip_smoke.py`` imports JAX or
anything of the JAX package ``neuraludf_tpu`` (the card they run on has
neither)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "neuraludf_tpu")


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = (sorted((ROOT / "neuraludf_tpu_torch").rglob("*.py"))
             + sorted((ROOT / "scripts").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])
    assert len(files) > 40
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


NEW_IN_THE_LAST_SLICE = ("neuraludf_tpu_torch/data/jpeg.py",
                         "neuraludf_tpu_torch/eval/eval_deepfashion.py",
                         "scripts/torch_benchmark_lobed.py",
                         "scripts/torch_benchmark_garment.py",
                         "scripts/torch_protocol.py",
                         "scripts/torch_garment_lift.py",
                         "scripts/torch_make_bmvs_fixture.py")


@pytest.mark.parametrize("rel", NEW_IN_THE_LAST_SLICE)
def test_entry_point_imports_nothing_of_jax(rel):
    """The file names no JAX module, and importing it in a fresh interpreter
    loads none (its imports are read, not guessed from its text)."""
    path = ROOT / rel
    assert [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN] == []
    module = rel[:-3].replace("/", ".") if rel.startswith("neuraludf") else Path(rel).stem
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'scripts')!r}]; "
            f"import {module}; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"
