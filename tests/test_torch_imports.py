"""The port stands alone: no module of ``neuraludf_tpu_torch/``, no script
of the port (``scripts/torch_*``) and not ``chip_smoke.py`` imports JAX or
anything of the JAX package ``neuraludf_tpu`` (the card they run on has
neither)."""

import ast
from pathlib import Path

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
