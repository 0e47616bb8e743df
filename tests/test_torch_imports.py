"""The port stands alone: nothing under ravvent_tpu_torch/, nor chip_smoke.py,
imports JAX, its libraries or the JAX package ravvent_tpu."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ravvent_tpu"}
FILES = sorted((REPO / "ravvent_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_found():
    assert len(FILES) > 20
    assert (REPO / "ravvent_tpu_torch" / "models" / "rnn.py") in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = sorted(set(imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_checker_sees_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom ravvent_tpu.models import rnn\nimport ravvent_tpu_torch\n")
    assert set(imported_roots(p)) & FORBIDDEN == {"ravvent_tpu"}
