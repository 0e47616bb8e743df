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


TOOL_MODULES = sorted(f"ravvent_tpu_torch.tools.{p.stem}"
                      for p in (REPO / "ravvent_tpu_torch" / "tools").glob("*.py")
                      if p.stem != "__init__")
USER_TOOLS = ["make_dataset", "train", "evaluate", "train_curriculum", "sweep_epochs",
              "eval_token_acc", "analyse_accuracies", "params_search", "event_max_estimation",
              "fix_invalid_reads", "plots"]
# the bench-side tools (the repo root's tools/{sweep_pipeline,floor_probe,
# bench_scaling,train_profile}.py)
BENCH_TOOLS = ["bench", "sweep_pipeline", "floor_probe", "bench_scaling", "train_profile"]
# the accuracy tools (the repo root's tools/{make_results_table,
# crosscheck_mapper,analyze_beam1_gap,exp_conf_gate}.py)
ACCURACY_TOOLS = ["make_results_table", "crosscheck_mapper", "analyze_beam1_gap",
                  "exp_conf_gate"]


def test_scan_covers_the_tools():
    for name in USER_TOOLS + BENCH_TOOLS + ACCURACY_TOOLS:
        assert REPO / "ravvent_tpu_torch" / "tools" / f"{name}.py" in FILES, name
    for rel in ("evaluation/guppy.py", "utils/shape_checker.py"):
        assert REPO / "ravvent_tpu_torch" / rel in FILES, rel


def test_tools_import_without_matplotlib_or_h5py(monkeypatch):
    """The card's machine has neither: every module of
    ravvent_tpu_torch.tools imports all the same."""
    import importlib
    import sys

    for name in ("matplotlib", "matplotlib.pyplot", "h5py"):
        monkeypatch.setitem(sys.modules, name, None)
    for mod in TOOL_MODULES + ["ravvent_tpu_torch.evaluation.guppy",
                               "ravvent_tpu_torch.utils.shape_checker"]:
        monkeypatch.delitem(sys.modules, mod, raising=False)
        importlib.import_module(mod)
    with pytest.raises(ImportError):
        importlib.import_module("matplotlib")
    assert len(TOOL_MODULES) >= len(USER_TOOLS) + len(BENCH_TOOLS) + len(ACCURACY_TOOLS) + 3
    for name in ACCURACY_TOOLS:
        assert f"ravvent_tpu_torch.tools.{name}" in TOOL_MODULES, name
