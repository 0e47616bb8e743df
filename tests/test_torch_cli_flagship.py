"""The port's evaluate-side CLIs on the trained flagship against the JAX
package's, on the CPU, each called in process through ``main``:
``checkpoints/flagship``'s Orbax parameters for the JAX tools, the same
through ``from_jax_params`` into an npz for the port's, over 2 reads that
ravvent_tpu_torch/tools/make_dataset.py builds.

- ``evaluate`` (tools/evaluate.py), f32 memory and encoder on both sides,
  ``--n-beams`` 1 and 3: the merged reads, the per-read results file and
  ``accuracy_results_all`` equal;
- ``eval_token_acc`` (tools/eval_token_acc.py): the three accuracies within
  1e-5 and the batch count equal.
"""

import json

import pytest
import torch

from ravvent_tpu.evaluation.mapping import MappingEvaluator as JMappingEvaluator
from ravvent_tpu.training.checkpoints import CheckpointManager as JCheckpointManager
from ravvent_tpu_torch import weights
from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
from ravvent_tpu_torch.tools import eval_token_acc, evaluate, make_dataset
from tests.test_torch_cli import REPO, run_jax_tool

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The trained flagship: its Orbax checkpoint, the same parameters as
    an npz, and a dataset of 2 eval reads."""
    d = tmp_path_factory.mktemp("flagship")
    tree = JCheckpointManager(str(REPO / "checkpoints")).restore_numpy("flagship")["params"]
    weights.save_npz(d / "flagship.npz", weights.from_jax_params(tree))
    make_dataset.build(d / "ds", 43, genome_len=20_000, train_reads=0, eval_reads=2,
                       read_len=(800, 1200), seed=11)
    return REPO / "checkpoints" / "flagship", d / "flagship.npz", d / "ds"


def recording(cls, monkeypatch, store):
    """Record every merged read the evaluator class maps."""
    map_identity = cls.map_identity

    def wrapped(self, pred_seq, ref_seq):
        store.append((pred_seq, ref_seq))
        return map_identity(self, pred_seq, ref_seq)

    monkeypatch.setattr(cls, "map_identity", wrapped)


@pytest.mark.parametrize("n_beams", [1, 3])
def test_evaluate_cli_on_the_flagship_equals_jax(flagship, tmp_path, monkeypatch, n_beams):
    jckpt, npz, ds = flagship
    fi = ds / "eval" / "files_info.snippets.stride_6.json"
    common = ["--files-info", str(fi), "--beams", "5", "--tag", "t", "--n-beams", str(n_beams)]
    merged = {"jax": [], "port": []}
    recording(JMappingEvaluator, monkeypatch, merged["jax"])
    recording(MappingEvaluator, monkeypatch, merged["port"])
    run_jax_tool("evaluate", common + ["--checkpoint", str(jckpt), "--out-dir",
                                       str(tmp_path / "jax"), "--cache-dir",
                                       str(tmp_path / "jc")], monkeypatch)
    totals = evaluate.main(["--cpu"] + common + ["--checkpoint", str(npz), "--out-dir",
                                                  str(tmp_path / "port"), "--cache-dir",
                                                  str(tmp_path / "tc")])
    print(f"evaluate, flagship, n_beams={n_beams}: port {totals}")
    assert len(merged["port"]) == 2 and merged["port"] == merged["jax"]
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "accuracy_results_all.t.beam5.json",
        "mapping_evaluator_results.t.joint.encd2.decd1.beam5.json"]
    for n in names:
        assert (json.loads((tmp_path / "port" / n).read_text())
                == json.loads((tmp_path / "jax" / n).read_text())), n
    assert list(json.loads((tmp_path / "port" / names[0]).read_text())) == ["(2, 1)"]


def test_eval_token_acc_on_the_flagship_matches_jax(flagship, tmp_path, monkeypatch):
    jckpt, npz, ds = flagship
    fi = ds / "eval" / "files_info.snippets.stride_6.json"
    common = ["--files-info", str(fi), "--tag", "t", "--batch-size", "32", "--max-batches", "2"]
    run_jax_tool("eval_token_acc", common + ["--checkpoint", str(jckpt), "--out-dir",
                                             str(tmp_path / "jax")], monkeypatch)
    row = eval_token_acc.main(["--cpu"] + common + ["--checkpoint", str(npz), "--out-dir",
                                                     str(tmp_path / "port")])
    ref = json.loads((tmp_path / "jax" / "token_acc.t.json").read_text())
    got = json.loads((tmp_path / "port" / "token_acc.t.json").read_text())
    print(f"eval_token_acc, flagship: port {row}, JAX {ref}")
    assert list(got) == list(ref) == ["(2, 1)"]
    g, r = got["(2, 1)"]["joint"], ref["(2, 1)"]["joint"]
    assert g["batches"] == r["batches"] == 2 and g == row
    for k in ("strict", "val_style", "teacher_forced"):
        assert abs(g[k] - r[k]) <= 1e-5, k
    assert all(0.0 < g[k] <= 1.0 for k in ("strict", "val_style", "teacher_forced"))
