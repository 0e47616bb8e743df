"""ravvent_tpu_torch/tools/train_curriculum.py against tools/
train_curriculum.py on the CPU, both called in process through ``main``
from the same weights (``--init-from``) at units 16, batch 16: two
teacher-forced stages, the bad-basin restart firing once
(``--restart-below 1.01 --max-restarts 1``) and an identity sweep of the
last 2 epochs. The summary's keys, the restart log and the final seed
equal; each stage's history within the train CLI's bars
(tests/test_torch_cli.py); the sweep's rows and the best epoch equal; the
export written.
"""

import json
import shutil

import numpy as np
import torch

from ravvent_tpu_torch.tools import train_curriculum
from tests.test_torch_cli import CSV_BARS, SMALL, dataset, init_weights, run_jax_tool  # noqa: F401

torch.set_num_threads(1)


def test_train_curriculum_matches_jax(dataset, init_weights, tmp_path, monkeypatch):
    common = SMALL + ["--tag", "t", "--stages", "[[1.0, 2e-3, 1, 3], [1.0, 1e-3, 1, 3]]",
                      "--sweep-epochs", "2", "--restart-below", "1.01", "--max-restarts", "1"]
    out = {}
    for side, init in (("jax", init_weights[0]), ("port", init_weights[1])):
        ds = tmp_path / f"{side}_ds"
        shutil.copytree(dataset, ds)
        argv = common + ["--dataset", str(ds), "--init-from", str(init),
                         "--workdir", str(tmp_path / side), "--export", str(tmp_path / f"{side}_x")]
        if side == "jax":
            run_jax_tool("train_curriculum", argv, monkeypatch)
        else:
            train_curriculum.main(["--cpu"] + argv)
        out[side] = json.loads((tmp_path / side / "curriculum_summary.json").read_text())
    got, ref = out["port"], out["jax"]
    assert list(got) == list(ref)
    assert got["restarts"] == ref["restarts"] and len(got["restarts"]) == 1
    assert got["restarts"][0]["restarted"] and got["seed"] == ref["seed"] == 23
    assert [h["stage"] for h in got["history"]] == [h["stage"] for h in ref["history"]] == [0, 1]
    for g, r in zip(got["history"], ref["history"]):
        for k, bars in CSV_BARS.items():
            np.testing.assert_allclose(g[k], r[k], **bars, err_msg=k)
    assert [r["epoch"] for r in got["epoch_sweep"]] == [1, 2]
    assert got["epoch_sweep"] == ref["epoch_sweep"]
    assert (got["best_epoch"], got["best_val_identity"]) == (ref["best_epoch"],
                                                             ref["best_val_identity"])
    assert (tmp_path / "port_x" / "params.npz").exists()
    assert json.loads((tmp_path / "port" / "restart_log.json").read_text()) == got["restarts"]
