"""The port's user CLIs against the JAX package's (tools/*.py), each
called in process through ``main`` with ``--cpu``, on datasets that
ravvent_tpu_torch/tools/make_dataset.py builds:

- ``train`` at units 16, batch 16, teacher forcing 1.0, 2 epochs x 3
  steps, both starting from the same weights (``--init-from``: the JAX
  tool's Orbax checkpoint, the port's npz): the CSV logs' names and columns
  equal, per-epoch train loss within 1e-4 relative and accuracy within
  1e-6, validation loss 1e-5 relative and accuracy 1e-5 (the bars of
  tests/test_torch_training.py for train steps and validation). On the port
  alone: a resume from epoch 1 equals the uninterrupted run (loss 1e-6
  relative, parameters 1e-6 of each leaf's largest); ``--init-from`` keeps
  the parameters and starts a fresh optimizer; a missing dataset is built.
- ``sweep_epochs`` over the JAX training run's checkpoints (carried into
  the port's format): the sweep table and the exported epoch equal.
- ``evaluate`` on the port alone: the beam-step path equals the plain
  decode; the default ``beam_impl`` rule is the engine's; a missing
  checkpoint is refused. ``SnippetBatchGenerator.skip``
  (the exact resume) equals drawing the batches.
- Without ``--cpu`` every CLI raises when there is no card.

tests/test_torch_cli_flagship.py holds ``evaluate`` and ``eval_token_acc``
on the trained flagship, tests/test_torch_curriculum.py
``train_curriculum``.
"""

import importlib
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ravvent_tpu.models.basecaller import init_basecaller as jinit
from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.training.checkpoints import CheckpointManager as JCheckpointManager
from ravvent_tpu_torch import weights
from ravvent_tpu_torch.config import DataConfig
from ravvent_tpu_torch.data.generator import SnippetBatchGenerator
from ravvent_tpu_torch.tools import (
    bench, eval_token_acc, evaluate, make_dataset, sweep_epochs, train, train_curriculum,
)
from ravvent_tpu_torch.training.checkpoints import CheckpointManager
from ravvent_tpu_torch.training.loop import Trainer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--enc-units", "16", "--dec-units", "16", "--batch-size", "16"]
TRAIN = SMALL + ["--epochs", "2", "--steps-per-epoch", "3", "--validation-steps", "2",
                 "--teacher-forcing", "1.0", "--lr", "3e-3"]
CSV_BARS = {"loss": dict(rtol=1e-4, atol=0), "acc": dict(rtol=0, atol=1e-6),
            "val_loss": dict(rtol=1e-5, atol=0), "val_acc": dict(rtol=0, atol=1e-5)}


def run_jax_tool(name, argv, monkeypatch):
    """tools/<name>.py's main() on ``argv``. Its import sets JAX's
    compilation cache directory, which is put back."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(sys, "argv", [f"tools/{name}.py", "--cpu"] + argv)
    mod = importlib.import_module(f"tools.{name}")
    jax.config.update("jax_compilation_cache_dir", before)
    return mod.main()


def read_csv(path):
    lines = Path(path).read_text().strip().splitlines()
    cols = lines[0].split(",")
    return cols, np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])


def assert_csv_close(got_path, ref_path):
    cols, got = read_csv(got_path)
    ref_cols, ref = read_csv(ref_path)
    assert cols == ref_cols == ["epoch", "acc", "loss", "val_acc", "val_loss"]
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    for i, c in enumerate(cols[1:], 1):
        np.testing.assert_allclose(got[:, i], ref[:, i], **CSV_BARS[c], err_msg=c)


def only(pattern_dir, pattern):
    found = sorted(Path(pattern_dir).glob(pattern))
    assert len(found) == 1, found
    return found[0]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """2 train reads and 4 eval reads (1 val, 3 test) of 1.5-2 kb."""
    d = tmp_path_factory.mktemp("cli") / "ds"
    make_dataset.build(d, 43, genome_len=20_000, train_reads=2, eval_reads=4,
                       read_len=(1500, 2000), seed=3)
    return d


@pytest.fixture(scope="module")
def init_weights(tmp_path_factory):
    """Seeded JAX weights at units 16: an Orbax checkpoint and an npz."""
    d = tmp_path_factory.mktemp("init")
    tree = jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(7), JConfig(
        enc_units=16, dec_units=16)))
    JCheckpointManager(str(d)).save("jax_init", tree)
    weights.save_npz(d / "init.npz", weights.from_jax_params(tree))
    return d / "jax_init", d / "init.npz"


@pytest.fixture(scope="module")
def trained(dataset, init_weights, tmp_path_factory):
    """Both train CLIs from the same weights, each on its own copy of the
    dataset (its own snippet cache)."""
    root = tmp_path_factory.mktemp("trained")
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for side, init in (("jax", init_weights[0]), ("port", init_weights[1])):
            ds = root / f"{side}_ds"
            shutil.copytree(dataset, ds)
            argv = TRAIN + ["--dataset", str(ds), "--init-from", str(init),
                            "--checkpoint-dir", str(root / f"{side}_models"),
                            "--info-dir", str(root / f"{side}_info")]
            if side == "jax":
                run_jax_tool("train", argv, mp)
            else:
                out["history"] = train.main(["--cpu"] + argv)
            out[side] = root
    finally:
        mp.undo()
    out["argv"] = TRAIN + ["--dataset", str(root / "port_ds")]
    return out


def test_train_cli_matches_jax_cli(trained):
    root = trained["port"]
    port_log = only(root / "port_info", "csvlog.*.log")
    jax_log = only(root / "jax_info", "csvlog.*.log")
    assert port_log.name == jax_log.name  # the run-name schema
    assert_csv_close(port_log, jax_log)
    _, rows = read_csv(port_log)
    np.testing.assert_allclose(rows[:, 2], trained["history"]["loss"], rtol=1e-7)
    for side in ("port", "jax"):
        names = sorted(p.name for p in (root / f"{side}_models" / "snippets" / "mask"
                                        / "encd_2_decd_1").iterdir())
        assert [n[-3:] for n in names] == [".01", ".02"]
    port_ckpt = only(root / "port_models/snippets/mask/encd_2_decd_1", "*.02")
    assert (port_ckpt / "params.npz").exists() and (port_ckpt / "state.pt").exists()


def test_train_cli_resume_equals_uninterrupted_run(trained, tmp_path):
    root = trained["port"]
    first = only(root / "port_models/snippets/mask/encd_2_decd_1", "*.01")
    hist = train.main(["--cpu"] + trained["argv"] + [
        "--resume-epoch", "1", "--resume-path", str(first),
        "--checkpoint-dir", str(tmp_path / "models"), "--info-dir", str(tmp_path / "info")])
    np.testing.assert_allclose(hist["loss"], trained["history"]["loss"][1:], rtol=1e-6)
    np.testing.assert_allclose(hist["val_loss"], trained["history"]["val_loss"][1:], rtol=1e-6)
    _, rows = read_csv(only(tmp_path / "info", "csvlog.*.log"))
    assert rows[:, 0].tolist() == [1.0]
    got = np.load(only(tmp_path / "models/snippets/mask/encd_2_decd_1", "*.02") / "params.npz")
    ref = np.load(only(root / "port_models/snippets/mask/encd_2_decd_1", "*.02") / "params.npz")
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        assert np.abs(got[k] - ref[k]).max() <= 1e-6 * np.abs(ref[k]).max(), k
    state = CheckpointManager(str(tmp_path)).restore(
        str(only(tmp_path / "models/snippets/mask/encd_2_decd_1", "*.02")))
    assert state["epoch"] == 2 and state["opt_state"].count == 6


def test_train_cli_init_from_keeps_params_and_resets_the_optimizer(trained, tmp_path):
    root = trained["port"]
    last = only(root / "port_models/snippets/mask/encd_2_decd_1", "*.02")
    assert CheckpointManager(str(root)).restore(str(last))["opt_state"].count == 6
    argv = ["--cpu"] + trained["argv"] + [
        "--init-from", str(last), "--epochs", "1", "--steps-per-epoch", "1",
        "--checkpoint-dir", str(tmp_path / "models"), "--info-dir", str(tmp_path / "info")]
    train.main(argv)
    got = CheckpointManager(str(tmp_path)).restore(
        str(only(tmp_path / "models/snippets/mask/encd_2_decd_1", "*.01")))
    assert got["opt_state"].count == 1  # a fresh optimizer took one step
    # one step of a trainer given the same parameters, on the same first batch
    cfg = train.run_config(train.parser().parse_args(argv))
    ref = Trainer(cfg, params=weights.load_npz(last / "params.npz"), device="cpu")
    gen = SnippetBatchGenerator.from_config(
        str(root / "port_ds/train/files_info.snippets.stride_6.json"),
        DataConfig(batch_size=16), cache_dir=str(root / "port_ds/.cache"))
    ref.train_on_batch(next(gen.steps(1)))
    want = weights.flatten(ref.params)
    for k, v in weights.flatten(got["params"]).items():
        assert np.abs(v - want[k]).max() <= 1e-6 * np.abs(want[k]).max(), k


def test_train_cli_builds_a_missing_dataset(tmp_path, monkeypatch):
    built = []
    build = make_dataset.build

    def small_build(out):
        built.append(Path(out))
        return build(out, 12, genome_len=6000, train_reads=1, eval_reads=4,
                                  read_len=(1500, 1800), seed=2)

    monkeypatch.setattr(make_dataset, "build", small_build)
    hist = train.main(["--cpu"] + SMALL + [
        "--dataset", str(tmp_path / "ds"), "--epochs", "1", "--steps-per-epoch", "1",
        "--validation-steps", "1", "--checkpoint-dir", str(tmp_path / "m"),
        "--info-dir", str(tmp_path / "i")])
    assert built == [tmp_path / "ds"] and len(hist["loss"]) == 1 and hist["val_loss"]


@pytest.mark.parametrize("cli,argv", [
    (train, []), (evaluate, ["--checkpoint", "c", "--files-info", "x.json"]),
    (train_curriculum, ["--dataset", "x", "--tag", "t"]),
    (sweep_epochs, ["--run-name", "r", "--epochs", "1", "--files-info", "x.json"]),
    (eval_token_acc, ["--checkpoint", "c", "--files-info", "x.json", "--tag", "t"]),
    (bench, []),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1])
def test_cli_needs_a_card_unless_asked_for_the_cpu(cli, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_sweep_epochs_matches_jax(trained, tmp_path, monkeypatch):
    """Both sweeps over the same parameters: the JAX training run's
    checkpoints, and the same carried into the port's format."""
    root = trained["port"]
    jdir = root / "jax_models"
    sub = "snippets/mask/encd_2_decd_1"
    ckpts = sorted((jdir / sub).iterdir())
    run_name = ckpts[0].name[:-3]
    port_dir = tmp_path / "models"
    for c in ckpts:
        tree = JCheckpointManager(str(jdir / sub)).restore_numpy(c.name)["params"]
        CheckpointManager(str(port_dir / sub)).save(c.name, weights.from_jax_params(tree))
    fi = root / "port_ds/eval/files_info.val.snippets.stride_6.json"
    common = SMALL[:4] + ["--run-name", run_name, "--epochs", "1,2,3", "--files-info", str(fi)]
    run_jax_tool("sweep_epochs", common + ["--checkpoint-dir", str(jdir), "--out",
                                           str(tmp_path / "jax.json"), "--export-best",
                                           str(tmp_path / "jax_best")], monkeypatch)
    res = sweep_epochs.main(["--cpu"] + common + [
        "--checkpoint-dir", str(port_dir), "--out", str(tmp_path / "port.json"),
        "--export-best", str(tmp_path / "port_best")])
    assert sorted(res) == [1, 2]  # epoch 3 is missing
    got = json.loads((tmp_path / "port.json").read_text())
    assert got == json.loads((tmp_path / "jax.json").read_text())
    best = CheckpointManager(str(tmp_path)).restore("port_best")
    assert best["epoch"] == got["best"]


def test_default_beam_impl_takes_the_kernels_where_they_serve(monkeypatch):
    """The tools' default follows the engine's own rule, ``kernels_serve``:
    "step" where it holds, and the engine refuses "step" where it does not.
    The beam step's kernels and the beam loop's take beam widths 1-32 and,
    on a card, decoder widths up to 256 units (64, 128 and 256 compiled, one
    list, the others zero-padded), and the engine's refusal names the sets;
    the fused greedy step takes those decoder widths and memory widths up to
    512 (64-512 compiled)."""
    from ravvent_tpu_torch.config import ModelConfig
    from ravvent_tpu_torch.evaluation import basecall
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine, kernels_serve
    from ravvent_tpu_torch.tools.common import default_beam_impl

    assert default_beam_impl(ModelConfig(), [5, 1]) == "step"
    assert default_beam_impl(ModelConfig(), [5, 6]) == "step"
    assert default_beam_impl(ModelConfig(), [5, 20]) == "step"
    assert default_beam_impl(ModelConfig(), [5, 33]) == "xla"  # 33 is not a kernel width
    assert kernels_serve(ModelConfig()) and not kernels_serve(ModelConfig(), [33])
    assert kernels_serve(ModelConfig(), [1, 6, 7, 10, 16, 17, 32])
    for U in (64, 256, 16, 96, 200):  # the other decoder widths, and beam 10, on a card
        assert default_beam_impl(ModelConfig(dec_units=U), [5], "cuda") == "step", U
        assert kernels_serve(ModelConfig(dec_units=U), device="cuda", impl="loop"), U
    assert default_beam_impl(ModelConfig(), [10], "cuda") == "step"
    assert default_beam_impl(ModelConfig(dec_units=264), [5], "cuda") == "xla"
    assert default_beam_impl(ModelConfig(), [20], "cuda") == "step"
    assert default_beam_impl(ModelConfig(), [33], "cuda") == "xla"
    assert kernels_serve(ModelConfig(), [8], device="cuda", impl="loop")
    for beams in ([6], [10], [16], [17], [32]):  # the loop's widths are the step's, 1-32
        assert kernels_serve(ModelConfig(), beams, device="cuda", impl="loop"), beams
        assert kernels_serve(ModelConfig(), beams, impl="loop"), beams
    assert not kernels_serve(ModelConfig(), [33], device="cuda", impl="loop")
    assert not kernels_serve(ModelConfig(dec_units=264), device="cuda", impl="loop")
    monkeypatch.setattr(basecall, "resolve_device", lambda device: torch.device("cuda", 0))
    for impl in ("loop", "step"):
        with pytest.raises(ValueError, match=r"of up to 256 units on a card \(64, 128, 256 "
                                             r"compiled, the others zero-padded; beam widths "
                                             r"1-32\).*dec_units=264"):
            BasecallEngine({}, ModelConfig(dec_units=264), beam_impl=impl)
    monkeypatch.undo()
    for cfg in (ModelConfig(decoder_depth=2), ModelConfig(rnn_type="bigru"),
                ModelConfig(attention_type="bahdanau")):
        assert default_beam_impl(cfg, [5]) == "xla", cfg
        assert not kernels_serve(cfg), cfg
        with pytest.raises(ValueError, match="depth-1 LSTM"):
            BasecallEngine({}, cfg, beam_impl="step", device="cpu")
    # on a card the kernels' widths too, up to the widest compiled one; the
    # CPU runs the plain versions at any width, so its choice does not change
    narrow = ModelConfig(enc_units=16, dec_units=16)
    wide = ModelConfig(enc_units=16, dec_units=264)
    assert default_beam_impl(narrow, [5, 1]) == default_beam_impl(narrow, [5, 1], "cpu") == "step"
    assert default_beam_impl(narrow, [5, 1], "cuda") == "step"
    assert default_beam_impl(wide, [5, 1]) == "step"
    assert default_beam_impl(wide, [5], "cuda") == "xla"
    assert default_beam_impl(ModelConfig(enc_units=16), [5, 1], "cuda") == "step"
    assert default_beam_impl(ModelConfig(), [5, 1], torch.device("cuda", 0)) == "step"
    assert kernels_serve(ModelConfig(), device="cuda", greedy=True)
    for cfg in (narrow, ModelConfig(enc_units=16), ModelConfig(rnn_type="lstm")):
        assert kernels_serve(cfg, device="cpu", greedy=True), cfg
        # memory widths 32 and 32 run padded to 64 on a card; a
        # unidirectional 128-unit encoder's 128 is compiled
        assert kernels_serve(cfg, device="cuda", greedy=True), cfg
    assert kernels_serve(ModelConfig(rnn_type="lstm", enc_units=256), device="cuda", greedy=True)
    for cfg in (ModelConfig(dec_units=64), ModelConfig(enc_units=64), ModelConfig(enc_units=256),
                ModelConfig(dec_units=256, enc_units=32), ModelConfig(enc_units=96),
                ModelConfig(enc_units=192, dec_units=200)):
        assert kernels_serve(cfg, device="cuda", greedy=True), cfg
    for cfg in (ModelConfig(enc_units=264), wide):  # memory width 528; 264 decoder units
        assert kernels_serve(cfg, device="cpu", greedy=True), cfg
        assert not kernels_serve(cfg, device="cuda", greedy=True), cfg


def test_tools_take_the_plain_decode_on_a_card_for_other_widths(monkeypatch):
    """On a card, eval_token_acc decodes a model wider than the fused step
    takes (264 decoder units, or a memory width of 528) greedily with the
    plain decode, and the flagship's widths, a 64-unit decoder and a 64-unit
    encoder (memory width 128), and the padded widths (16 decoder units, a
    memory width of 32) with the fused step; the engine refuses "step" and
    "loop" for a 264-unit decoder at construction, naming the width (the
    card stood in for: the checks run before anything reaches it)."""
    from types import SimpleNamespace

    from ravvent_tpu_torch.config import ModelConfig
    from ravvent_tpu_torch.evaluation import basecall

    picked = []
    monkeypatch.setattr(eval_token_acc, "greedy_decode", lambda *a: picked.append("plain") or [0])
    monkeypatch.setattr(eval_token_acc, "fused_greedy_decode",
                        lambda *a: picked.append("fused") or [0])
    on_card = SimpleNamespace(keys=SimpleNamespace(device=torch.device("cuda", 0)))
    on_cpu = SimpleNamespace(keys=SimpleNamespace(device=torch.device("cpu")))
    params = {"decoder": {}}
    for cfg, mem in ((ModelConfig(enc_units=16, dec_units=264), on_card),
                     (ModelConfig(enc_units=264), on_card),
                     (ModelConfig(enc_units=16, dec_units=16), on_card),
                     (ModelConfig(dec_units=16), on_card), (ModelConfig(enc_units=16), on_card),
                     (ModelConfig(), on_card), (ModelConfig(enc_units=16, dec_units=264), on_cpu),
                     (ModelConfig(dec_units=64), on_card), (ModelConfig(enc_units=64), on_card)):
        eval_token_acc.greedy_tokens(params, cfg, mem, 3)
    assert picked == ["plain", "plain"] + ["fused"] * 7

    monkeypatch.setattr(basecall, "resolve_device", lambda device: torch.device("cuda", 0))
    for impl in ("step", "loop"):
        with pytest.raises(ValueError, match="dec_units=264"):
            basecall.BasecallEngine({}, ModelConfig(enc_units=16, dec_units=264), beam_impl=impl)


def test_evaluate_cli_refuses_a_missing_checkpoint(tmp_path):
    """No checkpoint is an error, never seeded random weights."""
    fi = ["--cpu", "--files-info", "x.json"]
    with pytest.raises(SystemExit):
        evaluate.main(fi)  # --checkpoint is required
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        evaluate.main(fi + ["--checkpoint", str(tmp_path / "missing")])
    (tmp_path / "orbax").mkdir()  # a directory without params.npz, as a JAX checkpoint
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        evaluate.main(fi + ["--checkpoint", str(tmp_path / "orbax")])


def test_evaluate_cli_step_equals_its_plain_decode(trained, tmp_path):
    """The small model's last checkpoint through --beam-impl step (the
    default here) and xla: the same files, f32 on both."""
    root = trained["port"]
    ckpt = only(root / "port_models/snippets/mask/encd_2_decd_1", "*.02")
    argv = ["--cpu", "--checkpoint", str(ckpt), "--enc-units", "16", "--dec-units", "16",
            "--files-info", str(root / "port_ds/eval/files_info.val.snippets.stride_6.json"),
            "--beams", "5,1", "--tag", "t", "--cache-dir", str(root / "port_ds/.cache")]
    got = {impl: evaluate.main(argv + ["--beam-impl", impl, "--out-dir", str(tmp_path / impl)])
           for impl in ("step", "xla")}
    assert got["step"] == got["xla"] and len(got["step"]) == 2
    for p in sorted((tmp_path / "step").iterdir()):
        assert p.read_bytes() == (tmp_path / "xla" / p.name).read_bytes(), p.name


@pytest.mark.parametrize("plans", [0.0, 0.5, 1.0, 2.5])
def test_generator_skip_equals_drawing_the_batches(dataset, plans):
    """``skip(n)`` then ``steps(k)`` draws what ``steps(n + k)`` draws
    last, across the plans' reshuffles (the train CLI's exact resume)."""
    fi = str(dataset / "train/files_info.snippets.stride_6.json")

    def gen():
        return SnippetBatchGenerator.from_config(fi, DataConfig(batch_size=64),
                                                 cache_dir=str(dataset / ".cache"))

    n = int(plans * len(gen()))
    ref = list(gen().steps(n + 4))[n:]
    g = gen()
    g.skip(n)
    got = list(g.steps(4))
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(RuntimeError, match="before steps"):
        g.skip(1)
