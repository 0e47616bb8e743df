"""The port's host tools against the JAX package on the CPU:
ravvent_tpu_torch/tools/make_dataset.py (the files written byte for byte
equal to tools/make_dataset.py's with the same arguments and seed),
tools/{analyse_accuracies, params_search, event_max_estimation,
fix_invalid_reads, plots}.py, evaluation/guppy.py and
utils/shape_checker.py on the inputs of tests/test_tools_and_utils.py.
plots.attention_alignment (the port's model) against the matrix the JAX
plot_attention_weights draws, within 1e-5; rendering is skipped only where
matplotlib is missing."""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.data import simulator as jsim
from ravvent_tpu.evaluation import guppy as jguppy
from ravvent_tpu.models.basecaller import init_basecaller as jinit
from ravvent_tpu.tools import analyse_accuracies as jaa
from ravvent_tpu.tools import event_max_estimation as jeme
from ravvent_tpu.tools import fix_invalid_reads as jfix
from ravvent_tpu.tools import params_search as jps
from ravvent_tpu.utils.shape_checker import ShapeChecker as JShapeChecker
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.data import simulator
from ravvent_tpu_torch.data.generator import SnippetBatchGenerator
from ravvent_tpu_torch.evaluation import guppy
from ravvent_tpu_torch.tools import analyse_accuracies as aa
from ravvent_tpu_torch.tools import event_max_estimation as eme
from ravvent_tpu_torch.tools import fix_invalid_reads as fix
from ravvent_tpu_torch.tools import make_dataset, params_search, plots
from ravvent_tpu_torch.utils.shape_checker import ShapeChecker
from ravvent_tpu_torch.weights import from_jax_params
from tools import make_dataset as jmake_dataset

torch.set_num_threads(1)

READ_LEN = (1500, 2000)


def tree_bytes(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def both_builds(tmp_path, jax_fn, port_fn, out="ds"):
    """Run the JAX build function, then the port's, into the same path (the
    indexes hold the reads' paths); returns both trees' files."""
    d = tmp_path / out
    jax_fn(d)
    shutil.move(d, tmp_path / "jax_out")
    port_fn(d)
    return tree_bytes(tmp_path / "jax_out"), tree_bytes(d)


def fasta_pair(d: Path, prefix: str, rng):
    d.mkdir(parents=True, exist_ok=True)
    for split in ("train", "eval"):
        jsim.write_fasta(d / f"{prefix}.{split}.fasta", f"{prefix}.{split}",
                         jsim.generate_reduced_genome(45, 6000, rng))


@pytest.mark.parametrize("case", ["kmers", "random_genome", "cross", "cli", "ref_reduced",
                                  "cross_eval"])
def test_make_dataset_writes_the_jax_tools_bytes(tmp_path, monkeypatch, case):
    kw = dict(genome_len=9000, train_reads=2, eval_reads=4, read_len=READ_LEN, seed=5,
              profile="noisy")
    if case == "kmers":
        jb, tb = both_builds(tmp_path, lambda d: jmake_dataset.build(d, 43, **kw),
                             lambda d: make_dataset.build(d, 43, **kw))
    elif case == "random_genome":
        kw.update(profile=None, noise_std=6.0)
        jb, tb = both_builds(tmp_path, lambda d: jmake_dataset.build(d, 0, **kw),
                             lambda d: make_dataset.build(d, 0, **kw))
    elif case == "cross":
        rng = np.random.default_rng(1)
        tg, cg = (simulator.generate_reduced_genome(43, 9000, rng) for _ in range(2))
        kw.update(train_genome=tg, eval_genome=tg, cross_genome=cg, genome_name="t")
        jb, tb = both_builds(tmp_path, lambda d: jmake_dataset.build(d, **kw),
                             lambda d: make_dataset.build(d, **kw))
        assert "cross/files_info.snippets.stride_6.json" in tb
    elif case == "cli":
        argv = ["--n-kmers", "12", "--genome-len", "8000", "--train-reads", "1",
                "--eval-reads", "4", "--read-len", *map(str, READ_LEN), "--seed", "9"]
        jb, tb = both_builds(
            tmp_path, lambda d: jmake_dataset.build(d, 12, 8000, 1, 4, read_len=READ_LEN,
                                                    seed=9, profile="realistic"),
            lambda d: make_dataset.main(["--out", str(d)] + argv))
    elif case == "ref_reduced":
        ref = tmp_path / "reduced"
        fasta_pair(ref, make_dataset.REF_REDUCED_SETS[45], np.random.default_rng(2))
        monkeypatch.setattr(jmake_dataset, "REF_REDUCED_DIR", str(ref))
        monkeypatch.setenv(make_dataset.REF_REDUCED_ENV, str(ref))
        rkw = dict(eval_reads=4, read_len=READ_LEN, seed=3, profile="noisy")
        jb, tb = both_builds(tmp_path, lambda d: jmake_dataset.build_ref_reduced(d, 45, **rkw),
                             lambda d: make_dataset.build_ref_reduced(d, 45, **rkw))
        # coverage-sized: round(8 x 6000 bp / 1750 bp reads)
        assert sum(k.startswith("train/") and k.endswith(".signal") for k in tb) == 27
        monkeypatch.delenv(make_dataset.REF_REDUCED_ENV)
        with pytest.raises(FileNotFoundError, match=make_dataset.REF_REDUCED_ENV):
            make_dataset.load_ref_reduced_genomes(45)
    else:  # cross_eval, from a source dataset built once
        src = tmp_path / "src"
        make_dataset.build(src, 12, genome_len=6000, train_reads=1, eval_reads=1,
                           read_len=READ_LEN, seed=3)
        ckw = dict(n_reads=2, genome_len=6000, read_len=READ_LEN, seed=9)
        jb, tb = both_builds(tmp_path, lambda d: jmake_dataset.build_cross_eval(d, src, **ckw),
                             lambda d: make_dataset.build_cross_eval(d, src, **ckw), "cross")
        assert "test/files_info.snippets.stride_6.json" in tb
    assert sorted(tb) == sorted(jb) and len(tb) > 5
    for k in jb:
        assert tb[k] == jb[k], k


@pytest.fixture(scope="module")
def mini_reads():
    rng = np.random.default_rng(0)
    pore = simulator.PoreModel()
    reads = []
    for _ in range(2):
        seq = simulator.random_genome(400, rng)
        sig, _ = simulator.simulate_read(seq, rng, pore)
        reads.append((sig, len(seq)))
    return reads


@pytest.fixture(scope="module")
def chiron_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("reads")
    genome = simulator.random_genome(3000, np.random.default_rng(1))
    simulator.generate_chiron_dataset(d, genome, n_reads=2, read_len_range=(600, 900))
    return d


def test_params_search_equals_jax(mini_reads, chiron_dir):
    res = params_search.grid_search(mini_reads, wl1_range=[4, 6, 8], wl2_max=11)
    assert res == jps.grid_search(mini_reads, wl1_range=[4, 6, 8], wl2_max=11)
    assert params_search.get_best_params(res) == jps.get_best_params(res)
    for wl in ((4, 7), (6, 9)):
        r, n = mini_reads[0]
        assert params_search.evaluate_sequence(r, n, *wl) == jps.evaluate_sequence(r, n, *wl)
    got = params_search.load_reads_from_chiron_dir(chiron_dir, 2)
    ref = jps.load_reads_from_chiron_dir(chiron_dir, 2)
    assert [n for _, n in got] == [n for _, n in ref]
    for (a, _), (b, _) in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    (wl1, wl2), err = params_search.main(["--data-dir", str(chiron_dir), "--limit", "1"])
    assert ((wl1, wl2), err) == jps.get_best_params(
        jps.grid_search(jps.load_reads_from_chiron_dir(chiron_dir, 1)))


def test_event_max_estimation_equals_jax(chiron_dir):
    counts = eme.events_per_snippet(chiron_dir)
    np.testing.assert_array_equal(counts, jeme.events_per_snippet(chiron_dir))
    assert eme.summarize(counts) == jeme.summarize(counts)
    assert 5 < eme.summarize(counts)["max"] <= 40  # the static MAX_EVENT_LEN=30 regime
    assert eme.main(["--data-dir", str(chiron_dir)]) == jeme.summarize(counts)


def test_analyse_accuracies_equals_jax(tmp_path):
    res = {
        "(2, 1)": {"raw": (83.9, 84.2, 0.0), "event": (72.1, 72.4, 0.0),
                   "joint": (84.1, 84.3, 0.0)},
        "(3, 2)": {"joint": (86.0, 86.5, 1.0)},
    }
    keys = ["(2, 1)", "(3, 2)"]
    arr = aa.get_np_results(res, keys)
    np.testing.assert_array_equal(arr, jaa.get_np_results(res, keys))
    np.testing.assert_array_equal(aa.compare_beams(arr * 0.99, arr),
                                  jaa.compare_beams(arr * 0.99, arr))
    assert aa.REFERENCE_LAMBDA == jaa.REFERENCE_LAMBDA and aa.DATA_TYPES == jaa.DATA_TYPES
    for tag in ("a.beam5", "b.beam1"):
        (tmp_path / f"accuracy_results_all.{tag}.json").write_text(
            json.dumps({**res, "_provenance": "x"}))
    assert aa.collect_results(tmp_path) == jaa.collect_results(tmp_path)
    assert aa.main(["--results-dir", str(tmp_path)]) == jaa.collect_results(tmp_path)


def test_fix_invalid_reads_equals_jax(tmp_path):
    results = [
        {"path": "a.signal", "read_length": 100, "matches": 90, "total_block_len": 100,
         "identity": 0.9, "ref_length": 100},
        {"path": "b.signal", "read_length": 0, "matches": 0, "total_block_len": 0,
         "identity": 0.0, "ref_length": 100},
        {"path": "c.signal", "read_length": 0, "matches": 0, "total_block_len": 0,
         "identity": 0.0, "ref_length": 80},
    ]
    assert fix.find_invalid(results) == jfix.find_invalid(results) == [1, 2]

    class FakeEvaluator:
        def run(self, path):
            ok = path == "b.signal"
            return {"read_length": 90 if ok else 0, "matches": 80 if ok else 0,
                    "total_block_len": 95 if ok else 0, "identity": 0.84 if ok else 0.0}

    for d, mod in ((tmp_path / "port", fix), (tmp_path / "jax", jfix)):
        d.mkdir()
        (d / "res.json").write_text(json.dumps(results))
        (d / "other.json").write_text(json.dumps(results[:1]))
        assert mod.fix_results_file(d / "res.json", FakeEvaluator(), verbose=False) == 1
        (d / "res.json").write_text(json.dumps(results))
        assert mod.fix_all(d, FakeEvaluator()) == {"other.json": 0, "res.json": 1}
    for name in ("res.json", "other.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert json.loads((tmp_path / "port" / "res.json").read_text())[1]["ref_length"] == 100


def test_guppy_equals_jax(tmp_path):
    log = "Init time: 1234 ms\nCaller time: 5000 ms\nSamples called: 450000\n"
    stats = guppy.parse_guppy_log(log)
    assert stats == jguppy.parse_guppy_log(log) == {
        "init_time_ms": 1234.0, "caller_time_ms": 5000.0, "samples_called": 450000.0}
    assert guppy.parse_guppy_log("nothing") == jguppy.parse_guppy_log("nothing") == {}
    for s in (stats, {}):
        assert guppy.calculate_speed(s, 50000) == jguppy.calculate_speed(s, 50000)
    assert guppy.guppy_available() == jguppy.guppy_available()
    assert guppy.GUPPY_CONFIG == jguppy.GUPPY_CONFIG
    # guppy's FASTQ output, mapped with the evaluator's machinery
    rng = np.random.default_rng(4)
    ref = simulator.random_genome(1200, rng)
    reads = [ref[:700], ref[650:]]
    for i, r in enumerate(reads):
        (tmp_path / f"pass_{i}.fastq").write_text(f"@r{i}\n{r}\n+\n{'!' * len(r)}\n")
    assert guppy.read_fastq_sequences(tmp_path) == jguppy.read_fastq_sequences(tmp_path)
    got = guppy.evaluate_guppy_output(tmp_path, ref)
    assert got == jguppy.evaluate_guppy_output(tmp_path, ref) and got["identity"] > 0.9


def test_shape_checker_equals_jax():
    cases = [
        ([((4, 7), "batch t"), ((4, 7, 3), ("batch", "t", "logits"))], None),
        ([((4, 7), "batch t"), ((5, 7), "batch t")], ValueError),
        ([((4,), "batch t")], ValueError),
        ([((4, 7), "batch t"), ((1, 7), "batch t", True)], None),
    ]
    for calls, err in cases:
        for make in (np.zeros, torch.zeros):
            outcomes = []
            for checker in (ShapeChecker(), JShapeChecker()):
                try:
                    for shape, names, *bc in calls:
                        checker(make(shape), names, *bc)
                    outcomes.append((None, checker.shapes))
                except ValueError as e:
                    outcomes.append((ValueError, str(e)))
            assert outcomes[0] == outcomes[1] and outcomes[0][0] is err


@pytest.fixture(scope="module")
def small_model():
    cfg = JConfig(enc_units=16, dec_units=16, encoder_depth=1, decoder_depth=1)
    tree = jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(5), cfg))
    port_cfg = ModelConfig(enc_units=16, dec_units=16, encoder_depth=1, decoder_depth=1)
    return tree, cfg, from_jax_params(tree), port_cfg


def test_attention_alignment_equals_jax_plot(small_model, tmp_path):
    pytest.importorskip("matplotlib")
    from ravvent_tpu.tools import plots as jplots

    tree, jcfg, params, cfg = small_model
    d = tmp_path / "ds"
    simulator.generate_chiron_dataset(d, simulator.random_genome(4000, np.random.default_rng(3)),
                                      n_reads=1, read_len_range=(600, 800), seed=2)
    from ravvent_tpu_torch.data import chiron

    fi = chiron.create_files_info(d, stride=6, verbose=False)
    raw, event, nuc = SnippetBatchGenerator(fi, stride=6, batch_size=4, shuffle=False,
                                            cache_dir=None)[0]
    A = plots.attention_alignment(params, cfg, raw, event, nuc)
    fig = jplots.plot_attention_weights(tree, jcfg, raw, event, nuc)
    ref = np.asarray(fig.axes[0].images[0].get_array())
    assert A.shape == ref.shape == (nuc.shape[1] - 1, 230)
    np.testing.assert_allclose(A, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(A.sum(axis=1), 1.0, atol=1e-5)
    port_fig = plots.plot_attention_weights(params, cfg, raw, event, nuc, out=tmp_path / "a.png")
    assert (tmp_path / "a.png").stat().st_size > 1000 and port_fig is not None


def test_plots_render(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(3)
    genome = simulator.random_genome(300, rng)
    sig, ranges = simulator.simulate_read(genome, rng, simulator.PoreModel())
    plots.plot_raw_with_bases(sig, ranges, genome, out=tmp_path / "raw.png")
    plots.plot_event_detection(sig, out=tmp_path / "ed.png")
    plots.plot_window_search_heatmap({(4, 7): 0.2, (4, 9): 0.15, (6, 9): 0.1},
                                     out=tmp_path / "ws.png")
    (tmp_path / "log.csv").write_text(
        "epoch,acc,loss,val_acc,val_loss\n0,0.1,1.9,0.1,1.8\n1,0.3,1.2,0.2,1.4\n")
    plots.plot_learning_curves(tmp_path / "log.csv", out=tmp_path / "lc.png")
    plots.plot_accuracy_bars(["raw", "event", "joint"], [0.86, 0.75, 0.87],
                             reference_values=[0.87, 0.76, 0.87], out=tmp_path / "bars.png")
    plots.plot_accuracy_vs_kmers({"joint": {45: 0.95, 450: 0.9}}, title="t",
                                 out=tmp_path / "kmers.png")
    for f in ("raw.png", "ed.png", "ws.png", "lc.png", "bars.png", "kmers.png"):
        assert (tmp_path / f).stat().st_size > 1000
    assert plots.REFERENCE_REDUCED_ACCS == __import__(
        "ravvent_tpu.tools.plots", fromlist=["x"]).REFERENCE_REDUCED_ACCS
