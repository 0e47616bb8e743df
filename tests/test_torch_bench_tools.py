"""The port's bench-side tools (ravvent_tpu_torch/tools/{sweep_pipeline,
floor_probe, bench_scaling, train_profile}.py) on the CPU, against the JAX
package.

As tests/test_torch_bench.py does: 16 units, the JAX tree's seeded weights
through ``from_jax_params`` (the end token's logit pushed down, so that
the reads are not empty), f32 memory, encoder and wire, and the bench's
reads at 2 + 2 of 1.5-1.8 kb. (a) ``sweep_pipeline.main`` returns the
reference tool's keys, and its bases equal the JAX ``PerformanceEvaluator``'s
pipelined count on the same reads. (b) ``floor_probe.main`` returns the
reference's keys (the link probes null on the CPU); pass A's bases equal
the JAX count; pass C's merged reads equal the JAX merge (its
``_postprocess`` and ``merge_flat`` with the positional prior) of the same
decodes, sequence equal and scores within 1e-12. (c) ``bench_scaling.main
--virtual 2 --sizes 1,2`` counts equal bases at both mesh sizes, equal to
the JAX ``evaluate_files``'s, and its merged reads equal, at both sizes,
the JAX evaluator's; a ``--data-dir`` it did not make keeps what it holds,
and without ``--device`` each shard takes a card of its own. (d)
``train_profile.main`` on the bench's reads at
``tests/test_training.py::small_cfg``'s widths from an npz of a JAX tree:
its ``final_loss`` after the warm-up step and 2 timed steps equals the JAX
``Trainer``'s on the same batches and weights within 1e-4 relative
(tests/test_torch_training.py's bar for train steps), p = 0. (e) None of
the tools writes under ``results/``, ``info/`` or a ``BENCH_*.json``.
"""

import functools
import hashlib
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ravvent_tpu.assembly.merger import Merger as JMerger
from ravvent_tpu.assembly.merger import expected_overlaps_from_ranges as j_overlaps
from ravvent_tpu.config import DataConfig as JDataConfig
from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.config import RunConfig as JRunConfig
from ravvent_tpu.config import TrainConfig as JTrainConfig
from ravvent_tpu.data.generator import SnippetBatchGenerator as JGenerator
from ravvent_tpu.evaluation.basecall import BasecallEngine as JEngine
from ravvent_tpu.evaluation.performance import PerformanceEvaluator as JPerformanceEvaluator
from ravvent_tpu.models.basecaller import init_basecaller as j_init
from ravvent_tpu.parallel.mesh import make_mesh as j_make_mesh
from ravvent_tpu.training.loop import Trainer as JTrainer
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.evaluation.performance import PerformanceEvaluator
from ravvent_tpu_torch.tools import (
    bench, bench_scaling, floor_probe, sweep_pipeline, train_profile,
)
from ravvent_tpu_torch.tools.common import stream_paths
from ravvent_tpu_torch.weights import from_jax_params, save_npz

torch.set_num_threads(1)
SMALL = dict(n_reads=2, n_stream_reads=2, read_len=(1500, 1800))
CFG = dict(enc_units=16, dec_units=16)
F32 = dict(memory="f32", bf16_encoder=False, transport="f32")
REPO = Path(__file__).resolve().parents[1]


def records():
    """The TPU rounds' records the tools must not write: every file under
    results/ and info/ and each BENCH_*.json, with its modification time."""
    paths = [p for d in ("results", "info") for p in (REPO / d).rglob("*") if p.is_file()]
    return {str(p): p.stat().st_mtime_ns for p in paths + sorted(REPO.glob("BENCH_*.json"))}


RECORDS = records()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools") / "data"
    bench.ensure_dataset(d, **SMALL)
    return d


@pytest.fixture(scope="module")
def tree():
    tree = jax.tree_util.tree_map(np.array, j_init(jax.random.PRNGKey(3), JConfig(**CFG)))
    tree["decoder"]["fc"]["bias"][1] -= 20.0  # no snippet ends at once
    return tree


@pytest.fixture(scope="module")
def jpe(tree):
    jeng = JEngine(tree, JConfig(**CFG), chunk_size=1024, project_values=True, beam_impl="xla",
                   pack_u8=True, transport_dtype="f32", prob_bits=4)
    return JPerformanceEvaluator(jeng, beam_width=5)


@pytest.fixture(scope="module")
def jax_stream_bases(data, jpe):
    """The JAX evaluator's pipelined count over the stream reads."""
    stream = stream_paths(data / "stream" / "files_info.snippets.stride_6.json")
    return jpe.run_pipelined(stream, inflight=8, finishers=4)["bases_num"]


def small(fn, tree, **kw):
    """A tool's run function at the tests' model, weights and settings."""
    return functools.partial(fn, cfg=ModelConfig(**CFG), params=from_jax_params(tree),
                             settings=F32, **kw)


def test_sweep_pipeline_rows_count_the_jax_evaluators_bases(data, tree, jax_stream_bases,
                                                            monkeypatch):
    monkeypatch.setattr(sweep_pipeline, "run_sweep",
                        small(sweep_pipeline.run_sweep, tree, chunk_size=1024, **SMALL))
    out = sweep_pipeline.main(["--cpu", "--data-dir", str(data), "--configs", "2:1,8:4",
                               "--mults", "1,2", "--passes", "1"])
    assert {"metric", "rows"} <= set(out) and out["metric"] == "pipeline depth sweep"
    assert out["device"] == "cpu"
    assert [(r["reads"], r["inflight"], r["finishers"]) for r in out["rows"]] == \
        [(2, 2, 1), (2, 8, 4), (4, 2, 1), (4, 8, 4)]
    for r in out["rows"]:
        assert {"reads", "inflight", "finishers", "bases_per_s"} <= set(r)
        assert r["bases_per_s"] > 0
        assert r["bases_num"] == jax_stream_bases * r["reads"] // 2


def test_floor_probe_passes_match_the_jax_evaluator(data, tree, jpe, jax_stream_bases,
                                                    monkeypatch, tmp_path):
    monkeypatch.setattr(floor_probe, "run_probe",
                        small(floor_probe.run_probe, tree, passes=1, **SMALL))
    out = floor_probe.main(["--cpu", "--data-dir", str(data), "--chunk", "1024",
                            "--out", str(tmp_path / "probe.json")])
    keys = {"device", "reads", "link_rtt_ms", "upload_MBps", "A_pipeline",
            "B_device_stream_wall_s", "C_host_work_s", "S_sigdev_pipeline",
            "sigdev_begin_ms_per_read", "sigdev_finish_ms_per_read", "sigdev_slabs_per_read"}
    assert set(out) == keys and json.loads((tmp_path / "probe.json").read_text()) == out
    assert out["reads"] == 2 and out["link_rtt_ms"] is None and out["upload_MBps"] is None
    for k in ("A_pipeline", "S_sigdev_pipeline"):
        assert {"wall_s", "bases_per_s", "stages_s"} <= set(out[k])
        assert out[k]["bases_num"] == jax_stream_bases
    assert out["B_device_stream_wall_s"] > 0 and out["C_host_work_s"] > 0
    assert out["sigdev_slabs_per_read"] >= 1

    # pass C on the same decodes as the JAX package's merge
    engine = bench.bench_engine(from_jax_params(tree), ModelConfig(**CFG), "cpu", 1024, **F32)
    pe = PerformanceEvaluator(engine, beam_width=5, cache_dir=str(data / "cache"))
    decodes = floor_probe.collect_decodes(pe, stream_paths(data / "stream" /
                                                           "files_info.snippets.stride_6.json"))
    _, merged = floor_probe.host_pass(pe, decodes)
    merger = JMerger()
    for (tokens, probs, rr), got in zip(decodes, merged):
        blob, offsets, fp = JPerformanceEvaluator._postprocess(tokens, probs)
        eo = j_overlaps(rr, np.diff(offsets)) if rr.shape[0] > 1 else None
        ref = merger.merge_flat(blob, offsets, fp, expected_overlaps=eo)
        assert len(ref.seq) > 100 and got.seq == ref.seq
        np.testing.assert_allclose(np.asarray(got.logits, np.float64),
                                   np.asarray(ref.logits, np.float64), rtol=0, atol=1e-12)


def test_bench_scaling_meshes_count_and_call_as_jax(tree, jpe, monkeypatch, tmp_path):
    monkeypatch.setattr(bench_scaling, "run_scaling",
                        small(bench_scaling.run_scaling, tree, repeats=1))
    d = tmp_path / "scaling"
    out = bench_scaling.main(["--virtual", "2", "--sizes", "1,2,4", "--reads", "2",
                              "--read-len", "1500", "--chunk", "1024", "--compare-single",
                              "--data-dir", str(d)])
    assert {"metric", "device", "pipelined", "rows", "single_device_bases_per_s",
            "mesh1_vs_single"} <= set(out)
    assert out["device"] == "cpu" and out["pipelined"] is False
    rows = out["rows"]
    assert [(r["mesh"], r["devices"]) for r in rows] == [(1, ["cpu"]), (2, ["cpu", "cpu"])]
    for r in rows:
        assert {"mesh", "bases_per_s", "speedup", "efficiency"} <= set(r)
    assert rows[0]["speedup"] == 1.0 and out["mesh1_vs_single"] > 0

    fi = d / "files_info.snippets.stride_6.json"
    merged = []
    real = JMerger.merge_flat

    def recording(self, *a, **k):
        res = real(self, *a, **k)
        merged.append(res.seq)
        return res

    monkeypatch.setattr(JMerger, "merge_flat", recording)
    jres = jpe.evaluate_files(fi, tmp_path / "jax_perf.json", verbose=False)
    assert len(merged) == len(jres) == 2 and all(merged)
    digest = hashlib.sha1("\n".join(merged).encode()).hexdigest()
    for r in rows:
        assert r["bases_num"] == sum(j["bases_num"] for j in jres)
        assert r["called_bases"] == sum(len(s) for s in merged)
        assert r["called_sha1"] == digest



def test_bench_scaling_removes_only_what_it_made(tree, monkeypatch, tmp_path):
    """A --data-dir that the tool did not make keeps what it holds: the reads
    are made beside a file of the caller's, no meta is written, and a later
    run with other reads uses the dataset as it is. A directory the tool
    made is made again for other reads."""
    monkeypatch.setattr(bench_scaling, "run_scaling",
                        small(bench_scaling.run_scaling, tree, repeats=1))
    d = tmp_path / "mine"
    d.mkdir()
    (d / "keep.txt").write_text("the caller's")
    out = bench_scaling.main(["--virtual", "1", "--sizes", "1", "--reads", "1",
                              "--read-len", "1500", "--chunk", "1024", "--data-dir", str(d)])
    assert out["rows"][0]["bases_num"] > 0
    assert (d / "keep.txt").read_text() == "the caller's"
    assert not (d / bench_scaling.META).exists()
    fi = d / "files_info.snippets.stride_6.json"
    stamp = fi.stat().st_mtime_ns
    assert bench_scaling.ensure_reads(d, 2, 1500) == fi and fi.stat().st_mtime_ns == stamp
    assert (d / "keep.txt").exists() and len(stream_paths(fi)) == 1

    made = tmp_path / "made"
    fi = bench_scaling.ensure_reads(made, 1, 1500)
    assert json.loads((made / bench_scaling.META).read_text()) == {"reads": 1, "read_len": 1500}
    assert bench_scaling.ensure_reads(made, 2, 1500) == fi and len(stream_paths(fi)) == 2


def test_bench_scaling_takes_a_card_a_shard_by_default(monkeypatch):
    """Without --device or --virtual each shard is a card of its own, and the
    sizes above the machine's count of cards are left out (as the reference
    does); --device puts every shard on that device. No card is used: the
    engine and its measurement are stand-ins."""
    meshes = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(bench_scaling, "ensure_reads", lambda *a: Path("fi.json"))
    monkeypatch.setattr(bench, "model_params", lambda cfg, params, *a: (params, None))
    monkeypatch.setattr(bench, "bench_engine", lambda *a, mesh=None, **k: mesh)
    monkeypatch.setattr(bench, "device_line", str)
    monkeypatch.setattr(bench_scaling, "make_mesh", lambda devices: meshes.append(devices))
    monkeypatch.setattr(bench_scaling, "measure",
                        lambda *a: dict(bases_per_s=1.0, bases_num=1, called_bases=1,
                                        called_sha1=""))
    out = bench_scaling.run_scaling([1, 2, 4, 8], params={})
    assert [r["mesh"] for r in out["rows"]] == [1, 2]
    assert meshes == [["cuda:0"], ["cuda:0", "cuda:1"]] and out["device"] == "cuda:0"
    meshes.clear()
    bench_scaling.run_scaling([1, 2, 4], device="cuda:0", params={})
    assert meshes == [["cuda:0"], ["cuda:0"] * 2, ["cuda:0"] * 4]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_scaling.run_scaling([1, 2], params={})

def test_train_profile_final_loss_tracks_the_jax_trainer(data, monkeypatch, tmp_path):
    jcfg = JRunConfig(data=JDataConfig(batch_size=8),
                      model=JConfig(enc_units=16, dec_units=16, encoder_depth=1, decoder_depth=1,
                                    data_type="joint"),
                      train=JTrainConfig(batch_size=8, steps_per_epoch=2, learning_rate=3e-3,
                                         teacher_forcing=1.0))
    jtree = jax.tree_util.tree_map(np.array, j_init(jax.random.PRNGKey(5), jcfg.model))
    npz = tmp_path / "w.npz"
    save_npz(npz, from_jax_params(jtree))
    monkeypatch.setattr(train_profile, "run_profile", functools.partial(
        train_profile.run_profile, model=ModelConfig(**CFG, encoder_depth=1),
        learning_rate=3e-3, teacher_forcing=1.0))
    out = train_profile.main(["--cpu", "--data-dir", str(data), "--data-types", "joint",
                              "--steps", "2", "--batch-size", "8", "--weights", str(npz)])
    assert set(out) == {"device", "results"} and out["device"] == "cpu"
    (r,) = out["results"]
    assert {"data_type", "steps", "batch_size", "compile_plus_first_step_s", "train_time_s",
            "steps_per_s", "examples_per_s", "final_loss", "device_memory"} <= set(r)
    assert (r["data_type"], r["steps"], r["batch_size"]) == ("joint", 2, 8)
    assert r["device_memory"] == {"cpu": {"bytes_in_use": None, "peak_bytes_in_use": None}}
    assert r["steps_per_s"] > 0 and np.isfinite(r["validation_loss"])

    jtr = JTrainer(jcfg, mesh=j_make_mesh(1))
    jtr.params = jax.tree_util.tree_map(jax.numpy.asarray, jtree)
    fi = data / "files_info.snippets.stride_6.json"
    it = iter(JGenerator.from_config(str(fi), jcfg.data, cache_dir=str(tmp_path / "jcache"))
              .epoch())
    losses = [float(jtr.train_on_batch(next(it))["loss"]) for _ in range(3)]
    print(f"train_profile final_loss {r['final_loss']:.7f}, JAX {losses[-1]:.7f}")
    np.testing.assert_allclose(r["final_loss"], losses[-1], rtol=1e-4)


def test_tools_write_no_tpu_round_records():
    assert records() == RECORDS
