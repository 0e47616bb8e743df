"""The port's bench tool (ravvent_tpu_torch/tools/bench.py) on the CPU.

(a) Its reads are bench.py's: the generated genome and the chiron files of
``ensure_dataset`` (here 2 + 2 reads of 1.5-1.8 kb) equal, byte for byte,
what the JAX package's simulator writes from the same seeds. (b)
``run_bench`` on those reads at 16 units, on the JAX tree's seeded weights
with f32 memory, encoder and wire: each read's bases and samples equal the
JAX ``PerformanceEvaluator``'s; the compact wire's merged reads, mapping
records and identity equal the JAX ``MappingEvaluator``'s; the signal-only
wires map every read (their features differ from the JAX engine's in the
last bits, tests/test_torch_sigdev.py). (c) ``main`` (its ``run_bench`` given
the tests' model and sizes) ends in bench.py's JSON line plus ``device``;
``vs_baseline`` is null until ``--cpu --record-baseline`` writes the port's
own record; no ``BENCH_*.json`` is written.
"""

import functools
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.data import chiron as jchiron
from ravvent_tpu.data import simulator as jsimulator
from ravvent_tpu.evaluation.basecall import BasecallEngine as JEngine
from ravvent_tpu.evaluation.mapping import MappingEvaluator as JMappingEvaluator
from ravvent_tpu.evaluation.performance import PerformanceEvaluator as JPerformanceEvaluator
from ravvent_tpu.models.basecaller import init_basecaller as j_init
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
from ravvent_tpu_torch.tools import bench
from ravvent_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
SMALL = dict(n_reads=2, n_stream_reads=2, read_len=(1500, 1800))
CFG = dict(enc_units=16, dec_units=16)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The port's bench reads at the tests' size."""
    d = tmp_path_factory.mktemp("bench") / "data"
    bench.ensure_dataset(d, **SMALL)
    return d


def files(d: Path):
    return sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file()
                  and not p.name.startswith("files_info") and p.name != "bench_meta.json")


def test_bench_reads_equal_the_jax_simulators(data, tmp_path):
    genome, tag = bench.bench_genome()
    jgenome = jsimulator.generate_reduced_genome(43, 300_000, np.random.default_rng(7))
    assert tag == "generated-2048" and genome == jgenome
    profile = jsimulator.PROFILES["noisy"]
    ref = tmp_path / "jax"
    for d, seed in ((ref, 1234), (ref / "stream", 1235)):
        jsimulator.generate_chiron_dataset(d, jgenome, n_reads=2, read_len_range=(1500, 1800),
                                           seed=seed, profile=profile)
        jchiron.create_files_info(d, stride=6, verbose=False)
    names = files(ref)
    assert len(names) == 2 * (2 * 2 + 1)  # .signal + .label a read, a meta a directory
    assert files(data) == names
    for n in names:
        assert (data / n).read_bytes() == (ref / n).read_bytes(), n
    for sub in ("", "stream"):
        got, want = (json.loads((d / sub / "files_info.snippets.stride_6.json").read_text())
                     for d in (data, ref))
        assert [(Path(g["signal_path"]).name, g["snippets_num"]) for g in got] == \
               [(Path(w["signal_path"]).name, w["snippets_num"]) for w in want]
    # a directory made for other reads (another profile, or the bench's
    # profile at other sizes) is made again
    meta = data / "bench_meta.json"
    kept = meta.read_text()
    for other in ({"profile": "clean"}, dict(json.loads(kept), reads=[4, 12]),
                  dict(json.loads(kept), read_len=[12000, 18000])):
        meta.write_text(json.dumps(other))
        (data / "details.json").write_text("{}")
        bench.ensure_dataset(data, **SMALL)
        assert meta.read_text() == kept and files(data) == names
    assert json.loads(kept) == {"profile": "noisy", "genome": "generated-2048",
                                "reads": [2, 2], "read_len": [1500, 1800]}


def merged_reads(monkeypatch, cls) -> list:
    """Record every merged read ``cls.map_identity`` maps."""
    store = []
    real = cls.map_identity

    def recording(self, pred_seq, ref_seq):
        store.append(pred_seq)
        return real(self, pred_seq, ref_seq)

    monkeypatch.setattr(cls, "map_identity", recording)
    return store


def test_run_bench_counts_and_maps_as_the_jax_evaluators(data, monkeypatch):
    tree = jax.tree_util.tree_map(np.array, j_init(jax.random.PRNGKey(3), JConfig(**CFG)))
    # seeded weights end every snippet at once (merged reads of no bases):
    # the end token's logit pushed down, each snippet decodes to its bound
    tree["decoder"]["fc"]["bias"][1] -= 20.0
    params = from_jax_params(tree)
    merged = merged_reads(monkeypatch, MappingEvaluator)
    details = bench.run_bench(data, chunk_size=1024, memory="f32", bf16_encoder=False,
                              transport="f32", device="cpu", cfg=ModelConfig(**CFG),
                              params=params, **SMALL)
    assert details["device"] == "cpu" and details["weights"] == "the caller's"
    assert not details["trained_checkpoint"]
    assert (details["memory"], details["transport"], details["beam_impl"]) == ("f32", "f32",
                                                                               "step")
    assert len(merged) == 3 * 2  # three wires, two reads

    fi = data / "files_info.snippets.stride_6.json"
    paths = [v["signal_path"] for v in json.loads(fi.read_text())]
    jeng = JEngine(tree, JConfig(**CFG), chunk_size=1024, project_values=True, beam_impl="xla",
                   pack_u8=True, transport_dtype="f32", prob_bits=4)
    jpe = JPerformanceEvaluator(jeng, beam_width=5)
    for got, p in zip(details["reads"], paths):
        ref = jpe.run(p)
        assert got["path"] == p
        assert (got["bases_num"], got["samples_num"]) == (ref["bases_num"], ref["samples_num"])
    assert details["pipeline"]["bases_num"] > 0
    for wire in ("compact",) + bench.SIGNAL_WIRES:
        rec = details["pipeline" if wire == "compact" else f"pipeline_{wire}"]
        assert (rec["wire"], rec["reads"]) == (wire, 2)  # --cpu: one pass over <= 4 reads
        assert rec["bases_num"] == details["pipeline"]["bases_num"]

    jmerged = merged_reads(monkeypatch, JMappingEvaluator)
    out = data / "jax_map.json"
    jrec = JMappingEvaluator(jeng, beam_width=5).evaluate_files(fi, out, verbose=False)
    total = JMappingEvaluator.compute_total_results(out)
    print(f"identity (total, valid, invalid %): port {details['identity_total']}, "
          f"{details['identity_valid']}, {details['invalid_pct']}; JAX {total}; sigdev "
          f"{details['identity_total_sigdev']}, sigdev8 {details['identity_total_sigdev8']}")
    assert jmerged == merged[:2] and all(jmerged)
    assert details["map_results"] == jrec
    assert (details["identity_total"], details["identity_valid"],
            details["invalid_pct"]) == total
    for wire in bench.SIGNAL_WIRES:
        assert len(details[f"map_results_{wire}"]) == 2
        assert [r["path"] for r in details[f"map_results_{wire}"]] == paths


def test_main_prints_the_bench_line_and_its_own_baseline(data, tmp_path, monkeypatch):
    # main runs the flagship on the bench's sizes; here a narrow model on the
    # tests' reads
    monkeypatch.setattr(bench, "run_bench", functools.partial(
        bench.run_bench, cfg=ModelConfig(**CFG, encoder_depth=1), **SMALL))
    before = sorted(REPO.glob("BENCH*.json"))
    stamps = [p.stat().st_mtime_ns for p in before]
    argv = ["--cpu", "--data-dir", str(data), "--beam", "1", "--chunk", "1024",
            "--no-identity", "--no-bf16-encoder", "--memory", "f32"]
    line = bench.main(argv + ["--details", str(tmp_path / "d.json")])
    keys = {"metric", "value", "unit", "vs_baseline", "device"}
    assert set(line) == keys and line["unit"] == "bases/s" and line["device"] == "cpu"
    assert line["value"] > 0 and line["vs_baseline"] is None
    details = json.loads((tmp_path / "d.json").read_text())
    assert line["value"] == round(bench.headline(details), 1)
    assert not (data / bench.BASELINE).exists()
    with pytest.raises(SystemExit):  # the baseline is the CPU's
        bench.main(["--record-baseline"])
    line = bench.main(argv + ["--record-baseline"])
    assert set(line) == keys and isinstance(line["vs_baseline"], float)
    record = json.loads((data / bench.BASELINE).read_text())
    assert record["device"] == "cpu" and record["bases_per_s"] > 0
    assert (data / "details.json").exists()
    assert sorted(REPO.glob("BENCH*.json")) == before
    assert [p.stat().st_mtime_ns for p in before] == stamps
    assert not any(p.name.startswith("BENCH") for p in data.rglob("*"))
    os.remove(data / bench.BASELINE)
