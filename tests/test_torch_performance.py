"""The port's PerformanceEvaluator against the JAX package's on the CPU.

Two simulated reads (tests/test_compact_path.py:229's case) through
``run`` and ``run_pipelined`` on the bench's engine settings (i8dev wire,
bf16 encoder stream, bf16 memory, 4-bit probabilities) at small widths:
the counts equal the JAX evaluator's, the pipelined merge equals the
sequential one, and ``compute_total_results`` equals the JAX package's on
the same results file."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.evaluation.basecall import BasecallEngine as JEngine
from ravvent_tpu.evaluation.performance import PerformanceEvaluator as JEvaluator
from ravvent_tpu.models.basecaller import init_basecaller as j_init
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.data import chiron, simulator
from ravvent_tpu_torch.data.snippets import load_read_compact_ex
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
from ravvent_tpu_torch.evaluation.performance import PerformanceEvaluator
from ravvent_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
CFG = dict(enc_units=16, dec_units=16, encoder_depth=1, data_type="joint")
BENCH = dict(memory_dtype=torch.bfloat16, encoder_dtype=torch.bfloat16,
             transport_dtype="i8dev", prob_bits=4)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("reads")
    rng = np.random.default_rng(21)
    genome = simulator.random_genome(2000, rng)
    paths = []
    for i in range(2):
        sig, ranges = simulator.simulate_read(genome, rng, simulator.PoreModel())
        chiron.write_read(d / f"r{i}.signal", d / f"r{i}.label", sig, ranges, genome)
        paths.append(str(d / f"r{i}.signal"))
    info = d / "files_info.json"
    info.write_text(json.dumps([{"signal_path": p} for p in paths]))
    return d, paths, info


@pytest.fixture(scope="module")
def params():
    jp = j_init(jax.random.PRNGKey(0), JConfig(**CFG))
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp))


def _engine(params, **kw):
    return BasecallEngine(params[1], ModelConfig(**CFG), chunk_size=64, device="cpu",
                          **dict(BENCH, **kw))


def _capture(pe, store):
    """Record each merged read's sequence; returns the original method."""
    orig = pe.merger.merge_flat

    def wrapped(*a, **k):
        out = orig(*a, **k)
        store.append(out.seq)
        return out

    pe.merger.merge_flat = wrapped
    return orig


def test_run_and_run_pipelined_count_and_merge_alike(reads, params):
    d, paths, _ = reads
    engine = _engine(params)
    pe = PerformanceEvaluator(engine, beam_width=3, cache_dir=str(d / "cache"))

    # dispatch/collect split equals the one-shot call
    sig, rr, ev, er, nuc, aux = load_read_compact_ex(paths[0], d / "r0.label", 6)
    max_len = int((nuc != 0).sum(axis=1).max())
    t1, p1 = engine.predict_beam_compact(sig, rr, ev, er, max_len, 3, aux=aux)
    t2, p2 = engine.collect_beam_compact(
        engine.dispatch_beam_compact(sig, rr, ev, er, max_len, 3, aux=aux))
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(p1, p2)

    seq_sequential = []
    orig = _capture(pe, seq_sequential)
    per_read = [pe.run(p) for p in paths]
    pe.merger.merge_flat = orig
    seq_pipelined = []
    orig = _capture(pe, seq_pipelined)
    rec = pe.run_pipelined(paths, inflight=2, finishers=2)
    pe.merger.merge_flat = orig
    # finisher threads complete out of order: compare as multisets
    assert len(seq_sequential) == 2 and sorted(seq_pipelined) == sorted(seq_sequential)
    assert all(seq_sequential)

    jeng = JEngine(params[0], JConfig(**CFG), chunk_size=64, memory_dtype=jnp.bfloat16,
                   encoder_dtype=jnp.bfloat16, pack_u8=True, transport_dtype="i8dev",
                   prob_bits=4)
    jpe = JEvaluator(jeng, beam_width=3, cache_dir=str(d / "jcache"))
    for got, p in zip(per_read, paths):
        ref = jpe.run(p)
        assert (got["bases_num"], got["samples_num"]) == (ref["bases_num"], ref["samples_num"])
        assert got["total_processing"] == pytest.approx(
            got["t_predicting"] + got["t_postprocessing"] + got["t_merge"])
    assert rec["pipelined"] and rec["reads"] == 2 and rec["wire"] == "compact"
    assert rec["bases_num"] == sum(r["bases_num"] for r in per_read)
    assert rec["samples_num"] == sum(r["samples_num"] for r in per_read)
    assert rec["bases_per_s"] > 0 and set(rec["stages_s"]) == {
        "load", "dispatch", "collect_wait", "postproc", "merge"}


def test_evaluate_files_and_total_results_match_jax(reads, params, tmp_path):
    _, paths, info = reads
    pe = PerformanceEvaluator(_engine(params), beam_width=3)
    out = tmp_path / "res" / "perf.json"
    results = pe.evaluate_files(info, out, verbose=False)
    assert [r["path"] for r in results] == paths
    assert json.loads(out.read_text()) == results
    assert PerformanceEvaluator.compute_total_results(out) == JEvaluator.compute_total_results(out)


def test_signal_only_wires_are_not_ported(reads, params):
    """The name predates the port of the signal-only wires; it now holds
    that they run: run_pipelined over both reads on "sigdev" and "sigdev8"
    counts the bases and samples of the compact wire and merges every read
    (tests/test_torch_sigdev.py holds them against the JAX evaluator), one
    segmentation for each read or for the pair (seg_batch=2); ``run`` stays
    on the compact wire; other wires are refused."""
    d, paths, _ = reads
    engine = _engine(params, transport_dtype="f16")
    compact = PerformanceEvaluator(engine, beam_width=3, cache_dir=str(d / "cache"))
    ref = compact.run_pipelined(paths, inflight=2, finishers=2)
    for wire, seg_batch in (("sigdev", 1), ("sigdev8", 2)):
        pe = PerformanceEvaluator(engine, beam_width=3, cache_dir=str(d / "cache"), wire=wire)
        merged = []
        orig = _capture(pe, merged)
        rec = pe.run_pipelined(paths, inflight=2, finishers=2, seg_batch=seg_batch)
        pe.merger.merge_flat = orig
        assert rec["wire"] == wire and len(merged) == 2
        assert (rec["bases_num"], rec["samples_num"]) == (ref["bases_num"], ref["samples_num"])
        assert pe.run(paths[0])["bases_num"] == compact.run(paths[0])["bases_num"]
    with pytest.raises(ValueError, match="wire"):
        PerformanceEvaluator(engine, wire="sigdev16")
