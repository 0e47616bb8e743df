"""The port's evaluators on the signal-only wires ("sigdev", "sigdev8")
against the JAX package's on the CPU, on the trained flagship with f32
memory: PerformanceEvaluator.run_pipelined and MappingEvaluator over two
simulated reads (tests/test_torch_sigdev.py's reads and engines; the JAX
engine's segmentation runs its functions op by op, see there)."""

import pytest
import torch

from ravvent_tpu.evaluation.mapping import MappingEvaluator as JMappingEvaluator
from ravvent_tpu.evaluation.performance import PerformanceEvaluator as JPerformanceEvaluator
from ravvent_tpu_torch.assembly.alignment import banded_global_identity
from ravvent_tpu_torch.data import chiron
from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
from ravvent_tpu_torch.evaluation.performance import PerformanceEvaluator
from test_torch_sigdev import engines, flagship, reads  # noqa: F401  (fixtures)

torch.set_num_threads(1)


def _merged_identity(merged):
    """Banded-global identity (%) of merged reads against their truth."""
    matches = cols = 0
    for pred, ref in merged:
        m, c, _ = banded_global_identity(pred, ref)
        matches, cols = matches + m, cols + c
    return 100.0 * matches / max(cols, 1)


def _record_merges(evaluator):
    """Record each merged read of an evaluator's merger."""
    merged = []
    orig = evaluator.merger.merge_flat

    def wrapped(*a, **k):
        out = orig(*a, **k)
        merged.append(out.seq)
        return out

    evaluator.merger.merge_flat = wrapped
    return merged


def _truths(paths):
    return ["".join(chiron.load_label(p.replace(".signal", ".label"))[1]) for p in paths]


@pytest.mark.parametrize("wire", ["sigdev", "sigdev8"])
def test_run_pipelined_close_to_jax(flagship, reads, wire):
    """PerformanceEvaluator.run_pipelined on the signal-only wires over the
    two reads, f32 memory, the trained flagship: the bases and samples
    counted equal the JAX evaluator's, the merged reads' identity within
    0.3 points of the JAX evaluator's."""
    d, paths = reads
    jeng, teng = engines(flagship, "f32")
    runs = {}
    for name, ev in (("jax", JPerformanceEvaluator(jeng, wire=wire)),
                     ("port", PerformanceEvaluator(teng, wire=wire))):
        merged = _record_merges(ev)
        rec = ev.run_pipelined(paths, inflight=2, finishers=2)
        truths = _truths(paths)
        # run_pipelined's reads finish in any order: pair each merged read
        # with the truth it agrees with best
        pairs = [(m, max(truths, key=lambda t: banded_global_identity(m, t)[0])) for m in merged]
        runs[name] = (rec, _merged_identity(pairs), len(merged))
    (jrec, jid, jn), (trec, tid, tn) = runs["jax"], runs["port"]
    print(f"run_pipelined {wire}: merged identity port {tid:.3f} JAX {jid:.3f}; "
          f"bases {trec['bases_num']}, stages {trec['stages_s']}")
    assert trec["wire"] == wire and trec["reads"] == 2 and tn == jn == 2
    assert (trec["bases_num"], trec["samples_num"]) == (jrec["bases_num"], jrec["samples_num"])
    assert abs(tid - jid) <= 0.3


@pytest.mark.parametrize("wire", ["sigdev", "sigdev8"])
def test_mapping_evaluator_close_to_jax(flagship, reads, wire):
    """MappingEvaluator on the signal-only wires over the two reads, f32
    memory, the trained flagship: the records' reference lengths equal, the
    merged reads' identity within 0.3 points of the JAX evaluator's."""
    d, paths = reads
    jeng, teng = engines(flagship, "f32")
    out = {}
    for name, ev in (("jax", JMappingEvaluator(jeng, wire=wire, cache_dir=str(d / "cjax"))),
                     ("port", MappingEvaluator(teng, wire=wire, cache_dir=str(d / "cport")))):
        merged = []
        map_identity = ev.map_identity

        def recording(pred, ref, map_identity=map_identity, merged=merged):
            merged.append((pred, ref))
            return map_identity(pred, ref)

        ev.map_identity = recording
        records = ev.evaluate_files(d / "files_info.json", d / f"{name}_{wire}.json",
                                    verbose=False)
        out[name] = (records, _merged_identity(merged))
    (jrec, jid), (trec, tid) = out["jax"], out["port"]
    print(f"MappingEvaluator {wire}: merged identity port {tid:.3f} JAX {jid:.3f}")
    assert [r["ref_length"] for r in trec] == [r["ref_length"] for r in jrec]
    assert abs(tid - jid) <= 0.3
