"""Mapping identity in the port against the JAX package on the CPU.

``assembly/sce_mapper.map_identity``: records equal to the JAX package's on
the cases of tests/test_sce_mapper.py and tests/test_mapper_decliff.py.
``evaluation/mapping.MappingEvaluator`` on two simulated reads with the
trained flagship: f32 memory gives merged reads, records and totals equal
to the JAX evaluator's; int8 memory (bench.py --memory i8) the identity
within 0.3 points, the JAX engine's beam-step kernel in interpret mode.
"""

import functools
import json
from pathlib import Path

import jax.numpy as jnp  # noqa: F401  (keeps JAX on the CPU set by conftest)
import numpy as np
import pytest
import torch

from ravvent_tpu.assembly import sce_mapper as j_sce
from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.evaluation.basecall import BasecallEngine as JEngine
from ravvent_tpu.evaluation.mapping import MappingEvaluator as JMappingEvaluator
from ravvent_tpu.training.checkpoints import CheckpointManager
from ravvent_tpu_torch.assembly import sce_mapper
from ravvent_tpu_torch.assembly.alignment import banded_global_identity
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.data import chiron, simulator
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
from ravvent_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _random_seq(n, rng):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _mutate(seq, rng, sub=0.05, ins=0.03, dele=0.03):
    """Sequencing-like errors (tests/test_sce_mapper.py's)."""
    out = []
    for ch in seq:
        r = rng.random()
        if r < dele:
            continue
        out.append("ACGT"[rng.integers(4)] if r < dele + sub else ch)
        if rng.random() < ins:
            out.append("ACGT"[rng.integers(4)])
    return "".join(out)


def _mutate_rate(seq, rate, rng):
    """Errors at ``rate`` per base, 60/20/20 substitution, insertion,
    deletion (tests/test_mapper_decliff.py's): true identity ~ 1 - rate."""
    out = []
    for ch in seq:
        if rng.random() >= rate:
            out.append(ch)
            continue
        kind = rng.random()
        if kind < 0.6:
            out.append("ACGT"[("ACGT".index(ch) + rng.integers(1, 4)) % 4])
        elif kind < 0.8:
            out.append(ch)
            out.append("ACGT"[rng.integers(0, 4)])
    return "".join(out)


def _case(name):
    rng = np.random.default_rng(4)
    err = dict(sub=0.03, ins=0.02, dele=0.02)
    if name == "near_perfect":
        ref = _random_seq(3000, rng)
        return _mutate(ref, rng, **err), ref
    if name == "garbage_tail":
        ref = _random_seq(2500, rng)
        return _mutate(ref, rng, **err) + _random_seq(800, rng), ref
    if name == "split":
        ref = _random_seq(6000, rng)
        head, tail = _mutate(ref[:2500], rng, **err), _mutate(ref[2600:], rng, **err)
        return head + _random_seq(1500, rng) + tail, ref
    if name == "reverse":
        ref = _random_seq(2000, rng)
        return sce_mapper.revcomp(_mutate(ref, rng, **err)), ref
    if name == "unmapped":
        return _random_seq(2000, np.random.default_rng(9)), _random_seq(2000, rng)
    if name == "empty":
        return "", "ACGT" * 100
    if name == "reduced_genome":
        read = simulator.generate_reduced_genome(43, 30000, rng)[5000:8000]
        return _mutate(read, rng), read
    if name == "phase_shifted":
        ref = "ACGTGA" * 300
        return ref[3:1500], ref
    if name == "repetitive_coverage":
        ref = ("ACGTGA" * 500)[:2800]
        return _mutate_rate(ref, 0.03, rng), ref
    kind, rate = name.split("@")  # rescue at 50-90% identity
    ref = (_random_seq(3000, rng) if kind == "random"
           else simulator.generate_reduced_genome(43, 3000, rng))
    return _mutate_rate(ref, float(rate), rng), ref


CASES = ["near_perfect", "garbage_tail", "split", "reverse", "unmapped", "empty",
         "reduced_genome", "phase_shifted", "repetitive_coverage"] + [
    f"{kind}@{rate}" for kind in ("random", "reduced") for rate in (0.5, 0.4, 0.25, 0.1)]


@pytest.mark.parametrize("name", CASES)
def test_sce_mapper_equals_jax(name):
    pred, ref = _case(name)
    got = sce_mapper.map_identity(pred, ref)
    assert got == j_sce.map_identity(pred, ref)
    if name.startswith(("random@", "reduced@")) and float(name.split("@")[1]) <= 0.4:
        assert got["read_length"] > 0  # graded, not unmapped, at >= 60% identity


@pytest.fixture(scope="module")
def flagship():
    tree = CheckpointManager(str(REPO / "checkpoints")).restore_numpy("flagship")["params"]
    return tree, from_jax_params(tree)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Two simulated reads of 0.8-1.2 kb as chiron files, on the bench's
    genome recipe and signal profile (bench.py:ensure_dataset)."""
    d = tmp_path_factory.mktemp("reads")
    genome = simulator.generate_reduced_genome(43, 60_000, np.random.default_rng(7))
    simulator.generate_chiron_dataset(d, genome, n_reads=2, read_len_range=(800, 1200), seed=12,
                                      profile=simulator.PROFILES["noisy"])
    chiron.create_files_info(d, stride=6, verbose=False)
    return d


def _evaluate(evaluator, reads, tag):
    """evaluate_files over the reads: (records, totals, merged reads)."""
    merged = []
    map_identity = evaluator.map_identity

    def recording(pred_seq, ref_seq):
        merged.append((pred_seq, ref_seq))
        return map_identity(pred_seq, ref_seq)

    evaluator.map_identity = recording
    out = reads / f"{tag}.json"
    info = next(reads.glob("files_info*.json"))
    records = evaluator.evaluate_files(info, out, verbose=False)
    return records, evaluator.compute_total_results(out), merged


def _identity(merged):
    """Ref-length-weighted banded-global identity (%) of merged reads: the
    flagship's reads of this genome map near chance, where the seed-chain
    mapper reports them unmapped, so the merged bases are compared too."""
    matches = cols = 0
    for pred, ref in merged:
        m, c, _ = banded_global_identity(pred, ref)
        matches, cols = matches + m, cols + c
    return 100.0 * matches / max(cols, 1)


def test_mapping_evaluator_f32_memory_equals_jax(flagship, reads):
    tree, params = flagship
    jeng = JEngine(tree, JConfig(), chunk_size=256, project_values=True, beam_impl="xla")
    teng = BasecallEngine(params, ModelConfig(), chunk_size=256, memory_dtype=None,
                          pack_u8=False, device="cpu")
    jrec, jtot, jmerged = _evaluate(JMappingEvaluator(jeng, cache_dir=str(reads / "jc")), reads,
                                    "j")
    trec, ttot, tmerged = _evaluate(MappingEvaluator(teng, cache_dir=str(reads / "tc")), reads,
                                    "t")
    print(f"MappingEvaluator, f32 memory: totals port {ttot} JAX {jtot}; merged identity port "
          f"{_identity(tmerged):.3f} JAX {_identity(jmerged):.3f}")
    assert len(trec) == 2 and all(r["mapper"] == "sce" for r in trec)
    assert trec == jrec
    assert ttot == jtot
    assert tmerged == jmerged


def test_mapping_evaluator_i8_memory_close_to_jax(flagship, reads, monkeypatch):
    from ravvent_tpu.ops import beam_loop_pallas

    # the JAX engine's "step" path runs its Pallas kernel, which has no CPU
    # lowering outside interpret mode; it imports the entry at trace time
    monkeypatch.setattr(beam_loop_pallas, "beam_step_decode",
                        functools.partial(beam_loop_pallas.beam_step_decode, interpret=True))
    tree, params = flagship
    jeng = JEngine(tree, JConfig(), chunk_size=256, memory_dtype="i8", beam_impl="step")
    teng = BasecallEngine(params, ModelConfig(), chunk_size=256, memory_dtype="i8",
                          pack_u8=False, device="cpu")
    _, jtot, jmerged = _evaluate(JMappingEvaluator(jeng, cache_dir=str(reads / "jc")), reads, "j")
    trec, ttot, tmerged = _evaluate(MappingEvaluator(teng, cache_dir=str(reads / "tc")), reads,
                                    "t")
    # printed, not held: int8 codes turn the two encoders' last-bit
    # differences into rare code flips, and this near-chance decoder's
    # near-tied beams follow them (given the same encoder output the codes
    # and tokens are equal: tests/test_torch_quant.py)
    print(f"MappingEvaluator, i8 memory: totals port {ttot} JAX {jtot}; merged identity port "
          f"{_identity(tmerged):.3f} JAX {_identity(jmerged):.3f}")
    assert len(trec) == 2 and len(tmerged) == len(jmerged) == 2
    assert abs(ttot[0] - jtot[0]) <= 0.3 and ttot[2] == jtot[2]


def test_mapping_evaluator_rejects_what_is_not_ported():
    """Unknown wires are refused; the signal-only wires construct
    (tests/test_torch_sigdev.py runs them against the JAX evaluator); the
    defaults are the reference's. Multi-beam results are ported
    (tests/test_torch_multibeam.py)."""
    for wire, sig_wire in (("sigdev", "i16"), ("sigdev8", "u8")):
        assert MappingEvaluator(None, wire=wire).sig_wire == sig_wire
    with pytest.raises(ValueError, match="wire"):
        MappingEvaluator(None, wire="sigdev16")
    ev = MappingEvaluator(None)
    assert (ev.stride, ev.beam_width, ev.conf_gate) == (6, 5, (0.12, -0.15, 0.12))
    assert ev.merger.geom_arbitration == 4.0
