"""Top-K beams per snippet (BasecallEngine(n_beams=K)) and the mapping
evaluator's phase-aware beam selection, against the JAX package on the CPU
(ravvent_tpu/evaluation/basecall.py:398-411, 476-478, 1024-1060;
ravvent_tpu/evaluation/mapping.py:156-176, 200-205;
tests/test_beam_selection.py).

On the trained flagship: f32 memory gives every beam's tokens equal to the
JAX engine's over the live steps; the bench's bf16 settings >= 99.8% in
every beam. Beam 0 of K beams equals the n_beams=1 result bit for bit on
every wire. The selection equals the JAX evaluator's on the same arrays, and
MappingEvaluator with n_beams=2 merges the JAX evaluator's reads on the
compact wire (selection) and on sigdev (top beam)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.evaluation.basecall import BasecallEngine as JEngine
from ravvent_tpu.evaluation.mapping import MappingEvaluator as JMappingEvaluator
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.data import simulator
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER
from test_torch_engine import MAX_OUT, N_SNIP, _read_compact, _snippets, flagship  # noqa: F401
from test_torch_sigdev import segment_op_by_op

torch.set_num_threads(1)
K = 3

# the JAX engine's and the port's settings: f32 memory and encoder on the
# f16 wire, and the bench's (i8dev wire, bf16 encoder stream and memory,
# 4-bit probabilities)
SETTINGS = {
    "f32": (dict(), dict(memory_dtype=None)),
    "bench": (dict(memory_dtype=jnp.bfloat16, encoder_dtype=jnp.bfloat16, transport_dtype="i8dev",
                   prob_bits=4),
              dict(memory_dtype=torch.bfloat16, encoder_dtype=torch.bfloat16,
                   transport_dtype="i8dev", prob_bits=4)),
}


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_top_k_beams_match_jax_engine(flagship, setting):
    (jkw, tkw), (tree, params) = SETTINGS[setting], flagship
    sigc, rr, ev, er, _, aux = _read_compact()
    jeng = JEngine(tree, JConfig(), chunk_size=16, project_values=True, beam_impl="xla",
                   pack_u8=True, n_beams=K, **jkw)
    teng = BasecallEngine(params, ModelConfig(), chunk_size=16, device="cpu", n_beams=K, **tkw)
    jt, jp = jeng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5, aux=aux)
    tt, tp = teng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5, aux=aux)
    assert tt.shape == jt.shape == (N_SNIP, K, MAX_OUT)
    live = MAX_OUT - 1
    agree = [(tt[:, k, :live] == jt[:, k, :live]).mean() for k in range(K)]
    print(f"top {K} beams, {setting}: tokens agree by beam {np.round(agree, 5).tolist()}")
    if setting == "f32":
        np.testing.assert_array_equal(tt[..., :live], jt[..., :live])
        assert np.abs(tp[..., :live] - jp[..., :live]).max() <= 1 / 255 + 1e-6  # u8 wire
    else:
        assert min(agree) >= 0.998
    assert (tt[:, 0] != tt[:, 1]).any()  # the beams are distinct decodes


# (wire, max_output_len, other engine settings): an odd K * 47 columns pads
# the nibble row at its end
WIRE_CASES = {
    "f16-40": ("f16", 40, dict()),
    "f16-48": ("f16", 48, dict()),
    "f16-unpacked": ("f16", 48, dict(pack_u8=False)),
    "i8dev-48": ("i8dev", 48, dict(encoder_dtype=torch.bfloat16, prob_bits=4)),
    "loop-48": ("f16", 48, dict(beam_impl="loop")),
    "sigdev-48": ("sigdev", 48, dict(encoder_dtype=torch.bfloat16, prob_bits=4)),
    "materialized": ("predict_beam", 40, dict()),
}


@pytest.mark.parametrize("case", list(WIRE_CASES))
def test_beam0_equals_single_beam(flagship, case):
    """The port's counterpart of tests/test_beam_selection.py:79-116: K beams
    [N, K, T] whose beam 0 is the n_beams=1 result, tokens and step
    probabilities bit for bit."""
    wire, max_out, kw = WIRE_CASES[case]
    sigc, rr, ev, er, _, aux = _read_compact()
    out = {}
    for n_beams in (1, K):
        eng = BasecallEngine(flagship[1], ModelConfig(), chunk_size=16, device="cpu",
                             n_beams=n_beams, transport_dtype="f16" if wire in (
                                 "sigdev", "predict_beam") else wire, **kw)
        if wire == "sigdev":
            raw = simulator.simulate_read(simulator.random_genome(300, np.random.default_rng(4)),
                                          np.random.default_rng(5), simulator.PoreModel())[0]
            out[n_beams] = eng.predict_beam_signal(np.asarray(raw), max_out, 5)
        elif wire == "predict_beam":
            out[n_beams] = eng.predict_beam(*_snippets(sigc, rr, ev, er), max_out, 5)
        else:
            out[n_beams] = eng.predict_beam_compact(sigc, rr, ev, er, max_out, 5, aux=aux)
    (t1, p1), (tk, pk) = out[1], out[K]
    T = min(47, -(-max_out // 8) * 8)
    assert t1.shape == p1.shape == (t1.shape[0], T) and t1.shape[0] >= N_SNIP
    assert tk.shape == pk.shape == (t1.shape[0], K, T)
    np.testing.assert_array_equal(tk[:, 0], t1)
    np.testing.assert_array_equal(pk[:, 0], p1)
    assert (tk[:, 0] != tk[:, 1]).any()


def test_n_beams_below_one_is_refused(flagship):
    with pytest.raises(ValueError, match="n_beams"):
        BasecallEngine(flagship[1], ModelConfig(), device="cpu", n_beams=0)


def _beam_arrays(beam_seqs, T, rng):
    """tokens [N, K, T] as the engine returns them (bases, then the end
    token to the end) and step probabilities, beam 0 the most confident."""
    N, nk = len(beam_seqs), len(beam_seqs[0])
    tokens = np.full((N, nk, T), NUC_TOKENIZER.end_id, np.int64)
    for i, beams in enumerate(beam_seqs):
        for k, s in enumerate(beams):
            tokens[i, k, :len(s)] = NUC_TOKENIZER.texts_to_sequences([s])[0]
    probs = rng.uniform(0.55, 0.95, size=(N, nk, T)) - 0.1 * np.arange(nk)[None, :, None]
    return tokens, probs.astype(np.float32)


def _periodic(rng):
    """tests/test_beam_selection.py:18-76: a periodic read cut into
    overlapping snippets; every third snippet's top beam is one period off."""
    period, L, step = "ACGTGA", 30, 12
    genome = period * 40
    snips = [genome[s:s + L] for s in range(0, len(genome) - L + 1, step)]
    beams = [[s[len(period):] + period, s, period + s[:-len(period)]] if i % 3 == 1
             else [s, s[len(period):] + period, period + s[:-len(period)]]
             for i, s in enumerate(snips)]
    return snips, beams, step


def _unambiguous(rng):
    genome = "".join(rng.choice(list("ACGT"), 300))
    L, step = 30, 12
    snips = [genome[s:s + L] for s in range(0, len(genome) - L + 1, step)]
    return snips, [[s, s[:10] + "TTTT" + s[14:], s[::-1]] for s in snips], step


@pytest.mark.parametrize("read", ["periodic", "unambiguous"])
def test_select_beams_equals_jax(read):
    rng = np.random.default_rng(0)
    snips, beams, step = (_periodic if read == "periodic" else _unambiguous)(rng)
    tokens, probs = _beam_arrays(beams, 40, rng)
    # raw ranges of 10 samples a base: consecutive snippets overlap by L - step bases
    rr = np.array([[10 * step * i, 10 * (step * i + len(s))] for i, s in enumerate(snips)])
    tt, tp = MappingEvaluator(None)._select_beams(tokens, probs, rr)
    jt, jp = JMappingEvaluator(None)._select_beams(tokens, probs, rr)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tp, jp)
    assert tt.shape == (len(snips), 40)
    chosen = NUC_TOKENIZER.sequences_to_texts(tt)
    assert [c.upper() for c in chosen] == snips  # the phase-consistent chain, beam 0 otherwise


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """tests/test_torch_sigdev.py's two reads (500-700 bases, the bench's
    genome recipe and the noisy profile) as chiron files with files info."""
    d = tmp_path_factory.mktemp("reads")
    genome = simulator.generate_reduced_genome(43, 60_000, np.random.default_rng(7))
    simulator.generate_chiron_dataset(d, genome, n_reads=2, read_len_range=(500, 700), seed=12,
                                      profile=simulator.PROFILES["noisy"])
    paths = sorted(str(p) for p in d.glob("*.signal"))
    (d / "files_info.json").write_text(json.dumps([{"signal_path": p} for p in paths]))
    return d, paths


@pytest.mark.parametrize("wire", ["compact", "sigdev"])
def test_mapping_evaluator_multibeam_equals_jax(flagship, reads, wire):
    """n_beams=2, f32 memory and encoder: the merged reads equal the JAX
    evaluator's, and the compact wire's selection picked beam 1 somewhere."""
    tree, params = flagship
    d, paths = reads
    jeng = segment_op_by_op(JEngine(tree, JConfig(), chunk_size=64, project_values=True,
                                    beam_impl="xla", pack_u8=True, n_beams=2))
    teng = BasecallEngine(params, ModelConfig(), chunk_size=64, memory_dtype=None, device="cpu",
                          n_beams=2)
    merged, picks = {}, []
    for name, ev in (("jax", JMappingEvaluator(jeng, wire=wire, cache_dir=str(d / "cj"))),
                     ("port", MappingEvaluator(teng, wire=wire, cache_dir=str(d / "cp")))):
        merged[name] = [ev.basecall_read(p).seq for p in paths]
    if wire == "compact":
        ev = MappingEvaluator(teng, cache_dir=str(d / "cp"))
        select = ev._select_beams

        def recording(tokens, probs, rr):
            out = select(tokens, probs, rr)
            picks.append((out[0] != tokens[:, 0]).any(axis=1).sum())
            return out

        ev._select_beams = recording
        assert [ev.basecall_read(p).seq for p in paths] == merged["port"]
        assert len(picks) == len(paths) and sum(picks) > 0
    print(f"MappingEvaluator n_beams=2, {wire}: merged lengths {[len(s) for s in merged['port']]}"
          f"; snippets off the top beam {picks}")
    assert merged["port"] == merged["jax"]
    assert all(len(s) > 100 for s in merged["port"])
