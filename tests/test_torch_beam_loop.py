"""The whole-loop beam search of the port against the JAX package on the CPU.

JAX's whole-loop kernel runs in interpret mode
(beam_loop_decode(interpret=True)) on tests/test_beam_loop_pallas.py's setup
(flagship decoder widths, B = 8, 40 raw samples, S a multiple of 8); the
port's CPU path is the loop kernel's plain version. f32 memory: equal tokens
and parents, scores within 2e-4 over the live steps. bf16 memory: >= 99.8%
token agreement. Scores past max_steps are dead outputs and are not
compared. Then the engine's ``beam_impl="loop"`` compact path against the
JAX engine on the trained flagship checkpoint, and the CLI's --beam-impl."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import MAX_OUT, N_SNIP, _merged_identity, flagship, read  # noqa: F401

from ravvent_tpu.assembly.merger import Merger as JMerger
from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.evaluation.basecall import BasecallEngine as JEngine
from ravvent_tpu.models import attention as jattn
from ravvent_tpu.models.basecaller import encode_input as j_encode
from ravvent_tpu.models.basecaller import init_basecaller as j_init
from ravvent_tpu.ops import beam_loop_pallas as jloop
from ravvent_tpu.ops.decode_step_pallas import pack_decoder_weights as j_pack
from ravvent_tpu_torch.assembly.merger import Merger
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.data import simulator
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
from ravvent_tpu_torch.models import attention as tattn
from ravvent_tpu_torch.ops import beam_loop_cuda as tloop
from ravvent_tpu_torch.ops import beam_step_cuda as tstep
from ravvent_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
B, TOTAL, W, V = 8, 12, 5, 7


@pytest.fixture(scope="module")
def memories():
    """Memory from a real encoder pass (raw input, 40 samples, S = 40), in
    f32 and bf16, for both packages."""
    cfg = JConfig(enc_units=128, dec_units=128, encoder_depth=1, decoder_depth=1,
                  data_type="raw")
    jp = j_init(jax.random.PRNGKey(0), cfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    raw = np.random.default_rng(1).normal(size=(B, 40, 1)).astype(np.float32)
    raw[3, 25:] = 0.0  # a row with padding
    enc, mask = j_encode(jp, jnp.asarray(raw), jnp.zeros((B, 6, 5)), cfg)
    S_p = ((enc.shape[1] + 7) // 8) * 8
    enc = jnp.pad(enc, ((0, 0), (0, S_p - enc.shape[1]), (0, 0)))
    mask = jnp.pad(mask, ((0, 0), (0, S_p - mask.shape[1])))
    jd, td = jp["decoder"], tp["decoder"]
    out = {}
    for name, jdt, tdt in (("f32", None, None), ("bf16", jnp.bfloat16, torch.bfloat16)):
        jm = jattn.setup_memory(jd["attention"], enc, mask, jdt,
                                attention_layer=jd["attention_layer"])
        tm = tattn.setup_memory(td["attention"], torch.from_numpy(np.array(enc)),
                                torch.from_numpy(np.array(mask)), tdt,
                                attention_layer=td["attention_layer"])
        out[name] = (jd, jm, td, tm)
    return out


@pytest.mark.parametrize("max_steps", [12, 7])
@pytest.mark.parametrize("mem", ["f32", "bf16"])
def test_beam_loop_decode_matches_pallas_interpret(memories, mem, max_steps):
    jd, jm, td, tm = memories[mem]
    ref = jloop.beam_loop_decode(jd, jm, V, W, TOTAL, max_steps, b_tile=8, interpret=True)
    got = tloop.beam_loop_decode(td, tm, V, W, TOTAL, max_steps)
    ref_tokens = np.asarray(ref.tokens)
    if mem == "f32":
        np.testing.assert_array_equal(got.tokens.numpy(), ref_tokens)
        np.testing.assert_allclose(got.scores[:, :max_steps].numpy(),
                                   np.asarray(ref.scores[:, :max_steps]), rtol=2e-4, atol=2e-4)
    else:
        assert (got.tokens.numpy() == ref_tokens).mean() >= 0.998
    # the dead tail is never computed: zeros, as the per-step loop leaves it
    assert not got.scores[:, max_steps:].any()


@pytest.mark.parametrize("max_steps", [12, 7])
def test_beam_loop_trajectories_match_pallas_interpret(memories, max_steps):
    """Per-step tokens, parents and scores of the live steps, before the
    backtrack, against the reference kernel's raw outputs."""
    jd, jm, td, tm = memories["f32"]
    jtok, jpar, jsc = jloop._beam_loop_call(
        j_pack(jd, V), jnp.asarray(jm.watt_h, jnp.float32), jm.keys, jm.values,
        jm.mask.astype(jnp.float32), max_steps, vocab=V, total_steps=TOTAL, beam_width=W,
        b_tile=8, start_token=2, end_token=1, interpret=True)
    w = tstep.pack_decoder_weights(td, tm)
    tok, par, sc = tloop.beam_loop(tm.keys, tm.values, tm.mask, w, W, TOTAL, max_steps, 2, 1)
    live = slice(0, max_steps)
    as_tbw = lambda a: np.asarray(a).transpose(1, 0, 2)[live]  # noqa: E731
    np.testing.assert_array_equal(tok.numpy()[live], as_tbw(jtok))
    np.testing.assert_array_equal(par.numpy()[live], as_tbw(jpar))
    np.testing.assert_allclose(sc.numpy()[live], as_tbw(jsc), rtol=2e-4, atol=2e-4)


def test_beam_loop_equals_beam_step_decode(memories):
    """The two kernels' loops compute the same beams."""
    _, _, td, tm = memories["bf16"]
    a = tloop.beam_loop_decode(td, tm, V, W, TOTAL, 9)
    b = tstep.beam_step_decode(td, tm, V, W, TOTAL, 9)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.scores, b.scores)


def test_beam_loop_wrapper_uses_plain_version_on_cpu(memories):
    _, _, td, tm = memories["bf16"]
    w = tstep.pack_decoder_weights(td, tm)
    got = tloop.beam_loop(tm.keys, tm.values, tm.mask, w, W, TOTAL, 7, 2, 1)
    ref = tloop.beam_loop_plain(tm.keys, tm.values, tm.mask, w, W, TOTAL, 7, 2, 1)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))


@pytest.mark.parametrize("fault", [None, "token", "score"])
def test_replay_holds_a_loop_result_to_the_plain_step(memories, fault):
    """replay_plain passes the plain loop's own result and catches a pick or
    a score that the plain step does not give."""
    _, _, td, tm = memories["f32"]
    w = tstep.pack_decoder_weights(td, tm)
    tok, par, sc = tloop.beam_loop_plain(tm.keys, tm.values, tm.mask, w, W, TOTAL, 9, 2, 1)
    if fault == "token":
        tok = tok.clone()
        tok[4, 2, 0] = (tok[4, 2, 0] + 3) % V
    elif fault == "score":
        sc = sc.clone()
        sc[6, 5, 1] += 0.05
    rep = tloop.replay_plain(tok, par, sc, tm.keys, tm.values, tm.mask, w, 9, 2, 1)
    assert rep.distinct
    if fault is None:
        assert rep == (1.0, 0.0, 0.0, True)
    elif fault == "token":
        assert rep.exact < 1.0 and rep.rank_err > 1e-2 and rep.score_err > 1e-2
    else:  # the step that adds 0.05, and the steps after it from that cum
        assert rep.score_err == pytest.approx(0.05, abs=1e-5)


def test_engine_rejects_unknown_beam_impl(flagship):
    _, params = flagship
    with pytest.raises(ValueError, match="beam_impl"):
        BasecallEngine(params, ModelConfig(), device="cpu", beam_impl="pallas")


def test_compact_path_loop_f32_memory_matches_jax_engine(flagship, read):
    tree, params = flagship
    sigc, rr, ev, er, _ = read
    jeng = JEngine(tree, JConfig(), chunk_size=32, project_values=True, beam_impl="xla",
                   pack_u8=True)
    teng = BasecallEngine(params, ModelConfig(), chunk_size=32, memory_dtype=None,
                          device="cpu", beam_impl="loop")
    jt, jp = jeng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5)
    tt, tp = teng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5)
    assert tt.shape == (N_SNIP, MAX_OUT)
    np.testing.assert_array_equal(tt, jt)
    live = MAX_OUT - 1
    assert np.abs(tp[:, :live] - jp[:, :live]).max() <= 1 / 255 + 1e-6  # u8 wire


def test_compact_path_loop_bf16_memory_close_to_jax_engine(flagship, read):
    tree, params = flagship
    sigc, rr, ev, er, truth = read
    jeng = JEngine(tree, JConfig(), chunk_size=32, memory_dtype=jnp.bfloat16,
                   project_values=True, beam_impl="xla", pack_u8=True)
    teng = BasecallEngine(params, ModelConfig(), chunk_size=32, device="cpu", beam_impl="loop")
    jt, jp = jeng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5)
    tt, tp = teng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5)
    assert (tt == jt).mean() >= 0.998
    id_jax = _merged_identity(JMerger(), JEngine, jt, jp, rr, truth)
    id_port = _merged_identity(Merger(), BasecallEngine, tt, tp, rr, truth)
    assert abs(id_port - id_jax) <= 0.3


def test_cli_beam_impl_loop_writes_the_step_records(tmp_path):
    from ravvent_tpu_torch.data import chiron
    from ravvent_tpu_torch.tools.basecall import main

    rng = np.random.default_rng(5)
    for i in range(2):
        seq = simulator.random_genome(300, rng)
        sig, ranges = simulator.simulate_read(seq, rng, simulator.PoreModel())
        chiron.write_read(tmp_path / f"r{i}.signal", tmp_path / f"r{i}.label", sig, ranges, seq)
    texts = {}
    for impl in ("step", "loop"):
        out = tmp_path / f"calls_{impl}.fastq"
        main(["--cpu", "--seed", "2", "--input", str(tmp_path), "--out", str(out),
              "--format", "fastq", "--enc-units", "16", "--dec-units", "16",
              "--encoder-depth", "1", "--beam-impl", impl])
        texts[impl] = out.read_text()
    assert texts["loop"] == texts["step"]
    assert texts["loop"].splitlines()[0] == "@r0"
