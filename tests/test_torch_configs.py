"""The non-flagship configurations of the port against the JAX package on
the CPU: GRU and unidirectional encoders, Bahdanau attention, deeper
decoders, and the engine's ``beam_impl="xla"``, with its ``project_values``
and ``total_steps``.

The JAX side runs as its own tests run it on the CPU: the scan encoders and
the XLA decode loops (no Pallas kernel is on these paths). The trained
checkpoints are ``flagship32`` (joint, 3-layer BiLSTM, 2-layer LSTM
decoder), ``ablation3/bigru_raw``, ``gru_raw`` and ``lstm_raw``; Bahdanau
attention, which no checkpoint has, is held on seeded weights.

Tolerances (ROADMAP "How parity is held"): f32 encoder and memory, equal
tokens and floats within 1e-5 relative (scores past ``max_steps`` are dead
outputs and not compared); bf16, >= 99.8% of the tokens and the merged
read's identity within 0.3 points. A bf16 stream's layer outputs are bf16(h),
so a summation order that flips one rounding shows as a bf16 ulp carried by
the recurrence: outputs within 1e-2, f32 final states within 1e-3, as
tests/test_torch_rnn.py holds the BiLSTM.
"""

import dataclasses
import functools
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravvent_tpu.assembly.merger import Merger as JMerger
from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.decode import beam as jbeam
from ravvent_tpu.decode import greedy as jgreedy
from ravvent_tpu.evaluation.basecall import BasecallEngine as JEngine
from ravvent_tpu.models import attention as jattn
from ravvent_tpu.models import basecaller as jbc
from ravvent_tpu.models import decoder as jdec
from ravvent_tpu.models import rnn as jrnn
from ravvent_tpu.parallel.mesh import make_mesh
from ravvent_tpu.training.checkpoints import CheckpointManager as JCheckpoints
from ravvent_tpu.training.loop import Trainer as JTrainer
from ravvent_tpu_torch.assembly.merger import Merger
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
from ravvent_tpu_torch.models import attention as tattn
from ravvent_tpu_torch.models import basecaller as tbc
from ravvent_tpu_torch.models import decoder as tdec
from ravvent_tpu_torch.models import rnn as trnn
from ravvent_tpu_torch.decode import beam as tbeam
from ravvent_tpu_torch.decode import greedy as tgreedy
from ravvent_tpu_torch.training.loop import Trainer, tree_leaves, tree_unflatten
from ravvent_tpu_torch.weights import flatten, from_jax_params, load_npz, save_npz
from test_torch_engine import _merged_identity, _read_compact, _snippets
from test_torch_training import assert_leaves_close, port_cfg
from tests.test_training import small_cfg

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_OUT, BF16_STATE = 1e-2, 1e-3
V, MAX_OUT = 7, 40

# trained checkpoints: (directory, name, config, leaves)
TRAINED = {
    "flagship32": ("checkpoints", "flagship32", dict(encoder_depth=3, decoder_depth=2), 46),
    "bigru_raw": ("checkpoints/ablation3", "bigru_raw",
                  dict(rnn_type="bigru", data_type="raw"), 40),
    "gru_raw": ("checkpoints/ablation3", "gru_raw", dict(rnn_type="gru", data_type="raw"), 24),
    "lstm_raw": ("checkpoints/ablation3", "lstm_raw", dict(rnn_type="lstm", data_type="raw"), 19),
}
BAHDANAU = dict(attention_type="bahdanau")


@functools.lru_cache(maxsize=None)
def model(name: str):
    """(JAX tree with numpy leaves, the port's params, config kwargs) of a
    trained checkpoint, or of the flagship with Bahdanau attention on
    seeded weights ("bahdanau")."""
    if name == "bahdanau":
        tree = jax.tree_util.tree_map(
            np.asarray, jbc.init_basecaller(jax.random.PRNGKey(0), JConfig(**BAHDANAU)))
        return tree, from_jax_params(tree), BAHDANAU
    d, ck, kw, _ = TRAINED[name]
    tree = JCheckpoints(str(REPO / d)).restore_numpy(ck)["params"]
    return tree, from_jax_params(tree), kw


def to_t(x):
    return torch.from_numpy(np.array(np.asarray(x, dtype=np.float32)))


# ------------------------------------------------------------------ encoders


def _stream(xs: np.ndarray, stream: str):
    """The same input on both sides, rounded to bf16 for the bf16 stream."""
    if stream == "f32":
        return jnp.asarray(xs), torch.from_numpy(xs)
    j = jnp.asarray(xs).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, dtype=np.float32)).to(torch.bfloat16)


def _close(got: torch.Tensor, ref, stream: str, state: bool = False):
    g, r = got.float().numpy(), np.asarray(ref, dtype=np.float32)
    if stream == "f32":
        np.testing.assert_allclose(g, r, **TOL)
    else:
        assert np.abs(g - r).max() <= (BF16_STATE if state else BF16_OUT)


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_run_rnn_layer_matches_jax(cell, reverse, stream):
    B, T, F, U = 4, 10, 5, 16
    rng = np.random.default_rng(3)
    jp = jrnn.CELLS[cell][0](jax.random.PRNGKey(1), F, U)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    jx, tx = _stream(rng.normal(size=(B, T, F)).astype(np.float32), stream)
    n = 2 if cell == "lstm" else 1
    init = tuple((0.5 * rng.normal(size=(B, U))).astype(np.float32) for _ in range(n))
    jout, jfin = jrnn.run_rnn_layer(jp, cell, jx, tuple(map(jnp.asarray, init)), reverse)
    tout, tfin = trnn.run_rnn_layer(tp, cell, tx, tuple(map(torch.from_numpy, init)), reverse)
    assert tout.dtype == tx.dtype and len(tfin) == n
    _close(tout, jout, stream)
    for g, r in zip(tfin, jfin):
        _close(g, r, stream, state=True)


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("seeded", [False, True], ids=["zero_state", "initial_state"])
def test_gru_run_bidi_layer_matches_jax(seeded, stream):
    B, T, F, U = 4, 10, 5, 16
    rng = np.random.default_rng(4)
    jl = jrnn.init_encoder(jax.random.PRNGKey(2), U, 1, F, "gru")[0]
    tl = from_jax_params(jax.tree_util.tree_map(np.asarray, jl))
    jx, tx = _stream(rng.normal(size=(B, T, F)).astype(np.float32), stream)
    h0 = (0.5 * rng.normal(size=(2, B, U))).astype(np.float32) if seeded else None
    jout, (jh,) = jrnn.run_bidi_layer(jl, "gru", jx, None if h0 is None else (jnp.asarray(h0),))
    tout, (th,) = trnn.run_bidi_layer(tl, tx, None if h0 is None else (torch.from_numpy(h0),),
                                      "gru")
    assert tout.shape == (B, T, 2 * U) and tout.dtype == tx.dtype
    _close(tout, jout, stream)
    _close(th, jh, stream, state=True)


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("rnn_type", ["bilstm", "bigru", "lstm", "gru"])
def test_encoder_apply_matches_jax(rnn_type, stream):
    """Two stacked layers; layer 0's final states seed layer 1. The
    unidirectional encoder's final state comes back as ``(carry,)``."""
    B, T, F, U = 4, 10, 5, 16
    cfg = JConfig(rnn_type=rnn_type, enc_units=U)
    jls = jrnn.init_encoder(jax.random.PRNGKey(5), U, 2, F, cfg.cell_type, cfg.bidirectional)
    tls = from_jax_params(jax.tree_util.tree_map(np.asarray, jls))
    jx, tx = _stream(np.random.default_rng(6).normal(size=(B, T, F)).astype(np.float32), stream)
    jout, jst = jrnn.encoder_apply(jls, jx, cfg.cell_type, cfg.bidirectional)
    tout, tst = trnn.encoder_apply(tls, tx, cell_type=cfg.cell_type,
                                   bidirectional=cfg.bidirectional)
    assert tout.shape == (B, T, cfg.enc_out_dim) and tout.dtype == tx.dtype
    _close(tout, jout, stream)
    jleaves, tleaves = jax.tree_util.tree_leaves(jst), jax.tree_util.tree_leaves(tst)
    assert len(tleaves) == len(jleaves) == (2 if cfg.cell_type == "lstm" else 1)
    assert jax.tree_util.tree_structure(jst) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, tst))
    for g, r in zip(tleaves, jleaves):
        _close(g, r, stream, state=True)
    if rnn_type != "bilstm":
        with pytest.raises(ValueError, match="only bidirectional LSTM"):
            trnn.encoder_apply(tls, tx, [()], cell_type=cfg.cell_type,
                               bidirectional=cfg.bidirectional)


@pytest.mark.parametrize("rnn_type", ["bigru", "lstm", "gru"])
@pytest.mark.parametrize("attention", ["luong", "bahdanau"])
def test_seeded_init_has_the_jax_tree(rnn_type, attention):
    kw = dict(enc_units=16, dec_units=16, encoder_depth=2, decoder_depth=2, rnn_type=rnn_type,
              attention_type=attention)
    ref = flatten(jax.tree_util.tree_map(np.asarray,
                                         jbc.init_basecaller(jax.random.PRNGKey(0), JConfig(**kw))))
    got = flatten(tbc.init_basecaller(ModelConfig(**kw), torch.Generator().manual_seed(0)))
    assert sorted(got) == sorted(ref)
    assert all(got[k].shape == ref[k].shape for k in ref)
    if attention == "bahdanau":
        v = got["decoder/attention/attention_v"]
        assert np.abs(v).max() <= np.sqrt(6.0 / 32) and v.std() > 0


# ----------------------------------------------------------------- attention


@pytest.fixture(scope="module")
def bahdanau_parts():
    """Seeded Bahdanau attention at the flagship's widths over a small
    encoder-like memory with ragged masks."""
    B, S, E, U, W = 3, 24, 256, 128, 5
    rng = np.random.default_rng(7)
    jp = jattn.init_attention(jax.random.PRNGKey(3), "bahdanau", U, E, U)
    layer = {"kernel": jrnn.glorot_uniform(jax.random.PRNGKey(4), (U + E, U))}
    enc = rng.normal(size=(B, S, E)).astype(np.float32)
    mask = np.ones((B, S), bool)
    mask[1, 17:] = False
    mask[2, :] = False  # an all-masked row: uniform alignments
    query = rng.normal(size=(B, W, U)).astype(np.float32)
    return jp, layer, enc, mask, query


@pytest.mark.parametrize("projected", [False, True], ids=["values", "projected"])
@pytest.mark.parametrize("memory", ["f32", "bf16"])
def test_bahdanau_attend_beams_matches_jax(bahdanau_parts, memory, projected):
    """f32: setup_memory and attend_beams on both sides, 1e-5. bf16: both
    sides attend on the JAX memory's own bf16 keys and values; the
    alignments within 1e-5, the context within 2e-3 relative (an alignment
    rounded to bf16 on the other side of a rounding boundary moves one term
    by a bf16 ulp, 2^-8 relative)."""
    jp, layer, enc, mask, query = bahdanau_parts
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    tlayer = from_jax_params(jax.tree_util.tree_map(np.asarray, layer)) if projected else None
    dt = jnp.bfloat16 if memory == "bf16" else None
    jm = jattn.setup_memory(jp, jnp.asarray(enc), jnp.asarray(mask), dt,
                            attention_layer=layer if projected else None)
    if memory == "f32":
        tm = tattn.setup_memory(tp, torch.from_numpy(enc), torch.from_numpy(mask), None,
                                attention_layer=tlayer)
        for g, r in ((tm.keys, jm.keys), (tm.values, jm.values)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    else:
        bf = lambda x: to_t(x).to(torch.bfloat16)  # noqa: E731
        tm = tattn.AttnMemory(bf(jm.keys), bf(jm.values), torch.from_numpy(mask),
                              None if jm.watt_h is None else to_t(jm.watt_h))
    jc, ja = jattn.attend_beams(jp, "bahdanau", jnp.asarray(query), jm)
    tc, ta = tattn.attend_beams(tp, "bahdanau", torch.from_numpy(query), tm)
    assert tc.shape == (3, 5, 128 if projected else 256)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    if memory == "f32":
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    else:
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-3, atol=2e-3)
    assert torch.allclose(ta[2], torch.full_like(ta[2], 1.0 / ta.shape[2]))


# ------------------------------------------------------------------- decoder


@pytest.mark.parametrize("case", ["gru", "depth2", "gru_depth2_bahdanau"])
def test_decoder_step_matches_jax(case):
    cell = "gru" if "gru" in case else "lstm"
    depth = 2 if "depth2" in case else 1
    att = "bahdanau" if "bahdanau" in case else "luong"
    B, S, E, U = 4, 16, 32, 16
    rng = np.random.default_rng(8)
    jd = jdec.init_decoder(jax.random.PRNGKey(6), V, depth, U, E, att, cell)
    td = from_jax_params(jax.tree_util.tree_map(np.asarray, jd))
    enc = rng.normal(size=(B, S, E)).astype(np.float32)
    mask = rng.random((B, S)) < 0.8
    jm = jattn.setup_memory(jd["attention"], jnp.asarray(enc), jnp.asarray(mask))
    tm = tattn.setup_memory(td["attention"], torch.from_numpy(enc), torch.from_numpy(mask))
    js = jdec.zero_state(jd, B, U, cell)
    ts = tdec.zero_state(td, B, U, cell)
    assert len(ts.cells) == depth and all(len(c) == (2 if cell == "lstm" else 1) for c in ts.cells)
    tok = rng.integers(0, V, size=B)
    for _ in range(3):  # the state carries through the steps
        js, jl, ja = jdec.decoder_step(jd, js, jdec.embed(jnp.asarray(tok), V), jm, att, cell)
        ts, tl, ta = tdec.decoder_step(td, ts, tdec.embed(torch.from_numpy(tok), V), tm, 1,
                                       att, cell)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(ta[:, 0].numpy(), np.asarray(ja), **TOL)
        for g, r in zip(jax.tree_util.tree_leaves(ts), jax.tree_util.tree_leaves(js)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
        tok = np.array(jnp.argmax(jl, axis=-1))


# ------------------------------------------- decode on the trained checkpoints


DECODE_SNIP, DECODE_TOTAL = 12, 20


@functools.lru_cache(maxsize=None)
def decode_memories(name: str):
    """The JAX encoder's f32 memory of the read's first DECODE_SNIP
    snippets, un-projected and pre-projected, for both packages."""
    tree, params, kw = model(name)
    cfg = JConfig(**kw)
    raw, event = _snippets(*_read_compact()[:4])
    enc, mask = jbc.encode_input(tree, jnp.asarray(raw[:DECODE_SNIP]),
                                 jnp.asarray(event[:DECODE_SNIP]), cfg)
    td = params["decoder"]
    out = {}
    for proj in (False, True):
        layer = tree["decoder"]["attention_layer"] if proj else None
        jm = jattn.setup_memory(tree["decoder"]["attention"], enc, mask, attention_layer=layer)
        tm = tattn.AttnMemory(to_t(jm.keys), to_t(jm.values), torch.from_numpy(np.asarray(mask)),
                              None if jm.watt_h is None else to_t(jm.watt_h))
        out[proj] = (jm, tm)
    return cfg, tree["decoder"], td, out


DECODE_CASES = list(TRAINED) + ["bahdanau"]


@pytest.mark.parametrize("name", DECODE_CASES)
def test_beam_and_greedy_decode_match_jax(name):
    """The plain decoders on the same f32 memory: beam 5 on projected
    memory with max_steps 14 of 20 steps (the JAX engine's XLA path with
    project_values), greedy on un-projected memory."""
    cfg, jd, td, mems = decode_memories(name)
    att, cell = cfg.effective_attention, cfg.cell_type
    jm, tm = mems[True]
    ref = jbeam.beam_decode(jd, jm, V, 5, DECODE_TOTAL, 14, att, cell)
    got = tbeam.beam_decode(td, tm, V, 5, DECODE_TOTAL, 14, att, cell)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(got.scores[:, :14].numpy(), np.asarray(ref.scores[:, :14]), **TOL)
    assert not got.scores[:, 14:].any()  # the dead tail is never computed
    jm, tm = mems[False]
    jt, jl = jgreedy.greedy_decode(jd, jm, V, DECODE_TOTAL, 17, att, cell)
    tt, tl = tgreedy.greedy_decode(td, tm, V, DECODE_TOTAL, 17, att, cell)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


# -------------------------------------------------------------------- engine


@functools.lru_cache(maxsize=None)
def jax_engine_beam(project: bool, total_steps: int):
    tree, _, kw = model("flagship32")
    eng = JEngine(tree, JConfig(**kw), chunk_size=16, total_steps=total_steps,
                  project_values=project, beam_impl="xla")
    raw, event = _snippets(*_read_compact()[:4])
    return eng.predict_beam(raw, event, MAX_OUT, 5)


@pytest.mark.parametrize("total_steps", [12, 47])
@pytest.mark.parametrize("project", [False, True], ids=["values", "projected"])
def test_xla_engine_predict_beam_matches_jax_on_flagship32(project, total_steps):
    """f32 encoder and memory, the trained flagship32, 24 snippets in two
    chunks: equal tokens, live step probabilities within 1e-5."""
    _, params, kw = model("flagship32")
    eng = BasecallEngine(params, ModelConfig(**kw), chunk_size=16, memory_dtype=None,
                         device="cpu", beam_impl="xla", total_steps=total_steps,
                         project_values=project)
    raw, event = _snippets(*_read_compact()[:4])
    jt, jp = jax_engine_beam(project, total_steps)
    tt, tp = eng.predict_beam(raw, event, MAX_OUT, 5)
    live = min(total_steps, MAX_OUT - 1)
    assert tt.shape == jt.shape == (raw.shape[0], min(total_steps, MAX_OUT))
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp[:, :live], jp[:, :live], **TOL)
    mem = eng.memory(torch.from_numpy(raw[:2]), torch.from_numpy(event[:2]))
    assert mem.projected == project and mem.keys.shape[1] == 230  # not padded on "xla"


def test_xla_engine_bench_settings_close_to_jax_on_flagship32():
    """bench.py's settings on the "xla" path: the i8dev wire, a bf16 encoder
    stream, bf16 pre-projected memory, 4-bit probs; >= 99.8% of the tokens
    and the merged read's identity within 0.3 points."""
    tree, params, kw = model("flagship32")
    sigc, rr, ev, er, truth, aux = _read_compact()
    jeng = JEngine(tree, JConfig(**kw), chunk_size=16, memory_dtype=jnp.bfloat16,
                   project_values=True, beam_impl="xla", encoder_dtype=jnp.bfloat16,
                   pack_u8=True, transport_dtype="i8dev", prob_bits=4)
    teng = BasecallEngine(params, ModelConfig(**kw), chunk_size=16, memory_dtype=torch.bfloat16,
                          encoder_dtype=torch.bfloat16, transport_dtype="i8dev", prob_bits=4,
                          device="cpu", beam_impl="xla", project_values=True)
    jt, jp = jeng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5, aux=aux)
    tt, tp = teng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5, aux=aux)
    assert tt.shape == jt.shape == (rr.shape[0], MAX_OUT)
    id_jax = _merged_identity(JMerger(), JEngine, jt, jp, rr, truth)
    id_port = _merged_identity(Merger(), BasecallEngine, tt, tp, rr, truth)
    print(f"flagship32 bench settings on xla: tokens agree {(tt == jt).mean():.5f}, identity "
          f"port {id_port:.3f} JAX {id_jax:.3f}")
    assert (tt == jt).mean() >= 0.998
    assert abs(id_port - id_jax) <= 0.3


@pytest.mark.parametrize("name", ["bigru_raw", "gru_raw", "lstm_raw", "bahdanau"])
def test_xla_engine_compact_and_greedy_match_jax(name):
    """The CLI's wire (f16) with an f32 encoder and memory, un-projected
    values, beam 3 and two beams out; and predict_greedy on the same
    engine: equal tokens, floats within 1e-5."""
    tree, params, kw = model(name)
    sigc, rr, ev, er, _ = _read_compact()[:5]
    rr, er = rr[:12], er[:12]
    jeng = JEngine(tree, JConfig(**kw), chunk_size=8, beam_impl="xla", pack_u8=True, n_beams=2)
    teng = BasecallEngine(params, ModelConfig(**kw), chunk_size=8, memory_dtype=None,
                          device="cpu", beam_impl="xla", n_beams=2)
    jt, jp = jeng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 3)
    tt, tp = teng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 3)
    assert tt.shape == jt.shape == (12, 2, MAX_OUT)
    np.testing.assert_array_equal(tt, jt)
    assert np.abs(tp - jp)[..., :MAX_OUT - 1].max() <= 1 / 255 + 1e-6  # the u8 wire
    raw, event = _snippets(sigc, rr, ev, er)
    jg, jl = jeng.predict_greedy(raw, event, 24)
    tg, tl = teng.predict_greedy(raw, event, 24)
    # JAX pads a chunk's rows, which shifts the batch-wide stop: compare each
    # row up to its end token (decode/greedy.py)
    for a, b in zip(tg, jg):
        n = int(np.argmax(b == 1)) + 1 if (b == 1).any() else b.size
        np.testing.assert_array_equal(a[:n], b[:n])
    live = tg != 0
    np.testing.assert_allclose(tl[live], jl[live], **TOL)


def test_xla_engine_refusals_and_defaults():
    _, params, kw = model("bahdanau")
    for cfg in (ModelConfig(rnn_type="bigru"), ModelConfig(attention_type="bahdanau"),
                ModelConfig(decoder_depth=2), ModelConfig(rnn_type="gru")):
        for impl in ("step", "loop"):
            with pytest.raises(ValueError, match="beam_impl='xla'"):
                BasecallEngine(params, cfg, device="cpu", beam_impl=impl)
    for mem in ("i8", "i8mxu"):
        with pytest.raises(ValueError, match="int8 memory requires beam_impl='step'"):
            BasecallEngine(params, ModelConfig(**kw), device="cpu", beam_impl="xla",
                           memory_dtype=mem)
    with pytest.raises(ValueError, match="rnn_type"):
        BasecallEngine(params, ModelConfig(rnn_type="rnn"), device="cpu", beam_impl="xla")
    with pytest.raises(ValueError, match="attention_type"):
        tbc.check_config(ModelConfig(attention_type="dot"))
    # force_luong makes the Bahdanau config Luong, which the kernels take
    _, fparams, _ = model("flagship32")
    forced = ModelConfig(attention_type="bahdanau", force_luong=True)
    assert BasecallEngine(model("lstm_raw")[1], dataclasses.replace(
        forced, rnn_type="lstm", data_type="raw"), device="cpu").project_values
    # the port's defaults: the kernels' step path, bf16 memory, 4096-row chunks
    eng = BasecallEngine(fparams, ModelConfig(encoder_depth=3, decoder_depth=2), device="cpu",
                         beam_impl="xla")
    assert (eng.total_steps, eng.project_values, eng.memory_dtype, eng.chunk_size) == (
        47, False, torch.bfloat16, 4096)
    assert eng._enc_weights["encoder_raw"][0][3].kx == 4  # the BiLSTM laid out for B1
    assert BasecallEngine(model("gru_raw")[1], ModelConfig(rnn_type="gru", data_type="raw"),
                          device="cpu", beam_impl="xla")._enc_weights == {}


# ---------------------------------------------------------------- weights, CLI


@pytest.mark.parametrize("name", list(TRAINED))
def test_weights_carry_the_trained_trees(name, tmp_path):
    tree, params, _ = model(name)
    ref, got = flatten(tree), flatten(params)
    assert len(got) == len(ref) == TRAINED[name][3]
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    save_npz(tmp_path / "w.npz", params)
    back = flatten(load_npz(tmp_path / "w.npz"))
    assert sorted(back) == sorted(ref) and all(np.array_equal(back[k], ref[k]) for k in ref)


def test_cli_serves_flagship32_as_the_engine_does(tmp_path):
    """``--weights`` of flagship32 with ``--encoder-depth 3 --decoder-depth 2
    --beam-impl xla --cpu``: the FASTA equals the CLI's read path over an
    engine built the same way."""
    from ravvent_tpu_torch.data import chiron, simulator
    from ravvent_tpu_torch.tools.basecall import basecall_read, main

    _, params, kw = model("flagship32")
    save_npz(tmp_path / "flagship32.npz", params)
    rng = np.random.default_rng(9)
    seq = simulator.random_genome(150, rng)
    sig, ranges = simulator.simulate_read(seq, rng, simulator.PoreModel())
    d = tmp_path / "in"
    d.mkdir()
    chiron.write_read(d / "r0.signal", d / "r0.label", sig, ranges, seq)
    out = tmp_path / "calls.fasta"
    main(["--cpu", "--weights", str(tmp_path / "flagship32.npz"), "--input", str(d), "--out",
          str(out), "--encoder-depth", "3", "--decoder-depth", "2", "--beam-impl", "xla"])
    lines = out.read_text().splitlines()
    eng = BasecallEngine(load_npz(tmp_path / "flagship32.npz"), ModelConfig(**kw), device="cpu",
                         beam_impl="xla", project_values=True)
    call = basecall_read(eng, Merger(), sig, chiron.load_label(d / "r0.label")[0])
    assert lines == [">r0", call.merged.seq] and len(call.merged.seq) > 0


# ------------------------------------------------------------------- training


def train_cfg():
    """tests/test_training.py's small config with a bidirectional GRU
    encoder, Bahdanau attention and a depth-2 decoder."""
    cfg = small_cfg()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rnn_type="bigru", attention_type="bahdanau", decoder_depth=2))


@pytest.fixture(scope="module")
def train_batch():
    """8 seeded snippets of a simulated read: raw, events, targets."""
    from ravvent_tpu.data import chiron as jchiron
    from ravvent_tpu.data import simulator as jsim
    from ravvent_tpu.data.generator import SnippetBatchGenerator as JGenerator

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        genome = jsim.random_genome(3000, np.random.default_rng(0))
        jsim.generate_chiron_dataset(d, genome, n_reads=2, read_len_range=(500, 700), seed=1)
        fi = jchiron.create_files_info(d, stride=6, verbose=False)
        return JGenerator(fi, stride=6, batch_size=8, shuffle=False, cache_dir=str(d / "c"))[0]


def test_loss_and_grads_match_jax_on_gru_bahdanau_depth2(train_batch):
    cfg = train_cfg().model
    raw, event, targets = train_batch
    jp = jbc.init_basecaller(jax.random.PRNGKey(3), cfg)

    def jloss(params):
        out = jbc.train_forward(params, jnp.asarray(raw), jnp.asarray(event),
                                jnp.asarray(targets), cfg)
        return out.loss, out.acc

    (jl, jacc), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = jax.tree_util.tree_map(lambda x: torch.tensor(np.asarray(x), requires_grad=True), jp)
    out = tbc.train_forward(tp, torch.from_numpy(raw), torch.from_numpy(event),
                            torch.from_numpy(targets), cfg)
    grads = torch.autograd.grad(out.loss, tree_leaves(tp))
    np.testing.assert_allclose(float(out.loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(out.acc), float(jacc), rtol=1e-6)
    assert all(float(g.abs().max()) > 0 for g in grads)  # every leaf learns
    assert_leaves_close(tree_unflatten(tp, grads), jg, 1e-4)


def test_trainer_steps_track_jax_trainer_on_gru_bahdanau_depth2(train_batch):
    cfg = train_cfg()
    jtr = JTrainer(cfg, mesh=make_mesh(1))
    tr = Trainer(port_cfg(cfg), params=from_jax_params(
        jax.tree_util.tree_map(np.asarray, jtr.params)), device="cpu")
    for _ in range(3):
        jm, tm = jtr.train_on_batch(train_batch), tr.train_on_batch(train_batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["acc"]), float(jm["acc"]), atol=1e-6)
    jv, tv = jtr.validate_on_batch(train_batch), tr.validate_on_batch(train_batch)
    np.testing.assert_allclose(float(tv["loss"]), float(jv["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tv["acc"]), float(jv["acc"]), atol=1e-5)
