"""Greedy decode of the port against the JAX package on the CPU.

``greedy_decode`` (plain, over the model's decoder step) against JAX's
``greedy_decode``: f32 tokens equal, logits within 1e-5 relative. The fused
step's plain version against JAX's ``fused_decode_step(interpret=True)``
over 3 chained steps, at tests/test_pallas_decode.py's tolerances. The
fused loop against JAX's ``fused_greedy_decode(interpret=True, b_tile=8)``
on the trained flagship's memory of a read's snippets, where rows finish at
different steps, once to the all-finished point and once cut by max_steps.
Every comparison runs one batch on both sides: ``all_done`` couples the rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _snippets, flagship, read  # noqa: F401

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.decode.greedy import greedy_decode as j_greedy
from ravvent_tpu.models import attention as jattn
from ravvent_tpu.models import decoder as jdec
from ravvent_tpu.models.basecaller import encode_input as j_encode
from ravvent_tpu.models.basecaller import init_basecaller as j_init
from ravvent_tpu.ops import decode_step_pallas as jstep
from ravvent_tpu_torch.decode.greedy import greedy_decode, greedy_loop
from ravvent_tpu_torch.models import attention as tattn
from ravvent_tpu_torch.ops import decode_step_cuda as tstep
from ravvent_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
B, V = 8, 7
TOTAL = 47  # the engines' static decode length


def _memories(jd, td, enc, mask):
    """Un-projected and pre-projected f32 memory of the same encoder output
    for both packages: {name: (JAX memory, port memory)}."""
    out = {}
    for name, layer in (("raw", None), ("projected", "attention_layer")):
        jm = jattn.setup_memory(jd["attention"], jnp.asarray(enc), jnp.asarray(mask),
                                attention_layer=jd[layer] if layer else None)
        tm = tattn.setup_memory(td["attention"], torch.from_numpy(enc), torch.from_numpy(mask),
                                attention_layer=td[layer] if layer else None)
        out[name] = (jm, tm)
    return out


@pytest.fixture(scope="module")
def small():
    """tests/test_pallas_decode.py's setup: random weights at flagship decoder
    widths, raw input of 37 samples, S padded to 40, a multiple of 8."""
    cfg = JConfig(enc_units=128, dec_units=128, encoder_depth=1, decoder_depth=1,
                  data_type="raw")
    jp = j_init(jax.random.PRNGKey(0), cfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    raw = np.random.default_rng(1).normal(size=(B, 37, 1)).astype(np.float32)
    raw[2, 20:] = 0.0  # a row with padding
    enc, mask = j_encode(jp, jnp.asarray(raw), jnp.zeros((B, 6, 5)), cfg)
    S_p = ((enc.shape[1] + 7) // 8) * 8
    enc = np.array(jnp.pad(enc, ((0, 0), (0, S_p - enc.shape[1]), (0, 0))))
    mask = np.array(jnp.pad(mask, ((0, 0), (0, S_p - mask.shape[1]))))
    return jp["decoder"], tp["decoder"], _memories(jp["decoder"], tp["decoder"], enc, mask)


@pytest.fixture(scope="module")
def trained(flagship, read):  # noqa: F811
    """The trained flagship's decoder on the memory of one read's snippets
    (JAX encoder, S = 230 padded to 232)."""
    tree, params = flagship
    sigc, rr, ev, er, _ = read
    raw, event = _snippets(sigc, rr, ev, er)
    enc, mask = j_encode(tree, jnp.asarray(raw), jnp.asarray(event), JConfig())
    enc = np.array(jnp.pad(enc, ((0, 0), (0, 2), (0, 0))))
    mask = np.array(jnp.pad(mask, ((0, 0), (0, 2))))
    return tree["decoder"], params["decoder"], _memories(tree["decoder"], params["decoder"],
                                                         enc, mask)


@pytest.mark.parametrize("max_steps", [None, 5])
@pytest.mark.parametrize("memory", ["raw", "projected"])
def test_greedy_decode_matches_jax(small, memory, max_steps):
    jd, td, mems = small
    jm, tm = mems[memory]
    jt, jl = j_greedy(jd, jm, V, 12, max_steps)
    tt, tl = greedy_decode(td, tm, V, 12, max_steps)
    assert tt.dtype == torch.int32 and tt.shape == (B, 12) and tl.shape == (B, 12, V)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)


def test_greedy_decode_matches_jax_on_trained_decoder(trained):
    jd, td, mems = trained
    jm, tm = mems["raw"]
    jt, jl = j_greedy(jd, jm, V, TOTAL, 39)
    tt, tl = greedy_decode(td, tm, V, TOTAL, 39)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_fused_decode_step_plain_matches_pallas_interpret(small):
    jd, td, mems = small
    jm, tm = mems["raw"]
    jw = jstep.pack_decoder_weights(jd, V)
    tw = tstep.pack_decoder_weights(td)
    state = jdec.zero_state(jd, B, 128, "lstm")
    tok = np.full(B, 2, np.int32)
    tok[5] = V  # an id >= V embeds to zeros, as an all-zero one-hot does
    att, h, c = (torch.zeros(B, 128) for _ in range(3))
    for _ in range(3):  # chained steps: the state handoff too
        emb = jdec.embed(jnp.asarray(tok), V)
        jh, jc, ja, jlog = jstep.fused_decode_step(
            jw, V, emb, state.attention, state.cells[0][0], state.cells[0][1], jm.keys,
            jm.values, jm.mask.astype(jnp.float32), b_tile=8, interpret=True)
        th, tc, ta, tlog = tstep.fused_decode_step_plain(
            tw, torch.from_numpy(tok), att, h, c, tm.keys, tm.values, tm.mask)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=2e-4, atol=2e-4)
        # the next step from the reference's state and argmax
        state = jdec.DecoderState(cells=((jh, jc),), attention=ja)
        att, h, c = (torch.from_numpy(np.array(x)) for x in (ja, jh, jc))
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)


@pytest.mark.parametrize("case", ["to_all_finished", "cut_by_max_steps"])
def test_fused_greedy_decode_matches_pallas_interpret(trained, case):
    jd, td, mems = trained
    jm, tm = mems["raw"]
    max_steps = None if case == "to_all_finished" else 20
    jt, jl = jstep.fused_greedy_decode(jd, jm, V, TOTAL, max_steps, b_tile=8, interpret=True)
    tt, tl = tstep.fused_greedy_decode(td, tm, V, TOTAL, max_steps)
    jt, jl = np.asarray(jt), np.asarray(jl)
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=2e-4, atol=2e-4)
    first_end = np.where((jt == 1).any(axis=1), (jt == 1).argmax(axis=1), TOTAL)
    if case == "to_all_finished":
        # rows finish at different steps; finished rows go on emitting until
        # the last row finishes, then every output is zero
        assert first_end.max() < TOTAL - 1 and len(set(first_end.tolist())) > 1
        assert (jt[:, first_end.min() + 1:first_end.max()] != 0).any()
        assert not jt[:, first_end.max() + 1:].any() and not jl[:, first_end.max() + 1:].any()
    else:
        assert (first_end >= max_steps).any()  # rows still running at the cut
        assert not tt[:, max_steps:].any() and not tl[:, max_steps:].any()


def test_fused_greedy_decode_equals_plain_greedy(trained):
    _, td, mems = trained
    tm = mems["raw"][1]
    a = tstep.fused_greedy_decode(td, tm, V, TOTAL, 39)
    b = greedy_decode(td, tm, V, TOTAL, 39)
    assert torch.equal(a[0], b[0])
    torch.testing.assert_close(a[1], b[1], rtol=1e-5, atol=1e-5)


def test_engine_memory_for_fused_greedy_matches_jax(flagship, read):  # noqa: F811
    """The engine's compact gather (several chunks) and un-projected memory,
    decoded by fused_greedy_decode, against JAX's greedy decode of the same
    snippets."""
    from ravvent_tpu_torch.config import ModelConfig
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine

    tree, params = flagship
    sigc, rr, ev, er, _ = read
    engine = BasecallEngine(params, ModelConfig(), chunk_size=7, device="cpu")
    chunks = list(engine.compact_snippets(sigc, rr, ev, er))
    assert len(chunks) > 1
    raw, event = (torch.cat(x) for x in zip(*chunks))
    raw_np, event_np = _snippets(sigc, rr, ev, er)
    np.testing.assert_array_equal(raw.numpy(), raw_np)
    np.testing.assert_array_equal(event.numpy(), event_np)
    mem = engine.memory(raw, event, project=False)
    assert not mem.projected and mem.keys.dtype == torch.float32 and mem.keys.shape[1] == 232
    enc, mask = j_encode(tree, jnp.asarray(raw_np), jnp.asarray(event_np), JConfig())
    jm = jattn.setup_memory(tree["decoder"]["attention"], jnp.pad(enc, ((0, 0), (0, 2), (0, 0))),
                            jnp.pad(mask, ((0, 0), (0, 2))))
    np.testing.assert_array_equal(mem.mask.numpy(), np.asarray(jm.mask))
    np.testing.assert_allclose(mem.values.numpy(), np.asarray(jm.values), rtol=1e-4, atol=1e-4)
    jt, _ = j_greedy(tree["decoder"], jm, V, TOTAL, 39)
    tt, _ = tstep.fused_greedy_decode(engine.params["decoder"], mem, V, TOTAL, 39)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_fused_decode_step_wrapper_uses_plain_version_on_cpu(small):
    _, td, mems = small
    tm = mems["raw"][1]
    w = tstep.pack_decoder_weights(td)
    gen = torch.Generator().manual_seed(0)
    tok = torch.randint(0, V + 2, (B,), generator=gen, dtype=torch.int32)
    att, h, c = (torch.randn(B, 128, generator=gen) for _ in range(3))
    got = tstep.fused_decode_step(w, tok, att, h, c, tm.keys, tm.values, tm.mask)
    ref = tstep.fused_decode_step_plain(w, tok, att, h, c, tm.keys, tm.values, tm.mask)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))


def test_fused_greedy_decode_rejects_projected_memory(small):
    _, td, mems = small
    with pytest.raises(ValueError, match="un-projected"):
        tstep.fused_greedy_decode(td, mems["projected"][1], V, 12)


def test_greedy_loop_bookkeeping():
    """impute_finished=False: a finished row keeps emitting its argmax; all
    outputs are zero from the step after the last row finishes, and from
    max_steps on."""
    script = torch.tensor([[3, 1, 4, 4, 5], [3, 3, 3, 1, 6]])  # per row, per step
    end = 1

    def step_fn(_cur):
        t = step_fn.t
        step_fn.t += 1
        return torch.nn.functional.one_hot(script[:, t], V).float()

    step_fn.t = 0
    toks, logits = greedy_loop(step_fn, 2, V, 5, None, 2, end, "cpu")
    assert toks.tolist() == [[3, 1, 4, 4, 0], [3, 3, 3, 1, 0]]
    assert not logits[:, 4].any() and logits[0, 2, 4] == 1.0
    step_fn.t = 0
    toks, _ = greedy_loop(step_fn, 2, V, 5, 2, 2, end, "cpu")
    assert toks.tolist() == [[3, 1, 0, 0, 0], [3, 3, 0, 0, 0]]
