"""Beam search of the port against the JAX package on the CPU.

JAX's per-step fused beam kernel runs in interpret mode
(beam_step_decode(interpret=True)); the port's CPU path is the beam-step
kernel's plain version. f32 memory: equal tokens, scores within 1e-5
relative; bf16 memory: the same rounding on both sides, equal tokens here.
Scores past max_steps are dead outputs and are not compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.decode import beam as jbeam
from ravvent_tpu.models import attention as jattn
from ravvent_tpu.models.basecaller import encode_input as j_encode
from ravvent_tpu.models.basecaller import init_basecaller as j_init
from ravvent_tpu.ops.beam_loop_pallas import beam_step_decode as j_step_decode
from ravvent_tpu_torch.decode import beam as tbeam
from ravvent_tpu_torch.models import attention as tattn
from ravvent_tpu_torch.ops import beam_step_cuda as tstep
from ravvent_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
B, S, TOTAL = 8, 48, 12


@pytest.fixture(scope="module")
def memories():
    """Small-S memory from a real encoder pass (flagship widths, raw input),
    padded to a multiple of 8, in f32 and bf16, for both packages."""
    cfg = JConfig(enc_units=128, dec_units=128, encoder_depth=1, decoder_depth=1,
                  data_type="raw")
    jp = j_init(jax.random.PRNGKey(0), cfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    raw = np.random.default_rng(1).normal(size=(B, 45, 1)).astype(np.float32)
    raw[5, 30:] = 0.0
    raw[6] = 0.0  # an all-padding row: uniform alignments
    enc, mask = j_encode(jp, jnp.asarray(raw), jnp.zeros((B, 6, 5)), cfg)
    enc = jnp.pad(enc, ((0, 0), (0, S - enc.shape[1]), (0, 0)))
    mask = jnp.pad(mask, ((0, 0), (0, S - mask.shape[1])))
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
def test_beam_step_decode_matches_pallas_interpret(memories, mem, max_steps):
    jd, jm, td, tm = memories[mem]
    ref = j_step_decode(jd, jm, 7, 5, TOTAL, max_steps, b_tile=8, interpret=True)
    got = tstep.beam_step_decode(td, tm, 7, 5, TOTAL, max_steps)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(got.scores[:, :max_steps].numpy(),
                               np.asarray(ref.scores[:, :max_steps]), rtol=1e-5, atol=1e-5)
    # the tail is never computed: zeros, as the reference's early-exit loop leaves it
    assert not got.scores[:, max_steps:].any()


@pytest.mark.parametrize("max_steps", [12, 7])
def test_plain_beam_decode_matches_jax(memories, max_steps):
    jd, jm, td, tm = memories["f32"]
    ref = jbeam.beam_decode(jd, jm, 7, 5, TOTAL, max_steps)
    got = tbeam.beam_decode(td, tm, 7, 5, TOTAL, max_steps)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(got.scores[:, :max_steps].numpy(),
                               np.asarray(ref.scores[:, :max_steps]), rtol=1e-5, atol=1e-5)
    fused = tstep.beam_step_decode(td, tm, 7, 5, TOTAL, max_steps)
    np.testing.assert_array_equal(fused.tokens.numpy(), got.tokens.numpy())


@pytest.fixture(scope="module")
def width_memories():
    """Per decoder width U: a raw-input model with a 128-unit encoder and a
    U-unit decoder (JAX init, carried across by from_jax_params), and the
    encoder output of memories()'s rows, as f32 and bf16 memory for both
    packages; built on first use."""
    cache = {}

    def get(U: int, mem: str):
        if U not in cache:
            cfg = JConfig(enc_units=128, dec_units=U, encoder_depth=1, decoder_depth=1,
                          data_type="raw")
            jp = j_init(jax.random.PRNGKey(U), cfg)
            tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
            raw = np.random.default_rng(U).normal(size=(B, 45, 1)).astype(np.float32)
            raw[6] = 0.0  # an all-padding row
            enc, mask = j_encode(jp, jnp.asarray(raw), jnp.zeros((B, 6, 5)), cfg)
            enc = jnp.pad(enc, ((0, 0), (0, S - enc.shape[1]), (0, 0)))
            mask = jnp.pad(mask, ((0, 0), (0, S - mask.shape[1])))
            cache[U] = (jp["decoder"], tp["decoder"], enc, mask)
        jd, td, enc, mask = cache[U]
        jdt, tdt = (None, None) if mem == "f32" else (jnp.bfloat16, torch.bfloat16)
        jm = jattn.setup_memory(jd["attention"], enc, mask, jdt,
                                attention_layer=jd["attention_layer"])
        tm = tattn.setup_memory(td["attention"], torch.from_numpy(np.array(enc)),
                                torch.from_numpy(np.array(mask)), tdt,
                                attention_layer=td["attention_layer"])
        return jd, jm, td, tm

    return get


@pytest.mark.parametrize("mem", ["f32", "bf16"])
@pytest.mark.parametrize("U,W", [(64, 5), (256, 5), (128, 10), (64, 16)],
                         ids=["U64-W5", "U256-W5", "U128-W10", "U64-W16"])
def test_beam_step_decode_at_other_widths_matches_pallas_interpret(width_memories, U, W, mem):
    """The plain step, which the kernels are held to on the card, against
    the TPU kernel in interpret mode at the decoder and beam widths the
    port's kernels take besides the flagship's (ops/beam_step_cuda.py:
    STEP_UNITS, STEP_BEAMS): equal tokens, scores within 1e-5. At W > V = 7
    both re-pick a finfo.min candidate at the first step."""
    jd, jm, td, tm = width_memories(U, mem)
    assert tm.keys.shape == (B, S, U)
    ref = j_step_decode(jd, jm, 7, W, TOTAL, TOTAL, b_tile=8, interpret=True)
    got = tstep.beam_step_decode(td, tm, 7, W, TOTAL, TOTAL)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), rtol=1e-5, atol=1e-5)


def test_beam_step_wrapper_uses_plain_version_on_cpu(memories):
    _, _, td, tm = memories["bf16"]
    w = tstep.pack_decoder_weights(td, tm)
    st = tstep.initial_state(B, 5, 128, 2, torch.device("cpu"))
    (a, pa), (b, pb) = (f(st, tm.keys, tm.values, tm.mask, w, 1)
                        for f in (tstep.beam_step, tstep.beam_step_plain))
    assert torch.equal(pa, pb)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_top_w_breaks_ties_by_first_index():
    neg = tbeam.NEG_INF
    flat = torch.tensor([[1.0, 3.0, 3.0, neg, 3.0, 2.0], [neg, neg, neg, neg, neg, neg]])
    vals, idx = tbeam.top_w(flat, 4)
    # a pick becomes finfo.min, so in an all-finfo.min row index 0 wins every
    # time, exactly as in the reference kernel
    assert idx.tolist() == [[1, 2, 4, 5], [0, 0, 0, 0]]
    assert vals[0].tolist() == [3.0, 3.0, 3.0, 2.0]


def test_gather_tree_and_lengths_match_jax():
    rng = np.random.default_rng(0)
    T, Bq, W = 9, 6, 4
    tokens = rng.integers(0, 7, size=(T, Bq, W)).astype(np.int32)
    parents = rng.integers(0, W, size=(T, Bq, W)).astype(np.int32)
    from ravvent_tpu.ops.beam_loop_pallas import _reconstruct_lengths

    jl = _reconstruct_lengths(jnp.asarray(tokens), jnp.asarray(parents), 1)
    tl = tbeam.reconstruct_lengths(torch.from_numpy(tokens), torch.from_numpy(parents), 1)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for eff in (T, 5, 1):
        ref = jbeam._gather_tree(jnp.asarray(tokens), jnp.asarray(parents), jl, eff, 1)
        got = tbeam.gather_tree(torch.from_numpy(tokens), torch.from_numpy(parents), tl, eff, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_take_along_beam_and_step_probs_match_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(5, 4)).astype(np.float32)
    idx = rng.integers(0, 4, size=(5, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tbeam.take_along_beam(torch.from_numpy(a), torch.from_numpy(idx)).numpy(),
        np.asarray(jbeam.take_along_beam(jnp.asarray(a), jnp.asarray(idx))))
    scores = -np.cumsum(rng.random((5, 10)), axis=1).astype(np.float32)
    np.testing.assert_allclose(
        tbeam.beam_scores_to_step_probs(torch.from_numpy(scores)).numpy(),
        np.asarray(jbeam.beam_scores_to_step_probs(jnp.asarray(scores))), rtol=1e-6)
