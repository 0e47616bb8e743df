"""The decode kernels' wide shapes against the JAX package on the CPU.

The beam step and the whole beam loop at W = 17 and 32 (the attend
kernel's instance of 32 beams and the streamed loop's) and at the decoder
widths 96 and 200 (zero-padded to 128 and 256 on the card): the port's
plain versions, which the kernels are held to on the card, against the TPU
kernels in interpret mode (beam_step_decode, beam_loop_decode with
interpret=True) at the true widths, f32 memory: tokens equal, scores
within 1e-5 (the fused greedy step's wide shapes are in
test_torch_greedy_wide.py). Then the padded route
(ops/decoder_pad.py) through the plain versions, with ``on_card`` patched
so that the CPU takes it, against the true width: tokens equal, scores
within 1e-6 relative (the real units' f32 sums run at the padded width),
on f32, bf16 and int8 memory; and the engine's way, weights padded once
and the memory made from them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.models import attention as jattn
from ravvent_tpu.models.basecaller import encode_input as j_encode
from ravvent_tpu.models.basecaller import init_basecaller as j_init
from ravvent_tpu.ops import beam_loop_pallas as jloop
from ravvent_tpu_torch.models import attention as tattn
from ravvent_tpu_torch.ops import beam_loop_cuda as tloop
from ravvent_tpu_torch.ops import beam_step_cuda as tstep
from ravvent_tpu_torch.ops import cuda_lib, decoder_pad
from ravvent_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
B, S, V, STEPS = 8, 8, 7, 5
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    """Per (decoder units U, memory width E): a raw-input model with a
    BiLSTM of E / 2 units and a U-unit decoder (JAX init, carried across by
    from_jax_params), and its encoder output on B rows of S raw samples
    (row 2 partly and row 6 wholly padding); built on first use."""
    cache = {}

    def get(U: int, E: int = 64):
        if (U, E) not in cache:
            cfg = JConfig(enc_units=E // 2, dec_units=U, encoder_depth=1, decoder_depth=1,
                          data_type="raw")
            jp = j_init(jax.random.PRNGKey(U + E), cfg)
            tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
            raw = np.random.default_rng(U + E).normal(size=(B, S, 1)).astype(np.float32)
            raw[2, 5:] = 0.0
            raw[6] = 0.0
            enc, mask = j_encode(jp, jnp.asarray(raw), jnp.zeros((B, 6, 5)), cfg)
            assert enc.shape == (B, S, E)
            cache[(U, E)] = (jp["decoder"], tp["decoder"], np.array(enc), np.array(mask))
        return cache[(U, E)]

    return get


def memories(jd, td, enc, mask, projected: bool, dtype=None):
    """The same encoder output's memory for both packages (f32 on the JAX
    side; ``dtype`` on the port's)."""
    layer = "attention_layer" if projected else None
    jm = jattn.setup_memory(jd["attention"], jnp.asarray(enc), jnp.asarray(mask),
                            attention_layer=jd[layer] if layer else None)
    tm = tattn.setup_memory(td["attention"], torch.from_numpy(enc), torch.from_numpy(mask),
                            dtype, attention_layer=td[layer] if layer else None)
    return jm, tm


# (U, W): the new instances at the flagship's 128 units, and the padded
# decoder widths at the main path's beam (the loop's cases take them at 32)
STEP_CASES = [(128, 17), (128, 32), (96, 5), (200, 5)]
STEP_IDS = [f"U{u}-W{w}" for u, w in STEP_CASES]


@pytest.mark.parametrize("U,W", STEP_CASES, ids=STEP_IDS)
def test_beam_step_decode_wide_matches_pallas_interpret(model, U, W):
    """The plain step against the TPU kernel in interpret mode: tokens
    equal, scores within 1e-5 (at W > V = 7 both re-pick a finfo.min
    candidate at the first step)."""
    jd, td, enc, mask = model(U)
    jm, tm = memories(jd, td, enc, mask, True)
    ref = jloop.beam_step_decode(jd, jm, V, W, STEPS, STEPS, b_tile=8, interpret=True)
    got = tstep.beam_step_decode(td, tm, V, W, STEPS, STEPS)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), **TOL)


LOOP_CASES = [(128, 17), (128, 32), (96, 5), (200, 32)]


@pytest.mark.parametrize("U,W", LOOP_CASES, ids=[f"U{u}-W{w}" for u, w in LOOP_CASES])
def test_beam_loop_decode_wide_matches_pallas_interpret(model, U, W):
    """The plain loop against the whole-loop TPU kernel in interpret mode:
    tokens equal, scores within 1e-5."""
    jd, td, enc, mask = model(U)
    jm, tm = memories(jd, td, enc, mask, True)
    ref = jloop.beam_loop_decode(jd, jm, V, W, STEPS, STEPS, b_tile=8, interpret=True)
    got = tloop.beam_loop_decode(td, tm, V, W, STEPS, STEPS)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), **TOL)


def take_padded_route(monkeypatch) -> None:
    """From here on the decode entry points take the card's route:
    ``on_card`` true, so that a width the kernels are not compiled for is
    padded; the launch counts from zero."""
    monkeypatch.setattr(decoder_pad, "on_card", lambda t: True)
    cuda_lib.reset_launches()


def close_scores(got, ref) -> None:
    """Tokens equal, scores within 1e-6 relative (finfo.min ones equal)."""
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
    np.testing.assert_allclose(got.scores.numpy(), ref.scores.numpy(), rtol=1e-6, atol=1e-6)


PAD_CASES = [(96, 5, "f32"), (200, 17, "f32"), (96, 32, "bf16"), (200, 5, "i8"),
             (96, 5, "i8mxu")]


@pytest.mark.parametrize("U,W,mem", PAD_CASES, ids=[f"U{u}-W{w}-{m}" for u, w, m in PAD_CASES])
def test_padded_decoder_gives_the_true_widths_beams(model, monkeypatch, U, W, mem):
    """The beam step's decode on the padded route (weights and memory padded
    to the next compiled width, counted once as ``decoder_padded``) against
    the true width; then the engine's way (weights padded once, the memory
    made from them, so no further padding) against it too, its keys' padded
    columns zero and, on int8 memory, its scales the true width's (a max-abs
    ignores zeros)."""
    _, td, enc, mask = model(U)
    dtype = {"f32": None, "bf16": torch.bfloat16}.get(mem, "i8")
    mxu = mem == "i8mxu"
    tm = tattn.setup_memory(td["attention"], torch.from_numpy(enc), torch.from_numpy(mask),
                            dtype, attention_layer=td["attention_layer"])
    ref = tstep.beam_step_decode(td, tm, V, W, STEPS, STEPS, quant_mxu=mxu)
    take_padded_route(monkeypatch)
    close_scores(tstep.beam_step_decode(td, tm, V, W, STEPS, STEPS, quant_mxu=mxu), ref)
    assert cuda_lib.launches["decoder_padded"] == 1
    Up = decoder_pad.padded_width(U, tstep.STEP_UNITS, "U")
    pd = decoder_pad.pad_decoder_params(td, Up)
    pm = tattn.setup_memory(pd["attention"], torch.from_numpy(enc), torch.from_numpy(mask),
                            dtype, attention_layer=pd["attention_layer"])
    assert pm.keys.shape == (B, S, Up) and not pm.keys[..., U:].any()
    assert not pm.values[..., U:].any()
    if pm.quantized:
        assert torch.equal(pm.kscale, tm.kscale) and torch.equal(pm.vscale, tm.vscale)
    close_scores(tstep.beam_step_decode(pd, pm, V, W, STEPS, STEPS, quant_mxu=mxu), ref)
    assert cuda_lib.launches["decoder_padded"] == 1


@pytest.mark.parametrize("U,W", [(96, 17), (200, 5)], ids=["U96-W17", "U200-W5"])
def test_padded_decoder_gives_the_true_widths_loop(model, monkeypatch, U, W):
    """The whole-loop decode on the padded route against the true width."""
    _, td, enc, mask = model(U)
    tm = tattn.setup_memory(td["attention"], torch.from_numpy(enc), torch.from_numpy(mask),
                            torch.bfloat16, attention_layer=td["attention_layer"])
    ref = tloop.beam_loop_decode(td, tm, V, W, STEPS, STEPS)
    take_padded_route(monkeypatch)
    close_scores(tloop.beam_loop_decode(td, tm, V, W, STEPS, STEPS), ref)
    assert cuda_lib.launches["decoder_padded"] == 1


def test_widths_past_the_widest_raise():
    """A decoder wider than 256 units or a memory wider than 512 columns has
    no compiled width to pad to: ValueError, naming it."""
    with pytest.raises(ValueError, match="= 264 is wider than the decode kernels take"):
        decoder_pad.padded_width(264, tstep.STEP_UNITS, "dec_units")
    with pytest.raises(ValueError, match="memory width = 520"):
        decoder_pad.padded_width(520, (64, 128, 256, 512), "the greedy step's memory width")
