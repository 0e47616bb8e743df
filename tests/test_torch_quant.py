"""int8 attention memory in the port against the JAX package on the CPU.

``setup_memory(dtype="i8")``: codes within one step of the reference's and
equal on >= 99.9% of entries, scales within 1e-6 relative (the two
frameworks' key and value products differ in the last bits). The beam
step's plain int8 versions ("quant" and "quant_mxu") against the TPU
kernel's int8 branches in interpret mode on the same quantized memory:
top-beam tokens and parents equal on >= 99.8% of live steps, scores within
1e-3 where they agree. The rejections: int8 memory outside the beam step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.models import attention as jattn
from ravvent_tpu.models.basecaller import encode_input as j_encode
from ravvent_tpu.models.basecaller import init_basecaller as j_init
from ravvent_tpu.ops import beam_loop_pallas as jbl
from ravvent_tpu.ops.decode_step_pallas import pack_decoder_weights as j_pack
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
from ravvent_tpu_torch.models import attention as tattn
from ravvent_tpu_torch.ops import beam_loop_cuda as tloop
from ravvent_tpu_torch.ops import beam_step_cuda as tstep
from ravvent_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
B, S, TOTAL, W = 16, 48, 12, 5


@pytest.fixture(scope="module")
def model():
    """A flagship-width raw-input model (JAX init, carried across) and the
    encoder output of 16 rows of noise, one of them all padding, padded to
    S = 48 (tests/test_beam_loop_pallas.py's set-up)."""
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
    return jp["decoder"], tp["decoder"], np.array(enc), np.array(mask)


def _to_torch(mem):
    """The JAX package's memory as the port's: the same arrays, by numpy."""
    return tattn.AttnMemory(*(None if x is None else torch.from_numpy(np.array(x)) for x in mem))


@pytest.mark.parametrize("enc_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("projected", [True, False], ids=["projected", "unprojected"])
def test_setup_memory_i8_matches_jax(model, enc_dtype, projected):
    jd, td, enc, mask = model
    jenc = jnp.asarray(enc, jnp.bfloat16 if enc_dtype == "bf16" else jnp.float32)
    tenc = torch.from_numpy(np.array(jenc.astype(jnp.float32)))
    if enc_dtype == "bf16":
        tenc = tenc.to(torch.bfloat16)
    jm = jattn.setup_memory(jd["attention"], jenc, jnp.asarray(mask), "i8",
                            attention_layer=jd["attention_layer"] if projected else None)
    tm = tattn.setup_memory(td["attention"], tenc, torch.from_numpy(mask), "i8",
                            attention_layer=td["attention_layer"] if projected else None)
    assert tm.quantized and tm.projected == projected
    for name in ("keys", "values"):
        ref, got = np.asarray(getattr(jm, name)), getattr(tm, name)
        assert got.dtype == torch.int8 and tuple(got.shape) == ref.shape
        diff = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, name
    for name in ("kscale", "vscale"):
        ref, got = np.asarray(getattr(jm, name)), getattr(tm, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


def test_quantize_rows_rounds_half_to_even_and_divides():
    # x / scale lands on .5 for these rows: half to even, as jnp.round
    x = torch.tensor([[[127.0, 0.5, 1.5, -2.5, 2.5]]])
    q, scale = tattn.quantize_rows(x)
    assert scale.item() == 1.0
    assert q.tolist() == [[[127, 0, 2, -2, 2]]]
    zero, zscale = tattn.quantize_rows(torch.zeros(1, 2, 4))
    assert not zero.any() and torch.allclose(zscale, torch.full((1, 2), 1e-12 / 127))


@pytest.mark.parametrize("mxu", [False, True], ids=["quant", "quant_mxu"])
def test_plain_int8_step_matches_pallas_interpret(model, mxu):
    jd, td, enc, mask = model
    jm = jattn.setup_memory(jd["attention"], jnp.asarray(enc), jnp.asarray(mask), "i8",
                            attention_layer=jd["attention_layer"])
    tm = _to_torch(jm)
    # every step of the TPU kernel's loop: tokens, parents, scores [T, B, W]
    ref = jbl._beam_step_scan(
        j_pack(jd, 7), jnp.asarray(jm.watt_h, jnp.float32), jm.keys, jm.values, jm.kscale,
        jm.vscale, jm.mask.astype(jnp.float32), jnp.asarray(TOTAL, jnp.int32), 7, TOTAL, W, B,
        2, 1, True, True, mxu)
    rtok, rpar, rsc = (np.asarray(x) for x in ref)
    w = tstep.pack_decoder_weights(td, tm)
    tok, par, sc = (x.numpy() for x in tstep.step_loop(
        tstep.beam_step_plain, tm.keys, tm.values, tm.mask, w, W, TOTAL, TOTAL, 2, 1,
        (tm.kscale, tm.vscale), mxu))
    agree = (tok[..., 0] == rtok[..., 0]) & (par[..., 0] == rpar[..., 0])
    err = np.abs(sc[..., 0] - rsc[..., 0])[agree].max()
    print(f"int8 step {'quant_mxu' if mxu else 'quant'}: top-beam tokens and parents agree "
          f"{agree.mean():.5f}, all beams {((tok == rtok) & (par == rpar)).mean():.5f}, "
          f"score max_abs_err {err:.3e}")
    assert agree.mean() >= 0.998
    assert err <= 1e-3
    # the decode entry points, backtrack included
    jres = jbl.beam_step_decode(jd, jm, 7, W, TOTAL, TOTAL, interpret=True, quant_mxu=mxu)
    tres = tstep.beam_step_decode(td, tm, 7, W, TOTAL, TOTAL, quant_mxu=mxu)
    assert (tres.tokens[:, :, 0].numpy() == np.asarray(jres.tokens[:, :, 0])).mean() >= 0.998


@pytest.mark.parametrize("mxu", [False, True], ids=["quant", "quant_mxu"])
@pytest.mark.parametrize("U", [64, 256], ids=["U64", "U256"])
def test_plain_int8_step_at_other_widths_matches_pallas_interpret(model, U, mxu):
    """The plain int8 steps at the decoder widths the port's kernels take
    besides the flagship's (ops/beam_step_cuda.py:STEP_UNITS), on a U-unit
    decoder (JAX init, carried across) over the same quantized memory: the
    decode entry points' tokens equal, scores within 1e-5."""
    _, _, enc, mask = model
    cfg = JConfig(enc_units=128, dec_units=U, encoder_depth=1, decoder_depth=1, data_type="raw")
    jd = j_init(jax.random.PRNGKey(U), cfg)["decoder"]
    td = from_jax_params(jax.tree_util.tree_map(np.asarray, {"decoder": jd}))["decoder"]
    jm = jattn.setup_memory(jd["attention"], jnp.asarray(enc), jnp.asarray(mask), "i8",
                            attention_layer=jd["attention_layer"])
    tm = _to_torch(jm)
    assert tm.keys.shape == (B, S, U)
    jres = jbl.beam_step_decode(jd, jm, 7, W, TOTAL, TOTAL, interpret=True, quant_mxu=mxu)
    tres = tstep.beam_step_decode(td, tm, 7, W, TOTAL, TOTAL, quant_mxu=mxu)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_allclose(tres.scores.numpy(), np.asarray(jres.scores), rtol=1e-5,
                               atol=1e-5)


def test_int8_wrapper_uses_plain_version_on_cpu(model):
    jd, td, enc, mask = model
    tm = tattn.setup_memory(td["attention"], torch.from_numpy(enc), torch.from_numpy(mask), "i8",
                            attention_layer=td["attention_layer"])
    w = tstep.pack_decoder_weights(td, tm)
    st = tstep.initial_state(B, W, 128, 2, torch.device("cpu"))
    for mxu in (False, True):
        (a, pa), (b, pb) = (f(st, tm.keys, tm.values, tm.mask, w, 1, (tm.kscale, tm.vscale), mxu)
                            for f in (tstep.beam_step, tstep.beam_step_plain))
        assert torch.equal(pa, pb)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dot", ["scores", "context"])
def test_float_products_of_codes_are_exact(dot):
    """The plain int8 step multiplies codes as f32: every product is at most
    127^2 and a sum over U = 128 or S = 232 stays below 2^24, so the f32
    bmm equals the integer product bit for bit, as the kernel's s32 dots."""
    rng = np.random.default_rng(0)
    n, S_, U = 4, 232, 128
    a = rng.integers(-127, 128, size=(n, W, U if dot == "scores" else S_))
    b = rng.integers(-127, 128, size=(n, U, S_) if dot == "scores" else (n, S_, U))
    a[0], b[0] = 127, 127  # the largest sums
    a[1], b[1] = -127, 127
    ref = np.einsum("bik,bkj->bij", a.astype(np.int64), b.astype(np.int64))
    got = torch.bmm(torch.from_numpy(a.astype(np.int8)).float(),
                    torch.from_numpy(b.astype(np.int8)).float())
    assert np.abs(ref).max() == 127 * 127 * a.shape[2]
    assert np.array_equal(got.numpy().astype(np.int64), ref)


def test_int8_memory_outside_the_beam_step_raises(model):
    jd, td, enc, mask = model
    tm = tattn.setup_memory(td["attention"], torch.from_numpy(enc), torch.from_numpy(mask), "i8",
                            attention_layer=td["attention_layer"])
    w = tstep.pack_decoder_weights(td, tm)
    with pytest.raises(ValueError, match="beam step"):
        tattn.attend_beams(None, "luong", torch.zeros(B, W, 128), tm)
    with pytest.raises(ValueError, match="int8 memory"):
        tloop.beam_loop(tm.keys, tm.values, tm.mask, w, W, TOTAL, TOTAL, 2, 1,
                        (tm.kscale, tm.vscale))
    with pytest.raises(ValueError, match="int8 memory"):
        tloop.beam_loop_decode(td, tm, 7, W, TOTAL, TOTAL)
    with pytest.raises(ValueError, match="'i8'"):
        tattn.setup_memory(td["attention"], torch.from_numpy(enc), torch.from_numpy(mask), "i4")
    params = from_jax_params(jax.tree_util.tree_map(
        np.asarray, j_init(jax.random.PRNGKey(0), JConfig())))
    for memory in ("i8", "i8mxu"):
        with pytest.raises(ValueError, match="beam_impl='step'"):
            BasecallEngine(params, ModelConfig(), memory_dtype=memory, beam_impl="loop",
                           device="cpu")
        eng = BasecallEngine(params, ModelConfig(), memory_dtype=memory, device="cpu")
        assert eng.memory_dtype == "i8" and eng.quant_mxu == (memory == "i8mxu")
