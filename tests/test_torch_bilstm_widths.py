"""The BiLSTM layer at widths the kernels are not compiled for, on the
padded route, against the JAX package on the CPU.

On a card a layer of U units outside ops/rnn_cuda.py:KERNEL_UNITS runs the
kernel of the next compiled width Up on weights zero-padded once
(kernel_layout, pad_weights), and the encoder passes its activations at
that width from layer to layer, slicing them back at its end. Here the
predicate ``on_card`` is patched, so the encoder takes that route and the
``bilstm_layer`` wrapper, given CPU tensors, runs the plain version at Up
on the padded weights; the JAX side runs the TPU kernel in interpret mode
(run_bidi_lstm_pallas(interpret=True)) at the true width. f32 within 1e-5
(the sums' association moves with the padding's exact zeros); bf16 at
tests/test_torch_rnn.py's bf16 bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.models import rnn as jrnn
from ravvent_tpu.models.basecaller import encode_input as j_encode
from ravvent_tpu.models.basecaller import init_basecaller as j_init
from ravvent_tpu.ops import rnn_pallas
from ravvent_tpu.ops.rnn_pallas import run_bidi_lstm_pallas
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.models import rnn as trnn
from ravvent_tpu_torch.models.basecaller import encode_input as t_encode
from ravvent_tpu_torch.ops import rnn_cuda
from ravvent_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_OUT, BF16_STATE = 1e-2, 1e-3  # tests/test_torch_rnn.py's bf16 bars
STREAMS = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# (U, F): widths between the compiled ones (24 and 40 run at 32 and 64, 100
# at 128, 200 at 256), on raw (1), event (5) and a stacked layer's input (2U)
PADDED = [(U, F) for U in (24, 40, 100, 200) for F in (1, 5, 2 * U)]


@pytest.fixture
def padded_route(monkeypatch):
    """The encoder on the card's route: ``on_card`` true, and the widths each
    ``bilstm_layer`` call got (its Wh's units) recorded."""
    seen = []

    def wrapper(*a):
        seen.append(a[2].shape[1])
        return rnn_cuda.bilstm_layer(*a)

    monkeypatch.setattr(trnn, "on_card", lambda t: True)
    monkeypatch.setattr(trnn, "bilstm_layer", wrapper)
    return seen


def pallas_layer(jl, xs):
    """What the JAX encoder computes for one layer from a zero state: the
    TPU kernel in interpret mode where a batch tile fits the TPU's VMEM,
    and else its scan (as tests/test_torch_rnn.py:pallas_layer)."""
    B, T, F = xs.shape
    U = jl["fwd"]["recurrent"].shape[0]
    if rnn_pallas._pick_tile(B, T, F, U, xs.dtype.itemsize) is None:
        return jrnn.run_bidi_layer(jl, "lstm", xs)
    return run_bidi_lstm_pallas(jl, xs, None, interpret=True)


def assert_close(stream, got, ref) -> None:
    """The port's (out, h, c) against the JAX package's, as numpy."""
    got = [g.float().numpy() for g in got]
    ref = [np.asarray(r, dtype=np.float32) for r in ref]
    if stream == "f32":
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, **TOL)
    else:
        assert np.abs(got[0] - ref[0]).max() <= BF16_OUT
        assert max(np.abs(g - r).max() for g, r in zip(got[1:], ref[1:])) <= BF16_STATE


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("U,F", PADDED, ids=[f"U{U}-F{F}" for U, F in PADDED])
def test_padded_layer_matches_pallas_interpret(padded_route, stream, U, F):
    """One layer through encoder_apply on the padded route (the kernel
    layout made once, kernel_weights): the wrapper runs at Up, and the
    outputs and final states, sliced back to U, match the TPU kernel at U."""
    tdt, jdt = STREAMS[stream]
    B, T = 8, 6
    jl = jrnn.init_encoder(jax.random.PRNGKey(U + F), U, 1, F)[0]
    tl = from_jax_params(jax.tree_util.tree_map(np.asarray, jl))
    xs = np.random.default_rng(U * F).normal(size=(B, T, F)).astype(np.float32)
    jx = jnp.asarray(xs).astype(jdt)
    jout, (jh, jc) = pallas_layer(jl, jx)
    weights = trnn.kernel_weights(trnn.stream_weights([tl], tdt))
    assert weights[0][3].units == U and weights[0][3].padded is not None
    xt = torch.from_numpy(np.array(jx, dtype=np.float32)).to(tdt)
    out, (h, c) = trnn.encoder_apply([tl], xt, weights)
    assert padded_route == [rnn_cuda.padded_units(U)]
    assert out.dtype == tdt and out.shape == (B, T, 2 * U) and h.shape == c.shape == (2, B, U)
    assert_close(stream, (out, h, c), (jout, jh, jc))


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("U", [48, 100])
def test_padded_encode_input_matches_jax(padded_route, stream, U):
    """encode_input of a joint model with 48- or 100-unit encoders (2 layers
    each) on the padded route, its weights laid out once as the engine lays
    them out: every layer runs at 64 or 128 units, the activations between
    the layers padded, and the joint output matches the JAX encoder's."""
    tdt, jdt = STREAMS[stream]
    cfg = dict(enc_units=U, dec_units=16, encoder_depth=2, decoder_depth=1, data_type="joint")
    jp = j_init(jax.random.PRNGKey(U), JConfig(**cfg))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(U)
    raw = rng.normal(size=(6, 200, 1)).astype(np.float32)
    ev = rng.normal(size=(6, 30, 5)).astype(np.float32)
    raw[4, 150:] = 0.0  # ragged padding
    ev[4, 20:] = 0.0
    jo, jm = j_encode(jp, jnp.asarray(raw).astype(jdt), jnp.asarray(ev).astype(jdt),
                      JConfig(**cfg))
    weights = {k: trnn.kernel_weights(trnn.stream_weights(tp[k], tdt))
               for k in ("encoder_raw", "encoder_event")}
    to, tm = t_encode(tp, torch.from_numpy(raw).to(tdt), torch.from_numpy(ev).to(tdt),
                      ModelConfig(**cfg), weights)
    assert padded_route == [rnn_cuda.padded_units(U)] * 4
    assert to.dtype == tdt and to.shape == (6, 230, 2 * U)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    got, ref = to.float().numpy(), np.asarray(jo, dtype=np.float32)
    if stream == "f32":
        np.testing.assert_allclose(got, ref, **TOL)
    else:
        assert np.abs(got - ref).max() <= BF16_OUT


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("layer", ["first", "deeper"])
def test_padded_units_stay_zero(stream, layer):
    """The padded layer itself, run by the plain version at Up = 64 for a
    40-unit layer from seeded states: every padded unit's output and final
    state is exactly zero, on a first layer (F = 5) and on a deeper one fed
    a padded layer's [B, T, 2 Up] outputs (Wx's rows laid out for them, the
    padded positions of the input nonzero to show that they reach
    nothing)."""
    tdt, _ = STREAMS[stream]
    U, Up, B, T = 40, 64, 5, 7
    gen = torch.Generator().manual_seed(40)
    F = 5 if layer == "first" else 2 * U
    wx, wh, b = trnn.stream_weights(trnn.init_encoder(gen, U, 1, F), tdt)[0]
    layout = rnn_cuda.kernel_layout(wx, wh, b, None if layer == "first" else U)
    wxp, whp, bp = layout.padded
    assert whp.shape == (2, Up, 4 * Up) and bp.shape == (2, 4 * Up)
    xs = torch.randn(B, T, wxp.shape[1], generator=gen).to(tdt)
    h0, c0 = (rnn_cuda.pad_units(0.5 * torch.randn(2, B, U, generator=gen), Up)
              for _ in range(2))
    out, h, c = rnn_cuda.bilstm_layer_plain(xs, wxp, whp, bp, h0, c0)
    assert not out[..., U:Up].any() and not out[..., Up + U:].any()
    assert not h[..., U:].any() and not c[..., U:].any()
    # the real units: the plain version at U on the real inputs
    x_real = xs if layer == "first" else rnn_cuda.unpad_outputs(xs, U)
    ref = rnn_cuda.bilstm_layer_plain(x_real, wx, wh, b, h0[..., :U], c0[..., :U])
    got = (rnn_cuda.unpad_outputs(out, U), h[..., :U], c[..., :U])
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.float(), r.float(), **TOL)
