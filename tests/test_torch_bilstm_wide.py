"""The BiLSTM layer past 256 units, on the route a card runs it, against the
JAX package on the CPU.

On a card a layer of 257 to 512 units runs csrc/bilstm_wide.cu or
csrc/bilstm_bf16_wide.cu at a width of ops/rnn_cuda.py:WIDE_UNITS (320, 384,
448, 512), one between zero-padded to the next (kernel_layout,
pad_weights); past 512 it runs its plain version on the card, counted under
``bilstm_plain_route``. Here the predicate ``on_card`` is patched, so the
encoder takes the card's route and the ``bilstm_layer`` wrapper, given CPU
tensors, runs the plain version at the compiled width; the JAX side runs the
TPU kernel in interpret mode (run_bidi_lstm_pallas(interpret=True)) at the
true width where a batch tile fits the TPU's VMEM, else its scan, as the
JAX encoder does. f32 within 1e-5 (the sums' association moves with the
padding's exact zeros); bf16 at tests/test_torch_rnn.py's bf16 bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.models import rnn as jrnn
from ravvent_tpu.models.basecaller import encode_input as j_encode
from ravvent_tpu.ops import rnn_pallas
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.models import rnn as trnn
from ravvent_tpu_torch.models.basecaller import encode_input as t_encode
from ravvent_tpu_torch.models.basecaller import init_basecaller as t_init
from ravvent_tpu_torch.ops import cuda_lib, rnn_cuda
from test_torch_bilstm_widths import (  # noqa: F401 (fixture)
    BF16_OUT, STREAMS, TOL, assert_close, padded_route, pallas_layer,
)

torch.set_num_threads(1)
# (U, F): 264 and 300 run at 320, 384 at itself, on a stacked layer's input
# (2U), event (5) and raw (1) features. The JAX side compiles anew for each
# shape, which under a loaded tier-1 run sets this file's time, so one F a
# width: on bf16 all three reach the TPU kernel (pallas_supported), on f32
# 300 does and 264 and 384 run the reference's scan
WIDE = [(264, 528), (300, 5), (384, 1)]


def to_jax(tree):
    """The port's parameter tree (the JAX tree's layout) with jnp leaves.
    The weights are drawn by the port's seeded init: the JAX package's
    eager init (QR of 384 x 1536 matrices, op by op) would set this file's
    time on a loaded host."""
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("U,F", WIDE, ids=[f"U{U}-F{F}" for U, F in WIDE])
def test_wide_layer_matches_pallas_interpret(padded_route, stream, U, F):
    """One layer through encoder_apply on the card's route (the kernel
    layout made once, kernel_weights): the wrapper runs at the compiled
    width, and the outputs and final states, sliced back to U, match the
    JAX package's layer at U (the TPU kernel in interpret mode where
    rnn_pallas.pallas_supported holds, else its scan)."""
    tdt, jdt = STREAMS[stream]
    B, T = 8, 5
    tl = trnn.init_encoder(torch.Generator().manual_seed(U + F), U, 1, F)[0]
    jl = to_jax(tl)
    xs = np.random.default_rng(U * F).normal(size=(B, T, F)).astype(np.float32)
    jx = jnp.asarray(xs).astype(jdt)
    jout, (jh, jc) = pallas_layer(jl, jx)
    weights = trnn.kernel_weights(trnn.stream_weights([tl], tdt))
    assert weights[0][3].units == U and (weights[0][3].padded is None) == (U == 384)
    xt = torch.from_numpy(np.array(jx, dtype=np.float32)).to(tdt)
    out, (h, c) = trnn.encoder_apply([tl], xt, weights)
    assert padded_route == [rnn_cuda.padded_units(U)]
    assert out.dtype == tdt and out.shape == (B, T, 2 * U) and h.shape == c.shape == (2, B, U)
    assert_close(stream, (out, h, c), (jout, jh, jc))


def test_widest_fused_bf16_layer_matches_pallas_interpret(padded_route):
    """The widest layer the reference fuses into its TPU kernel: 489 units
    on a bf16 raw input (F = 1), padded to 512, against
    run_bidi_lstm_pallas(interpret=True) at 489 units."""
    U, F, B, T = 489, 1, 8, 4
    assert rnn_pallas.pallas_supported(B, T, F, U, 2)
    assert not rnn_pallas.pallas_supported(B, T, F, U + 1, 2)
    tl = trnn.init_encoder(torch.Generator().manual_seed(U), U, 1, F)[0]
    jl = to_jax(tl)
    xs = np.random.default_rng(U).normal(size=(B, T, F)).astype(np.float32)
    jx = jnp.asarray(xs).astype(jnp.bfloat16)
    jout, (jh, jc) = rnn_pallas.run_bidi_lstm_pallas(jl, jx, None, interpret=True)
    weights = trnn.kernel_weights(trnn.stream_weights([tl], torch.bfloat16))
    xt = torch.from_numpy(np.array(jx, dtype=np.float32)).to(torch.bfloat16)
    out, (h, c) = trnn.encoder_apply([tl], xt, weights)
    assert padded_route == [512]
    assert_close("bf16", (out, h, c), (jout, jh, jc))


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("U", [264, 384])
def test_wide_encode_input_matches_jax(padded_route, stream, U):
    """encode_input of a joint model with 264- or 384-unit encoders (2
    layers each) on the card's route, its weights laid out once as the
    engine lays them out: every layer runs at 320 or 384 units (the
    activations between the 264-unit layers padded to 320, layer 1's Wx rows
    placed for them), and the joint output matches the JAX encoder's."""
    tdt, jdt = STREAMS[stream]
    cfg = dict(enc_units=U, dec_units=16, encoder_depth=2, decoder_depth=1, data_type="joint")
    tp = t_init(ModelConfig(**cfg), torch.Generator().manual_seed(U))
    jp = to_jax(tp)
    rng = np.random.default_rng(U)
    raw = rng.normal(size=(4, 40, 1)).astype(np.float32)  # short: JAX's scans run on the CPU
    ev = rng.normal(size=(4, 12, 5)).astype(np.float32)
    raw[2, 30:] = 0.0  # ragged padding
    ev[2, 8:] = 0.0
    jo, jm = j_encode(jp, jnp.asarray(raw).astype(jdt), jnp.asarray(ev).astype(jdt),
                      JConfig(**cfg))
    weights = {k: trnn.kernel_weights(trnn.stream_weights(tp[k], tdt))
               for k in ("encoder_raw", "encoder_event")}
    to, tm = t_encode(tp, torch.from_numpy(raw).to(tdt), torch.from_numpy(ev).to(tdt),
                      ModelConfig(**cfg), weights)
    assert padded_route == [rnn_cuda.padded_units(U)] * 4
    assert to.dtype == tdt and to.shape == (4, 52, 2 * U)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    got, ref = to.float().numpy(), np.asarray(jo, dtype=np.float32)
    if stream == "f32":
        np.testing.assert_allclose(got, ref, **TOL)
    else:
        assert np.abs(got - ref).max() <= BF16_OUT


@pytest.mark.parametrize("U,Up", [(257, 320), (320, 320), (511, 512), (512, 512), (513, None)])
def test_wide_widths_and_what_the_kernels_take(U, Up):
    """padded_units and kernel_takes past 256 units: every width up to 512
    runs at the next of WIDE_UNITS on both streams, on the encoder's raw (1)
    and event (5) inputs and on a deeper layer's (2 Up, the padded outputs
    of the layer before); F past 2 Up, and on bf16 F > 16 not a multiple of
    8, are refused; past 512 no F is taken."""
    assert rnn_cuda.WIDE_UNITS == (320, 384, 448, 512)
    assert rnn_cuda.padded_units(U) == Up
    for dtype in rnn_cuda.STREAMS:
        for F in (1, 5, 2 * (Up or U)):
            assert rnn_cuda.kernel_takes(U, F, dtype) == (Up is not None)
        if Up is not None:
            assert not rnn_cuda.kernel_takes(U, 2 * Up + 1, dtype)
    if Up is not None:
        assert not rnn_cuda.kernel_takes(U, 20, torch.bfloat16)


def test_past_the_widest_runs_the_counted_plain_route(padded_route):
    """A 2-layer f32 encoder of 513 units, one past the widest compiled
    width, on the card's route: no layer reaches the wrapper, each runs its
    plain version, counted under bilstm_plain_route (2), and the outputs
    match the JAX encoder's (its scan: no batch tile of this width fits the
    TPU's VMEM)."""
    U, B, T = 513, 3, 4
    tls = trnn.init_encoder(torch.Generator().manual_seed(U), U, 2, 5)
    jls = to_jax(tls)
    xs = np.random.default_rng(U).normal(size=(B, T, 5)).astype(np.float32)
    assert not rnn_pallas.pallas_supported(B, T, 5, U, 4)
    jo, (jh, jc) = jrnn.encoder_apply(jls, jnp.asarray(xs))
    weights = trnn.kernel_weights(trnn.stream_weights(tls))
    assert all(len(w) == 3 for w in weights)  # no kernel layout
    before = cuda_lib.launches["bilstm_plain_route"]
    out, (h, c) = trnn.encoder_apply(tls, torch.from_numpy(xs), weights)
    assert cuda_lib.launches["bilstm_plain_route"] == before + 2
    assert padded_route == []
    assert_close("f32", (out, h, c), (jo, jh, jc))


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("U,layer", [(264, "first"), (264, "deeper"), (300, "deeper")])
def test_wide_padded_units_stay_zero(stream, U, layer):
    """The padded layer run by the plain version at Up = 320 from seeded
    states: every padded unit's output and final state is exactly zero, on a
    first layer (F = 5) and on a deeper one fed a padded layer's [B, T, 640]
    outputs (its Wx rows at [0, U) and [320, 320 + U), the gap's input
    positions nonzero to show that they reach nothing); the real units
    match the plain version at U."""
    tdt, _ = STREAMS[stream]
    Up, B, T = 320, 3, 4
    gen = torch.Generator().manual_seed(U)
    F = 5 if layer == "first" else 2 * U
    wx, wh, b = trnn.stream_weights(trnn.init_encoder(gen, U, 1, F), tdt)[0]
    layout = rnn_cuda.kernel_layout(wx, wh, b, None if layer == "first" else U)
    wxp, whp, bp = layout.padded
    assert whp.shape == (2, Up, 4 * Up) and bp.shape == (2, 4 * Up)
    assert wxp.shape[1] == (F if layer == "first" else 2 * Up)
    xs = torch.randn(B, T, wxp.shape[1], generator=gen).to(tdt)
    h0, c0 = (rnn_cuda.pad_units(0.5 * torch.randn(2, B, U, generator=gen), Up)
              for _ in range(2))
    out, h, c = rnn_cuda.bilstm_layer_plain(xs, wxp, whp, bp, h0, c0)
    assert not out[..., U:Up].any() and not out[..., Up + U:].any()
    assert not h[..., U:].any() and not c[..., U:].any()
    x_real = xs if layer == "first" else rnn_cuda.unpad_outputs(xs, U)
    ref = rnn_cuda.bilstm_layer_plain(x_real, wx, wh, b, h0[..., :U], c0[..., :U])
    got = (rnn_cuda.unpad_outputs(out, U), h[..., :U], c[..., :U])
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.float(), r.float(), **TOL)
