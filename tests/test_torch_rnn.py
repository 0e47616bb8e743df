"""BiLSTM layer and encoder of the port against the JAX package on the CPU.

The JAX side runs the TPU kernel in interpret mode
(run_bidi_lstm_pallas(interpret=True)); the port's CPU path is the kernel's
plain version. Both compute in f32 with another summation order: 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravvent_tpu.models import rnn as jrnn
from ravvent_tpu.ops import rnn_pallas
from ravvent_tpu.ops.rnn_pallas import run_bidi_lstm_pallas
from ravvent_tpu_torch.models import rnn as trnn
from ravvent_tpu_torch.ops import rnn_cuda
from ravvent_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _layer(F, U, seed):
    jl = jrnn.init_encoder(jax.random.PRNGKey(seed), U, 1, F)[0]
    return jl, from_jax_params(jax.tree_util.tree_map(np.asarray, jl))


# (U, F) of the layers held against the TPU kernel: the kernels' compiled
# widths (ops/rnn_cuda.py:KERNEL_UNITS), each on raw (1), event (5) and a
# stacked layer's input (2U). The flagship's 128 units keep their ids.
WIDTHS = [(128, 1), (128, 5), (128, 256), (64, 1), (64, 5), (64, 128), (256, 1), (256, 5),
          (256, 512)]
WIDTH_IDS = [str(F) if U == 128 else f"U{U}-{F}" for U, F in WIDTHS]


def pallas_layer(jl, xs, state):
    """What the JAX encoder computes for one layer: the TPU kernel,
    run_bidi_lstm_pallas(interpret=True), where a batch tile fits the TPU's
    VMEM, and else its scan (models/rnn.py:encoder_apply takes
    run_bidi_layer where _pick_tile is None: 256 units on f32 at F = 512)."""
    B, T, F = xs.shape
    U = jl["fwd"]["recurrent"].shape[0]
    if rnn_pallas._pick_tile(B, T, F, U, xs.dtype.itemsize) is None:
        return jrnn.run_bidi_layer(jl, "lstm", xs, initial_state=state)
    return run_bidi_lstm_pallas(jl, xs, state, interpret=True)


def test_lstm_step_matches_jax():
    rng = np.random.default_rng(0)
    p = jrnn.init_lstm_cell(jax.random.PRNGKey(1), 9, 16)
    x, h, c = (rng.normal(size=s).astype(np.float32) for s in [(4, 9), (4, 16), (4, 16)])
    (jh, jc), _ = jrnn.lstm_step(p, (jnp.asarray(h), jnp.asarray(c)), jnp.asarray(x))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, p))
    (th, tc), _ = trnn.lstm_step(tp, (torch.from_numpy(h), torch.from_numpy(c)), torch.from_numpy(x))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


@pytest.mark.parametrize("seeded", [False, True], ids=["zero_state", "initial_state"])
@pytest.mark.parametrize("U,F", WIDTHS, ids=WIDTH_IDS)
def test_run_bidi_layer_matches_pallas_interpret(U, F, seeded):
    B, T = (8, 12) if U == 128 else (8, 6)
    rng = np.random.default_rng(F + (U != 128) * U)
    jl, tl = _layer(F, U, F)
    xs = rng.normal(size=(B, T, F)).astype(np.float32)
    state = None
    if seeded:
        h0, c0 = (0.5 * rng.normal(size=(2, B, U))).astype(np.float32), (
            0.5 * rng.normal(size=(2, B, U))).astype(np.float32)
        state = (h0, c0)
    jout, (jh, jc) = pallas_layer(
        jl, jnp.asarray(xs), None if state is None else tuple(map(jnp.asarray, state)))
    tout, (th, tc) = trnn.run_bidi_layer(
        tl, torch.from_numpy(xs), None if state is None else tuple(map(torch.from_numpy, state)))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_bilstm_wrapper_uses_plain_version_on_cpu():
    U, B, T, F = 128, 3, 5, 4
    _, tl = _layer(F, U, 7)
    xs = torch.randn(B, T, F, generator=torch.Generator().manual_seed(0))
    z = torch.zeros(2, B, U)
    wx, wh, b = trnn.stacked_weights(tl)
    got = rnn_cuda.bilstm_layer(xs, wx, wh, b, z, z)
    ref = rnn_cuda.bilstm_layer_plain(xs, wx, wh, b, z, z)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_encoder_apply_matches_jax_scan():
    """Two stacked layers: layer 0's final states seed layer 1, forward to
    forward and backward to backward."""
    B, T, F, U = 4, 10, 5, 16
    jls = jrnn.init_encoder(jax.random.PRNGKey(3), U, 2, F)
    tls = from_jax_params(jax.tree_util.tree_map(np.asarray, jls))
    xs = np.random.default_rng(1).normal(size=(B, T, F)).astype(np.float32)
    jout, (jh, jc) = jrnn.encoder_apply(jls, jnp.asarray(xs))
    tout, (th, tc) = trnn.encoder_apply(tls, torch.from_numpy(xs))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_seeded_init_shapes_and_keras_conventions():
    gen = torch.Generator().manual_seed(0)
    cell = trnn.init_lstm_cell(gen, 5, 16)
    assert cell["kernel"].shape == (5, 64) and cell["recurrent"].shape == (16, 64)
    assert torch.equal(cell["bias"][16:32], torch.ones(16))  # unit forget bias
    r = cell["recurrent"].double()
    torch.testing.assert_close(r @ r.T, torch.eye(16, dtype=torch.float64), atol=1e-5, rtol=0)
    again = trnn.init_lstm_cell(torch.Generator().manual_seed(0), 5, 16)
    assert all(torch.equal(cell[k], again[k]) for k in cell)


# bf16 stream: outputs are bf16(h), so a summation order that flips one
# rounding shows as one bf16 ulp (2**-8 at |h| in [0.5, 1)) and the
# recurrence carries it: about two ulps. Final states stay f32.
BF16_OUT, BF16_STATE = 1e-2, 1e-3


@pytest.mark.parametrize("seeded", [False, True], ids=["zero_state", "initial_state"])
@pytest.mark.parametrize("U,F", WIDTHS, ids=WIDTH_IDS)
def test_bf16_layer_matches_pallas_interpret(U, F, seeded):
    """The plain version on a bf16 stream against the TPU kernel run on the
    same bf16 input (weights cast to bf16 inside it, f32 state)."""
    B, T = (8, 12) if U == 128 else (8, 6)
    rng = np.random.default_rng(100 + F + (U != 128) * U)
    jl, tl = _layer(F, U, F)
    xs = jnp.asarray(rng.normal(size=(B, T, F)).astype(np.float32)).astype(jnp.bfloat16)
    state = None
    if seeded:
        state = tuple((0.5 * rng.normal(size=(2, B, U))).astype(np.float32) for _ in range(2))
    jout, (jh, jc) = pallas_layer(
        jl, xs, None if state is None else tuple(map(jnp.asarray, state)))
    wx, wh, b = trnn.stream_weights([tl], torch.bfloat16)[0]
    h0, c0 = (torch.zeros(2, B, U), torch.zeros(2, B, U)) if state is None else map(
        torch.from_numpy, state)
    xt = torch.from_numpy(np.asarray(xs, dtype=np.float32)).to(torch.bfloat16)
    tout, th, tc = rnn_cuda.bilstm_layer_plain(xt, wx, wh, b, h0, c0)
    assert tout.dtype == torch.bfloat16 and th.dtype == tc.dtype == torch.float32
    err_out = np.abs(tout.float().numpy() - np.asarray(jout, dtype=np.float32)).max()
    err_state = max(np.abs(th.numpy() - np.asarray(jh)).max(),
                    np.abs(tc.numpy() - np.asarray(jc)).max())
    print(f"bf16 layer U={U} F={F} {'seeded' if seeded else 'zero state'}: out {err_out:.3e}, "
          f"final states {err_state:.3e}")
    assert err_out <= BF16_OUT and err_state <= BF16_STATE


def test_bf16_encoder_matches_jax_stream():
    """Two stacked layers on a bf16 stream: bf16 between the layers, layer
    0's f32 final states seeding layer 1, against the JAX encoder's bf16
    stream (its scan path, models/rnn.py:_stream_mm)."""
    B, T, F, U = 4, 10, 5, 16
    jls = jrnn.init_encoder(jax.random.PRNGKey(4), U, 2, F)
    tls = from_jax_params(jax.tree_util.tree_map(np.asarray, jls))
    xs = jnp.asarray(np.random.default_rng(2).normal(size=(B, T, F)).astype(np.float32))
    jout, (jh, jc) = jrnn.encoder_apply(jls, xs.astype(jnp.bfloat16))
    xt = torch.from_numpy(np.array(xs)).to(torch.bfloat16)
    tout, (th, tc) = trnn.encoder_apply(tls, xt)
    assert tout.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    assert np.abs(tout.float().numpy() - np.asarray(jout, dtype=np.float32)).max() <= BF16_OUT
    assert np.abs(th.numpy() - np.asarray(jh)).max() <= BF16_STATE
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= BF16_STATE
    # weights cast once and passed in give the same result
    again, _ = trnn.encoder_apply(tls, xt, trnn.stream_weights(tls, torch.bfloat16))
    assert torch.equal(again, tout)


def test_bf16_wrapper_uses_plain_version_on_cpu():
    U, B, T, F = 128, 3, 5, 256
    _, tl = _layer(F, U, 9)
    xs = torch.randn(B, T, F, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    z = torch.zeros(2, B, U)
    wx, wh, b = trnn.stream_weights([tl], torch.bfloat16)[0]
    got = rnn_cuda.bilstm_layer(xs, wx, wh, b, z, z)
    ref = rnn_cuda.bilstm_layer_plain(xs, wx, wh, b, z, z)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_engine_encoder_unchanged_with_kernel_layout():
    """The engine lays its bf16 encoders' weights out for the kernel once
    (models/rnn.py:kernel_weights); on the CPU the wrapper takes the layout
    and runs the plain version, so the encoder's output is the same, bit for
    bit, as with the plain weights."""
    from ravvent_tpu_torch.config import ModelConfig
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.models.basecaller import encode_input, init_basecaller

    cfg = ModelConfig()
    params = init_basecaller(cfg, torch.Generator().manual_seed(3))
    engine = BasecallEngine(params, cfg, device="cpu", encoder_dtype=torch.bfloat16)
    for key in ("encoder_raw", "encoder_event"):
        layers = engine._enc_weights[key]
        assert all(isinstance(layer[3], rnn_cuda.KernelLayout) for layer in layers)
        assert [layer[3].kx for layer in layers] == [16, 256]
    rng = np.random.default_rng(5)
    raw = torch.from_numpy(rng.normal(size=(6, 200, 1)).astype(np.float32)).to(torch.bfloat16)
    event = torch.from_numpy(rng.normal(size=(6, 30, 5)).astype(np.float32)).to(torch.bfloat16)
    plain = {k: trnn.stream_weights(params[k], torch.bfloat16)
             for k in ("encoder_raw", "encoder_event")}
    got, mask = encode_input(params, raw, event, cfg, engine._enc_weights)
    ref, ref_mask = encode_input(params, raw, event, cfg, plain)
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref) and torch.equal(mask, ref_mask)


@pytest.mark.parametrize("U,F", WIDTHS, ids=WIDTH_IDS)
def test_kernel_layout_holds_each_weight_once_in_fragment_order(U, F):
    """kernel_layout's Wx and Wh fragments: each plain weight appears once,
    at the (warp of U / 8, k-tile, gate, lane, tile, register, half) the
    mma.m16n8k16 B fragment reads it from; Wx's rows past F are zero."""
    gen = torch.Generator().manual_seed(F)
    wx = torch.randn(2, F, 4 * U, generator=gen).to(torch.bfloat16)
    wh = torch.randn(2, U, 4 * U, generator=gen).to(torch.bfloat16)
    lay = rnn_cuda.kernel_layout(wx, wh)
    kx, warps = -(-F // 16) * 16, U // 8
    assert lay.kx == kx and lay.wx.shape == (2, warps, kx // 16, 4, 32, 4)
    assert lay.wh.shape == (2, warps, U // 16, 4, 32, 4)
    for plain, frag, K in ((wx, lay.wx, F), (wh, lay.wh, U)):
        f = frag.reshape(2, warps, -1, 4, 8, 4, 2, 2)  # [.., g, tg, r, e]
        last_kt = max(K // 16 - 1, 0)
        for warp, kt, gate, g, tg, r, e in [(0, 0, 0, 0, 0, 0, 0), (3, 0, 2, 5, 1, 0, 1),
                                            (warps - 1, 0, 3, 7, 3, 1, 1),
                                            (warps // 2, last_kt, 1, 2, 2, 1, 0)]:
            k, n = 16 * kt + 2 * tg + 8 * r + e, gate * U + 8 * warp + g
            want = plain[:, k, n] if k < K else torch.zeros(2, dtype=torch.bfloat16)
            assert torch.equal(f[:, warp, kt, gate, g, tg, r, e], want)
        padded = torch.nn.functional.pad(plain, (0, 0, 0, -(-K // 16) * 16 - K))
        assert torch.equal(torch.sort(frag.float().reshape(2, -1)).values,
                           torch.sort(padded.float().reshape(2, -1)).values)


@pytest.mark.parametrize("U,F", WIDTHS, ids=WIDTH_IDS)
def test_f32_kernel_layout_holds_each_weight_once_by_unit(U, F):
    """kernel_layout of f32 weights (csrc/bilstm.cu's order): Wx padded to F
    rounded up to 4 rows, row k's gates i, f, g, o of unit u at [d, k, u],
    each plain weight once; the padding rows zero."""
    gen = torch.Generator().manual_seed(F)
    wx = torch.randn(2, F, 4 * U, generator=gen)
    wh = torch.randn(2, U, 4 * U, generator=gen)
    lay = rnn_cuda.kernel_layout(wx, wh)
    kx = -(-F // 4) * 4
    assert lay.kx == kx and lay.wx.shape == (2, kx, U, 4) and lay.wh.shape == (2, U, U, 4)
    assert lay.wx.is_contiguous() and lay.wh.is_contiguous()
    for plain, laid, K in ((wx, lay.wx, F), (wh, lay.wh, U)):
        for k, u, gate in [(0, 0, 0), (K - 1, U // 2 + 13, 2), (K // 2, U - 1, 3)]:
            assert torch.equal(laid[:, k, u, gate], plain[:, k, gate * U + u])
        assert torch.equal(laid[:, :K], plain.reshape(2, K, 4, U).transpose(2, 3))
        assert not laid[:, K:].any()
        assert torch.equal(torch.sort(laid[:, :K].reshape(2, -1)).values,
                           torch.sort(plain.reshape(2, -1)).values)


def test_engine_lays_out_the_f32_encoder_once():
    """An engine built without encoder_dtype (the CLI's) lays its f32
    encoders' weights out for csrc/bilstm.cu once; on the CPU the wrapper
    takes the layout and runs the plain version, so the encoder's output is
    the same, bit for bit, as with the plain weights."""
    from ravvent_tpu_torch.config import ModelConfig
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.models.basecaller import encode_input, init_basecaller

    cfg = ModelConfig()
    params = init_basecaller(cfg, torch.Generator().manual_seed(4))
    engine = BasecallEngine(params, cfg, device="cpu")
    kxs = {"encoder_raw": [4, 256], "encoder_event": [8, 256]}
    for key, want in kxs.items():
        layers = engine._enc_weights[key]
        assert all(isinstance(layer[3], rnn_cuda.KernelLayout) for layer in layers)
        assert [layer[3].kx for layer in layers] == want
        assert all(layer[3].wx.dtype == torch.float32 for layer in layers)
    rng = np.random.default_rng(6)
    raw = torch.from_numpy(rng.normal(size=(6, 200, 1)).astype(np.float32))
    event = torch.from_numpy(rng.normal(size=(6, 30, 5)).astype(np.float32))
    plain = {k: trnn.stream_weights(params[k]) for k in kxs}
    got, mask = encode_input(params, raw, event, cfg, engine._enc_weights)
    ref, ref_mask = encode_input(params, raw, event, cfg, plain)
    assert got.dtype == torch.float32 and torch.equal(got, ref) and torch.equal(mask, ref_mask)


class OnCard:
    """A CPU tensor that says it lies on the card: enough of one for
    ``bilstm_layer``'s checks, which run before its launch."""

    is_cuda = True

    def __init__(self, t: torch.Tensor) -> None:
        self.t, self.shape, self.dtype, self.device = t, t.shape, t.dtype, t.device

    def data_ptr(self) -> int:
        return self.t.data_ptr()


class Launched(Exception):
    pass


def test_kernel_takes_states_what_the_wrapper_accepts(monkeypatch):
    """``bilstm_layer`` on a card's tensor gets past its checks to the launch
    on the shapes the kernels take (64, 128 and 256 units, F <= 2U; 16 and
    48 units, padded to 32 and 64; past 256 units 384 and 512, and 300,
    padded to 320), and raises a ValueError naming the shape where
    ``kernel_takes`` is false: a width past the widest compiled one (520,
    544), too many features, an unaligned bf16 feature count, another
    dtype."""
    from ravvent_tpu_torch.ops import cuda_lib

    def launch():
        raise Launched

    monkeypatch.setattr(cuda_lib, "check_tensors", lambda *a: None)  # devices are the CPU's
    monkeypatch.setattr(cuda_lib, "lib", launch)
    B, T = 3, 2
    f32, bf16 = torch.float32, torch.bfloat16
    taken = [(128, 1, f32), (128, 5, bf16), (128, 24, bf16), (128, 256, f32), (128, 256, bf16),
             (64, 5, f32), (64, 128, bf16), (256, 1, bf16), (256, 512, f32), (16, 5, f32),
             (48, 96, bf16), (300, 5, f32), (384, 768, bf16), (512, 1024, f32)]
    refused = [(520, 5, f32), (544, 96, bf16), (64, 256, bf16), (64, 136, f32), (128, 264, f32),
               (128, 17, bf16), (256, 520, bf16), (128, 5, torch.float16)]
    for U, F, dt in taken + refused:
        wx, wh = torch.zeros(2, F, 4 * U, dtype=dt), torch.zeros(2, U, 4 * U, dtype=dt)
        b, z = torch.zeros(2, 4 * U), torch.zeros(2, B, U)
        xs = OnCard(torch.zeros(B, T, F, dtype=dt))
        assert rnn_cuda.kernel_takes(U, F, dt) == ((U, F, dt) in taken), (U, F, dt)
        if (U, F, dt) in taken:
            with pytest.raises(Launched):
                rnn_cuda.bilstm_layer(xs, wx, wh, b, z, z)
        else:
            with pytest.raises(ValueError, match=f"U = {U} units on F = {F} features"):
                rnn_cuda.bilstm_layer(xs, wx, wh, b, z, z)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_encoder_apply_routes_other_widths_to_the_plain_layer(dtype, monkeypatch):
    """On a card (the predicate patched), a 520- or 544-unit encoder, past
    the widest width the kernels are compiled for (512), runs every layer on
    the plain version and counts each under ``bilstm_plain_route``, with the
    CPU encoder's output bit for bit; a 64-, 128- or 256-unit one calls the
    kernels' wrapper, bit for bit, and counts nothing; a 16-, 48- or
    300-unit one calls it at the padded width (32, 64, 320) on the padded
    weights, counts nothing, and is sliced back to its own width: equal within 1e-5 on f32
    and the bf16 bars on bf16, the padding's exact zeros moving only the
    sums' association."""
    from ravvent_tpu_torch.ops import cuda_lib

    gen = torch.Generator().manual_seed(4)
    xs = torch.randn(6, 9, 5, generator=gen).to(dtype)
    cases = []
    for U, routed in ((16, 0), (48, 0), (64, 0), (128, 0), (256, 0), (300, 0), (520, 2),
                      (544, 2)):
        layers = trnn.init_encoder(gen, U, 2, 5)
        weights = trnn.kernel_weights(trnn.stream_weights(layers, dtype))
        cases.append((U, layers, weights, routed, trnn.encoder_apply(layers, xs, weights)))

    wrapped = []

    def wrapper(*a):
        wrapped.append(a[2].shape[1])
        return rnn_cuda.bilstm_layer_plain(*a[:6])

    monkeypatch.setattr(trnn, "on_card", lambda t: True)
    monkeypatch.setattr(trnn, "bilstm_layer", wrapper)
    for U, layers, weights, routed, (ref, ref_state) in cases:
        cuda_lib.reset_launches()
        wrapped.clear()
        out, state = trnn.encoder_apply(layers, xs, weights)
        assert cuda_lib.launches["bilstm_plain_route"] == routed
        assert wrapped == [rnn_cuda.padded_units(U)] * (2 - routed)
        assert out.dtype == dtype and out.shape == ref.shape
        assert all(s.shape == r.shape == (2, 6, U) for s, r in zip(state, ref_state))
        if U in rnn_cuda.KERNEL_UNITS or routed:
            assert torch.equal(out, ref)
            assert all(torch.equal(a, b) for a, b in zip(state, ref_state))
        elif dtype == torch.float32:
            torch.testing.assert_close(out, ref, **TOL)
            for a, b in zip(state, ref_state):
                torch.testing.assert_close(a, b, **TOL)
        else:
            assert (out.float() - ref.float()).abs().max().item() <= BF16_OUT
            assert all((a - b).abs().max().item() <= BF16_STATE for a, b in zip(state, ref_state))
    cuda_lib.reset_launches()
