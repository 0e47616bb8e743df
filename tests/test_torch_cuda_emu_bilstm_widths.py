"""The BiLSTM-layer kernels (csrc/bilstm.cu, f32; csrc/bilstm_bf16.cu, bf16)
at the widths beside the first three: compiled at 32, 96 and 192 units,
and a layer of another width zero-padded to the next compiled one
(ops/rnn_cuda.py:kernel_layout, pad_weights), run on the CPU by the
emulation of tools/cuda_emu.py against ``bilstm_layer_plain`` at the
layer's own width. The compiled widths' first cases, and what the C entries
refuse, are in test_torch_cuda_emu_bilstm.py; the card-only tests in
test_torch_gpu.py stay the yardstick of the kernels themselves. Needs g++."""

import pytest
import torch

from cuda_emu_cases import (  # noqa: F401 (fixtures)
    bilstm_case, emu_bilstm, emu_bilstm_f32, emu_layer, nan_outputs,
)
from ravvent_tpu_torch.ops import rnn_cuda

# (U, F, T, B, seeded state): the emulated card has 2 SMs, so at 32 and 96
# units B picks 16, 32, 48 or 64 rows a CTA (13, 20, 37, then 70 in two
# tiles), none a multiple of it; at 192 units the f32 kernel takes 16 rows
# (B 13) or 32 (B 20, 37 in two tiles) and the bf16 kernel 16 (1, 2 and 3
# tiles), Wh streaming from L2; F = 1 and 5 run one partial x k-tile, F = 2U
# every k-tile
WIDTH_CASES = [(32, 1, 7, 13, False), (32, 5, 3, 37, True), (32, 64, 5, 20, True),
               (32, 64, 3, 70, False),
               (96, 1, 7, 13, False), (96, 5, 3, 37, True), (96, 192, 5, 20, True),
               (96, 192, 3, 70, False),
               (192, 1, 3, 13, True), (192, 5, 4, 20, False), (192, 384, 3, 37, True)]
WIDTH_IDS = [f"U{c[0]}-F{c[1]}-T{c[2]}-B{c[3]}-{'seeded' if c[4] else 'zero'}"
             for c in WIDTH_CASES]
# (U, F, T, B, seeded) of a layer the wrapper pads: 40 units run the
# 64-unit kernel, 100 the 128-unit one
PADDED_CASES = [(40, 5, 5, 20, True), (40, 80, 3, 37, False), (100, 1, 7, 13, False),
                (100, 200, 3, 37, True)]
PADDED_IDS = [f"U{c[0]}-F{c[1]}-T{c[2]}-B{c[3]}-{'seeded' if c[4] else 'zero'}"
              for c in PADDED_CASES]
STREAMS = {"bf16": (torch.bfloat16, "emu_bilstm", "rv_bilstm_layer_bf16"),
           "f32": (torch.float32, "emu_bilstm_f32", "rv_bilstm_layer")}


def entry_of(request, stream):
    dtype, fixture, name = STREAMS[stream]
    return dtype, getattr(request.getfixturevalue(fixture), name)


def check(stream, got, ref) -> None:
    """A kernel's (out, hN, cN) against the plain version's: chip_smoke.py
    phase 2's 1e-4 on f32 (sums in another order), phase 9's bars on bf16
    (outputs within two bf16 ulps at |h| <= 1, f32 final states 1e-3)."""
    if stream == "f32":
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
    else:
        assert (got[0].float() - ref[0].float()).abs().max().item() <= 1e-2
        assert max((g - r).abs().max().item() for g, r in zip(got[1:], ref[1:])) <= 1e-3


def run_padded(entry, ins, layout):
    """One padded layer through a C entry at its compiled width, as
    ops/rnn_cuda.py:bilstm_layer runs it: the layout's padded weights, the
    states padded with zeros, NaN-filled outputs at the compiled width.
    Returns (rc, out, hN, cN) at that width."""
    xs, h0, c0 = ins[0], ins[4], ins[5]
    wx, wh, b = layout.padded
    Up = wh.shape[1]
    outs = nan_outputs(xs.shape[0], xs.shape[1], Up, xs.dtype)
    ins_p = (xs, wx, wh, b, rnn_cuda.pad_units(h0, Up), rnn_cuda.pad_units(c0, Up))
    return (emu_layer(entry, ins_p, outs, layout),) + outs


def own_width(out, h, c, U):
    """A padded layer's outputs at its own width, after holding its padded
    units to exactly zero."""
    Up = h.shape[-1]
    pads = (out[..., U:Up], out[..., Up + U:], h[..., U:], c[..., U:])
    assert all(p.float().eq(0).all() for p in pads), "a padded unit is not zero"
    return rnn_cuda.unpad_outputs(out, U), h[..., :U], c[..., :U]


@pytest.mark.parametrize("stream", ["bf16", "f32"])
@pytest.mark.parametrize("U,F,T,B,seeded", WIDTH_CASES, ids=WIDTH_IDS)
def test_emulated_bilstm_new_widths_match_plain(request, stream, U, F, T, B, seeded):
    """The C entries at 32, 96 and 192 units on the weights in
    kernel_layout's order against bilstm_layer_plain. Every output is
    written (the outputs start as NaN)."""
    dtype, entry = entry_of(request, stream)
    ins, outs = bilstm_case(U, F, T, B, seeded, dtype)
    assert U in rnn_cuda.KERNEL_UNITS
    assert emu_layer(entry, ins, outs) == 0
    check(stream, outs, rnn_cuda.bilstm_layer_plain(*ins))


@pytest.mark.parametrize("stream", ["bf16", "f32"])
@pytest.mark.parametrize("U,F,T,B,seeded", PADDED_CASES, ids=PADDED_IDS)
def test_emulated_padded_layer_matches_plain_at_its_width(request, stream, U, F, T, B, seeded):
    """A layer of 40 or 100 units, laid out zero-padded to 64 or 128, run by
    the compiled width's C entry: its padded units' outputs and final states
    are exactly zero, and its own units match bilstm_layer_plain at the true
    width."""
    dtype, entry = entry_of(request, stream)
    ins, _ = bilstm_case(U, F, T, B, seeded, dtype)
    layout = rnn_cuda.kernel_layout(*ins[1:4])
    assert layout.units == U and layout.padded[1].shape[1] == rnn_cuda.padded_units(U)
    rc, *got = run_padded(entry, ins, layout)
    assert rc == 0
    check(stream, own_width(*got, U), rnn_cuda.bilstm_layer_plain(*ins))


@pytest.mark.parametrize("stream", ["bf16", "f32"])
def test_emulated_padded_chain_matches_plain(request, stream):
    """Two stacked 40-unit layers as the encoder runs them on a card: layer 0
    padded to 64 units, its [B, T, 128] outputs and its padded final states
    fed to layer 1, whose Wx rows are laid out for them (kernel_layout's
    ``in_units``), sliced to 40 units once at the end; against the plain
    version of both layers at 40 units."""
    dtype, entry = entry_of(request, stream)
    U, T, B = 40, 4, 20
    ins0, _ = bilstm_case(U, 5, T, B, True, dtype)
    ins1, _ = bilstm_case(U, 2 * U, T, B, False, dtype)
    rc, out0, h0, c0 = run_padded(entry, ins0, rnn_cuda.kernel_layout(*ins0[1:4]))
    assert rc == 0
    layout1 = rnn_cuda.kernel_layout(*ins1[1:4], in_units=U)
    assert layout1.padded[0].shape[1] == 128
    outs = nan_outputs(B, T, 64, dtype)
    assert emu_layer(entry, (out0, *layout1.padded, h0, c0), outs, layout1) == 0
    ref0 = rnn_cuda.bilstm_layer_plain(*ins0)
    ref1 = rnn_cuda.bilstm_layer_plain(ref0[0], *ins1[1:4], ref0[1], ref0[2])
    check(stream, own_width(*outs, U), ref1)
