"""The BiLSTM-layer kernels past 256 units (csrc/bilstm_wide.cu, f32;
csrc/bilstm_bf16_wide.cu, bf16) at each of their compiled widths
(ops/rnn_cuda.py:WIDE_UNITS: 320, 384, 448, 512) and on a layer zero-padded
to one of them (300 units run at 320), run on the CPU by the emulation of
tools/cuda_emu.py against ``bilstm_layer_plain`` at the layer's own width;
and what their C entries refuse. The card-only tests in test_torch_gpu.py
stay the yardstick of the kernels themselves. Needs g++."""

import ctypes

import pytest
import torch

from cuda_emu_cases import (  # noqa: F401 (fixtures)
    _load, bilstm_case, emu_bilstm, emu_bilstm_f32, emu_layer, nan_outputs,
)
from ravvent_tpu_torch.ops import rnn_cuda
from test_torch_cuda_emu_bilstm_widths import check, own_width, run_padded

STREAMS = {"f32": (torch.float32, "rv_bilstm_layer_wide", 4),
           "bf16": (torch.bfloat16, "rv_bilstm_layer_bf16_wide", 16)}


@pytest.fixture(scope="module")
def emu_wide():
    return _load("bilstm_wide.cu", "bilstm_bf16_wide.cu")


def entry_of(emu_wide, stream):
    dtype, name, _ = STREAMS[stream]
    return dtype, getattr(emu_wide, name)


# (U, F, T, B, seeded state) at each wide width, on raw (1), event (5) and a
# stacked layer's input (2U) features: the f32 kernel takes 16 rows a CTA
# (B 13 in one ragged tile, 20 in two, 37 in three), the bf16 kernel 32 (13
# in one, 37 in two, 70 in three)
WIDE_CASES = [(320, 1, 3, 13, True), (320, 5, 3, 37, False), (320, 640, 2, 20, True),
              (384, 1, 3, 37, False), (384, 5, 2, 70, True), (384, 768, 2, 13, False),
              (448, 1, 2, 20, True), (448, 5, 3, 13, False), (448, 896, 2, 37, True),
              (512, 1, 2, 70, False), (512, 5, 3, 20, True), (512, 1024, 2, 13, False)]
WIDE_IDS = [f"U{c[0]}-F{c[1]}-T{c[2]}-B{c[3]}-{'seeded' if c[4] else 'zero'}"
            for c in WIDE_CASES]
# (U, F, T, B, seeded) of a layer the wrapper pads from 300 units to 320
PADDED_CASES = [(300, 1, 3, 37, False), (300, 5, 3, 20, True), (300, 600, 2, 13, True)]
PADDED_IDS = [f"U{c[0]}-F{c[1]}-T{c[2]}-B{c[3]}-{'seeded' if c[4] else 'zero'}"
              for c in PADDED_CASES]


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("U,F,T,B,seeded", WIDE_CASES, ids=WIDE_IDS)
def test_emulated_wide_bilstm_matches_plain(emu_wide, stream, U, F, T, B, seeded):
    """The wide C entries on the weights in kernel_layout's order against
    bilstm_layer_plain: f32 within 1e-4 (chip_smoke.py phase 2's bar), bf16
    outputs within 1e-2 and final states within 1e-3 (phase 9's). Every
    output is written (the outputs start as NaN)."""
    dtype, entry = entry_of(emu_wide, stream)
    ins, outs = bilstm_case(U, F, T, B, seeded, dtype)
    assert U in rnn_cuda.WIDE_UNITS
    assert emu_layer(entry, ins, outs) == 0
    check(stream, outs, rnn_cuda.bilstm_layer_plain(*ins))


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("U,F,T,B,seeded", PADDED_CASES, ids=PADDED_IDS)
def test_emulated_wide_padded_layer_matches_plain_at_its_width(emu_wide, stream, U, F, T, B,
                                                                seeded):
    """A 300-unit layer, laid out zero-padded to 320 units, run by the wide
    C entry: its padded units' outputs and final states are exactly zero,
    and its own units match bilstm_layer_plain at 300 units."""
    dtype, entry = entry_of(emu_wide, stream)
    ins, _ = bilstm_case(U, F, T, B, seeded, dtype)
    layout = rnn_cuda.kernel_layout(*ins[1:4])
    assert layout.units == U and layout.padded[1].shape[1] == 320
    rc, *got = run_padded(entry, ins, layout)
    assert rc == 0
    check(stream, own_width(*got, U), rnn_cuda.bilstm_layer_plain(*ins))


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("U", [264, 300])
def test_emulated_wide_padded_chain_matches_plain(emu_wide, stream, U):
    """Two stacked layers of 264 or 300 units as the encoder runs them on a
    card: layer 0 padded to 320 units, its [B, T, 640] outputs and padded
    final states fed to layer 1, whose Wx rows sit at [0, U) and [320, 320
    + U) (kernel_layout's ``in_units``: the gap 320 - U holds zero rows
    that meet the padded units' zero outputs), sliced to U once at the end;
    against the plain version of both layers at U units."""
    dtype, entry = entry_of(emu_wide, stream)
    T, B = 2, 20
    ins0, _ = bilstm_case(U, 5, T, B, True, dtype)
    ins1, _ = bilstm_case(U, 2 * U, T, B, False, dtype)
    rc, out0, h0, c0 = run_padded(entry, ins0, rnn_cuda.kernel_layout(*ins0[1:4]))
    assert rc == 0
    layout1 = rnn_cuda.kernel_layout(*ins1[1:4], in_units=U)
    wx1 = layout1.padded[0]
    assert wx1.shape[1] == 640
    assert not wx1[:, U:320].any() and not wx1[:, 320 + U:].any()
    outs = nan_outputs(B, T, 320, dtype)
    assert emu_layer(entry, (out0, *layout1.padded, h0, c0), outs, layout1) == 0
    ref0 = rnn_cuda.bilstm_layer_plain(*ins0)
    ref1 = rnn_cuda.bilstm_layer_plain(ref0[0], *ins1[1:4], ref0[1], ref0[2])
    check(stream, own_width(*outs, U), ref1)


@pytest.mark.parametrize("stream", ["f32", "bf16"])
def test_emulated_wide_entries_refuse_what_they_do_not_take(request, emu_wide, stream):
    """The wide C entry returns cudaErrorInvalidValue (1 in the emulation)
    for a unit count outside WIDE_UNITS (the narrow kernels' 256, a padded
    300, 336, past the widest 520), for a Kx that is not F rounded up to the
    stream's k-step, for F past 2U, for no rows and (bf16) for F > 16 not a
    multiple of 8; the narrow C entries refuse every wide width."""
    _, entry = entry_of(emu_wide, stream)
    step = STREAMS[stream][2]
    z = torch.zeros(1)
    args = (z.data_ptr(),) * 8
    kx = lambda F: -(-F // step) * step  # noqa: E731
    for U in (256, 300, 336, 520):
        assert U not in rnn_cuda.WIDE_UNITS
        assert entry(z.data_ptr(), 4, 3, 5, kx(5), U, *args, None) == 1
    assert entry(z.data_ptr(), 4, 3, 5, kx(5) + step, 384, *args, None) == 1
    assert entry(z.data_ptr(), 4, 3, 776, kx(776), 384, *args, None) == 1
    assert entry(z.data_ptr(), 0, 3, 5, kx(5), 384, *args, None) == 1
    if stream == "bf16":
        assert entry(z.data_ptr(), 4, 3, 20, 32, 384, *args, None) == 1
    narrow = (request.getfixturevalue("emu_bilstm_f32").rv_bilstm_layer if stream == "f32"
              else request.getfixturevalue("emu_bilstm").rv_bilstm_layer_bf16)
    for U in rnn_cuda.WIDE_UNITS:
        assert narrow(z.data_ptr(), 4, 3, 5, kx(5), U, *args, None) == 1


@pytest.mark.parametrize("stream", ["f32", "bf16"])
def test_emulated_wide_cta_fits_a_block(emu_wide, stream):
    """rv_bilstm_layer_*_wide_cta: at each wide width, on F = 1, 5 and 2U, a
    CTA of U threads (U / 32 warps) and 16 rows (f32) or 32 (bf16), whose
    shared memory fits the 227 KB a block can use on the H100 (232,448
    bytes, its 16 static bytes on f32 beside); refused past the set."""
    name = "rv_bilstm_layer_wide_cta" if stream == "f32" else "rv_bilstm_layer_bf16_wide_cta"
    entry = getattr(emu_wide, name)
    step = STREAMS[stream][2]
    info = (ctypes.c_int * 5)()
    for U in rnn_cuda.WIDE_UNITS:
        for F in (1, 5, 2 * U):
            assert entry(U, -(-F // step) * step, info) == 0
            threads, smem, rows = info[0], info[1], info[2]
            assert threads == U and rows == (16 if stream == "f32" else 32)
            assert 0 < smem <= 232448 - 16
    assert entry(520, 16, info) == 1 and entry(300, 16, info) == 1
