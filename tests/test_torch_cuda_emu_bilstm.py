"""The BiLSTM-layer kernels (csrc/bilstm.cu, f32; csrc/bilstm_bf16.cu, bf16)
at their compiled widths, run on the CPU by the emulation of
tools/cuda_emu.py against ``bilstm_layer_plain`` (ops/rnn_cuda.py), and
what their C entries refuse. The emulation runs the kernels' own code (the
k-tiles, the rows a CTA, the mma fragments) one CTA at a time, each CUDA
thread a fiber; the card-only tests in test_torch_gpu.py stay the
yardstick of the kernels themselves. Needs g++."""

import pytest
import torch

from cuda_emu_cases import bilstm_case, emu_bilstm, emu_bilstm_f32, emu_layer  # noqa: F401
from ravvent_tpu_torch.ops import rnn_cuda

# (U, F, T, B, seeded state): the emulated card has 2 SMs, so at 64 and 128
# units B picks 16, 32, 48 or 64 rows a CTA (13, 20, 37, then 70 in two
# tiles), none a multiple of it; at 256 units the f32 kernel takes 16 rows
# (B 13) or 32 (B 20, 37 in two tiles) and the bf16 kernel 16 (1, 2 and 3
# tiles); F = 1 and 5 run one partial x k-tile, F = 2U every k-tile
BILSTM_CASES = [(128, 1, 7, 13, False), (128, 1, 3, 70, True), (128, 5, 3, 37, True),
                (128, 5, 7, 20, False), (128, 256, 3, 37, True), (128, 256, 7, 20, False),
                (128, 256, 3, 70, False),
                (64, 1, 7, 13, False), (64, 5, 3, 37, True), (64, 128, 5, 20, True),
                (64, 128, 3, 70, False),
                (256, 1, 3, 13, True), (256, 5, 4, 20, False), (256, 512, 3, 37, True)]
# unit counts around the compiled ones (csrc/bilstm_units.cuh), which the
# C entries refuse: ops/rnn_cuda.py pads such a layer to a compiled width
# before it reaches them (520 is past the widest, 512)
UNCOMPILED = (16, 48, 80, 112, 160, 520)
BILSTM_IDS = [("" if c[0] == 128 else f"U{c[0]}-")
              + f"F{c[1]}-T{c[2]}-B{c[3]}-{'seeded' if c[4] else 'zero'}" for c in BILSTM_CASES]


@pytest.mark.parametrize("U,F,T,B,seeded", BILSTM_CASES, ids=BILSTM_IDS)
def test_emulated_bilstm_bf16_matches_plain(emu_bilstm, U, F, T, B, seeded):
    """rv_bilstm_layer_bf16 on the weights in kernel_layout's fragment order
    against bilstm_layer_plain, at chip_smoke.py phase 9's bars: bf16 outputs
    within 1e-2 (two bf16 ulps at |h| <= 1), f32 final states within 1e-3.
    At 256 units Wh streams from L2 with Wx. Every output is written (the
    outputs start as NaN)."""
    ins, (out, hN, cN) = bilstm_case(U, F, T, B, seeded, torch.bfloat16)
    assert emu_layer(emu_bilstm.rv_bilstm_layer_bf16, ins, (out, hN, cN)) == 0
    ref = rnn_cuda.bilstm_layer_plain(*ins)
    assert (out.float() - ref[0].float()).abs().max().item() <= 1e-2
    assert (hN - ref[1]).abs().max().item() <= 1e-3
    assert (cN - ref[2]).abs().max().item() <= 1e-3


def test_emulated_bilstm_bf16_refuses_what_it_does_not_take(emu_bilstm):
    """The C entry returns cudaErrorInvalidValue (1 in the emulation) for a
    Kx that is not F rounded up to 16, for F > 16 not a multiple of 8, for F
    past 2U, and for a unit count it was not compiled for."""
    z = torch.zeros(1)
    args = (z.data_ptr(),) * 8
    entry = emu_bilstm.rv_bilstm_layer_bf16
    assert entry(z.data_ptr(), 4, 3, 5, 32, 128, *args, None) == 1
    assert entry(z.data_ptr(), 4, 3, 36, 48, 128, *args, None) == 1
    assert entry(z.data_ptr(), 4, 3, 300, 304, 128, *args, None) == 1
    assert entry(z.data_ptr(), 4, 3, 136, 144, 64, *args, None) == 1
    for U in UNCOMPILED:
        assert U not in rnn_cuda.KERNEL_UNITS
        assert entry(z.data_ptr(), 4, 3, 5, 16, U, *args, None) == 1


@pytest.mark.parametrize("U,F,T,B,seeded", BILSTM_CASES, ids=BILSTM_IDS)
def test_emulated_bilstm_f32_matches_plain(emu_bilstm_f32, U, F, T, B, seeded):
    """rv_bilstm_layer on the weights in kernel_layout's by-unit order
    against bilstm_layer_plain, within chip_smoke.py phase 2's 1e-4 (f32
    sums in another order). At 256 units the k-tiles are 8 rows. Every
    output is written (the outputs start as NaN)."""
    ins, outs = bilstm_case(U, F, T, B, seeded, torch.float32)
    assert emu_layer(emu_bilstm_f32.rv_bilstm_layer, ins, outs) == 0
    for got, ref in zip(outs, rnn_cuda.bilstm_layer_plain(*ins)):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_emulated_bilstm_f32_refuses_what_it_does_not_take(emu_bilstm_f32):
    """The C entry returns cudaErrorInvalidValue (1 in the emulation) for a
    Kx that is not F rounded up to 4, for F past 2U, for no rows, and for a
    unit count it was not compiled for."""
    z = torch.zeros(1)
    args = (z.data_ptr(),) * 8
    entry = emu_bilstm_f32.rv_bilstm_layer
    assert entry(z.data_ptr(), 4, 3, 5, 16, 128, *args, None) == 1
    assert entry(z.data_ptr(), 4, 3, 260, 260, 128, *args, None) == 1
    assert entry(z.data_ptr(), 0, 3, 5, 8, 128, *args, None) == 1
    assert entry(z.data_ptr(), 4, 3, 132, 132, 64, *args, None) == 1
    for U in UNCOMPILED:
        assert U not in rnn_cuda.KERNEL_UNITS
        assert entry(z.data_ptr(), 4, 3, 5, 8, U, *args, None) == 1
