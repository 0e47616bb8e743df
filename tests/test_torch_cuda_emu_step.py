"""The beam step's cell kernel (csrc/beam_step_f.cu's ``beam_cell``) at each
decoder width, and what the step's C entries refuse, run on the CPU by the
emulation of tools/cuda_emu.py against their plain versions
(ops/beam_step_cuda.py: ``cell_plain``). The emulation runs the kernels' own
code (indexing, shared-memory layout, the persistent grid's row walk, the
warp shuffles) one CTA at a time, each CUDA thread a fiber, so these tests
hold the CUDA source's logic on a machine without a card; the card's
arithmetic is not the host's, so the card-only tests in test_torch_gpu.py
stay the yardstick of the kernels themselves. Needs g++."""

import ctypes

import numpy as np
import pytest
import torch

from cuda_emu_cases import (  # noqa: F401 (emu: a fixture)
    decoder_weights, emu, emu_attend, emu_cell, memory, mid_decode_state,
)
from ravvent_tpu_torch.ops import beam_step_cuda as tstep

V = 7

# (U, B, W) of the cell: the flagship's 128 units keep their ids; at 64
# units a CTA has 128 threads, at 256 it has 512 (Cell in beam_step_f.cu)
CELL_CASES = [(128, 9, 1), (128, 7, 5), (128, 4, 8), (64, 7, 5), (256, 9, 5)]
CELL_IDS = [("" if u == 128 else f"U{u}-") + f"{b}-{w}" for u, b, w in CELL_CASES]


@pytest.mark.parametrize("U,B,W", CELL_CASES, ids=CELL_IDS)
def test_emulated_beam_cell_matches_plain(emu, U, B, W):
    """h', c' and att_h of the cell kernel against cell_plain: f32 sums of
    2U and U terms in another order, within 1e-5; the last 32-hypothesis
    tile is ragged."""
    rng = np.random.default_rng(10 * B + W)
    w = decoder_weights(rng, U)
    st = mid_decode_state(rng, B, W, U)
    rc, got = emu_cell(emu, st, w)
    assert rc == 0
    for g, r in zip(got, tstep.cell_plain(st, w)):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["bf16", "quant"])
def test_emulated_beam_step_refuses_shapes_not_compiled(emu, mode):
    """The C entries return cudaErrorInvalidValue (1 in the emulation),
    launching nothing, for what beam_step_shapes.cuh does not list: 96 units
    (the cell and the attend) and 33 or 0 beams; rv_beam_attend_info says
    a CTA of S = 4000 positions at 256 units and 16 beams does not fit."""
    rng = np.random.default_rng(3)
    mem = memory(rng, 3, 16, mode)
    w = decoder_weights(rng)._replace(watt_h=mem.watt_h)
    st = mid_decode_state(rng, 3, 5)
    cell = tstep.cell_plain(st, w)
    for u, beams in ((96, None), (None, 33), (None, 0)):
        rc, got, _ = emu_attend(emu, st, cell, mem, w, mode, W=beams, U=u)
        assert rc == 1, (u, beams)
    rc, got = emu_cell(emu, st, w, U=96)
    assert rc == 1 and all(g.isnan().all() for g in got)
    info = (ctypes.c_int * 3)()
    for mode_no, (u, beams, S, fits) in enumerate(((128, 5, 232, True), (256, 16, 232, True),
                                                    (256, 16, 4000, False), (64, 1, 8, True))):
        assert emu.rv_beam_attend_info(mode_no, u, beams, S, V, ctypes.addressof(info)) == 0
        assert (info[0] <= tstep.SMEM_LIMIT) == fits and (info[2] > 0) == fits, (u, beams, S)
    assert emu.rv_beam_attend_info(0, 96, 5, 8, V, ctypes.addressof(info)) == 1
