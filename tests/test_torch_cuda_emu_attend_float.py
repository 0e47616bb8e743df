"""The beam step's attend kernel (csrc/beam_attend.cuh) on bf16 and f32 memory, run
on the CPU by the emulation of tools/cuda_emu.py against ``attend_plain``
(ops/beam_step_cuda.py) on the same cell outputs, at 64, 128 and 256 units
and W = 1-16. The other memory modes' cases are in
test_torch_cuda_emu_attend_int8.py; both take their cases, ids and check
from cuda_emu_cases.py. Needs g++."""

import pytest

from cuda_emu_cases import (  # noqa: F401 (emu: a fixture)
    ATTEND_CASES, ATTEND_IDS, check_attend, emu,
)


@pytest.mark.parametrize("U,B,W,S", ATTEND_CASES, ids=ATTEND_IDS)
@pytest.mark.parametrize("mode", ['bf16', 'f32'])
def test_emulated_beam_attend_matches_plain(emu, mode, U, B, W, S):
    """The attend kernel in each of these memory modes against attend_plain
    (cuda_emu_cases.check_attend)."""
    check_attend(emu, mode, U, B, W, S)
