"""The peak scan of event detection (csrc/peak_scan.cu: the blocked scan and
its exactness check) run on the CPU by the emulation of tools/cuda_emu.py
against ``peak_scan_plain`` (ops/event_detect.py), bit for bit, and what
its C entry refuses. The traces live in tests/cuda_emu_cases.py, shared
with tests/test_torch_event_detect.py and tests/test_torch_gpu.py. Needs
g++."""

import pytest
import torch

from cuda_emu_cases import emu_peak, peak_scan_inputs  # noqa: F401 (emu_peak)
from ravvent_tpu_torch.ops import event_detect as ted
from ravvent_tpu_torch.ops import peak_scan_cuda

def emu_peak_scan(lib, t1, t2, nv):
    """Both kernels of csrc/peak_scan.cu, as ops/peak_scan_cuda.py launches
    them; the fired mask starts all True, so an unwritten sample shows."""
    B, S = t1.shape
    C = -(-S // peak_scan_cuda.BLOCK)
    fired = torch.ones(B, S, dtype=torch.bool)
    states = torch.empty(B, C, 2, peak_scan_cuda.STATE_WORDS, dtype=torch.int32)
    ok = torch.empty(B, dtype=torch.uint8)
    args = (B, S, 6, 9, 1.4, 9.0, 0.2, t1.data_ptr(), t2.data_ptr(), nv.data_ptr(),
            fired.data_ptr())
    assert lib.rv_peak_scan_blocks(*args, states.data_ptr(), None) == 0
    assert lib.rv_peak_scan_check(*args, states.data_ptr(), ok.data_ptr(), None) == 0
    return fired, ok.bool()


@pytest.mark.parametrize("case", ["reads", "coupling_failure", "memory"])
def test_emulated_peak_scan_matches_plain(emu_peak, case):
    """The scan and the check against peak_scan_plain, bit for bit: two
    padded reads (the check passes; nothing fires from n_valid on), and the
    two traces whose check fails, where the rescan gives the sequential
    answer (on the memory trace the blocked fires are wrong)."""
    t1, t2, nv = peak_scan_inputs(case)
    fired, ok = emu_peak_scan(emu_peak, t1, t2, nv)
    assert emu_peak.rv_peak_scan_state_bytes() == 4 * peak_scan_cuda.STATE_WORDS
    assert torch.equal(fired, ted.peak_scan_plain(t1, t2, 6, 9, n_valid=nv))
    assert ok.tolist() == ([True, True] if case == "reads" else [False])
    if case == "reads":
        assert not fired[1, int(nv[1]):].any() and fired.sum() > 400
    if case == "memory":
        assert torch.nonzero(fired[0]).flatten().tolist() == [1503]


def test_emulated_peak_scan_refuses_what_it_does_not_take(emu_peak):
    t = torch.zeros(1, 8)
    nv = torch.tensor([8], dtype=torch.int32)
    for B, S in ((0, 8), (1, 0), (70000, 8)):
        assert emu_peak.rv_peak_scan_blocks(B, S, 6, 9, 1.4, 9.0, 0.2, t.data_ptr(), t.data_ptr(),
                                            nv.data_ptr(), t.data_ptr(), t.data_ptr(), None) != 0
