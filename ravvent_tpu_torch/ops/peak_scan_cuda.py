"""The peak-scan kernel of on-device event detection: its wrapper.

``csrc/peak_scan.cu`` holds two kernels: the blocked scan (one thread per
block of 512 samples: 256 warm-up samples from the default state, then its
own 512, the state in registers), then the check (one warp per read:
every block starting before ``n_valid`` must begin in the state the block
before it ended in; a read that fails is scanned again one sample at a time
and its fired mask overwritten). Together they compute what
ravvent_tpu/ops/event_detect.py's blocked ``lax.scan``, sequential
``lax.scan`` and ``lax.cond`` fallback compute, with the decision on the card.
Their plain version is ops/event_detect.py:peak_scan_plain; the dispatcher
ops/event_detect.py:peak_scan calls this wrapper for CUDA tensors only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ravvent_tpu_torch.ops import cuda_lib
from ravvent_tpu_torch.ops.event_detect import BLOCK  # the kernel's compiled block length

STATE_WORDS = 7  # (s_pos, s_val, s_valid, l_pos, l_val, l_valid, l_masked), 4 bytes each


def peak_scan_cuda(tstat1: torch.Tensor, tstat2: torch.Tensor, n_valid: torch.Tensor, w1: int,
                   w2: int, threshold1: float = 1.4, threshold2: float = 9.0,
                   peak_height: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two kernels on t-statistics tstat1, tstat2 [B, S] f32 and true
    lengths n_valid [B] int32, all contiguous on one card. Returns (fired
    [B, S] bool, masked to i < n_valid; ok [B] bool, True where the blocked
    scan stood and False where the read was scanned again)."""
    if not tstat1.is_cuda:
        raise ValueError("peak_scan_cuda takes CUDA tensors; ops/event_detect.py:peak_scan "
                         "runs the plain version on the CPU")
    if tstat1.dim() != 2:
        raise ValueError(f"peak_scan: tstat1 must be [B, S], got shape {tuple(tstat1.shape)}")
    B, S = tstat1.shape
    if B == 0 or S == 0 or B > 65535:
        raise ValueError(f"peak_scan: needs 1 <= B <= 65535 reads and S >= 1 samples, got "
                         f"B={B}, S={S}")
    if not (1 <= w1 and 1 <= w2):
        raise ValueError(f"peak_scan: windows must be >= 1, got w1={w1}, w2={w2}")
    f32 = torch.float32
    cuda_lib.check_tensors("peak_scan", tstat1.device, [
        ("tstat1", tstat1, f32, (B, S)), ("tstat2", tstat2, f32, (B, S)),
        ("n_valid", n_valid, torch.int32, (B,))])
    dev = tstat1.device
    C = -(-S // BLOCK)
    fired = torch.empty(B, S, dtype=torch.bool, device=dev)
    states = torch.empty(B, C, 2, STATE_WORDS, dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = cuda_lib.lib()
    args = (B, S, w1, w2, threshold1, threshold2, peak_height, tstat1.data_ptr(),
            tstat2.data_ptr(), n_valid.data_ptr(), fired.data_ptr())
    cuda_lib.check(lib.rv_peak_scan_blocks(*args, states.data_ptr(), stream), "peak_scan")
    cuda_lib.launches["peak_scan"] += 1
    cuda_lib.check(lib.rv_peak_scan_check(*args, states.data_ptr(), ok.data_ptr(), stream),
                   "peak_scan check")
    cuda_lib.launches["peak_scan"] += 1
    return fired, ok.bool()
