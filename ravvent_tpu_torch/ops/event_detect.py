"""On-device event detection: raw samples in, event boundaries out.

Counterpart of ravvent_tpu/ops/event_detect.py, the signal-only wire's
segmentation. Phase 1 computes both windows' Welch t-statistics for every
sample from windowed sums (:func:`compute_tstats_device`, plain tensor
code); phase 2 runs the dual-detector peak state machine over time
(:func:`peak_scan`). The JAX package runs phase 2 as ``lax.scan`` loops that
XLA compiles into one program; in eager PyTorch each of a read's ~768
sequential steps would cost some 50 launches, so on a CUDA tensor
:func:`peak_scan` launches the hand-written kernel of csrc/peak_scan.cu
(ops/peak_scan_cuda.py), and on a CPU tensor it runs :func:`peak_scan_plain`,
the reference's blocked scan with its exactness check and sequential
fallback written out in tensor code.

Parity domain: boundaries bit-equal to the streaming detector for window
configs with ``w2 <= 2*w1`` (the production windows 6/9);
:func:`detect_boundaries_device` refuses others. :func:`boundaries_to_events`
computes the events' statistics on the host in float64, as the streaming
detector does.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

FLT_MIN = 1.17549435e-38
FLT_MAX = 3.4028234663852886e38  # the f32 maximum (the reference rounds 3.40282347e38 to it)
BLOCK = 512  # samples per block of the blocked scan
WARMUP = 256  # samples each block replays from the default state before its own


def _windowed_sums(x: torch.Tensor, w: int) -> torch.Tensor:
    """sums[:, i] = x[:, i] + ... + x[:, i+w-1], added left to right, the
    tail zero-padded (valid for i <= S-w)."""
    S = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, w - 1))
    s = xp[:, 0:S]
    for k in range(1, w):
        s = s + xp[:, k:k + S]
    return s


def _nv_column(n_valid, device) -> torch.Tensor:
    """``n_valid`` (an int, a 0-d tensor or a [B] tensor) as a [B or 1, 1]
    int64 tensor on ``device``."""
    return torch.as_tensor(n_valid, device=device).reshape(-1, 1).long()


def compute_tstats_device(raw: torch.Tensor, w: int, w2: int, n_valid=None) -> torch.Tensor:
    """The t-statistic for window ``w`` of a batch of reads raw [B, S], f32
    (ravvent_tpu/ops/event_detect.py:43-99). ``tstat[:, i]`` is the
    streaming detector's value while it processes sample i: with
    m = i + 1 - w2, window 1 is samples [m-w, m) and window 2 [m, m+w).

    ``n_valid`` (an int, or a [B] tensor of each read's true length) marks
    where a zero-padded read ends: windows reaching past it are dead, so the
    padded result equals the exact-length one."""
    B, S = raw.shape
    dev = raw.device
    x = raw.to(torch.float32)
    sums = _windowed_sums(x, w)
    sumsq = _windowed_sums(x * x, w)

    i = torch.arange(S, device=dev)
    lo1 = i + 1 - w2 - w  # start of window 1 (m - w)
    lo2 = i + 1 - w2  # start of window 2 (m)
    idx1 = lo1.clamp(0, S - 1)
    idx2 = lo2.clamp(0, S - 1)
    # window 1 starting before the read while window 2 is live: the
    # streaming ring returns sum1 = sumsq1 = 0
    zero1 = (lo1 < 0)[None, :]
    sum1 = torch.where(zero1, 0.0, sums[:, idx1])
    sumsq1 = torch.where(zero1, 0.0, sumsq[:, idx1])
    sum2 = sums[:, idx2]
    sumsq2 = sumsq[:, idx2]

    # w as a tensor on the device: divided by a Python number, a CUDA
    # tensor is multiplied by its f32 reciprocal, another rounding
    wf = torch.full((), float(w), device=dev)
    mean1 = sum1 / wf
    mean2 = sum2 / wf
    comb = sumsq1 / wf - mean1 * mean1 + sumsq2 / wf - mean2 * mean2
    comb = torch.clamp(comb, min=FLT_MIN)
    # a window pair of no variance: comb / w is subnormal, which XLA's CPU
    # backend flushes to zero (so the reference's tstat is inf, or NaN for
    # equal means); flushed here on every device
    var = comb / wf
    var = torch.where(var < FLT_MIN, 0.0, var)
    # the correctly rounded f32 square root, as the reference's: torch's f32
    # sqrt on the CPU is not (an f64 root rounded to f32 is, 53 >= 2*24 + 2)
    tstat = torch.abs(mean2 - mean1) / torch.sqrt(var.double()).float()

    # quick return while t = i + 2 <= 2w, and window 2 must fit in the read
    if n_valid is None:
        fit = (lo2 + w <= S)[None, :]
    else:
        fit = lo2[None, :] + w <= _nv_column(n_valid, dev)
    live = ((i + 2) > 2 * w)[None, :] & (lo2 >= 0)[None, :] & fit
    if w < 2:
        return torch.zeros_like(tstat)
    return torch.where(live, tstat, 0.0)


# The detector's state: (s_pos i32, s_val f32, s_valid bool, l_pos i32,
# l_val f32, l_valid bool, l_masked i32) for the short (window w1) and the
# long (window w2) detector.
State = Tuple[torch.Tensor, ...]


def _peak_init(shape, device) -> State:
    """The default detector state (pos -1, val FLT_MAX, masked_to 0)."""
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.full(shape, -1, **i32), torch.full(shape, FLT_MAX, device=device),
            torch.zeros(shape, dtype=torch.bool, device=device),
            torch.full(shape, -1, **i32), torch.full(shape, FLT_MAX, device=device),
            torch.zeros(shape, dtype=torch.bool, device=device),
            torch.zeros(shape, **i32))


def _peak_step(carry: State, t1, t2, bm, active, w1: int, w2: int, threshold1: float,
               threshold2: float, peak_height: float) -> Tuple[State, torch.Tensor]:
    """One sample of the dual-detector peak state machine
    (ravvent_tpu/ops/event_detect.py:102-164) on a state of any shape; t1,
    t2 f32 and bm i32 of the state's shape, ``active`` a bool that
    broadcasts to it: an inactive step passes the state through and cannot
    fire. The thresholds compare in f32, as the reference's weakly typed
    Python floats do. Returns (new state, fired)."""
    s_pos, s_val, s_valid, l_pos, l_val, l_valid, l_masked = carry
    where = torch.where

    # short detector (skipped at bm == 0: masked_to 0 >= 0)
    run_s = (bm != 0) & active
    in_case1 = s_pos == -1
    lower = t1 < s_val
    rise = (t1 - s_val) > peak_height
    s_val_c1 = where(lower | rise, t1, s_val)
    s_pos_c1 = where(rise & ~lower, bm, s_pos)
    upd = t1 > s_val
    s_val_c2 = where(upd, t1, s_val)
    s_pos_c2 = where(upd, bm, s_pos)
    mask_long = s_val_c2 > threshold1
    s_valid_c2 = s_valid | (((s_val_c2 - t1) > peak_height) & mask_long)
    fire_s = s_valid_c2 & ((bm - s_pos_c2) > (w1 / 2.0))
    s_pos_new = where(in_case1, s_pos_c1, where(fire_s, -1, s_pos_c2))
    s_val_new = where(in_case1, s_val_c1, where(fire_s, t1, s_val_c2))
    s_valid_new = where(in_case1, s_valid, s_valid_c2 & ~fire_s)
    fire_s = fire_s & ~in_case1 & run_s
    s_pos_new = where(run_s, s_pos_new, s_pos)
    s_val_new = where(run_s, s_val_new, s_val)
    s_valid_new = where(run_s, s_valid_new, s_valid)
    do_mask = run_s & ~in_case1 & mask_long

    # the long detector, reset by the short one's masking
    l_masked = where(do_mask, s_pos_c2 + w1, l_masked)
    l_pos = where(do_mask, -1, l_pos)
    l_val = where(do_mask, FLT_MAX, l_val)
    l_valid = l_valid & ~do_mask

    run_l = (l_masked < bm) & active
    in_case1l = l_pos == -1
    lowerl = t2 < l_val
    risel = (t2 - l_val) > peak_height
    l_val_c1 = where(lowerl | risel, t2, l_val)
    l_pos_c1 = where(risel & ~lowerl, bm, l_pos)
    updl = t2 > l_val
    l_val_c2 = where(updl, t2, l_val)
    l_pos_c2 = where(updl, bm, l_pos)
    l_valid_c2 = l_valid | (((l_val_c2 - t2) > peak_height) & (l_val_c2 > threshold2))
    fire_l = l_valid_c2 & ((bm - l_pos_c2) > (w2 / 2.0))
    l_pos_new = where(in_case1l, l_pos_c1, where(fire_l, -1, l_pos_c2))
    l_val_new = where(in_case1l, l_val_c1, where(fire_l, t2, l_val_c2))
    l_valid_new = where(in_case1l, l_valid, l_valid_c2 & ~fire_l)
    fire_l = fire_l & ~in_case1l & run_l
    l_pos = where(run_l, l_pos_new, l_pos)
    l_val = where(run_l, l_val_new, l_val)
    l_valid = where(run_l, l_valid_new, l_valid)
    return ((s_pos_new, s_val_new, s_valid_new, l_pos, l_val, l_valid, l_masked),
            fire_s | fire_l)


def peak_scan_device(tstat1: torch.Tensor, tstat2: torch.Tensor, w1: int, w2: int,
                     threshold1: float = 1.4, threshold2: float = 9.0,
                     peak_height: float = 0.2) -> torch.Tensor:
    """The peak scan one sample at a time (ravvent_tpu/ops/event_detect.py:180-206),
    over reads [B, S]. Returns the bool [B, S] fired mask: sample i fires
    => an event ends at stream coordinate ``i + 2 - w2 - w1``. A Python loop
    of S steps: for short traces and the blocked scan's fallback."""
    B, S = tstat1.shape
    dev = tstat1.device
    carry = _peak_init((B,), dev)
    active = torch.ones((), dtype=torch.bool, device=dev)
    fired = torch.zeros(B, S, dtype=torch.bool, device=dev)
    for i in range(S):
        bm = torch.full((B,), i + 1 - w2, dtype=torch.int32, device=dev)
        carry, fired[:, i] = _peak_step(carry, tstat1[:, i], tstat2[:, i], bm, active, w1, w2,
                                        threshold1, threshold2, peak_height)
    return fired


def peak_scan_device_blocked(tstat1: torch.Tensor, tstat2: torch.Tensor, w1: int, w2: int,
                             threshold1: float = 1.4, threshold2: float = 9.0,
                             peak_height: float = 0.2, n_valid=None, block: int = BLOCK,
                             warmup: int = WARMUP) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocked scan with its exactness check
    (ravvent_tpu/ops/event_detect.py:210-306). Returns (fired [B, S] bool,
    ok 0-d bool).

    The read is cut into C = ceil(S / block) blocks, all advanced together:
    each block first replays the ``warmup`` samples before it from the
    default state (block 0 dead-steps them), then scans its own samples.
    A fire resets the firing detector to a function of the current sample,
    so two trajectories over the same samples soon coincide. ``ok`` says
    that every block starting before ``n_valid`` began where the block
    before it ended (all 7 state components equal), which proves every fire
    equal to the sequential scan's by induction from block 0."""
    B, S = tstat1.shape
    L, W = block, warmup
    if W > L:
        raise ValueError("warmup must not exceed block")
    dev = tstat1.device
    C = -(-S // L)
    P = C * L

    def prep(t):
        # block c's warm-up samples [cL - W, cL) are the last W of block c-1
        main = torch.nn.functional.pad(t, (0, P - S)).reshape(B, C, L)
        warm = torch.cat([main.new_zeros(B, 1, W), main[:, :-1, L - W:]], dim=1)
        return torch.cat([warm, main], dim=2)  # [B, C, W + L]

    t1b, t2b = prep(tstat1), prep(tstat2)
    # the absolute sample of each (block, step): cL - W + j
    samp = (torch.arange(C, device=dev) * L)[:, None] + (torch.arange(W + L, device=dev) - W)[None, :]
    bm = (samp + 1 - w2).to(torch.int32)
    active = samp >= 0  # block 0's warm-up lies before the read

    carry = _peak_init((B, C), dev)
    for j in range(W):
        carry, _ = _peak_step(carry, t1b[:, :, j], t2b[:, :, j], bm[None, :, j], active[:, j],
                              w1, w2, threshold1, threshold2, peak_height)
    warm_end = carry
    fired = torch.zeros(B, C, L, dtype=torch.bool, device=dev)
    for j in range(W, W + L):
        carry, fired[:, :, j - W] = _peak_step(carry, t1b[:, :, j], t2b[:, :, j],
                                               bm[None, :, j], active[:, j], w1, w2,
                                               threshold1, threshold2, peak_height)
    final = carry
    fired = fired.reshape(B, P)[:, :S]

    # exactness: warm_end[c] must equal final[c-1] wherever block c matters
    starts = torch.arange(C, device=dev) * L
    if n_valid is None:
        need = (starts < S)[None, :]
    else:
        need = starts[None, :] < _nv_column(n_valid, dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for we, fi in zip(warm_end, final):
        ok = ok & ((we[:, 1:] == fi[:, :-1]) | ~need[:, 1:]).all()
    return fired, ok


def peak_scan_plain(tstat1: torch.Tensor, tstat2: torch.Tensor, w1: int, w2: int,
                    threshold1: float = 1.4, threshold2: float = 9.0,
                    peak_height: float = 0.2, n_valid=None) -> torch.Tensor:
    """The plain version of the peak-scan kernel: the blocked scan, and the
    sequential scan in its place when the check fails (the reference's
    ``lax.cond``, ravvent_tpu/ops/event_detect.py:339-352), then the
    ``n_valid`` mask. Returns fired [B, S] bool."""
    fired, ok = peak_scan_device_blocked(tstat1, tstat2, w1, w2, threshold1, threshold2,
                                         peak_height, n_valid=n_valid)
    if not bool(ok):
        fired = peak_scan_device(tstat1, tstat2, w1, w2, threshold1, threshold2, peak_height)
    if n_valid is not None:
        S = tstat1.shape[1]
        fired = fired & (torch.arange(S, device=fired.device)[None, :]
                         < _nv_column(n_valid, fired.device))
    return fired


def peak_scan(tstat1: torch.Tensor, tstat2: torch.Tensor, w1: int, w2: int,
              threshold1: float = 1.4, threshold2: float = 9.0, peak_height: float = 0.2,
              n_valid=None) -> torch.Tensor:
    """The blocked peak scan with its check and fallback, masked to
    ``n_valid``: csrc/peak_scan.cu's two kernels for CUDA tensors,
    :func:`peak_scan_plain` for CPU tensors. Returns fired [B, S] bool."""
    if not tstat1.is_cuda:
        return peak_scan_plain(tstat1, tstat2, w1, w2, threshold1, threshold2, peak_height,
                               n_valid)
    from ravvent_tpu_torch.ops.peak_scan_cuda import peak_scan_cuda

    B, S = tstat1.shape
    nv = (torch.full((B,), S, dtype=torch.int32, device=tstat1.device) if n_valid is None
          else _nv_column(n_valid, tstat1.device).reshape(-1).to(torch.int32).expand(B)
          .contiguous())
    return peak_scan_cuda(tstat1, tstat2, nv, w1, w2, threshold1, threshold2, peak_height)[0]


def detect_boundaries_device(raw: torch.Tensor, w1: int = 6, w2: int = 9,
                             threshold1: float = 1.4, threshold2: float = 9.0,
                             peak_height: float = 0.2, n_valid=None) -> torch.Tensor:
    """Event-end firings of a batch of (zero-padded) reads raw [B, S]: bool
    [B, S]; fired sample i ends an event at ``i + 2 - w2 - w1``
    (ravvent_tpu/ops/event_detect.py:309-356 with ``block=512``).
    ``n_valid`` (an int or a [B] tensor) is each read's true length: the
    result is then bit-equal to the exact-length run's, and samples from
    ``n_valid`` on never fire. Only ``w2 <= 2*w1`` is in the exact-parity
    domain."""
    if w2 > 2 * w1:
        raise ValueError("on-device event detection supports w2 <= 2*w1 (exact-parity "
                         "domain); use the host detector for other configs")
    t1 = compute_tstats_device(raw, w1, w2, n_valid)
    t2 = compute_tstats_device(raw, w2, w2, n_valid)
    return peak_scan(t1, t2, w1, w2, threshold1, threshold2, peak_height, n_valid)


def fired_to_event_lens(fired: torch.Tensor, w1: int, w2: int, max_events: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fired masks [B, S] (or [S]) to (lens [B, max_events] int32, n_events
    [B] int32, the uncapped count [B] int32), as
    ravvent_tpu/ops/event_detect.py:359-379 does per read: ends strictly
    increase, ends <= 0 are skipped, lengths are the ends' differences.
    ``n_events`` saturates at ``max_events``; the uncapped count shows the
    overflow. Ends past ``max_events`` go to a dropped slot (the
    reference's scatter ``mode="drop"``)."""
    squeeze = fired.dim() == 1
    if squeeze:
        fired = fired[None]
    B, S = fired.shape
    dev = fired.device
    ends = (torch.arange(S, device=dev, dtype=torch.int32) + (2 - w2 - w1))[None, :].expand(B, S)
    keep = fired & (ends > 0)
    k32 = keep.to(torch.int32)
    n_true = k32.sum(dim=1, dtype=torch.int32)
    pos = torch.cumsum(k32, dim=1, dtype=torch.int32) - 1
    idx = torch.where(keep & (pos < max_events), pos, max_events).long()
    ends_arr = torch.zeros(B, max_events + 1, dtype=torch.int32, device=dev)
    ends_arr.scatter_(1, idx, ends)
    ends_arr = ends_arr[:, :max_events]
    prev = torch.nn.functional.pad(ends_arr[:, :-1], (1, 0))
    n_ev = torch.clamp(n_true, max=max_events)
    rows = torch.arange(max_events, device=dev, dtype=torch.int32)
    lens = torch.where(rows[None, :] < n_ev[:, None], ends_arr - prev, 0)
    if squeeze:
        return lens[0], n_ev[0], n_true[0]
    return lens, n_ev, n_true


def boundaries_to_events(raw: np.ndarray, fired: np.ndarray, w1: int = 6, w2: int = 9
                         ) -> np.ndarray:
    """Events from a fired mask, on the host in float64 with the streaming
    detector's statistics (ravvent_tpu/ops/event_detect.py:382-406).
    Returns [n_events, 4] (start, length, mean, stdv)."""
    idx = np.nonzero(np.asarray(fired))[0]
    ends = idx + 2 - w2 - w1  # stream coordinates
    x = np.asarray(raw, np.float64)
    S = np.concatenate(([0.0], np.cumsum(x)))
    Sq = np.concatenate(([0.0], np.cumsum(x ** 2)))
    events = []
    st, st_sum, st_sq = 0, 0.0, 0.0
    for en in ends:
        if en <= st:
            continue
        length = float(en - st)
        e_sum, e_sq = S[en], Sq[en]
        mean = (e_sum - st_sum) / length
        stdv = math.sqrt(max((e_sq - st_sq) / length - mean ** 2, FLT_MIN))
        events.append((st, int(length), mean, stdv))
        st, st_sum, st_sq = en, e_sum, e_sq
    return np.array(events).reshape(-1, 4)

