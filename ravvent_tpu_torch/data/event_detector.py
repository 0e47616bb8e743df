"""t-test segmentation of raw nanopore current into events.

Behavior-equivalent, from-scratch implementation of the Scrappie-derived
streaming event detector used by the reference
(reference: event_detection/event_detector.py). Two implementations:

- :class:`StreamingEventDetector`: a faithful per-sample streaming port — the
  executable spec. Slow (Python loop); used as the parity oracle in tests.
- :func:`detect_events`: the production host path — Welch t-statistics for both
  windows computed vectorized over the whole read (closed form over cumulative
  sums, including the reference's u32 ring-buffer aliasing behavior for early
  samples), followed by a single tight stateful peak-detection scan. Produces
  bit-identical events to the streaming detector.

The same two-phase formulation (parallel t-stat pass + sequential peak scan)
is what the on-device JAX/Pallas version in ``ravvent_tpu.ops.event_detect``
implements.

Semantics notes (all preserved deliberately):
- Sample i is processed at stream time t=i+2 with ``buf_mid = i+1-w2`` (u32
  wrapped when negative), so event start/end coordinates are offset by +1
  relative to raw sample indices (reference: event_detector.py:72-95).
- The ring buffer holds cumulative sums; early-stream reads of "negative"
  indices alias to slot ``(2**32 + k) % BUF_LEN``, which for the default
  windows returns a *different valid cumsum* rather than garbage
  (reference: event_detector.py:125-134). Reproduced exactly.
- The short detector, while holding an above-threshold peak, masks and resets
  the long detector every sample (reference: event_detector.py:169-176).
- A confirmed peak emits an event ending at ``buf_mid - w1 + 1`` (the
  *confirmation-time* position, not the peak position)
  (reference: event_detector.py:103-104).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

FLT_MIN = 1.17549435e-38
FLT_MAX = 3.40282347e38

DEFAULT_WINDOW1 = 6
DEFAULT_WINDOW2 = 9
DEFAULT_THRESHOLD1 = 1.4
DEFAULT_THRESHOLD2 = 9.0
DEFAULT_PEAK_HEIGHT = 0.2


def _u32(v: int) -> int:
    return int(v) & 0xFFFFFFFF


def _i32(v: int) -> int:
    n = int(v) & 0xFFFFFFFF
    return (n ^ 0x80000000) - 0x80000000


@dataclasses.dataclass
class Event:
    start: int
    length: int
    mean: float
    stdv: float

    @property
    def end(self) -> int:
        return self.start + self.length


class _PeakDetector:
    """State for one t-stat peak detector (short or long window)."""

    DEF_PEAK_POS = -1
    DEF_PEAK_VAL = FLT_MAX

    def __init__(self, threshold: float, window_length: int) -> None:
        self.threshold = threshold
        self.window_length = window_length
        self.masked_to = 0
        self.peak_pos = self.DEF_PEAK_POS
        self.peak_value = self.DEF_PEAK_VAL
        self.valid_peak = False

    def reset_peak(self, current_value: float) -> None:
        self.peak_pos = self.DEF_PEAK_POS
        self.peak_value = current_value
        self.valid_peak = False


class StreamingEventDetector:
    """Faithful streaming port — the executable spec / parity oracle.

    reference: event_detection/event_detector.py:26-210
    """

    def __init__(
        self,
        window_length1: int = DEFAULT_WINDOW1,
        window_length2: int = DEFAULT_WINDOW2,
        threshold1: float = DEFAULT_THRESHOLD1,
        threshold2: float = DEFAULT_THRESHOLD2,
        peak_height: float = DEFAULT_PEAK_HEIGHT,
    ) -> None:
        self.w1 = window_length1
        self.w2 = window_length2
        self.threshold1 = threshold1
        self.threshold2 = threshold2
        self.peak_height = peak_height
        self.BUF_LEN = 1 + 2 * window_length2
        self.sum = np.zeros(self.BUF_LEN, dtype=np.float64)
        self.sumsq = np.zeros(self.BUF_LEN, dtype=np.float64)
        self.reset()

    def reset(self) -> None:
        self.sum[:] = 0.0
        self.sumsq[:] = 0.0
        self.t = 1
        self.evt_st = 0
        self.evt_st_sum = 0.0
        self.evt_st_sumsq = 0.0
        self.buf_mid = 0
        self.short = _PeakDetector(self.threshold1, self.w1)
        self.long = _PeakDetector(self.threshold2, self.w2)
        self._event: Event | None = None

    def run(self, raw: np.ndarray) -> List[Event]:
        events: List[Event] = []
        raw = np.asarray(raw)
        for i in range(raw.size):
            if self._add_sample(float(raw[i])):
                events.append(self._event)
        self.reset()
        return events

    def _add_sample(self, s: float) -> bool:
        t_mod = _u32(self.t % self.BUF_LEN)
        prev = t_mod - 1 if t_mod > 0 else self.BUF_LEN - 1
        self.sum[t_mod] = self.sum[prev] + s
        self.sumsq[t_mod] = self.sumsq[prev] + s * s

        self.t = _u32(self.t + 1)
        self.buf_mid = _u32(self.t - self.BUF_LEN // 2 - 1)
        tstat1 = self._compute_tstat(self.w1)
        tstat2 = self._compute_tstat(self.w2)

        p1 = self._detect_peak(tstat1, self.short)
        p2 = self._detect_peak(tstat2, self.long)

        if p1 or p2:
            return self._create_event(self.buf_mid - self.w1 + 1)
        return False

    def _compute_tstat(self, w: int) -> float:
        if self.t <= 2 * w or w < 2:
            return 0.0
        wf = float(w)
        i = _u32(self.buf_mid % self.BUF_LEN)
        st = _u32(self.buf_mid - w) % self.BUF_LEN
        en = _u32(self.buf_mid + w) % self.BUF_LEN
        sum1 = self.sum[i] - self.sum[st]
        sumsq1 = self.sumsq[i] - self.sumsq[st]
        sum2 = self.sum[en] - self.sum[i]
        sumsq2 = self.sumsq[en] - self.sumsq[i]
        mean1, mean2 = sum1 / wf, sum2 / wf
        combined_var = sumsq1 / wf - mean1 * mean1 + sumsq2 / wf - mean2 * mean2
        combined_var = max(combined_var, FLT_MIN)
        return math.fabs(mean2 - mean1) / math.sqrt(combined_var / wf)

    def _detect_peak(self, value: float, det: _PeakDetector) -> bool:
        if det.masked_to >= self.buf_mid:
            return False
        if det.peak_pos == det.DEF_PEAK_POS:
            if value < det.peak_value:
                det.peak_value = value
            elif value - det.peak_value > self.peak_height:
                det.peak_value = value
                det.peak_pos = _i32(self.buf_mid)
        else:
            if value > det.peak_value:
                det.peak_value = value
                det.peak_pos = _i32(self.buf_mid)
            if det.window_length == self.short.window_length:
                if det.peak_value > det.threshold:
                    self.long.masked_to = _u32(det.peak_pos + det.window_length)
                    self.long.peak_pos = self.long.DEF_PEAK_POS
                    self.long.peak_value = self.long.DEF_PEAK_VAL
                    self.long.valid_peak = False
            if det.peak_value - value > self.peak_height and det.peak_value > det.threshold:
                det.valid_peak = True
            if det.valid_peak and (self.buf_mid - det.peak_pos) > det.window_length / 2:
                det.reset_peak(value)
                return True
        return False

    def _create_event(self, evt_en: int) -> bool:
        evt_en = _u32(evt_en)
        evt_en_buf = _u32(evt_en % self.BUF_LEN)
        length = float(evt_en - self.evt_st)
        if length < FLT_MIN:
            return False
        mean = float(self.sum[evt_en_buf] - self.evt_st_sum) / length
        deltasqr = self.sumsq[evt_en_buf] - self.evt_st_sumsq
        stdv = math.sqrt(max(deltasqr / length - mean**2, FLT_MIN))
        self._event = Event(self.evt_st, int(length), mean, stdv)
        self.evt_st = evt_en
        self.evt_st_sum = self.sum[evt_en_buf]
        self.evt_st_sumsq = self.sumsq[evt_en_buf]
        return True


# ---------------------------------------------------------------------------
# Vectorized implementation
# ---------------------------------------------------------------------------


def _ring_read(S: np.ndarray, u: np.ndarray, i: np.ndarray, B: int) -> np.ndarray:
    """Value the streaming ring buffer would return for u32 index ``u`` while
    processing sample ``i``.

    ``S[j]`` = sum of the first ``j`` samples. The ring slot is ``u % B``; it
    holds ``S[t']`` for the largest write time ``t' <= i+1`` congruent to the
    slot mod B, or its zero initialization if never written
    (reference: event_detector.py:125-134, 35-36). For in-range reads this is
    just ``S[u]``; for u32-wrapped "negative" indices it aliases to another
    (earlier) cumsum — reproduced exactly.
    """
    u = np.asarray(u, dtype=np.int64) % (1 << 32)
    i = np.asarray(i, dtype=np.int64)
    q = i + 1
    slot = u % B
    t_prime = q - ((q - slot) % B)
    unwritten = t_prime < 0
    vals = S[np.clip(t_prime, 0, len(S) - 1)]
    return np.where(unwritten, 0.0, vals)


def compute_tstats(
    raw: np.ndarray, w: int, w2: int
) -> np.ndarray:
    """Per-sample Welch t-statistic for window ``w``, exactly as the streaming
    detector computes it at each step (including early-sample aliasing).

    Returns ``tstat[i]`` = the value ``_compute_tstat(w)`` yields while
    processing sample ``i`` (reference: event_detector.py:109-147). ``w2`` is
    the long window (defines BUF_LEN and the buf_mid offset).
    """
    raw = np.asarray(raw, dtype=np.float64)
    n = raw.size
    B = 1 + 2 * w2
    S = np.concatenate(([0.0], np.cumsum(raw)))
    Sq = np.concatenate(([0.0], np.cumsum(raw * raw)))

    i = np.arange(n, dtype=np.int64)
    m = i + 1 - w2  # signed buf_mid; u32 wrap handled by _ring_read

    s_mid = _ring_read(S, m, i, B)
    s_lo = _ring_read(S, m - w, i, B)
    s_hi = _ring_read(S, m + w, i, B)
    q_mid = _ring_read(Sq, m, i, B)
    q_lo = _ring_read(Sq, m - w, i, B)
    q_hi = _ring_read(Sq, m + w, i, B)

    wf = float(w)
    sum1 = s_mid - s_lo
    sumsq1 = q_mid - q_lo
    sum2 = s_hi - s_mid
    sumsq2 = q_hi - q_mid
    mean1 = sum1 / wf
    mean2 = sum2 / wf
    combined_var = sumsq1 / wf - mean1 * mean1 + sumsq2 / wf - mean2 * mean2
    combined_var = np.maximum(combined_var, FLT_MIN)
    tstat = np.abs(mean2 - mean1) / np.sqrt(combined_var / wf)

    # Quick return: t-test undefined for t <= 2w (t = i+2) or w < 2.
    if w < 2:
        return np.zeros(n)
    live = (i + 2) > 2 * w
    return np.where(live, tstat, 0.0)


def _peak_scan(
    tstat1: np.ndarray,
    tstat2: np.ndarray,
    w1: int,
    w2: int,
    threshold1: float,
    threshold2: float,
    peak_height: float,
) -> List[Tuple[int, int]]:
    """Sequential dual-detector peak scan; returns ``(sample_index, end)``
    pairs where ``end = buf_mid - w1 + 1`` in u32 stream coordinates, in
    firing order. One event per sample even if both detectors fire
    (reference: event_detector.py:99-104)."""
    n = len(tstat1)
    # short detector state (masked_to is always 0 for the short detector, but
    # the `masked_to >= buf_mid` guard still skips it when buf_mid == 0).
    s_pos, s_val, s_valid = -1, FLT_MAX, False
    # long detector state
    l_pos, l_val, l_valid, l_masked = -1, FLT_MAX, False, 0
    ends: List[Tuple[int, int]] = []
    for i in range(n):
        bm = _u32(i + 1 - w2)
        fired = False
        # --- short detector (reference: event_detector.py:149-187) ---
        if bm != 0:
            v = tstat1[i]
            if s_pos == -1:
                if v < s_val:
                    s_val = v
                elif v - s_val > peak_height:
                    s_val = v
                    s_pos = _i32(bm)
            else:
                if v > s_val:
                    s_val = v
                    s_pos = _i32(bm)
                if s_val > threshold1:
                    l_masked = _u32(s_pos + w1)
                    l_pos, l_val, l_valid = -1, FLT_MAX, False
                if s_val - v > peak_height and s_val > threshold1:
                    s_valid = True
                if s_valid and (bm - s_pos) > w1 / 2:
                    s_pos, s_val, s_valid = -1, v, False
                    fired = True
        # --- long detector ---
        if not (l_masked >= bm):
            v = tstat2[i]
            if l_pos == -1:
                if v < l_val:
                    l_val = v
                elif v - l_val > peak_height:
                    l_val = v
                    l_pos = _i32(bm)
            else:
                if v > l_val:
                    l_val = v
                    l_pos = _i32(bm)
                if l_val - v > peak_height and l_val > threshold2:
                    l_valid = True
                if l_valid and (bm - l_pos) > w2 / 2:
                    l_pos, l_val, l_valid = -1, v, False
                    fired = True
        if fired:
            ends.append((i, _u32(bm - w1 + 1)))
    return ends


def detect_events(
    raw: np.ndarray,
    window_length1: int = DEFAULT_WINDOW1,
    window_length2: int = DEFAULT_WINDOW2,
    threshold1: float = DEFAULT_THRESHOLD1,
    threshold2: float = DEFAULT_THRESHOLD2,
    peak_height: float = DEFAULT_PEAK_HEIGHT,
    use_native: bool = True,
) -> np.ndarray:
    """Fast host event detection: vectorized t-stats + one peak scan.

    Returns an ``[n_events, 4]`` float array of ``(start, length, mean, stdv)``
    bit-identical to ``StreamingEventDetector.run`` (which returns Event
    objects). Coordinates are stream coordinates (sample index + 1), matching
    the reference's off-by-one (see module docstring).

    Uses the native C++ scan (ravvent_tpu_torch.ops.native) when available
    (~100x faster than the Python peak loop); parity between all three
    implementations is enforced by tests.
    """
    if use_native:
        try:
            from ravvent_tpu_torch.ops import native

            if native.available():
                out = native.detect_events(
                    np.asarray(raw, dtype=np.float64),
                    window_length1, window_length2,
                    threshold1, threshold2, peak_height,
                )
                if out is not None:
                    return out
        except Exception:
            pass
    raw = np.asarray(raw, dtype=np.float64)
    tstat1 = compute_tstats(raw, window_length1, window_length2)
    tstat2 = compute_tstats(raw, window_length2, window_length2)
    ends = _peak_scan(
        tstat1,
        tstat2,
        window_length1,
        window_length2,
        threshold1,
        threshold2,
        peak_height,
    )
    if not ends:
        return np.zeros((0, 4))

    B = 1 + 2 * window_length2
    S = np.concatenate(([0.0], np.cumsum(raw)))
    Sq = np.concatenate(([0.0], np.cumsum(raw * raw)))

    events = []
    evt_st, st_sum, st_sumsq = 0, 0.0, 0.0
    for i, en in ends:
        # reference: event_detector.py:189-210 (_create_event). Indices are
        # u32; for well-formed window configs en is the clean cumsum index,
        # for degenerate ones the ring read aliases (handled by _ring_read).
        length = float(en - evt_st)
        if length < FLT_MIN:
            continue
        e_sum = float(_ring_read(S, np.int64(en), np.int64(i), B))
        e_sumsq = float(_ring_read(Sq, np.int64(en), np.int64(i), B))
        mean = (e_sum - st_sum) / length
        deltasqr = e_sumsq - st_sumsq
        stdv = math.sqrt(max(deltasqr / length - mean**2, FLT_MIN))
        events.append((evt_st, int(length), mean, stdv))
        evt_st, st_sum, st_sumsq = en, e_sum, e_sumsq
    return np.array(events, dtype=np.float64)


def events_to_objects(arr: np.ndarray) -> List[Event]:
    return [Event(int(s), int(l), float(m), float(sd)) for s, l, m, sd in arr]
