"""Pairwise sequence alignment.

From-scratch replacement for the Biopython ``pairwise2`` C extension the
reference merger depends on (reference: merger.py:167-180). Two entry points:

- :func:`local_align` — Smith-Waterman-Gotoh local alignment with affine gaps
  using pairwise2 conventions: a gap of length L costs
  ``open + (L-1) * extend``; the result contains the *full* input sequences
  with gap padding (unaligned flanks of seq1 laid out before those of seq2),
  so downstream position-wise merging keeps every input character — the
  property the reference's overlap splice relies on
  (merger.py:204-244).
- :func:`banded_global_identity` — banded Needleman-Wunsch used as the
  built-in fallback for minimap2-style mapping identity when minimap2 is not
  installed (see ravvent_tpu.evaluation.mapping in the JAX package). Prefers the native C++
  implementation (ravvent_tpu_torch.ops.native) and falls back to numpy.

Substitution-matrix scoring (reference merger score set 2,
merger.py:138-146) is supported via ``matrix=``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

NEG = -1e30


class AlignmentResult(NamedTuple):
    seq1_gapped: str
    seq2_gapped: str
    score: float
    begin: int
    end: int


def _score_matrix_fn(seq1, seq2, match, mismatch, matrix):
    a = np.frombuffer(seq1.encode(), dtype=np.uint8)
    b = np.frombuffer(seq2.encode(), dtype=np.uint8)
    if matrix is None:
        return np.where(a[:, None] == b[None, :], match, mismatch).astype(np.float64)
    S = np.zeros((len(a), len(b)))
    for i, ca in enumerate(seq1):
        for j, cb in enumerate(seq2):
            S[i, j] = matrix[(ca, cb)]
    return S


def local_align(
    seq1: str,
    seq2: str,
    match: float = 1.0,
    mismatch: float = -1.0,
    gap_open: float = -1.0,
    gap_extend: float = -0.2,
    matrix: Optional[Dict[Tuple[str, str], float]] = None,
    expected_offset: Optional[float] = None,
    offset_weight: float = 0.0,
) -> Optional[AlignmentResult]:
    """Best local alignment, or None if no positive-scoring alignment exists
    (the reference treats an empty alignment list as "no alignment",
    merger.py:181-197).

    With ``offset_weight > 0`` and an ``expected_offset``, restarting a local
    alignment on diagonal ``d = i - j`` costs ``offset_weight *
    |d - expected_offset|`` instead of 0 — a positional prior that biases the
    alignment toward a geometrically known shift. On (near-)periodic
    sequence the unconstrained maximum-score alignment is systematically a
    period-shifted one (it aligns MORE columns than the true overlap), which
    makes overlap merging delete one period per junction; the prior makes
    the expected shift win unless the data strongly contradicts it.
    ``offset_weight=0`` is exact plain Smith-Waterman."""
    n, m = len(seq1), len(seq2)
    if n == 0 or m == 0:
        return None
    S = _score_matrix_fn(seq1, seq2, match, mismatch, matrix)

    use_prior = offset_weight > 0.0 and expected_offset is not None

    def restart(i, j):
        if not use_prior:
            return 0.0
        return -offset_weight * abs(float(i - j) - expected_offset)

    H = np.zeros((n + 1, m + 1))
    E = np.full((n + 1, m + 1), NEG)  # gap in seq1 (moving along seq2)
    F = np.full((n + 1, m + 1), NEG)  # gap in seq2 (moving along seq1)
    if use_prior:
        H[0, :] = [restart(0, j) for j in range(m + 1)]
        H[1:, 0] = [restart(i, 0) for i in range(1, n + 1)]
    # traceback: 0 stop, 1 diag, 2 up (gap in seq2), 3 left (gap in seq1)
    TB = np.zeros((n + 1, m + 1), dtype=np.int8)
    TE = np.zeros((n + 1, m + 1), dtype=np.int8)  # E came from H (0) or E (1)
    TF = np.zeros((n + 1, m + 1), dtype=np.int8)

    for i in range(1, n + 1):
        # E: horizontal (consume seq2 char, gap in seq1)
        e_open = H[i, :-1] + gap_open
        e_ext = E[i, :-1] + gap_extend
        # E needs a row-wise scan; do it with a loop over columns fused below.
        hf_prev_row = H[i - 1]
        f_open = hf_prev_row + gap_open
        f_ext = F[i - 1] + gap_extend
        F[i] = np.maximum(f_open, f_ext)
        TF[i] = (f_ext > f_open).astype(np.int8)
        e = NEG
        row_h = H[i]
        row_e = E[i]
        diag = H[i - 1, :-1] + S[i - 1]
        for j in range(1, m + 1):
            e_o = H[i, j - 1] + gap_open
            e_x = e + gap_extend
            if e_x > e_o:
                e = e_x
                TE[i, j] = 1
            else:
                e = e_o
                TE[i, j] = 0
            row_e[j] = e
            best = restart(i, j)
            tb = 0
            d = diag[j - 1]
            if d > best:
                best, tb = d, 1
            if F[i, j] > best:
                best, tb = F[i, j], 2
            if e > best:
                best, tb = e, 3
            row_h[j] = best
            TB[i, j] = tb

    # best cell
    flat = np.argmax(H)
    bi, bj = divmod(flat, m + 1)
    if H[bi, bj] <= 0:
        return None
    score = float(H[bi, bj])

    # traceback (preferring the recorded move)
    i, j = int(bi), int(bj)
    core1, core2 = [], []
    state = "H"
    while i > 0 or j > 0:
        if state == "H":
            tb = TB[i, j]
            if tb == 0:
                break
            if tb == 1:
                core1.append(seq1[i - 1])
                core2.append(seq2[j - 1])
                i -= 1
                j -= 1
            elif tb == 2:
                state = "F"
            else:
                state = "E"
        elif state == "F":
            core1.append(seq1[i - 1])
            core2.append("-")
            came_ext = TF[i, j]
            i -= 1
            state = "F" if came_ext else "H"
        else:  # E
            core1.append("-")
            core2.append(seq2[j - 1])
            came_ext = TE[i, j]
            j -= 1
            state = "E" if came_ext else "H"

    start1, start2 = i, j
    core1.reverse()
    core2.reverse()

    # pairwise2-style full-length layout: left flanks (seq1's then seq2's),
    # aligned core, right flanks (seq1's then seq2's).
    left1, left2 = seq1[:start1], seq2[:start2]
    right1, right2 = seq1[bi:], seq2[bj:]
    a1 = left1 + "-" * len(left2) + "".join(core1) + right1 + "-" * len(right2)
    a2 = "-" * len(left1) + left2 + "".join(core2) + "-" * len(right1) + right2
    begin = len(left1) + len(left2)
    end = begin + len(core1)
    return AlignmentResult(a1, a2, score, begin, end)


def sw_local_identity(
    query: str,
    ref: str,
    match: float = 1.0,
    mismatch: float = -1.0,
    gap_open: float = -2.0,
    gap_extend: float = -0.5,
    use_native: bool = True,
) -> Optional[Tuple[int, int, int, int, int, int, float]]:
    """Exact (full, unbanded) Smith-Waterman-Gotoh local identity: returns
    (matches, block_len, q_start, q_end, t_start, t_end, score) of the best
    local alignment, or None when no positive-scoring alignment exists.

    This is the exact-DP referee the seed-chain mapper is validated against
    (and its rescue stage below the seed cliff): the full DP has no seeds,
    no chaining heuristics and no band, so its (matches, block_len) is the
    ground-truth local identity for the score set. Columns outside the
    local block are soft-clipped, matching minimap2 map-ont accounting
    (reference metric semantics: ravvent_mapping_evaluator.py:85-108).

    Uses the native SW kernel (ravvent_tpu_torch.ops.native.local_align — O(n*m)
    time/traceback memory, ~1e9 cells/s) when available, else the pure-
    python aligner (small inputs only; native<->python parity is enforced by
    tests/test_merger.py's aligner parity suite)."""
    n, m = len(query), len(ref)
    if n == 0 or m == 0:
        return None
    res = None
    if use_native:
        try:
            from ravvent_tpu_torch.ops import native

            if native.available():
                res = native.local_align(
                    query, ref, match, mismatch, gap_open, gap_extend)
                if res is None:
                    return None
        except Exception:
            res = None
    if res is None:
        res = local_align(query, ref, match, mismatch, gap_open, gap_extend)
        if res is None:
            return None
    core1 = res.seq1_gapped[res.begin:res.end]
    core2 = res.seq2_gapped[res.begin:res.end]
    matches = sum(a == b for a, b in zip(core1, core2))
    cols = res.end - res.begin
    q_start = len(res.seq1_gapped[:res.begin].replace("-", ""))
    t_start = len(res.seq2_gapped[:res.begin].replace("-", ""))
    q_end = q_start + len(core1.replace("-", ""))
    t_end = t_start + len(core2.replace("-", ""))
    return matches, cols, q_start, q_end, t_start, t_end, float(res.score)


def banded_global_identity(
    query: str,
    ref: str,
    match: float = 1.0,
    mismatch: float = -1.0,
    gap_open: float = -2.0,
    gap_extend: float = -0.5,
    band: Optional[int] = None,
) -> Tuple[int, int, float]:
    """Banded global alignment of ``query`` vs ``ref``; returns
    (matches, block_len, score) where block_len counts alignment columns —
    the minimap2 PAF (matches, block length) analogue used for identity.

    Tries the native C++ kernel first (ravvent_tpu_torch.ops.native); falls back to
    a numpy implementation.
    """
    try:
        from ravvent_tpu_torch.ops import native

        if native.available():
            return native.banded_global_identity(
                query, ref, match, mismatch, gap_open, gap_extend, band
            )
    except Exception:
        pass
    return _banded_global_identity_np(query, ref, match, mismatch, gap_open, gap_extend, band)


def _banded_global_identity_np(query, ref, match, mismatch, gap_open, gap_extend, band):
    """Numpy mirror of the native banded Gotoh kernel
    (native/ravvent_native.cpp rv_banded_global / banded_global_core):
    identical full-affine E/F recurrences, tie-breaking, band re-centering
    (floor division) and traceback counting — parity is enforced by tests, so
    identity numbers no longer depend on whether g++ was available.

    The within-row E (left-gap) recurrence is sequential; it is vectorized
    with the closed form E[k] = (k-1)*ext + max_{k'<k}(M[k'] + open - k'*ext)
    where M = max(diag, up) — valid because gap_open <= gap_extend (in
    penalty terms) makes H's E-component never feed a cheaper re-open. All
    default scores are binary fractions, so the closed form is bit-exact
    against the native kernel's sequential adds.
    """
    n, m = len(query), len(ref)
    if n == 0 or m == 0:
        return 0, max(n, m), 0.0
    if band is None or band <= 0:
        band = max(128, abs(n - m) + 128)
    if gap_open > gap_extend:
        raise ValueError("banded_global requires gap_open <= gap_extend "
                         "(penalties; affine closed form)")
    q = np.frombuffer(query.encode(), dtype=np.uint8)
    r = np.frombuffer(ref.encode(), dtype=np.uint8)

    W = 2 * band + 1
    ks = np.arange(W)

    def center(i):  # native: (i * m) / n with integer division
        return (i * m) // n

    H = np.full(W, NEG)
    F = np.full(W, NEG)
    # packed traceback, one byte/cell: bits 0-1 move (0 diag, 1 up, 2 left,
    # 3 none), bit 2 E-extend, bit 3 F-extend
    TB = np.full((n + 1, W), 3, dtype=np.uint8)

    c0 = center(0)
    js0 = c0 - band + ks
    at0 = (js0 == 0)
    pos = (js0 > 0) & (js0 <= m)
    H[at0] = 0.0
    H[pos] = gap_open + (js0[pos] - 1) * gap_extend
    TB[0, pos] = 2

    def shifted(prev, off):
        idx = ks + off
        ok = (idx >= 0) & (idx < W)
        out = np.full(W, NEG)
        out[ok] = prev[idx[ok]]
        return out

    for i in range(1, n + 1):
        shift = center(i) - center(i - 1)
        js = center(i) - band + ks
        valid = (js >= 0) & (js <= m)
        h_up = shifted(H, shift)
        f_up = shifted(F, shift)
        h_dg = shifted(H, shift - 1)

        f_open = h_up + gap_open
        f_ext = f_up + gap_extend
        f_bit = f_ext > f_open
        Fn = np.where(f_bit, f_ext, f_open)

        is_match = np.zeros(W, dtype=bool)
        okj = (js >= 1) & (js <= m)
        is_match[okj] = r[js[okj] - 1] == q[i - 1]
        d = np.where(okj & (h_dg > NEG / 2),
                     h_dg + np.where(is_match, match, mismatch), NEG)

        # non-E candidate per cell, NEG on invalid cells so the closed-form
        # E never opens from outside the band
        M = np.where(valid, np.maximum(d, Fn), NEG)

        # closed-form E (see docstring); E[0] has no left neighbor
        E = np.full(W, NEG)
        if W > 1:
            run = np.maximum.accumulate(M[:-1] + gap_open - ks[:-1] * gap_extend)
            E[1:] = run + (ks[1:] - 1) * gap_extend
            E[1:] = np.where(run <= NEG / 2, NEG, E[1:])
        e_bit = np.zeros(W, dtype=bool)
        if W > 1:
            # native: e_ext = e_prev + ext vs e_open = H[k-1] + open (H of
            # this row = max(M, E)); recomputed from final values
            Hrow_prev = np.maximum(M[:-1], E[:-1])
            e_bit[1:] = (E[:-1] + gap_extend) > (Hrow_prev + gap_open)

        Hn = np.where(valid, np.maximum(M, E), NEG)
        mv = np.zeros(W, dtype=np.uint8)
        mv = np.where(Fn > d, 1, mv)
        mv = np.where(E > np.maximum(d, Fn), 2, mv)
        row = np.where(
            valid,
            (mv | (e_bit.astype(np.uint8) << 2) | (f_bit.astype(np.uint8) << 3)
             ).astype(np.uint8),
            np.uint8(3),
        )
        TB[i] = row
        H, F = Hn, Fn

    kf = m - center(n) + band
    if not (0 <= kf < W) or H[kf] < NEG / 2:
        return 0, 0, 0.0
    score = float(H[kf])

    # traceback (mirrors native/ravvent_native.cpp banded_global_core)
    i, k = n, int(kf)
    matches = 0
    cols = 0
    state = 0  # 0 H, 1 F(up), 2 E(left)
    while i > 0 or (center(i) - band + k) > 0:
        j = center(i) - band + k
        if j < 0:
            return 0, 0, 0.0
        if i == 0:
            cols += j
            break
        if j == 0:
            cols += i
            break
        tb = int(TB[i, k])
        mv = (tb & 3) if state == 0 else (1 if state == 1 else 2)
        if mv == 0:
            if q[i - 1] == r[j - 1]:
                matches += 1
            cols += 1
            k = k + (center(i) - center(i - 1)) - 1
            i -= 1
            state = 0
        elif mv == 1:
            cols += 1
            ext = (tb >> 3) & 1
            k = k + (center(i) - center(i - 1))
            i -= 1
            state = 1 if ext else 0
        elif mv == 2:
            cols += 1
            ext = (tb >> 2) & 1
            k -= 1
            state = 2 if ext else 0
        else:
            return 0, 0, 0.0
        if k < 0 or k >= W:
            return 0, 0, 0.0
    return int(matches), int(cols), score
