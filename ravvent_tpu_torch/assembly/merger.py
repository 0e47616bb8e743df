"""Overlap merging of per-snippet basecalls into full reads.

Behavior-equivalent rebuild of the reference merger (reference: merger.py):
consecutive snippet predictions are folded together by locally aligning the
last/first ``overlap_seq_len`` (25) bases of the accumulated/next sequence,
gap-aligning their per-base scores, resolving each overlap column by the
higher score (gaps filled from the other sequence), and splicing the merged
overlap between prefix and suffix (merger.py:155-248). The no-alignment
keep/reset fallback is preserved (merger.py:181-197).

The alignment itself uses the native C++ kernel when available (exact
pairwise2 ``localms``/``localds`` conventions; see
ravvent_tpu_torch/assembly/alignment.py), falling back to the Python implementation.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from ravvent_tpu_torch.assembly import alignment

logger = logging.getLogger("ravvent_tpu_torch.merger")


class SeqLogitsPair:
    """A sequence with one score per base (reference: merger.py:7-37)."""

    @classmethod
    def align_logits(cls, seq_gapped: str, logits_non_gapped: List[float]) -> List[float]:
        logits_gapped: List[float] = []
        index = 0
        for c in seq_gapped:
            if c == "-":
                logits_gapped.append(-1.0)
            else:
                logits_gapped.append(logits_non_gapped[index])
                index += 1
        return logits_gapped

    def __init__(self, seq: str, logits) -> None:
        assert len(seq) == len(logits)
        self._seq = seq
        # Keep numpy score arrays as-is and convert lazily: the evaluators
        # only read .seq from the merged pair, and the list conversion of a
        # ~60k-score read costs ~3ms.
        self._logits = None if isinstance(logits, np.ndarray) else list(logits)
        self._logits_arr = logits if isinstance(logits, np.ndarray) else None

    @property
    def seq(self) -> str:
        return self._seq

    @property
    def logits(self) -> List[float]:
        if self._logits is None:
            self._logits = self._logits_arr.tolist()
        return self._logits


def expected_overlaps_from_ranges(
    raw_ranges: np.ndarray, seq_lens: np.ndarray
) -> np.ndarray:
    """Geometric estimate of the overlapping BASES between consecutive
    snippets, from their raw-sample spans and predicted sequence lengths.

    Snippet windows are cut from the same read with a fixed event stride
    (reference: data_loader.py:29-51), so consecutive raw spans overlap by a
    known number of samples; dividing by the snippet's own samples-per-base
    rate converts that to bases. Snippets with empty predictions fall back
    to the read-average rate. Returns [n-1] floats (>= 0)."""
    rr = np.asarray(raw_ranges, dtype=np.float64)
    lens = np.asarray(seq_lens, dtype=np.float64)
    spans = np.maximum(rr[:, 1] - rr[:, 0], 1.0)
    tot_len = lens.sum()
    spb_global = spans.sum() / tot_len if tot_len > 0 else 9.0
    spb = np.where(lens > 0, spans / np.maximum(lens, 1.0), spb_global)
    ov_samples = np.maximum(rr[:-1, 1] - rr[1:, 0], 0.0)
    return ov_samples / spb[1:]


def snippet_confidences(flat_probs: np.ndarray, offsets: np.ndarray
                        ) -> np.ndarray:
    """Per-snippet decode confidence: mean log step-probability of the
    emitted bases (flat layout: ``flat_probs`` concatenates the per-base
    step probabilities row by row; ``offsets`` delimits rows, as produced
    by ``NucTokenizer.sequences_to_texts_flat``).

    A catastrophically derailed decode (greedy commits a wrong token in
    the first few steps and free-runs an unrelated sequence) is reliably
    low-confidence: measured AUC ~0.95 for detecting id<0.7 snippets at
    beam 1 (tools/diag_conf_vs_id.py, matrix (3,1) raw cell). Empty
    snippets get confidence 0.0 (they contribute nothing to the fold)."""
    flat = np.asarray(flat_probs, dtype=np.float64)
    off = np.asarray(offsets, dtype=np.int64)
    counts = np.diff(off)
    lp = np.log(np.clip(flat, 1e-9, 1.0))
    csum = np.concatenate([[0.0], np.cumsum(lp)])
    sums = csum[off[1:]] - csum[off[:-1]]
    return sums / np.maximum(counts, 1)


# (rel_gap, abs_floor, max_drop_frac) for confidence_keep_mask — chosen on
# the (3,1)/(1,1) raw and (2,1) joint matrix cells and no-harm-checked on
# the saturated ref45 and harsh 4096 regimes (results/CONF_GATE.md)
CONF_GATE_DEFAULT = (0.12, -0.15, 0.12)


def confidence_keep_mask(
    flat_probs: np.ndarray,
    offsets: np.ndarray,
    rel_gap: float = CONF_GATE_DEFAULT[0],
    abs_floor: float = CONF_GATE_DEFAULT[1],
    max_drop_frac: float = CONF_GATE_DEFAULT[2],
    max_consecutive: int | None = None,
) -> np.ndarray:
    """[N] bool keep-mask over snippets: False marks a snippet the merge
    fold should drop as a derailed decode.

    A snippet is dropped only when its confidence (``snippet_confidences``,
    mean log step-prob per emitted base) is BOTH (a) more than ``rel_gap``
    nats below the read's median — a fixed margin, NOT a MAD multiple: in a
    uniformly low-quality regime (4096 vocab) the read's spread is tiny and
    a scale-free outlier rule would fire on ordinary fluctuation, while a
    derailed decode sits a near-constant ~0.15-0.6 nats/base below its
    read's median at every quality level — and (b) below the absolute
    floor ``abs_floor`` (-0.15 ~= mean step-prob 0.86), which keeps the
    gate quiet on saturated reads where the whole distribution is high.
    At most ``max_drop_frac`` of the read's snippets are dropped (the
    lowest-confidence candidates first, never on reads of <4 snippets).

    Rationale: the residual beam-1 deficit after the round-5 fold is
    catastrophic early-commit derailments — greedy takes a wrong token in
    the first ~3 steps and free-runs an unrelated sequence (id ~0.3-0.6)
    that beam-5 decodes near-perfectly. Confidence detects them at AUC
    ~0.95 (tools/diag_conf_vs_id.py), and the ~80% snippet-window overlap
    (30-event windows, stride 6) means neighbors cover a dropped span —
    the junction geometry is recomputed from the surviving raw spans."""
    conf = snippet_confidences(flat_probs, offsets)
    n = conf.shape[0]
    if n < 4:
        return np.ones(n, bool)
    med = float(np.median(conf))
    bad = (conf < med - rel_gap) & (conf < abs_floor)
    cap = max(1, int(max_drop_frac * n))
    if bad.sum() > cap:
        # keep only the `cap` lowest-confidence candidates dropped
        cand = np.where(bad)[0]
        worst = cand[np.argsort(conf[cand])][:cap]
        bad = np.zeros(n, bool)
        bad[worst] = True
    if max_consecutive is not None:
        # coverage constraint in its native form: a run of k consecutive
        # dropped snippets leaves windows i-1 and i+k overlapping
        # 30 - 6*(k+1) events, so runs of <= max_consecutive keep the
        # junction geometrically bridgeable; longer runs keep their
        # highest-confidence members back until the run is short enough
        i = 0
        while i < n:
            if not bad[i]:
                i += 1
                continue
            j = i
            while j < n and bad[j]:
                j += 1
            run = np.arange(i, j)
            if len(run) > max_consecutive:
                # keep back every (max_consecutive+1)-th member (run
                # indices mc, 2mc+1, ...): splits the run into sub-runs of
                # exactly <= max_consecutive with kept separators
                sep = run[np.arange(len(run)) % (max_consecutive + 1)
                          == max_consecutive]
                bad[sep] = False
            i = j
    return ~bad


def drop_snippet_rows(
    blob: bytes, offsets: np.ndarray, flat_probs: np.ndarray,
    keep: np.ndarray,
):
    """Filter the flat (blob, offsets, flat_probs) snippet layout down to
    the kept rows. Returns (blob, offsets, flat_probs) unchanged (same
    objects) when every row is kept."""
    if keep.all():
        return blob, offsets, flat_probs
    off = np.asarray(offsets, dtype=np.int64)
    starts, ends = off[:-1], off[1:]
    idx = np.where(keep)[0]
    new_blob = b"".join(blob[starts[i]:ends[i]] for i in idx)
    lens = (ends - starts)[idx]
    new_off = np.zeros(len(idx) + 1, dtype=off.dtype)
    np.cumsum(lens, out=new_off[1:])
    flat = np.asarray(flat_probs)
    new_flat = (np.concatenate([flat[starts[i]:ends[i]] for i in idx])
                if idx.size else flat[:0])
    return new_blob, new_off, new_flat


class SingleMergerByLogits:
    """Column-wise overlap resolution: higher score wins; gaps are filled
    from the other sequence (reference: merger.py:83-119)."""

    def merge(self, p1: SeqLogitsPair, p2: SeqLogitsPair) -> SeqLogitsPair:
        seq1, seq2, l1, l2 = p1.seq, p2.seq, p1.logits, p2.logits
        assert len(seq1) == len(seq2)
        seq_out: List[str] = []
        log_out: List[float] = []
        for n1, n2, a, b in zip(seq1, seq2, l1, l2):
            if n1 == "-":
                seq_out.append(n2)
                log_out.append(b)
            elif n2 == "-":
                seq_out.append(n1)
                log_out.append(a)
            elif b > a:
                seq_out.append(n2)
                log_out.append(b)
            else:
                seq_out.append(n1)
                log_out.append(a)
        return SeqLogitsPair("".join(seq_out), log_out)


class MergerLeftPriority:
    """Alternative resolver: keep seq1 up to its last base, then seq2
    (reference: merger.py:39-81; unused by default)."""

    def merge(self, p1: SeqLogitsPair, p2: SeqLogitsPair) -> SeqLogitsPair:
        seq1, seq2 = p1.seq, p2.seq
        assert len(seq1) == len(seq2)
        end_index = max(i for i, c in enumerate(seq1) if c != "-")
        seq_g = seq1[: end_index + 1] + seq2[end_index + 1 :]
        log_g = p1.logits[: end_index + 1] + p2.logits[end_index + 1 :]
        seq = seq_g.replace("-", "")
        logits = [s for s in log_g if s > 0]
        return SeqLogitsPair(seq, logits)


SCORE_SETS = {
    0: {"match": 1.0, "mismatch": -1.0, "gap_open": -1.0, "gap_extend": -0.2},
    1: {"match": 5.0, "mismatch": -4.0, "gap_open": -3.0, "gap_extend": -0.1},
    2: {
        "matrix": {
            ("A", "A"): 10.0, ("A", "C"): -3.0, ("A", "G"): -1.0, ("A", "T"): -4.0,
            ("C", "A"): -3.0, ("C", "C"): 9.0, ("C", "G"): -5.0, ("C", "T"): 0.0,
            ("G", "A"): -1.0, ("G", "C"): -5.0, ("G", "G"): 7.0, ("G", "T"): -3.0,
            ("T", "A"): -4.0, ("T", "C"): 0.0, ("T", "G"): -3.0, ("T", "T"): 8.0,
        },
        "gap_open": -9.0,
        "gap_extend": -2.0,
    },
}


def _submat_array(matrix) -> np.ndarray:
    order = "ACGT"
    out = np.zeros((4, 4))
    for i, a in enumerate(order):
        for j, b in enumerate(order):
            out[i, j] = matrix[(a, b)]
    return out


class Merger:
    """``offset_prior_weight`` (with per-pair ``expected_overlaps``) enables a
    positional prior on the overlap alignments: on (near-)periodic sequence
    the unconstrained best local alignment is systematically a period-shifted
    one (it aligns more columns than the true ~stride-determined overlap), so
    each junction silently deletes one period of bases — the 45-6-mer-set
    failure (identity 54.6 at 0.988 token accuracy). The weight must exceed
    the per-base match score so a Δ-base shift (gaining ≤Δ matches on
    periodic sequence) always loses Δ·(weight−match) > 0."""

    DEFAULT_GEOM_ARBITRATION = 4.0
    # length-constrained splice slack (columns tolerated beyond the
    # geometric junction length before gap-column trimming) — see merge()
    TRIM_SLACK = 1

    def __init__(self, scores_id: int = 0, use_native: bool = True,
                 offset_prior_weight: float = 1.5,
                 geom_arbitration: Optional[float] = DEFAULT_GEOM_ARBITRATION
                 ) -> None:
        self.scores_id = scores_id
        self.overlap_seq_len = 25
        self._merger = SingleMergerByLogits()
        self.use_native = use_native
        self.offset_prior_weight = offset_prior_weight
        # geom_arbitration (ON by default since round 5; pass None for
        # bit-parity with the reference fold, reference merger.py:155-248):
        # accept a junction alignment only when its implied overlap length
        # is within this many bases of the geometric expectation AND it
        # consumes ~the expected shared bases; otherwise splice
        # geometrically at round(expected_overlap). Low-accuracy snippets
        # (e.g. beam-1 at the 4096 vocab) produce successful-but-wrong tiny
        # alignments that inflate the merged read ~2x; arbitration bounds
        # the damage at snippet quality instead of zero. Flipped to default
        # after the round-4 study measured improvement in all 15 depth x
        # modality cells, mean +4.07 points, with the saturated ref45 row
        # unharmed (results/ARBITRATION.md). The soft positional prior
        # remains the primary mechanism — this is a hard gate for the
        # regime where even the prior-scored alignment is noise. Requires
        # expected_overlaps (snippet raw-span geometry); without them the
        # fold is identical to the reference fold regardless of this value.
        self.geom_arbitration = geom_arbitration

    def _align(self, s1: str, s2: str, expected_overlap: Optional[float] = None
               ) -> Optional[alignment.AlignmentResult]:
        sc = SCORE_SETS[self.scores_id]
        exp_off, w = None, 0.0
        if expected_overlap is not None and self.offset_prior_weight > 0:
            exp_off = len(s1) - min(float(expected_overlap), float(len(s1)))
            w = self.offset_prior_weight
        if "matrix" in sc:
            if self.use_native:
                try:
                    from ravvent_tpu_torch.ops import native

                    if native.available():
                        return native.local_align(
                            s1, s2, 0.0, 0.0, sc["gap_open"], sc["gap_extend"],
                            submat=_submat_array(sc["matrix"]),
                            expected_offset=exp_off, offset_weight=w,
                        )
                except Exception:
                    pass
            return alignment.local_align(
                s1, s2, gap_open=sc["gap_open"], gap_extend=sc["gap_extend"],
                matrix=sc["matrix"],
                expected_offset=exp_off, offset_weight=w,
            )
        if self.use_native:
            try:
                from ravvent_tpu_torch.ops import native

                if native.available():
                    return native.local_align(
                        s1, s2, sc["match"], sc["mismatch"], sc["gap_open"], sc["gap_extend"],
                        expected_offset=exp_off, offset_weight=w,
                    )
            except Exception:
                pass
        return alignment.local_align(
            s1, s2, sc["match"], sc["mismatch"], sc["gap_open"], sc["gap_extend"],
            expected_offset=exp_off, offset_weight=w,
        )

    def select_beams_by_overlap(
        self,
        beam_seqs: List[List[str]],
        beam_logprob: np.ndarray,  # [N, K] total model log-prob per beam
        expected_overlaps=None,
        model_weight: float = 0.05,
    ) -> np.ndarray:
        """Phase-aware beam selection for periodic genomes: Viterbi over
        (snippet, beam) where the transition score is the overlap-alignment
        score between the previous beam's tail and the next beam's head
        (same score set + positional prior as the merge fold itself).

        Motivation (round-3 residual on the 45-6-mer set): each snippet's
        free-running beam decode can lock onto the WRONG PHASE of a periodic
        sequence — per-snippet token accuracy stays ~0.99 but the merged
        read silently gains/loses periods at junctions, and no alignment
        prior can repair a junction whose two sides genuinely disagree. The
        correctly-phased variant is almost always among the top few beams;
        choosing the chain of beams that maximizes junction agreement
        (agreement scored exactly like the merge alignment, model log-prob
        as a weak tie-break so unambiguous genomes keep the top beam)
        re-anchors each snippet's phase on its predecessor. Returns the
        [N] chosen beam index per snippet.
        """
        N = len(beam_seqs)
        if N == 0:
            return np.zeros(0, int)
        K = len(beam_seqs[0])
        L = self.overlap_seq_len
        ptr = np.zeros((N, K), int)
        prev = model_weight * np.asarray(beam_logprob[0], float)
        for i in range(1, N):
            eo = (float(expected_overlaps[i - 1])
                  if expected_overlaps is not None else None)
            agree = np.zeros((K, K))
            for b in range(K):
                tail = beam_seqs[i - 1][b][-L:]
                if not tail:
                    continue
                for b2 in range(K):
                    head = beam_seqs[i][b2][:L]
                    if not head:
                        continue
                    res = self._align(tail, head, eo)
                    agree[b, b2] = res.score if res is not None else 0.0
            tot = prev[:, None] + agree
            ptr[i] = np.argmax(tot, axis=0)
            prev = (tot[ptr[i], np.arange(K)]
                    + model_weight * np.asarray(beam_logprob[i], float))
        sel = np.zeros(N, int)
        sel[-1] = int(np.argmax(prev))
        for i in range(N - 1, 0, -1):
            sel[i - 1] = ptr[i][sel[i]]
        return sel

    def merge_flat(
        self, blob: bytes, offsets: np.ndarray, flat_logits: np.ndarray,
        expected_overlaps=None,
    ) -> SeqLogitsPair:
        """Fold over snippets given as one flat ASCII blob + row offsets +
        flat per-base scores (see NucTokenizer.sequences_to_texts_flat) —
        the zero-marshalling fast path into the native fold.
        ``expected_overlaps`` (len n-1, from snippet raw-span geometry)
        enables the positional alignment prior."""
        if self.use_native and offsets.size > 2:
            try:
                from ravvent_tpu_torch.ops import native

                if native.available():
                    sc = SCORE_SETS[self.scores_id]
                    kw = (
                        dict(match=0.0, mismatch=0.0,
                             submat=_submat_array(sc["matrix"]))
                        if "matrix" in sc
                        else dict(match=sc["match"], mismatch=sc["mismatch"])
                    )
                    out = native.merge_read_flat(
                        blob, offsets, flat_logits, gap_open=sc["gap_open"],
                        gap_extend=sc["gap_extend"],
                        overlap_len=self.overlap_seq_len,
                        expected_overlaps=expected_overlaps,
                        offset_weight=self.offset_prior_weight
                        if expected_overlaps is not None else 0.0,
                        geom_arbitration=self.geom_arbitration, **kw,
                    )
                    if out is not None:
                        return SeqLogitsPair(out[0], out[1])
            except Exception:
                logger.exception("native merge failed; falling back to python")
        big = blob.decode("ascii")
        seqs = [big[offsets[i] : offsets[i + 1]] for i in range(offsets.size - 1)]
        rows = [flat_logits[offsets[i] : offsets[i + 1]] for i in range(offsets.size - 1)]
        return self.merge(
            [SeqLogitsPair(s, list(np.asarray(l, dtype=float))) for s, l in zip(seqs, rows)],
            expected_overlaps=expected_overlaps,
        )

    def merge_arrays(self, seqs: List[str], logits: List,
                     expected_overlaps=None) -> SeqLogitsPair:
        """Fold over (seq, per-base-score-array) pairs without building a
        Python SeqLogitsPair per snippet — the native fast path consumes the
        arrays directly (the per-element list conversions cost ~15ms/read)."""
        if self.use_native and len(seqs) > 1:
            try:
                from ravvent_tpu_torch.ops import native

                if native.available():
                    sc = SCORE_SETS[self.scores_id]
                    kw = (
                        dict(match=0.0, mismatch=0.0,
                             submat=_submat_array(sc["matrix"]))
                        if "matrix" in sc
                        else dict(match=sc["match"], mismatch=sc["mismatch"])
                    )
                    out = native.merge_read(
                        seqs, logits, gap_open=sc["gap_open"],
                        gap_extend=sc["gap_extend"],
                        overlap_len=self.overlap_seq_len,
                        expected_overlaps=expected_overlaps,
                        offset_weight=self.offset_prior_weight
                        if expected_overlaps is not None else 0.0,
                        geom_arbitration=self.geom_arbitration, **kw,
                    )
                    if out is not None:
                        return SeqLogitsPair(out[0], out[1])
            except Exception:
                logger.exception("native merge failed; falling back to python")
        return self.merge(
            [SeqLogitsPair(s, list(np.asarray(l, dtype=float))) for s, l in zip(seqs, logits)],
            expected_overlaps=expected_overlaps,
        )

    def merge(self, nuc_pred_snippets: List[SeqLogitsPair],
              expected_overlaps=None) -> SeqLogitsPair:
        """Fold over snippet predictions (reference: merger.py:155-248).

        The whole fold runs in the native library when available (one call
        per read instead of one alignment call per snippet pair); the Python
        fold below is the behavior oracle. ``expected_overlaps[i]`` is the
        geometrically expected number of overlapping bases between snippets
        i and i+1 (see merge_flat) — enables the positional prior."""
        if self.use_native and len(nuc_pred_snippets) > 1:
            try:
                from ravvent_tpu_torch.ops import native

                if native.available():
                    w = (self.offset_prior_weight
                         if expected_overlaps is not None else 0.0)
                    sc = SCORE_SETS[self.scores_id]
                    if "matrix" in sc:
                        out = native.merge_read(
                            [p.seq for p in nuc_pred_snippets],
                            [p.logits for p in nuc_pred_snippets],
                            0.0, 0.0, sc["gap_open"], sc["gap_extend"],
                            self.overlap_seq_len, submat=_submat_array(sc["matrix"]),
                            expected_overlaps=expected_overlaps, offset_weight=w,
                            geom_arbitration=self.geom_arbitration,
                        )
                    else:
                        out = native.merge_read(
                            [p.seq for p in nuc_pred_snippets],
                            [p.logits for p in nuc_pred_snippets],
                            sc["match"], sc["mismatch"], sc["gap_open"],
                            sc["gap_extend"], self.overlap_seq_len,
                            expected_overlaps=expected_overlaps, offset_weight=w,
                            geom_arbitration=self.geom_arbitration,
                        )
                    if out is not None:
                        return SeqLogitsPair(out[0], out[1])
            except Exception:
                logger.exception("native merge failed; falling back to python")

        seq_merged = nuc_pred_snippets[0].seq
        logits_merged = nuc_pred_snippets[0].logits
        merge_flag = False

        for i in range(1, len(nuc_pred_snippets)):
            seq_appended = nuc_pred_snippets[i].seq
            logits_appended = nuc_pred_snippets[i].logits
            seq1_overlap = seq_merged[-self.overlap_seq_len :]
            seq2_overlap = seq_appended[: self.overlap_seq_len]
            logits1_overlap = logits_merged[-self.overlap_seq_len :]
            logits2_overlap = logits_appended[: self.overlap_seq_len]

            eo = None
            if expected_overlaps is not None and expected_overlaps[i - 1] >= 0:
                eo = float(expected_overlaps[i - 1])
            algn = self._align(seq1_overlap, seq2_overlap, expected_overlap=eo)
            if (algn is not None and eo is not None
                    and self.geom_arbitration is not None):
                # hard geometry gate: the aligned block must (a) start
                # where geometry expects the shared region to start in the
                # accumulated tail and (b) actually CONSUME ~the expected
                # number of shared bases of the appended snippet — a tiny
                # high-scoring match at the right offset still inflates the
                # splice (union grows by the unmatched remainder)
                start1 = len(algn.seq1_gapped[: algn.begin].replace("-", ""))
                implied = len(seq1_overlap) - start1
                consumed2 = len(
                    algn.seq2_gapped[algn.begin: algn.end].replace("-", ""))
                eo_c = min(eo, float(len(seq1_overlap)),
                           float(len(seq2_overlap)))
                tol = self.geom_arbitration
                if (abs(implied - eo_c) > tol
                        or consumed2 < eo_c - tol):
                    algn = None  # treat as unusable -> geometric splice
            if algn is None and self.geom_arbitration is not None and eo is not None:
                # geometric splice: drop the expected overlap from the
                # appended snippet (bounded damage instead of keep/reset)
                k = min(int(round(eo)), len(seq_appended))
                seq_merged = seq_merged + seq_appended[k:]
                logits_merged = logits_merged + logits_appended[k:]
                merge_flag = True
                continue
            if algn is None:
                logger.warning(
                    "no alignment was found between %dth and %dth snippets", i - 1, i
                )
                if not merge_flag:
                    seq_merged = seq_appended
                    logits_merged = logits_appended
                    continue
                else:
                    return SeqLogitsPair(seq=seq_merged, logits=logits_merged)

            merge_flag = True
            seq1_gapped, seq2_gapped = algn.seq1_gapped, algn.seq2_gapped
            logits1_gapped = SeqLogitsPair.align_logits(seq1_gapped, logits1_overlap)
            logits2_gapped = SeqLogitsPair.align_logits(seq2_gapped, logits2_overlap)
            merged = self._merger.merge(
                SeqLogitsPair(seq1_gapped, logits1_gapped),
                SeqLogitsPair(seq2_gapped, logits2_gapped),
            )
            if self.geom_arbitration is not None and eo is not None:
                # Length-constrained splice (round 5): the union keeps every
                # gap-column base from BOTH windows, so each junction adds
                # ~2-3 inserted bases at realistic snippet accuracy — the
                # merged read compounds ~8-11% over-length and the mapper
                # charges every insertion. Geometry fixes the junction's true
                # length (|s1|+|s2|-round(overlap)); drop the lowest-scoring
                # gap-column bases (the columns only one window voted for)
                # until the splice is within TRIM_SLACK of it. The 1-column
                # slack tolerates a real single-indel decode difference (the
                # raw-span overlap estimate is itself ±1-2 bases); without it
                # the near-saturated periodic row over-trims real bases
                # (ref45 98.2->95.8 measured at slack 0). Measured on (3,1)
                # raw at slack 1: beam-5 92.3->94.7, beam-1 88.8->92.7,
                # beam5-beam1 delta 3.5->2.0, ref45 98.2->98.3 (no harm).
                gapcols = [j for j, (a, b)
                           in enumerate(zip(seq1_gapped, seq2_gapped))
                           if a == "-" or b == "-"]
                eo_c = min(eo, float(len(seq1_overlap)),
                           float(len(seq2_overlap)))
                target = (len(seq1_overlap) + len(seq2_overlap)
                          - int(round(eo_c)))
                excess = len(merged.seq) - target - self.TRIM_SLACK
                if excess > 0 and gapcols:
                    drop = set(sorted(gapcols,
                                      key=lambda j: merged.logits[j])[:excess])
                    merged = SeqLogitsPair(
                        "".join(c for j, c in enumerate(merged.seq)
                                if j not in drop),
                        [v for j, v in enumerate(merged.logits)
                         if j not in drop],
                    )
            seq_merged = (
                seq_merged[: -self.overlap_seq_len] + merged.seq
                + seq_appended[self.overlap_seq_len :]
            )
            logits_merged = (
                logits_merged[: -self.overlap_seq_len] + merged.logits
                + logits_appended[self.overlap_seq_len :]
            )
        return SeqLogitsPair(seq=seq_merged, logits=logits_merged)
