"""ctypes bindings for the native host kernels (native/ravvent_native.cpp).

A copy of ravvent_tpu/ops/native.py. The C++ source belongs to neither
package; this copy builds it lazily with g++ on first use into the port's
gitignored build directory (``ravvent_tpu_torch/build/``). Every entry point
has a pure-Python fallback elsewhere in the package, so the port works
without a toolchain — just slower.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "ravvent_native.cpp"
_LIB_PATH = _REPO_ROOT / "ravvent_tpu_torch" / "build" / "libravvent_native.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17",
        str(_SRC), "-o", str(tmp),
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if res.returncode != 0:
        return False
    # several test workers may build at once: publish the library atomically
    os.replace(tmp, _LIB_PATH)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None

        lib.rv_detect_events.restype = ctypes.c_long
        lib.rv_detect_events.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_long,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ]
        lib.rv_local_align.restype = ctypes.c_long
        lib.rv_local_align.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_double, ctypes.c_double,
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ]
        lib.rv_merge_read.restype = ctypes.c_long
        lib.rv_merge_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_double), ctypes.c_long,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), ctypes.c_double, ctypes.c_double,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ]
        lib.rv_banded_global.restype = ctypes.c_int
        lib.rv_banded_global.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.rv_map_read.restype = ctypes.c_long
        lib.rv_map_read.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_long, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def detect_events(
    raw: np.ndarray, w1: int, w2: int, t1: float, t2: float, peak_height: float
) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.float64)
    max_events = raw.size + 1
    out = np.empty(4 * max_events, dtype=np.float64)
    n = lib.rv_detect_events(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), raw.size,
        w1, w2, t1, t2, peak_height,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_events,
    )
    return out[: 4 * n].reshape(-1, 4).copy()


def local_align(
    seq1: str, seq2: str, match: float, mismatch: float,
    gap_open: float, gap_extend: float, submat: Optional[np.ndarray] = None,
    expected_offset: Optional[float] = None, offset_weight: float = 0.0,
):
    lib = _load()
    if lib is None:
        return None
    n, m = len(seq1), len(seq2)
    buf1 = ctypes.create_string_buffer(n + m + 2)
    buf2 = ctypes.create_string_buffer(n + m + 2)
    score = ctypes.c_double()
    begin = ctypes.c_long()
    end = ctypes.c_long()
    sm = (
        submat.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if submat is not None
        else None
    )
    if expected_offset is None:
        expected_offset, offset_weight = 0.0, 0.0
    ln = lib.rv_local_align(
        seq1.encode(), n, seq2.encode(), m,
        match, mismatch, gap_open, gap_extend, sm,
        float(expected_offset), float(offset_weight),
        buf1, buf2, ctypes.byref(score), ctypes.byref(begin), ctypes.byref(end),
    )
    if ln == 0:
        return None
    from ravvent_tpu_torch.assembly.alignment import AlignmentResult

    return AlignmentResult(
        buf1.value.decode(), buf2.value.decode(), score.value, begin.value, end.value
    )


def banded_global_identity(
    query: str, ref: str, match: float, mismatch: float,
    gap_open: float, gap_extend: float, band: Optional[int],
) -> Tuple[int, int, float]:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    matches = ctypes.c_long()
    cols = ctypes.c_long()
    score = ctypes.c_double()
    ok = lib.rv_banded_global(
        query.encode(), len(query), ref.encode(), len(ref),
        match, mismatch, gap_open, gap_extend, band if band else 0,
        ctypes.byref(matches), ctypes.byref(cols), ctypes.byref(score),
    )
    if not ok:
        return 0, 0, float("-inf")
    return matches.value, cols.value, score.value


def map_read(
    query: str, ref: str, k: int, w: int, max_occ: int,
    min_chain_score: int, min_chain_anchors: int,
    a_match: float, a_mismatch: float, a_gap_open: float, a_gap_extend: float,
    max_chains: int,
) -> np.ndarray:
    """Native seed-chain-extend mapper (rv_map_read). Returns an
    [n_chains, 6] int array of (matches, block_len, q_start, q_end,
    t_start, t_end) rows, best chain first."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = np.zeros(6 * max_chains, dtype=np.int64)
    n = lib.rv_map_read(
        query.encode(), len(query), ref.encode(), len(ref),
        k, w, max_occ, min_chain_score, min_chain_anchors,
        a_match, a_mismatch, a_gap_open, a_gap_extend,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), max_chains,
    )
    return out[: 6 * n].reshape(-1, 6).copy()


def _exp_overlaps_ptr(expected_overlaps, n_snippets: int):
    """(ptr, weight) for the optional positional-prior arrays."""
    if expected_overlaps is None:
        return None, 0.0
    arr = np.ascontiguousarray(expected_overlaps, dtype=np.float64)
    if arr.size != n_snippets - 1:
        raise ValueError("expected_overlaps must have n_snippets-1 entries")
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def merge_read(
    seqs, logits_list, match: float, mismatch: float,
    gap_open: float, gap_extend: float, overlap_len: int = 25,
    submat: Optional[np.ndarray] = None,
    expected_overlaps=None, offset_weight: float = 0.0,
    geom_arbitration: Optional[float] = None,
):
    """Native whole-read overlap merge (reference merger.py:155-248 fold).
    ``seqs``: list[str]; ``logits_list``: list of per-base score lists.
    ``expected_overlaps`` (len n-1) + ``offset_weight`` enable the
    positional prior on each pairwise alignment (periodic-sequence fix).
    ``geom_arbitration`` (tolerance in bases; None = reference fold) enables
    the junction geometry gate — see Merger.merge.
    Returns (merged_seq, merged_logits) or None if the library is missing."""
    lib = _load()
    if lib is None:
        return None
    blob = "".join(seqs).encode()
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    flat_logits = np.ascontiguousarray(
        np.concatenate([np.asarray(l, dtype=np.float64) for l in logits_list])
        if any(len(l) for l in logits_list) else np.zeros(0)
    )
    if flat_logits.size != offsets[-1]:
        raise ValueError("logits/seq length mismatch")
    cap = int(offsets[-1]) + overlap_len + 2
    out_seq = ctypes.create_string_buffer(cap)
    out_log = np.empty(cap, dtype=np.float64)
    sm = (
        submat.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if submat is not None else None
    )
    eo_keepalive, eo = (None, None)
    if expected_overlaps is not None:
        eo_keepalive, eo = _exp_overlaps_ptr(expected_overlaps, len(seqs))
    n = lib.rv_merge_read(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        flat_logits.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(seqs), match, mismatch, gap_open, gap_extend, sm, overlap_len,
        eo, float(offset_weight),
        -1.0 if geom_arbitration is None else float(geom_arbitration),
        out_seq, out_log.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap,
    )
    del eo_keepalive
    return out_seq.value.decode(), out_log[:n].tolist()


def merge_read_flat(
    blob: bytes, offsets: np.ndarray, flat_logits: np.ndarray,
    match: float, mismatch: float,
    gap_open: float, gap_extend: float, overlap_len: int = 25,
    submat: Optional[np.ndarray] = None,
    expected_overlaps=None, offset_weight: float = 0.0,
    geom_arbitration: Optional[float] = None,
):
    """:func:`merge_read` on pre-flattened inputs: ``blob`` is the snippet
    sequences concatenated as ASCII bytes, ``offsets[i]:offsets[i+1]``
    delimits snippet i in both ``blob`` and ``flat_logits``. Skips the
    join/concatenate marshalling (and the list conversion of the output
    scores — returns a numpy array). Returns None if the library is missing."""
    lib = _load()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    flat_logits = np.ascontiguousarray(flat_logits, dtype=np.float64)
    if flat_logits.size != offsets[-1] or len(blob) != offsets[-1]:
        raise ValueError("logits/seq length mismatch")
    n_snippets = offsets.size - 1
    cap = int(offsets[-1]) + overlap_len + 2
    out_seq = ctypes.create_string_buffer(cap)
    out_log = np.empty(cap, dtype=np.float64)
    sm = (
        submat.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if submat is not None else None
    )
    eo_keepalive, eo = (None, None)
    if expected_overlaps is not None:
        eo_keepalive, eo = _exp_overlaps_ptr(expected_overlaps, n_snippets)
    n = lib.rv_merge_read(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        flat_logits.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_snippets, match, mismatch, gap_open, gap_extend, sm, overlap_len,
        eo, float(offset_weight),
        -1.0 if geom_arbitration is None else float(geom_arbitration),
        out_seq, out_log.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap,
    )
    del eo_keepalive
    return out_seq.value.decode(), out_log[:n]
