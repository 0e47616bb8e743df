"""Snippet construction: raw signal + labels -> model-ready tensors.

Behavior-equivalent rebuild of the reference preprocessing
(reference: data_loader.py:29-126), with its quirks preserved deliberately:

- the event feature scaler is *fit* on pre-clip events but *applied* to
  post-clip events (data_loader.py:78-96);
- per-read (not global) standardization of both raw signal and event features;
- a snippet's raw range ends at the *start* of its last event, so the event
  snippet covers one more event than the raw snippet (data_loader.py:48-51);
- event coordinates are stream coordinates (sample index + 1) from the event
  detector, applied directly to raw arrays;
- ``compute_fitting_event_ranges`` reproduces the reference's cum-length
  mutation loop exactly (data_loader.py:29-46).

Output shapes are static for the TPU path: raw ``[N, max_raw_len, 1]``,
events ``[N, max_event_len, 5]``, targets ``[N, max_target_len]`` (the
reference pads targets to the per-file batch max; we use a global static
length — extra positions are pad tokens, masked everywhere).
"""

from __future__ import annotations

import hashlib
import os
import threading
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from ravvent_tpu_torch.config import (
    ED_WINDOW_LENGTH_1,
    ED_WINDOW_LENGTH_2,
    INPUT_PADDING,
    MAX_EVENT_LEN,
    MAX_RAW_LEN,
    MAX_TARGET_LEN,
)
from ravvent_tpu_torch.data import chiron
from ravvent_tpu_torch.data.event_detector import detect_events
from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER


def standardize_fit(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Column mean/std (population, ddof=0) — StandardScaler semantics."""
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    std = np.where(std == 0.0, 1.0, std)
    return mean, std


def compute_fitting_event_ranges(
    events_lens: np.ndarray, stride: int, raw_max_len: int = MAX_RAW_LEN
) -> np.ndarray:
    """Sliding event windows: every ``stride`` events, take the longest event
    run whose cumulative raw length stays <= ``raw_max_len``
    (reference: data_loader.py:29-46, reproduced exactly including the
    cum-length mutation loop expressed in closed form)."""
    cum = np.cumsum(events_lens, axis=0, dtype=np.int64)
    n = len(events_lens)
    ranges = []
    for i in range(0, n, stride):
        offset = cum[i - 1] if i > 0 else 0
        # first index where (cum - offset) > raw_max_len; none or index 0 => stop
        end_id = int(np.searchsorted(cum, raw_max_len + offset, side="right"))
        if end_id >= n or end_id == 0:
            break
        ranges.append((i, end_id))
        if (i + stride - 1) >= n:
            break
    return np.array(ranges, dtype=np.int64).reshape(-1, 2)


def convert_events_ranges_to_raw_ranges(events_ranges: np.ndarray, events: np.ndarray) -> np.ndarray:
    """Raw range = [start of first event, start of last event) — end exclusive
    of the last event's span (reference: data_loader.py:48-51)."""
    starts = events[:, 0][events_ranges[:, 0]].astype(np.int64)
    ends = events[:, 0][events_ranges[:, 1] - 1].astype(np.int64)
    return np.column_stack((starts, ends))


def convert_ranges_to_id_sequence(ranges: np.ndarray) -> np.ndarray:
    """Map each raw sample position to the index of the base covering it
    (-1 before the first labeled sample) (reference: data_loader.py:53-62)."""
    lens = ranges[:, 1] - ranges[:, 0]
    core = np.repeat(np.arange(ranges.shape[0]), lens)
    if ranges[0, 0] == 0:
        return core
    return np.concatenate((np.full(ranges[0, 0], -1), core))


def prepare_snippets(
    raw: np.ndarray,
    nuc_raw_ranges: np.ndarray,
    nuc_reference_symbols: np.ndarray,
    stride: int,
    max_raw_len: int = MAX_RAW_LEN,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[str]]:
    """reference: data_loader.py:70-108."""
    ev = detect_events(raw, ED_WINDOW_LENGTH_1, ED_WINDOW_LENGTH_2)
    if ev.shape[0] == 0:
        return [], [], []
    # feature columns: (start, end, length, mean, stdv, mean^2, delta-mean)
    starts = ev[:, 0]
    lengths = ev[:, 1]
    means = ev[:, 2]
    stdvs = ev[:, 3]
    dmean = np.concatenate(([0.0], np.diff(means)))
    events = np.column_stack((starts, starts + lengths, lengths, means, stdvs, means**2, dmean))

    # scaler FIT on pre-clip events (reference quirk, data_loader.py:78-79)
    ev_mean, ev_std = standardize_fit(events[:, 2:])

    # clip events to the labeled region; patch first/last boundaries
    keep = np.logical_and(
        events[:, 0] >= nuc_raw_ranges[0, 0], events[:, 1] <= nuc_raw_ranges[-1, 1]
    )
    events = events[keep, :]
    if events.shape[0] == 0:
        return [], [], []
    events[0, 2] += events[0, 0] - nuc_raw_ranges[0, 0]
    events[0, 0] = nuc_raw_ranges[0, 0]
    events[-1, 2] = nuc_raw_ranges[-1, 1] - events[-1, 0]

    # per-read z-score of raw (column vector, like the reference's
    # StandardScaler on raw.reshape(-1,1))
    rmean, rstd = standardize_fit(raw.reshape(-1, 1).astype(np.float64))
    raw_sc = (raw.reshape(-1, 1) - rmean) / rstd

    events_ranges = compute_fitting_event_ranges(events[:, 2], stride, raw_max_len=max_raw_len)
    if events_ranges.shape[0] == 0:
        return [], [], []
    raw_ranges = convert_events_ranges_to_raw_ranges(events_ranges, events)

    events_sc = (events[:, 2:] - ev_mean) / ev_std

    raw_snippets = [raw_sc[s:e] for s, e in raw_ranges]
    event_snippets = [events_sc[s:e] for s, e in events_ranges]

    nuc_id_seq = convert_ranges_to_id_sequence(nuc_raw_ranges)
    nuc_sym_snippets = []
    for s, e in raw_ranges:
        ids = np.unique(nuc_id_seq[s:e])
        nuc_sym_snippets.append("$" + "".join(nuc_reference_symbols[ids]) + "^")

    return raw_snippets, event_snippets, nuc_sym_snippets


def pad_input_snippets(
    snippets: Sequence[np.ndarray], maxlen: int, features: int
) -> np.ndarray:
    """Post-pad/post-truncate with INPUT_PADDING (reference: data_loader.py:110-111)."""
    out = np.full((len(snippets), maxlen, features), INPUT_PADDING, dtype=np.float32)
    for i, s in enumerate(snippets):
        n = min(len(s), maxlen)
        out[i, :n] = s[:n]
    return out


def _EMPTY_AUX() -> dict:
    return {
        "ev_lens": np.zeros(0, np.int64),
        "ev_starts": np.zeros(0, np.int64),
        "stride": 0,
        "scaler_mean": np.zeros(5, np.float32),
        "scaler_std": np.ones(5, np.float32),
        "raw_mean": np.float32(0.0),
        "raw_std": np.float32(1.0),
        "contiguous": False,
    }


def prepare_compact(
    raw: np.ndarray,
    nuc_raw_ranges: np.ndarray,
    nuc_reference_symbols: np.ndarray,
    stride: int,
):
    """Compact per-read representation: the z-scored signal and scaled event
    features ONCE, plus per-snippet index ranges — instead of materialized
    (heavily overlapping) snippet tensors. Snippet construction then happens
    on device by gather (ravvent_tpu_torch.evaluation.basecall), cutting
    host->device traffic by the overlap factor (~4x at stride 6).

    Returns (signal_sc [S] f32, raw_ranges [N,2] i64, events_sc [E,5] f32,
    events_ranges [N,2] i64, nuc_sym_snippets list[str], aux dict).
    Semantics identical to :func:`prepare_snippets`.
    """
    ev = detect_events(raw, ED_WINDOW_LENGTH_1, ED_WINDOW_LENGTH_2)
    if ev.shape[0] == 0:
        return (np.zeros(0, np.float32), np.zeros((0, 2), np.int64),
                np.zeros((0, 5), np.float32), np.zeros((0, 2), np.int64), [],
                _EMPTY_AUX())
    starts, lengths, means, stdvs = ev[:, 0], ev[:, 1], ev[:, 2], ev[:, 3]
    dmean = np.concatenate(([0.0], np.diff(means)))
    events = np.column_stack((starts, starts + lengths, lengths, means, stdvs, means**2, dmean))
    ev_mean, ev_std = standardize_fit(events[:, 2:])
    keep = np.logical_and(
        events[:, 0] >= nuc_raw_ranges[0, 0], events[:, 1] <= nuc_raw_ranges[-1, 1]
    )
    events = events[keep, :]
    if events.shape[0] == 0:
        return (np.zeros(0, np.float32), np.zeros((0, 2), np.int64),
                np.zeros((0, 5), np.float32), np.zeros((0, 2), np.int64), [],
                _EMPTY_AUX())
    events[0, 2] += events[0, 0] - nuc_raw_ranges[0, 0]
    events[0, 0] = nuc_raw_ranges[0, 0]
    events[-1, 2] = nuc_raw_ranges[-1, 1] - events[-1, 0]

    rmean, rstd = standardize_fit(raw.reshape(-1, 1).astype(np.float64))
    raw_sc = ((raw - rmean[0]) / rstd[0]).astype(np.float32)

    events_ranges = compute_fitting_event_ranges(events[:, 2], stride, raw_max_len=MAX_RAW_LEN)
    if events_ranges.shape[0] == 0:
        return (np.zeros(0, np.float32), np.zeros((0, 2), np.int64),
                np.zeros((0, 5), np.float32), np.zeros((0, 2), np.int64), [],
                _EMPTY_AUX())
    raw_ranges = convert_events_ranges_to_raw_ranges(events_ranges, events)
    events_sc = ((events[:, 2:] - ev_mean) / ev_std).astype(np.float32)

    nuc_id_seq = convert_ranges_to_id_sequence(nuc_raw_ranges)
    nuc_sym_snippets = []
    for s, e in raw_ranges:
        ids = np.unique(nuc_id_seq[s:e])
        nuc_sym_snippets.append("$" + "".join(nuc_reference_symbols[ids]) + "^")

    # Aux for on-device event-feature reconstruction ("i8dev" wire format,
    # ravvent_tpu_torch.evaluation.basecall): with the (patched) event lengths,
    # the raw z-score affine and the (pre-clip-fit) scaler stats, the device
    # can recompute the 5 scaled features from the uploaded signal — only
    # 2 bytes/event travel instead of 10. Events tile the labeled region
    # contiguously ("contiguous" asserts it; if ever False the engine falls
    # back to shipping features).
    starts_i = events[:, 0].astype(np.int64)
    lens_i = events[:, 2].astype(np.int64)
    aux = {
        "ev_lens": lens_i,
        "ev_starts": starts_i,
        "stride": int(stride),
        "scaler_mean": ev_mean.astype(np.float32),
        "scaler_std": ev_std.astype(np.float32),
        "raw_mean": np.float32(rmean[0]),
        "raw_std": np.float32(rstd[0]),
        # "contiguous" doubles as the wire-eligibility flag: boundaries must
        # tile (starts reconstructible by cumsum) and lengths must fit u16
        "contiguous": bool(
            (starts_i[1:] == starts_i[:-1] + lens_i[:-1]).all()
            and (lens_i > 0).all() and (lens_i < 65536).all()
        ),
    }
    return raw_sc, raw_ranges, events_sc, events_ranges, nuc_sym_snippets, aux


def load_read_compact(
    signal_path,
    label_path,
    stride: int,
    max_target_len: int | None = MAX_TARGET_LEN,
    cache_dir: str | None = None,
):
    """Compact-representation loader with optional caching; returns
    (signal_sc, raw_ranges, events_sc, events_ranges, nuc_tok)."""
    out = load_read_compact_ex(
        signal_path, label_path, stride, max_target_len, cache_dir
    )
    return out[:5]


def load_read_compact_ex(
    signal_path,
    label_path,
    stride: int,
    max_target_len: int | None = MAX_TARGET_LEN,
    cache_dir: str | None = None,
):
    """:func:`load_read_compact` plus the aux dict needed for on-device
    event-feature reconstruction (the "i8dev" wire format): returns
    (signal_sc, raw_ranges, events_sc, events_ranges, nuc_tok, aux)."""
    cache_path = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        st = os.stat(signal_path)
        key = hashlib.sha1(
            f"compact3|{Path(signal_path).resolve()}|{stride}|{max_target_len}"
            f"|{st.st_size}|{int(st.st_mtime)}".encode()
        ).hexdigest()[:16]
        cache_path = Path(cache_dir) / f"{Path(signal_path).stem}.{key}.npz"
        if cache_path.exists():
            z = np.load(cache_path)
            aux = {
                "ev_lens": z["ev_lens"], "ev_starts": z["ev_starts"],
                "stride": int(stride),
                "scaler_mean": z["scaler_mean"], "scaler_std": z["scaler_std"],
                "raw_mean": np.float32(z["raw_affine"][0]),
                "raw_std": np.float32(z["raw_affine"][1]),
                "contiguous": bool(z["contiguous"]),
                "n_bases": int(z["read_counts"][0]),
                "n_samples": int(z["read_counts"][1]),
            }
            return z["sig"], z["rr"], z["ev"], z["er"], z["nuc"], aux

    raw = chiron.load_signal(signal_path)
    nuc_raw_ranges, nuc_reference_symbols = chiron.load_label(label_path)
    sig, rr, ev, er, nuc_syms, aux = prepare_compact(
        raw, nuc_raw_ranges, nuc_reference_symbols, stride
    )
    nuc_tok = NUC_TOKENIZER.pad_sequences(
        NUC_TOKENIZER.texts_to_sequences(nuc_syms), maxlen=max_target_len
    )
    aux["n_bases"] = len(nuc_reference_symbols)
    aux["n_samples"] = int(nuc_raw_ranges[-1, 1] - nuc_raw_ranges[0, 0])
    if cache_path is not None:
        # uncompressed: cache reload is on the serving hot path and DEFLATE
        # costs ~10ms/read against ~1.5MB of storage saved
        np.savez(
            cache_path, sig=sig, rr=rr, ev=ev, er=er, nuc=nuc_tok,
            ev_lens=aux["ev_lens"], ev_starts=aux["ev_starts"],
            scaler_mean=aux["scaler_mean"], scaler_std=aux["scaler_std"],
            raw_affine=np.array([aux["raw_mean"], aux["raw_std"]], np.float32),
            contiguous=np.bool_(aux["contiguous"]),
            read_counts=np.array([aux["n_bases"], aux["n_samples"]], np.int64),
        )
    return sig, rr, ev, er, nuc_tok, aux


def load_read_snippets(
    signal_path,
    label_path,
    stride: int,
    max_target_len: int | None = MAX_TARGET_LEN,
    cache_dir: str | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full per-read preprocessing (reference: data_loader.py:113-126), with an
    optional on-disk cache (the reference re-preprocesses every file visit of
    every epoch — data_loader.py:234-240 — which would leave the TPU
    input-bound; caching removes that).

    ``max_target_len=None`` pads targets to the per-read max (reference
    behavior); an int gives static TPU shapes.
    """
    cache_path = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        st = os.stat(signal_path)
        key = hashlib.sha1(
            f"{Path(signal_path).resolve()}|{stride}|{max_target_len}"
            f"|{st.st_size}|{int(st.st_mtime)}".encode()
        ).hexdigest()[:16]
        cache_path = Path(cache_dir) / f"{Path(signal_path).stem}.{key}.npz"
        if cache_path.exists():
            try:
                z = np.load(cache_path)
                return z["raw"], z["event"], z["nuc"]
            except Exception:
                # torn/corrupt cache entry (e.g. a writer killed mid-write
                # before writes were atomic): recompute and rewrite
                cache_path.unlink(missing_ok=True)

    raw = chiron.load_signal(signal_path)
    nuc_raw_ranges, nuc_reference_symbols = chiron.load_label(label_path)

    raw_snips, event_snips, nuc_syms = prepare_snippets(
        raw, nuc_raw_ranges, nuc_reference_symbols, stride
    )
    raw_arr = pad_input_snippets(raw_snips, MAX_RAW_LEN, 1)
    event_arr = pad_input_snippets(event_snips, MAX_EVENT_LEN, 5)
    nuc_tok = NUC_TOKENIZER.pad_sequences(
        NUC_TOKENIZER.texts_to_sequences(nuc_syms), maxlen=max_target_len
    )

    if cache_path is not None:
        # atomic publish: a concurrent reader (trainer vs cache prewarmer)
        # must never see a partially-written archive; the temporary file is
        # this writer's own, so two threads that miss one entry never share it
        tmp = cache_path.with_name(
            f".{cache_path.name}.tmp{os.getpid()}.{threading.get_ident()}")
        try:
            with open(tmp, "wb") as f:
                np.savez_compressed(f, raw=raw_arr, event=event_arr, nuc=nuc_tok)
            os.replace(tmp, cache_path)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
    return raw_arr, event_arr, nuc_tok
