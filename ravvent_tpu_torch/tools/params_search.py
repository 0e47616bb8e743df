"""Event-detector window grid search (a copy of
ravvent_tpu/tools/params_search.py; host code, no device).

Rebuild of the reference parameter search
(reference: event_detection/params_search_window_lengths.py): sweep
``window_length1`` in [3, 9] and odd ``window_length2`` in [wl1+1, 21],
scoring each pair by the mean relative error between the number of detected
events and the number of reference bases per read; the best pair minimizes
that error (the reference's result, 6/9, is baked into the data pipeline).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ravvent_tpu_torch.data import chiron
from ravvent_tpu_torch.data.event_detector import detect_events


def evaluate_sequence(
    raw: np.ndarray, n_ref_bases: int, wl1: int, wl2: int
) -> float:
    """Relative error |#events - #bases| / #bases for one read
    (reference: params_search_window_lengths.py:35-45)."""
    events = detect_events(raw, wl1, wl2)
    return abs(events.shape[0] - n_ref_bases) / max(n_ref_bases, 1)


def grid_search(
    reads: Sequence[Tuple[np.ndarray, int]],
    wl1_range: Sequence[int] = range(3, 10),
    wl2_max: int = 21,
) -> Dict[Tuple[int, int], float]:
    """Mean relative error per (wl1, wl2) pair; wl2 sweeps odd values in
    (wl1, wl2_max] (reference: params_search_window_lengths.py:62-80)."""
    results: Dict[Tuple[int, int], float] = {}
    for wl1 in wl1_range:
        for wl2 in range(wl1 + 1, wl2_max + 1):
            if wl2 % 2 == 0:
                continue
            errs = [evaluate_sequence(raw, n, wl1, wl2) for raw, n in reads]
            results[(wl1, wl2)] = float(np.mean(errs))
    return results


def get_best_params(results: Dict[Tuple[int, int], float]) -> Tuple[Tuple[int, int], float]:
    best = min(results.items(), key=lambda kv: kv[1])
    return best


def load_reads_from_chiron_dir(files_dir, limit: int | None = None) -> List[Tuple[np.ndarray, int]]:
    reads = []
    for sp, lp in chiron.list_read_pairs(files_dir)[:limit]:
        raw = chiron.load_signal(sp)
        ranges, _ = chiron.load_label(lp)
        reads.append((raw, int(ranges.shape[0])))
    return reads


def main(argv=None) -> Tuple[Tuple[int, int], float]:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--limit", type=int, default=4)
    args = ap.parse_args(argv)
    reads = load_reads_from_chiron_dir(args.data_dir, args.limit)
    res = grid_search(reads)
    (wl1, wl2), err = get_best_params(res)
    print(f"best windows: ({wl1}, {wl2}) mean rel err {err:.4f}")
    return (wl1, wl2), err


if __name__ == "__main__":
    main()
