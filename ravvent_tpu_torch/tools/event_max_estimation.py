"""Events-per-snippet histogram — justifies MAX_EVENT_LEN (a copy of
ravvent_tpu/tools/event_max_estimation.py; host code, no device).

Rebuild of the reference estimator (reference: event_max_estimation.py:4-49):
over a dataset, compute the distribution of events per fitting window (the
windows the snippet pipeline would cut), confirming the static
``MAX_EVENT_LEN`` bound (30 in the reference; our static target length bound
derives from the same histogram).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ravvent_tpu_torch.config import MAX_RAW_LEN
from ravvent_tpu_torch.data import chiron
from ravvent_tpu_torch.data.event_detector import detect_events
from ravvent_tpu_torch.data.snippets import compute_fitting_event_ranges


def events_per_snippet(files_dir, stride: int = 6, limit: int | None = None) -> np.ndarray:
    counts = []
    for sp, lp in chiron.list_read_pairs(files_dir)[:limit]:
        raw = chiron.load_signal(sp)
        ev = detect_events(raw)
        if ev.shape[0] == 0:
            continue
        ranges = compute_fitting_event_ranges(ev[:, 1], stride, MAX_RAW_LEN)
        if ranges.shape[0]:
            counts.extend((ranges[:, 1] - ranges[:, 0]).tolist())
    return np.array(counts)


def summarize(counts: np.ndarray) -> Dict[str, float]:
    return {
        "max": float(counts.max()),
        "p999": float(np.percentile(counts, 99.9)),
        "p99": float(np.percentile(counts, 99)),
        "mean": float(counts.mean()),
    }


def main(argv=None) -> Dict[str, float]:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--stride", type=int, default=6)
    ap.add_argument("--limit", type=int, default=8)
    args = ap.parse_args(argv)
    counts = events_per_snippet(args.data_dir, args.stride, args.limit)
    summary = summarize(counts)
    print(summary)
    hist, edges = np.histogram(counts, bins=range(0, int(counts.max()) + 2))
    for h, e in zip(hist, edges):
        if h:
            print(f"{e:3d}: {h}")
    return summary


if __name__ == "__main__":
    main()
