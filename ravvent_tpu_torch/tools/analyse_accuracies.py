"""Accuracy-results aggregation and comparison (a copy of
ravvent_tpu/tools/analyse_accuracies.py; host code, no device).

Rebuild of the reference analysis script (reference: analyse_accuracies.py):
loads per-depth-config accuracy result JSONs into
``[data_type x depth-config x (total, valid, invalid%)]`` arrays and prints
beam-width deltas. Also ships the reference's committed baseline numbers so
our runs can be compared against them directly (BASELINE.md).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

DATA_TYPES = ["raw", "event", "joint"]

# Reference baselines (accuracy_results_all.*.json; see BASELINE.md).
REFERENCE_LAMBDA = {
    5: {"(2, 1)": {"raw": 83.95, "event": 72.18, "joint": 84.16},
        "(3, 2)": {"raw": 86.99, "event": 76.33, "joint": 87.39}},
    1: {"(2, 1)": {"raw": 83.32, "event": 69.78, "joint": 83.57},
        "(3, 2)": {"raw": 86.76, "event": 75.03, "joint": 86.50}},
}


def get_np_results(
    results: Dict[str, Dict[str, Sequence[float]]],
    depth_keys: Sequence[str],
) -> np.ndarray:
    """dict[depth_config][data_type] = (total, valid, invalid%) -> array
    [data_type, depth_config, 3] (reference: analyse_accuracies.py:162-177)."""
    out = np.zeros((len(DATA_TYPES), len(depth_keys), 3))
    for i, dt in enumerate(DATA_TYPES):
        for j, dk in enumerate(depth_keys):
            out[i, j] = results.get(dk, {}).get(dt, (0.0, 0.0, 0.0))
    return out


def compare_beams(res_beam1: np.ndarray, res_beam5: np.ndarray) -> np.ndarray:
    """beam5 - beam1 identity deltas (reference: analyse_accuracies.py:144-180)."""
    return res_beam5[:, :, 0] - res_beam1[:, :, 0]


def collect_results(results_dir, pattern: str = "accuracy_results_all.*.json") -> Dict:
    out = {}
    for p in sorted(Path(results_dir).glob(pattern)):
        with open(p) as f:
            out[p.stem] = json.load(f)
    return out


def main(argv=None) -> Dict:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results-dir", default="info")
    args = ap.parse_args(argv)
    all_res = collect_results(args.results_dir)
    for name, res in all_res.items():
        # "_"-prefixed keys are reserved metadata (e.g. _provenance), not
        # depth configs
        keys = sorted(k for k in res.keys() if not k.startswith("_"))
        arr = get_np_results(res, keys)
        print(name, keys)
        print(np.round(arr[:, :, 0], 2))
    return all_res


if __name__ == "__main__":
    main()
