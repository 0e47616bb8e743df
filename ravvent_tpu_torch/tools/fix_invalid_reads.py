"""Re-run and patch invalid (unmapped) reads in evaluation result files (a
copy of ravvent_tpu/tools/fix_invalid_reads.py; the evaluator given runs the
reads on its engine's device).

Working rebuild of the reference's stale retry tool
(reference: fix_invalid_read_results.py — its imports no longer exist
upstream; the intent, re-running reads whose mapping came back empty
(``read_length == 0``) and patching the result JSONs in place, is implemented
here against the live evaluator API).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator


def find_invalid(results: List[Dict]) -> List[int]:
    return [i for i, r in enumerate(results) if r.get("read_length", 0) == 0]


def fix_results_file(
    results_path, evaluator: MappingEvaluator, verbose: bool = True
) -> int:
    """Re-run every invalid read in ``results_path``; returns how many were
    repaired (now mapping)."""
    with open(results_path, "rt") as f:
        results = json.load(f)
    fixed = 0
    for i in find_invalid(results):
        path = results[i]["path"]
        if verbose:
            print(f"retrying {path}", flush=True)
        new = evaluator.run(path)
        new["path"] = path
        new["ref_length"] = results[i].get("ref_length", 0)
        if new["read_length"] != 0:
            fixed += 1
        results[i] = new
        with open(results_path, "wt") as f:
            json.dump(results, f, indent=2)
    return fixed


def fix_all(results_dir, evaluator: MappingEvaluator, pattern: str = "*.json") -> Dict[str, int]:
    out = {}
    for p in sorted(Path(results_dir).glob(pattern)):
        out[p.name] = fix_results_file(p, evaluator)
    return out
