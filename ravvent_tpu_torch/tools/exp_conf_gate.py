"""Merged-identity experiment for confidence-gated snippet dropping, on the
GPU.

Counterpart of the repo root's tools/exp_conf_gate.py, which runs the JAX
package, with its flags. Decode each eval read once per beam width, then
merge it again under each setting of the gate grid (relative-outlier gap,
absolute floor, drop cap[, longest run dropped]; assembly/merger.py:
confidence_keep_mask) and map each merged read. The gate drops a snippet
before the fold when its confidence is both a robust outlier below the
read's median and below an absolute floor; the ~80% window overlap lets its
neighbours cover the span (the expected overlaps recomputed from the
surviving raw spans).

``--checkpoint`` is a port checkpoint directory or an npz of weights
(tools/common.py:load_params). The engine keeps the JAX tool's numerics
(tools/common.py:eval_engine). Runs on the first CUDA device unless
``--cpu`` or ``--device``. ``main`` returns the results that ``--out``
writes: ``{"baseline" | "g<setting>": {"beam<b>": mean merged identity,
"mean_drop_frac": x}}``.

  python -m ravvent_tpu_torch.tools.exp_conf_gate \\
      --checkpoint ravvent_tpu_torch/assets/flagship.npz --data-type joint \\
      --encoder-depth 2 --files-info datasets/ds/eval/files_info.test.snippets.stride_6.json \\
      [--cache-dir DIR] [--reads 4] [--beams 5,1] [--out f.json] [--cpu | --device DEV]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ravvent_tpu_torch.assembly.merger import (
    Merger, confidence_keep_mask, drop_snippet_rows, expected_overlaps_from_ranges,
)
from ravvent_tpu_torch.data import chiron
from ravvent_tpu_torch.data.snippets import load_read_compact_ex
from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER
from ravvent_tpu_torch.tools.common import add_study_flags, study_engine

# confidence_keep_mask's (rel_gap, abs_floor, max_drop_frac[, max_consecutive]);
# None is the baseline, no gate
GRID = [None,
        (0.12, -0.15, 0.12),
        (0.12, -0.15, 0.25, 2)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_study_flags(ap, reads=4)
    ap.add_argument("--beams", default="5,1")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    beams = [int(b) for b in args.beams.split(",")]
    engine = study_engine(args, beams)
    ev_map = MappingEvaluator(engine, cache_dir=args.cache_dir)
    merger = Merger()

    fi = json.loads(Path(args.files_info).read_text())[: args.reads]
    decoded = []  # one record a (read, beam)
    for rec in fi:
        sig_path = rec["signal_path"]
        label_path = Path(sig_path).with_suffix(".label")
        sig, rr, ev, er, nuc, aux = load_read_compact_ex(
            sig_path, label_path, 6, cache_dir=args.cache_dir)
        if not rr.shape[0]:
            continue
        max_out = int((nuc != 0).sum(axis=1).max())
        _, syms = chiron.load_label(label_path)
        ref_seq = "".join(syms)
        for beam in beams:
            tokens, probs = engine.predict_beam_compact(sig, rr, ev, er, max_out, beam, aux=aux)
            _, blob, offsets = NUC_TOKENIZER.sequences_to_texts_flat(tokens)
            probs = np.asarray(probs, np.float64)
            counts = np.diff(offsets)
            prefix = np.arange(probs.shape[1])[None, :] < counts[:, None]
            decoded.append(dict(read=Path(sig_path).name, beam=beam, blob=blob,
                                offsets=offsets, flat=probs[prefix], rr=rr, ref=ref_seq))

    results = {}
    for g in GRID:
        key = "baseline" if g is None else "g" + "_".join(str(x) for x in g)
        per_beam = {b: [] for b in beams}
        drop_fracs = []
        for d in decoded:
            blob, offsets, flat, rr = d["blob"], d["offsets"], d["flat"], d["rr"]
            if g is not None:
                keep = confidence_keep_mask(flat, offsets, *g)
                drop_fracs.append(float((~keep).mean()))
                blob, offsets, flat = drop_snippet_rows(blob, offsets, flat, keep)
                rr = rr[keep]
            counts = np.diff(offsets)
            eo = expected_overlaps_from_ranges(rr, counts) if rr.shape[0] > 1 else None
            merged = merger.merge_flat(blob, offsets, flat, expected_overlaps=eo)
            ident = ev_map.map_identity(merged.seq, d["ref"])
            per_beam[d["beam"]].append(ident.get("identity", 0.0))
        results[key] = {f"beam{b}": round(float(np.mean(per_beam[b])), 4) for b in beams}
        if drop_fracs:
            results[key]["mean_drop_frac"] = round(float(np.mean(drop_fracs)), 4)
        print(key, json.dumps(results[key]), flush=True)

    print(json.dumps(results, indent=1))
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
