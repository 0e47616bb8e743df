"""Decompose the beam5-beam1 merged-identity gap, on the GPU.

Counterpart of the repo root's tools/analyze_beam1_gap.py, which runs the
JAX package, with its flags. For each evaluated read: decode every snippet
at beam widths 5 and 1, score each decoded snippet against its ground-truth
label sequence with the exact local aligner (per-snippet identity = matches
/ aligned columns), then merge and map both ways. The two deltas side by
side separate the gap's two candidate causes:

- per-snippet delta -> the beam-1 DECODE is worse (a search problem);
- merged delta beyond the per-snippet delta -> the MERGE amplifies beam-1
  errors at junctions (a fold problem).

A read without snippets is skipped, and the summary averages over the rows
printed. ``--checkpoint`` is a port checkpoint directory or an npz of
weights (tools/common.py:load_params). The engine keeps the JAX tool's
numerics (tools/common.py:eval_engine: f32 memory and encoder, chunks of
1024 rows, the beam-step kernels where the configuration allows them).
Runs on the first CUDA device unless ``--cpu`` or ``--device``. ``main``
returns the summary that ``--out`` writes.

  python -m ravvent_tpu_torch.tools.analyze_beam1_gap \\
      --checkpoint ravvent_tpu_torch/assets/flagship.npz --data-type joint \\
      --encoder-depth 2 --files-info datasets/ds/eval/files_info.test.snippets.stride_6.json \\
      --cache-dir datasets/ds/.cache --reads 6 [--cpu | --device DEV]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ravvent_tpu_torch.assembly.alignment import sw_local_identity
from ravvent_tpu_torch.data import chiron
from ravvent_tpu_torch.data.snippets import load_read_compact_ex
from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER
from ravvent_tpu_torch.tools.common import add_study_flags, study_engine

BEAMS = (5, 1)


def snippet_identity(pred: str, true: str) -> float:
    """Symmetric local-alignment identity of one decoded snippet against
    its label (matches / aligned columns, 0 when no alignment)."""
    if not pred or not true:
        return 0.0
    out = sw_local_identity(pred, true, 2.0, -1.0, -2.0, -0.5)
    if out is None:
        return 0.0
    matches, cols = out[0], out[1]
    return matches / max(cols, len(pred), len(true))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_study_flags(ap, reads=6)
    ap.add_argument("--out", default=None, help="write the JSON record here")
    args = ap.parse_args(argv)

    engine = study_engine(args, BEAMS)
    fi = json.loads(Path(args.files_info).read_text())[: args.reads]
    rows = []
    for rec in fi:
        sig_path = rec["signal_path"]
        label_path = Path(sig_path).with_suffix(".label")
        sig, rr, ev, er, nuc, aux = load_read_compact_ex(
            sig_path, label_path, 6, cache_dir=args.cache_dir)
        if not rr.shape[0]:
            continue
        max_out = int((nuc != 0).sum(axis=1).max())
        true_texts, _, _ = NUC_TOKENIZER.sequences_to_texts_flat(nuc)
        row = {"read": Path(sig_path).name, "n_snippets": int(rr.shape[0])}
        for beam in BEAMS:
            evb = MappingEvaluator(engine, beam_width=beam, cache_dir=args.cache_dir)
            tokens, _ = engine.predict_beam_compact(sig, rr, ev, er, max_out, beam, aux=aux)
            pred_texts, _, _ = NUC_TOKENIZER.sequences_to_texts_flat(tokens)
            ids = [snippet_identity(p, t) for p, t in zip(pred_texts, true_texts)]
            merged = evb.basecall_read(sig_path, label_path)
            _, syms = chiron.load_label(label_path)
            ident = evb.map_identity(merged.seq, "".join(syms))
            row[f"beam{beam}"] = {
                "snippet_identity_mean": round(float(np.mean(ids)), 4),
                "snippet_identity_p25": round(float(np.percentile(ids, 25)), 4),
                "merged_identity": ident.get("identity", 0.0),
                "merged_len_ratio": round(len(merged.seq) / max(len(syms), 1), 3),
            }
        rows.append(row)
        print(json.dumps(row), flush=True)

    def agg(key, sub):
        return round(float(np.mean([r[key][sub] for r in rows])), 4)

    summary = {
        "checkpoint": str(Path(args.checkpoint)), "data_type": args.data_type,
        "reads": len(rows),
        "snippet_identity_mean": {b: agg(f"beam{b}", "snippet_identity_mean") for b in BEAMS},
        "merged_identity_mean": {b: agg(f"beam{b}", "merged_identity") for b in BEAMS},
        "snippet_delta": round(agg("beam5", "snippet_identity_mean")
                               - agg("beam1", "snippet_identity_mean"), 4),
        "merged_delta": round(agg("beam5", "merged_identity")
                              - agg("beam1", "merged_identity"), 4),
        "rows": rows,
    }
    print(json.dumps({k: summary[k] for k in
                      ("snippet_identity_mean", "merged_identity_mean",
                       "snippet_delta", "merged_delta")}, indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
