"""Accuracy evaluation CLI, on the GPU: the reference's mapping-evaluator
sweep as a tool.

Counterpart of tools/evaluate.py of the JAX package, with its flags. Runs
read-level mapping evaluation of a checkpoint over a files_info index
(reference: ravvent_mapping_evaluator.py:203-237 ``evaluate_specific``),
writes the per-read results as it goes, aggregates them with the
reference's ref-length-weighted identity, and folds the totals into
``accuracy_results_all.<tag>.beam<k>.json`` in the reference's schema
(``{"(encd, decd)": {data_type: [total, valid, invalid%]}}``).

``--checkpoint`` is a port checkpoint directory (``params.npz`` +
``state.pt``) or an npz of weights (``weights.save_npz``); the tool raises
when it holds neither. The engine keeps
the JAX tool's numerics: f32 memory and encoder, chunks of 1024 rows; it
decodes with the beam-step kernels where the configuration allows it (a
depth-1 LSTM decoder with Luong attention, every beam width in
``STEP_BEAMS``, 1-32, and on a card ``dec_units`` up to 256, the widths
between ``STEP_UNITS``' 64, 128 and 256 zero-padded: ops/beam_step_cuda.py,
ops/decoder_pad.py) and with the plain beam decode otherwise
(evaluation/basecall.py:kernels_serve), or as ``--beam-impl`` says. Runs on
the first CUDA device unless ``--cpu`` is given.

  python -m ravvent_tpu_torch.tools.evaluate --checkpoint checkpoints/flagship.npz \
      --files-info datasets/sim_lambda/eval/files_info.test.snippets.stride_6.json \
      --data-type joint --beam 5 --tag sim_lambda
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from ravvent_tpu_torch.evaluation.basecall import BEAM_IMPLS, resolve_device
from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
from ravvent_tpu_torch.tools.common import (
    add_model_flags, device_name, eval_engine, load_params, model_config,
)


def conf_gate_setting(args):
    """The evaluator's ``conf_gate`` from the flags: None (off) with
    --no-conf-gate or --reference-fold, the parsed --conf-gate, else the
    default."""
    # --reference-fold promises bit-parity with the reference merge
    # semantics, so it also disables the confidence gate
    if args.no_conf_gate or args.reference_fold:
        return None
    if args.conf_gate:
        parts = [float(x) for x in args.conf_gate.split(",")]
        if len(parts) == 4:
            parts[3] = int(parts[3])
        return tuple(parts)
    return "default"


def main(argv=None) -> dict:
    """Evaluate; returns {(tag, beam): (total, valid, invalid%)}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True, help="port checkpoint dir or npz of weights")
    ap.add_argument("--files-info", default=None)
    ap.add_argument("--eval", action="append", default=[],
                    help="additional TAG:FILES_INFO[:CACHE_DIR] evaluations "
                         "run in the same process")
    add_model_flags(ap)
    ap.add_argument("--beam", type=int, default=None,
                    help="single beam width (default: use --beams)")
    ap.add_argument("--beams", default="5",
                    help="comma-separated beam widths, e.g. 5,1")
    ap.add_argument("--out-dir", default="info/mapping_evaluations")
    ap.add_argument("--tag", default="sim_lambda")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--beam-impl", default=None, choices=list(BEAM_IMPLS),
                    help="the engine's beam decode (default: step where the configuration "
                         "allows it, else xla)")
    ap.add_argument("--geom-arbitration", type=float, default=None,
                    help="merge-fold geometry gate tolerance in bases "
                         "(default: the Merger default, arbitrated fold; "
                         "see assembly.merger.Merger)")
    ap.add_argument("--reference-fold", action="store_true",
                    help="disable geometry arbitration: bit-parity with the "
                         "reference merge fold")
    ap.add_argument("--n-beams", type=int, default=1,
                    help="fetch the top-K beams per snippet and select by "
                         "junction overlap agreement before merging (phase "
                         "fix for periodic genomes; K=1 = reference flow)")
    ap.add_argument("--no-conf-gate", action="store_true",
                    help="disable the confidence gate (derailed-snippet "
                         "drop before the fold; assembly.merger."
                         "confidence_keep_mask). Implied by "
                         "--reference-fold.")
    ap.add_argument("--conf-gate", default=None,
                    help="override the gate parameters: "
                         "'rel_gap,abs_floor,max_drop_frac[,max_consecutive]' "
                         "(e.g. '0.12,-0.15,0.25,2'); default follows "
                         "merger.CONF_GATE_DEFAULT")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    cfg = model_config(args)
    params = load_params(args.checkpoint)
    print(f"loaded {args.checkpoint}", file=sys.stderr)

    # evaluation plan: (tag, files_info, cache_dir) x beam widths
    plan = []
    if args.files_info:
        plan.append((args.tag, args.files_info, args.cache_dir))
    for spec in args.eval:
        parts = spec.split(":")
        tag, fi = parts[0], parts[1]
        cache = parts[2] if len(parts) > 2 else args.cache_dir
        plan.append((tag, fi, cache))
    if not plan:
        ap.error("need --files-info or at least one --eval TAG:FILES_INFO")
    beams = [args.beam] if args.beam else [int(b) for b in args.beams.split(",")]

    engine = eval_engine(params, cfg, device, beams, n_beams=args.n_beams,
                         beam_impl=args.beam_impl)
    print(f"engine: beam_impl={engine.beam_impl} on {device} ({device_name(device)})",
          file=sys.stderr)
    ga = (None if args.reference_fold
          else args.geom_arbitration if args.geom_arbitration is not None
          else "default")
    cg = conf_gate_setting(args)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    depth_key = f"({args.encoder_depth}, {args.decoder_depth})"
    totals = {}
    for beam in beams:
        for tag, files_info, cache in plan:
            ev = MappingEvaluator(engine, beam_width=beam, cache_dir=cache,
                                  geom_arbitration=ga, conf_gate=cg)
            res_path = out_dir / (
                f"mapping_evaluator_results.{tag}.{args.data_type}."
                f"encd{args.encoder_depth}.decd{args.decoder_depth}.beam{beam}.json"
            )
            t0 = time.perf_counter()
            ev.evaluate_files(files_info, res_path)
            dt = time.perf_counter() - t0
            total, valid, invalid = ev.compute_total_results(res_path)
            totals[(tag, beam)] = (total, valid, invalid)
            print(f"[{tag} beam{beam}] identity total/valid/invalid%: "
                  f"{total} / {valid} / {invalid} ({dt:.3f} s on {device_name(device)})")

            # fold into the reference's accuracy_results_all schema
            all_path = out_dir / f"accuracy_results_all.{tag}.beam{beam}.json"
            all_res = {}
            if all_path.exists():
                all_res = json.loads(all_path.read_text())
            all_res.setdefault(depth_key, {})[args.data_type] = [total, valid, invalid]
            all_path.write_text(json.dumps(all_res, indent=2))
            print(f"aggregated -> {all_path}")
    return totals


if __name__ == "__main__":
    main()
