"""Epoch-sweep model selection by mapping identity, on the GPU.

Counterpart of tools/sweep_epochs.py of the JAX package. The reference
sweeps per-epoch checkpoints with the mapping evaluator and keeps the best
epoch per configuration (reference: ravvent_mapping_evaluator.py:203-237
``evaluate_specific``). This tool does the same over the run-name schema:
for each requested epoch it restores the port checkpoint
``<checkpoint-dir>/snippets/mask/encd_E_decd_D/<run-name>.<epoch:02d>``
(training/checkpoints.py), runs read-level beam evaluation over a held-out
files_info index, and reports ref-length-weighted identity; ``--export-best``
saves the winner's parameters as a checkpoint.

Select on a held-out *selection* set, report on the *test* set, and select
by identity, not val_loss (they diverge; see docs/TRAINING.md). The engine
keeps the JAX tool's numerics, f32 memory and encoder with chunks of 1024
rows, on the beam-step kernels where the configuration allows it and the
plain beam decode otherwise (evaluation/basecall.py:kernels_serve). Runs on the
first CUDA device unless ``--cpu`` is given.

  python -m ravvent_tpu_torch.tools.sweep_epochs --run-name model.1.joint.lambda...spv16 \
      --epochs 44,46,48 --files-info datasets/sim_lambda/eval2/files_info...json \
      --data-type joint --export-best checkpoints/flagship
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

from ravvent_tpu_torch.evaluation.basecall import resolve_device
from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
from ravvent_tpu_torch.tools.common import add_model_flags, eval_engine, load_params, model_config
from ravvent_tpu_torch.training.checkpoints import CheckpointManager


def main(argv=None) -> dict:
    """Sweep; returns {epoch: {"total", "valid", "invalid_pct"}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-name", required=True,
                    help="checkpoint run name without the trailing .<epoch>")
    ap.add_argument("--epochs", required=True,
                    help="comma-separated epoch list, e.g. 44,46,48")
    ap.add_argument("--files-info", required=True)
    add_model_flags(ap, rnn_type=False)
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--checkpoint-dir", default="models")
    ap.add_argument("--export-best", default=None,
                    help="save the best epoch's params to this checkpoint dir")
    ap.add_argument("--out", default=None, help="write the sweep table to this JSON")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    cfg = model_config(args)
    base = (Path(args.checkpoint_dir) / "snippets" / "mask"
            / f"encd_{args.encoder_depth}_decd_{args.decoder_depth}")

    results = {}
    best_params = best_ep = None
    with tempfile.TemporaryDirectory() as tmp:
        for ep in [int(e) for e in args.epochs.split(",")]:
            # training saves zero-padded epoch dirs (reference {epoch:02d} schema)
            name = f"{args.run_name}.{ep:02d}"
            if not (base / name).exists():
                name = f"{args.run_name}.{ep}"
            if not (base / name).exists():
                print(f"epoch {ep}: checkpoint missing ({base / name})", file=sys.stderr)
                continue
            params = load_params(base / name)
            engine = eval_engine(params, cfg, device, [args.beam])
            ev = MappingEvaluator(engine, beam_width=args.beam)
            res = Path(tmp) / f"sweep_epochs.{args.data_type}.{ep}.json"
            ev.evaluate_files(args.files_info, res)
            total, valid, invalid = ev.compute_total_results(res)
            results[ep] = {"total": total, "valid": valid, "invalid_pct": invalid}
            print(f"epoch {ep}: identity {total} (valid {valid}, invalid {invalid}%)",
                  flush=True)
            if best_ep is None or total > results[best_ep]["total"]:
                best_ep, best_params = ep, params

    if not results:
        sys.exit("no checkpoints evaluated")
    print(f"best epoch: {best_ep} identity {results[best_ep]['total']}")
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"run_name": args.run_name, "results": results, "best": best_ep},
            indent=2))
    if args.export_best:
        out = Path(args.export_best)
        CheckpointManager(str(out.parent)).save(out.name, best_params, epoch=best_ep)
        print(f"exported epoch {best_ep} -> {out}")
    return results


if __name__ == "__main__":
    main()
