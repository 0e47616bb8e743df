"""Build the accuracy-results table in the reference's schema, on the GPU.

Counterpart of the repo root's tools/make_results_table.py, which runs the
JAX package, with its flags. The reference's regression oracle is four JSON
files (``accuracy_results_all.{lambda,ecoli}.beam{1,5}.json``) laid out as
``{"(encd, decd)": {data_type: [identity_total, identity_valid, invalid%]}}``
(reference: analyse_accuracies.py:144-180; ravvent_mapping_evaluator.py:
130-174). For every (data type, encoder depth, decoder depth) of
``--configs`` whose checkpoint is in the registry, the tool runs read-level
beam evaluation over each dataset at each beam width of ``--beams``, writes
the per-read results under ``per_read/``, folds the totals into the JSONs
already in ``--results-dir`` and renders ``ACCURACY.md`` from every merged
JSON there.

The registry, under ``--checkpoints-dir``: ``best.<data_type><encd><decd>``,
then ``flagship`` for (joint, 2, 1) and ``flagship32`` for (joint, 3, 2),
each a port checkpoint directory (one holding ``params.npz``) or
``<name>.npz`` (weights.save_npz). An Orbax directory is not a checkpoint to
the port: the configuration is skipped, and its stderr line says why.

The datasets are the JAX tool's two, ``sim_lambda`` and ``sim_ecoli``,
unless ``--dataset TAG=FILES_INFO`` (repeatable) names others;
``--datasets`` picks among them. The engine keeps the JAX tool's numerics
(tools/common.py:eval_engine: f32 memory and encoder, chunks of 1024 rows),
decoding with the beam-step kernels where the configuration allows it and
with the plain beam decode otherwise (a depth-2 decoder): each engine's
choice is printed. Runs on the first CUDA device unless ``--cpu`` or
``--device``. ``main`` returns this run's totals, ``{(dataset, beam):
{"(encd, decd)": {data_type: [total, valid, invalid%]}}}``.

  python -m ravvent_tpu_torch.tools.make_results_table \\
      --dataset lambda=datasets/sim_lambda/eval/files_info.test.snippets.stride_6.json \\
      [--configs joint:2:1,raw:2:1] [--beams 1,5] [--checkpoints-dir checkpoints] \\
      [--results-dir info/accuracy_table] [--cpu | --device DEV]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Tuple

from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
from ravvent_tpu_torch.tools.common import (
    add_device_flags, device_name, eval_engine, load_params, tool_device,
)
from ravvent_tpu_torch.training.checkpoints import PARAMS_FILE

DATASETS = {
    "sim_lambda": "datasets/sim_lambda/eval/files_info.test.snippets.stride_6.json",
    "sim_ecoli": "datasets/sim_ecoli/test/files_info.snippets.stride_6.json",
}
TAGS = {"sim_lambda": "lambda", "sim_ecoli": "ecoli"}
FALLBACKS = {("joint", 2, 1): "flagship", ("joint", 3, 2): "flagship32"}


def checkpoint_for(checkpoints_dir, data_type: str, encd: int,
                   decd: int) -> Tuple[Optional[Path], str]:
    """(the configuration's weights, "") or (None, why there are none): the
    first name of the registry that is a directory holding ``params.npz``
    or a ``.npz`` file."""
    names = [f"best.{data_type}{encd}{decd}"]
    if (data_type, encd, decd) in FALLBACKS:
        names.append(FALLBACKS[(data_type, encd, decd)])
    root = Path(checkpoints_dir)
    why = []
    for name in names:
        d, npz = root / name, root / f"{name}.npz"
        if (d / PARAMS_FILE).is_file():
            return d, ""
        if npz.is_file():
            return npz, ""
        if d.is_dir():
            why.append(f"{d} holds no {PARAMS_FILE} (an Orbax checkpoint, which the port does "
                       "not read: export it with weights.save_npz)")
    return None, "; ".join(why) or f"none of {', '.join(names)} (a directory or .npz) in {root}"


def render_table(out_dir: Path) -> str:
    """ACCURACY.md from every merged JSON in ``out_dir``, as the JAX tool
    renders it."""
    lines = ["# Accuracy results (ref-length-weighted minimap2-convention identity)",
             "", "Identity (total) per config; reference schema "
             "`accuracy_results_all.*.json` files alongside.", ""]
    for p in sorted(out_dir.glob("accuracy_results_all.*.json")):
        _, tag, beam_tag, _ = p.name.split(".")
        merged = json.loads(p.read_text())
        lines.append(f"## {tag}, {beam_tag.replace('beam', 'beam ')}")
        lines.append("")
        lines.append("| depths | raw | event | joint |")
        lines.append("|---|---|---|---|")
        for key in sorted(merged):
            row = merged[key]
            cells = [str(row.get(dt, ["-"])[0]) for dt in ("raw", "event", "joint")]
            lines.append(f"| {key} | " + " | ".join(cells) + " |")
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results-dir", default="info/accuracy_table",
                    help="where the tables are written and folded (not results/, which holds "
                         "the committed ones)")
    ap.add_argument("--configs",
                    default="joint:2:1,raw:2:1,event:2:1,joint:3:2,raw:3:2,event:3:2")
    ap.add_argument("--beams", default="1,5")
    ap.add_argument("--datasets", default=None,
                    help="comma-separated names of the datasets to run (default: all)")
    ap.add_argument("--dataset", action="append", default=[], metavar="TAG=FILES_INFO",
                    help="a dataset to run, replacing the default two (repeatable)")
    ap.add_argument("--checkpoints-dir", default="checkpoints")
    add_device_flags(ap)
    args = ap.parse_args(argv)

    device = tool_device(args)
    datasets = dict(DATASETS)
    if args.dataset:
        datasets = dict(spec.split("=", 1) for spec in args.dataset)
    names = args.datasets.split(",") if args.datasets else list(datasets)
    out_dir = Path(args.results_dir)
    (out_dir / "per_read").mkdir(parents=True, exist_ok=True)
    beams = [int(b) for b in args.beams.split(",")]
    configs = []
    for c in args.configs.split(","):
        dt, encd, decd = c.split(":")
        configs.append((dt, int(encd), int(decd)))

    tables = {}  # (dataset, beam) -> {depth_key: {dt: [total, valid, invalid]}}
    for dt, encd, decd in configs:
        ckpt, why = checkpoint_for(args.checkpoints_dir, dt, encd, decd)
        if ckpt is None:
            print(f"skip {dt} ({encd},{decd}): no checkpoint: {why}", file=sys.stderr)
            continue
        cfg = ModelConfig(enc_units=128, dec_units=128, encoder_depth=encd,
                          decoder_depth=decd, data_type=dt)
        engine = eval_engine(load_params(ckpt), cfg, device, beams)
        print(f"{dt} ({encd},{decd}): {ckpt}, beam_impl={engine.beam_impl} on {device} "
              f"({device_name(device)})", file=sys.stderr)
        for beam in beams:
            ev = MappingEvaluator(engine, beam_width=beam)
            for ds in names:
                res = out_dir / "per_read" / (
                    f"mapping.{ds}.{dt}.encd{encd}.decd{decd}.beam{beam}.json")
                res.unlink(missing_ok=True)
                ev.evaluate_files(datasets[ds], res, verbose=False)
                total, valid, invalid = ev.compute_total_results(res)
                key = f"({encd}, {decd})"
                tables.setdefault((ds, beam), {}).setdefault(key, {})[dt] = [
                    total, valid, invalid]
                print(f"{ds} beam{beam} {dt} ({encd},{decd}): "
                      f"{total} / {valid} / {invalid}%", flush=True)

    for (ds, beam), table in tables.items():
        p = out_dir / f"accuracy_results_all.{TAGS.get(ds, ds)}.beam{beam}.json"
        merged = json.loads(p.read_text()) if p.exists() else {}
        for k, v in table.items():
            merged.setdefault(k, {}).update(v)
        p.write_text(json.dumps(merged, indent=2))
        print(f"wrote {p}")

    # rendered from the merged JSONs, so partial (re)runs still give the whole table
    (out_dir / "ACCURACY.md").write_text(render_table(out_dir))
    print(f"wrote {out_dir / 'ACCURACY.md'}")
    return tables


if __name__ == "__main__":
    main()
