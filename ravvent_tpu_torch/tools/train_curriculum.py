"""Staged-curriculum training and identity-based epoch selection, one
process, on the GPU.

Counterpart of tools/train_curriculum.py of the JAX package. The recipe of
this model family (docs/TRAINING.md): teacher-forced pretrain,
scheduled-sampling fine-tune, then anneal the sampling probability; each
stage warm-starts from the previous one (parameters, Adam moments and the
trainer's generator), mirroring the reference's chained runs (reference:
ravvent.py:57-59 resume pattern, rename_models.py epoch chaining). The bad-
basin rule restarts the whole curriculum with the next seed when the first
trained stage ends below ``--restart-below`` train accuracy
(``restart_log.json``). After the last stage the trailing epochs are swept
by held-out mapping identity (the reference's ``evaluate_specific`` sweep,
ravvent_mapping_evaluator.py:203-237), the summary goes to
``curriculum_summary.json`` with the JAX tool's keys, and ``--export``
saves the best epoch's parameters as a checkpoint.

Checkpoints are the port's (training/checkpoints.py); ``--init-from`` takes
a checkpoint directory or an npz of weights. The sweep's engine keeps the
JAX tool's numerics, f32 memory and encoder with chunks of 1024 rows, on the
beam-step kernels where the configuration allows it and the plain beam
decode otherwise (evaluation/basecall.py:kernels_serve). Runs on the first
CUDA device unless ``--cpu`` is given.

One model, one command:
  python -m ravvent_tpu_torch.tools.train_curriculum --dataset datasets/ref45 \
      --tag ref45 --data-type joint --export checkpoints/ref45_joint
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from ravvent_tpu_torch.config import DataConfig, RunConfig, TrainConfig
from ravvent_tpu_torch.data.generator import SnippetBatchGenerator
from ravvent_tpu_torch.evaluation.basecall import resolve_device
from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
from ravvent_tpu_torch.tools.common import (
    add_model_flags, device_name, eval_engine, load_params, model_config,
)
from ravvent_tpu_torch.tools.train import batches
from ravvent_tpu_torch.training.checkpoints import CheckpointManager
from ravvent_tpu_torch.training.loop import Trainer

# (teacher_forcing, lr, epochs, steps_per_epoch) — docs/TRAINING.md curriculum
DEFAULT_STAGES = [
    (1.0, 2e-3, 10, 500),
    (0.5, 5e-4, 12, 500),
    (0.45, 1e-4, 12, 800),
    (0.4, 7e-5, 12, 800),
]


def main(argv=None) -> dict:
    """Run the curriculum; returns the summary written to
    ``curriculum_summary.json``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--tag", required=True, help="dataset tag in run names")
    add_model_flags(ap)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=22)
    ap.add_argument("--stages", default=None,
                    help="JSON [[tf, lr, epochs, steps], ...] overriding the default curriculum")
    ap.add_argument("--sweep-epochs", type=int, default=10,
                    help="trailing epochs swept by val mapping identity")
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--workdir", default=None,
                    help="checkpoint/log root (default runs/<tag>.<type>...)")
    ap.add_argument("--cache-dir", default=None,
                    help="snippet cache dir (default <dataset>/.cache). Use "
                         "a dedicated dir when overriding the event-detector "
                         "config (RAVVENT_ED_W1/W2): the cache is not keyed "
                         "by it")
    ap.add_argument("--export", default=None,
                    help="export the identity-best params here")
    ap.add_argument("--init-from", default=None,
                    help="params checkpoint dir or npz to warm-start stage 1 from")
    ap.add_argument("--skip-stages", type=int, default=0,
                    help="skip the first N stages (resume with --init-from)")
    ap.add_argument("--restart-below", type=float, default=None,
                    help="bad-basin restart rule: if the final stage-1 "
                         "(teacher-forced) epoch's TRAIN acc is below this, "
                         "restart the whole curriculum with seed+1 (0.85 is "
                         "the documented threshold for the 2048-vocab matrix "
                         "protocol)")
    ap.add_argument("--max-restarts", type=int, default=2,
                    help="max bad-basin restarts before accepting the run")
    ap.add_argument("--cpu", action="store_true", help="train on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    stages = json.loads(args.stages) if args.stages else DEFAULT_STAGES
    ds = Path(args.dataset)
    mcfg = model_config(args)
    name = (f"{args.tag}.{args.data_type}.{args.rnn_type}"
            f".encd{args.encoder_depth}.decd{args.decoder_depth}")
    workdir = Path(args.workdir or f"runs/{name}")
    workdir.mkdir(parents=True, exist_ok=True)

    cache = args.cache_dir or str(ds / ".cache")
    fi_train = ds / "train" / "files_info.snippets.stride_6.json"
    fi_val = ds / "eval" / "files_info.val.snippets.stride_6.json"
    dcfg = DataConfig(batch_size=args.batch_size)
    gen = SnippetBatchGenerator.from_config(str(fi_train), dcfg, cache_dir=cache)
    val_gen = batches(fi_val, dcfg, cache)

    print(f"curriculum {name}: {len(stages)} stages on {device} ({device_name(device)})",
          flush=True)
    cm = CheckpointManager(str(workdir))
    warm_params = None  # --init-from snapshot for bad-basin restarts
    if args.init_from:
        warm_params = load_params(args.init_from)
        print(f"warm-started from {args.init_from}", flush=True)

    restart_log = []
    t_start = time.time()
    for attempt in range(max(0, args.max_restarts) + 1):
        seed = args.seed + attempt
        carried = {"params": warm_params} if warm_params is not None else None
        epoch_ckpts = []  # (global_epoch, checkpoint_path)
        history_all = []
        epoch_base = 0
        restarted = False
        for si, (tf, lr, n_epochs, spe) in enumerate(stages):
            if si < args.skip_stages:
                epoch_base += n_epochs
                continue
            cfg = RunConfig(
                data=dcfg, model=mcfg,
                train=TrainConfig(
                    teacher_forcing=tf, learning_rate=lr, batch_size=args.batch_size,
                    epochs=epoch_base + n_epochs, steps_per_epoch=spe,
                    validation_steps=8, random_seed=seed,
                    dataset_tag=args.tag, checkpoint_dir=str(workdir),
                    info_dir=str(workdir),
                ),
            )
            trainer = Trainer(cfg, device=device)
            if carried is not None:
                # parameters, and after a stage its Adam moments and generator
                trainer.load_state(carried)
            print(f"--- stage {si + 1}/{len(stages)}: tf={tf} lr={lr} "
                  f"{n_epochs}x{spe} (seed {seed}) ---", flush=True)
            hist = trainer.fit(
                gen, val_gen,
                epochs=epoch_base + n_epochs, steps_per_epoch=spe,
                validation_steps=8, initial_epoch=epoch_base,
                csv_log_path=str(workdir / f"csvlog.{cfg.run_name}.log"),
                checkpoint_manager=cm,
            )
            history_all.append({"stage": si, "tf": tf, "lr": lr, **hist})
            for e in range(epoch_base + 1, epoch_base + n_epochs + 1):
                epoch_ckpts.append((e, cfg.checkpoint_path(e)))
            carried = {"params": trainer.params, "opt_state": trainer.opt_state,
                       "rng": trainer.rng.get_state()}
            epoch_base += n_epochs

            # bad-basin restart rule: checked once, at the end of the first
            # trained stage (the tf=1.0 pretrain), before any
            # scheduled-sampling stage can mask it
            if (si == args.skip_stages and args.restart_below is not None
                    and attempt < args.max_restarts):
                s1_acc = float(hist["acc"][-1]) if hist.get("acc") else 0.0
                fired = s1_acc < args.restart_below
                restart_log.append({
                    "attempt": attempt, "seed": seed,
                    "stage1_final_train_acc": round(s1_acc, 4),
                    "threshold": args.restart_below, "restarted": fired,
                })
                (workdir / "restart_log.json").write_text(
                    json.dumps(restart_log, indent=2))
                if fired:
                    print(f"RESTART: stage-1 train acc {s1_acc:.3f} < "
                          f"{args.restart_below} (bad basin); retrying with "
                          f"seed {seed + 1}", flush=True)
                    restarted = True
                    break
        if not restarted:
            break

    print(f"training done in {time.time() - t_start:.0f}s", flush=True)
    params = carried["params"] if carried is not None else None

    # ---- identity epoch sweep over the trailing checkpoints ----
    sweep = epoch_ckpts[-args.sweep_epochs:] if args.sweep_epochs else []
    best = None
    sweep_rows = []
    if sweep and val_gen is not None:
        for epoch, path in sweep:
            p = cm.restore(path)["params"]
            engine = eval_engine(p, mcfg, device, [args.beam])
            ev = MappingEvaluator(engine, beam_width=args.beam, cache_dir=cache)
            res_path = workdir / f"val_sweep.epoch{epoch:02d}.json"
            ev.evaluate_files(str(fi_val), res_path, verbose=False)
            total, valid, invalid = ev.compute_total_results(res_path)
            sweep_rows.append({"epoch": epoch, "identity_total": total,
                               "identity_valid": valid, "invalid_pct": invalid})
            print(f"epoch {epoch}: val identity {total} ({invalid}% invalid)",
                  flush=True)
            if best is None or total > best[1]:
                best = (epoch, total, path, p)

    summary = {
        "name": name,
        "stages": stages,
        "seed": seed,
        "restarts": restart_log,
        "history": history_all,
        "epoch_sweep": sweep_rows,
        "best_epoch": best[0] if best else None,
        "best_val_identity": best[1] if best else None,
        "wall_s": round(time.time() - t_start, 1),
    }
    (workdir / "curriculum_summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps({k: summary[k] for k in
                      ("name", "best_epoch", "best_val_identity", "wall_s")}))

    if args.export:
        out = Path(args.export)
        exp_params = best[3] if best else params
        exp_epoch = best[0] if best else epoch_base
        CheckpointManager(str(out.parent)).save(out.name, exp_params, epoch=exp_epoch)
        print(f"exported epoch {exp_epoch} -> {out}")
    return summary


if __name__ == "__main__":
    main()
