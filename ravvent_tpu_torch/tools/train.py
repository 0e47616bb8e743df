"""Training CLI, on the GPU: the reference's ``ravvent.py`` as a tool.

Counterpart of tools/train.py of the JAX package, with every flag of it. The
run name comes from the hyperparameters (reference: ravvent.py:11-88), the
generator-fed fit loop writes a checkpoint every epoch at
``RunConfig.checkpoint_path(epoch)`` and the CSV log
``<info-dir>/csvlog.<run_name>.log``. One process on one card
(training/loop.py:Trainer); ``--cpu`` runs on the CPU. A dataset that is
missing is built first (ravvent_tpu_torch/tools/make_dataset.py:build).

Checkpoints are the port's (training/checkpoints.py: ``params.npz`` +
``state.pt``):
- ``--resume-epoch E`` / ``--resume-path DIR`` restore the parameters, the
  Adam state and the trainer's generator, and the run starts at epoch E.
  The batch streams start where the uninterrupted run's stood after E
  epochs (``SnippetBatchGenerator.skip``), so a resumed run repeats the
  uninterrupted one (the JAX CLI starts them anew);
- ``--init-from`` takes a checkpoint directory or an npz of weights
  (``weights.save_npz``): its parameters only, with a fresh optimizer;
- ``--export-flagship DIR`` saves the final parameters as a checkpoint.
A JAX Orbax checkpoint crosses through ``weights.from_jax_params`` and
``weights.save_npz`` where JAX is installed (README).

Typical flagship run:
  python -m ravvent_tpu_torch.tools.train --dataset datasets/sim_lambda \
      --data-type joint --epochs 10 --steps-per-epoch 500 --lr 5e-4
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from ravvent_tpu_torch.config import DataConfig, RunConfig, TrainConfig
from ravvent_tpu_torch.data.generator import SnippetBatchGenerator
from ravvent_tpu_torch.evaluation.basecall import resolve_device
from ravvent_tpu_torch.tools.common import add_model_flags, device_name, load_params, model_config
from ravvent_tpu_torch.training.checkpoints import CheckpointManager
from ravvent_tpu_torch.training.loop import Trainer


def run_config(args) -> RunConfig:
    return RunConfig(
        data=DataConfig(batch_size=args.batch_size),
        model=model_config(args),
        train=TrainConfig(
            teacher_forcing=args.teacher_forcing, learning_rate=args.lr,
            batch_size=args.batch_size, epochs=args.epochs,
            steps_per_epoch=args.steps_per_epoch,
            validation_steps=args.validation_steps, random_seed=args.seed,
            dataset_tag=args.dataset_tag,
            checkpoint_dir=args.checkpoint_dir, info_dir=args.info_dir,
        ),
    )


def batches(files_info: Path, cfg: DataConfig, cache: str):
    """The index's batch generator; None when the index is missing or makes
    no batch (a split of too few reads), which would never yield one."""
    if not files_info.exists():
        return None
    gen = SnippetBatchGenerator.from_config(str(files_info), cfg, cache_dir=cache)
    if not len(gen):
        print(f"{files_info} makes no batch of {cfg.batch_size}: not used")
        return None
    return gen


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="datasets/sim_lambda")
    ap.add_argument("--files-info", default=None,
                    help="explicit training files_info JSON (default: <dataset>/train/...)")
    ap.add_argument("--dataset-tag", default="lambda",
                    help="dataset tag in the run-name schema (reference: ravvent.py:31)")
    add_model_flags(ap, attention=True)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--steps-per-epoch", type=int, default=500)
    ap.add_argument("--validation-steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--teacher-forcing", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=22)
    ap.add_argument("--cpu", action="store_true", help="train on the CPU instead of the GPU")
    ap.add_argument("--resume-epoch", type=int, default=0)
    ap.add_argument("--resume-path", default=None,
                    help="explicit checkpoint dir to resume from (overrides the run-name schema)")
    ap.add_argument("--init-from", default=None,
                    help="params-only checkpoint dir or npz to warm-start from (fresh "
                         "optimizer; e.g. seed a joint model from a trained raw model)")
    ap.add_argument("--checkpoint-dir", default="models")
    ap.add_argument("--info-dir", default="info")
    ap.add_argument("--export-flagship", default=None,
                    help="also save final params to this dir (e.g. checkpoints/flagship)")
    return ap


def main(argv=None) -> dict:
    """Train; returns ``fit``'s history."""
    args = parser().parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    cfg = run_config(args)
    print("RUNNING", cfg.run_name, flush=True)
    print("device:", device, device_name(device), flush=True)

    ds = Path(args.dataset)
    fi_train = (
        Path(args.files_info) if args.files_info
        else ds / "train" / "files_info.snippets.stride_6.json"
    )
    fi_val = ds / "eval" / "files_info.val.snippets.stride_6.json"
    if not fi_train.exists():
        print("dataset missing — building it first (tools/make_dataset.py)")
        from ravvent_tpu_torch.tools.make_dataset import build

        build(ds)

    cache = str(ds / ".cache")
    gen = SnippetBatchGenerator.from_config(str(fi_train), cfg.data, cache_dir=cache)
    val = batches(fi_val, cfg.data, cache)

    trainer = Trainer(cfg, device=device)
    cm = CheckpointManager(".")
    if args.init_from:
        # Params-only warm start (e.g. seed a joint model from a trained raw
        # model: the params tree carries both encoders regardless of
        # data_type, so trees are interchangeable across modalities).
        trainer.load_state({"params": load_params(args.init_from)})
        print(f"warm-started params from {args.init_from}")
    if args.resume_epoch > 0 or args.resume_path:
        state = cm.restore(args.resume_path or cfg.checkpoint_path(args.resume_epoch))
        trainer.load_state(state)
        print(f"resumed from epoch {int(state['epoch'])}")
        gen.skip(args.resume_epoch * args.steps_per_epoch)
        if val is not None:
            val.skip(args.resume_epoch * args.validation_steps)

    t0 = time.time()
    history = trainer.fit(
        gen, val,
        epochs=args.epochs,
        steps_per_epoch=args.steps_per_epoch,
        validation_steps=args.validation_steps,
        initial_epoch=args.resume_epoch,
        csv_log_path=f"{args.info_dir}/csvlog.{cfg.run_name}.log",
        checkpoint_manager=cm,
    )
    print(f"training done in {time.time() - t0:.0f}s")

    if args.export_flagship:
        out = Path(args.export_flagship)
        CheckpointManager(str(out.parent)).save(out.name, trainer.params, epoch=args.epochs)
        print(f"flagship params exported to {out}")
    return history


if __name__ == "__main__":
    main()
