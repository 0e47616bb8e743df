"""Training throughput and device memory a data type, on the GPU.

Counterpart of the repo root's tools/train_profile.py, which runs the JAX
package (the reference's manual profiling script: a short fit a data type
with a wall timer, reference: test_training_memory_time.py:55-71). For
each data type of ``--data-types`` the port's ``Trainer``
(training/loop.py) takes one warm-up step (the card's first use; timed on
its own as ``compile_plus_first_step_s``), then ``--steps`` timed steps on
``SnippetBatchGenerator.from_config`` batches of ``--batch-size``, an epoch
started again where it runs out; then one ``validate_on_batch`` (the
encoders on the f32 BiLSTM kernel on the card, a plain greedy decode),
timed as ``validation_step_s``. A train step itself runs the plain encoders
under autograd: no hand-written kernel.

Reports per data type: steps/s, examples/s, the last step's loss
(``final_loss``) and ``device_memory``, ``{device: {"bytes_in_use",
"peak_bytes_in_use"}}`` from ``torch.cuda.memory_allocated`` and
``max_memory_allocated`` (null on the CPU; the peak is reset before each
data type).

The data: ``--files-info`` or the files-info under ``--data-dir`` (alias
``--dataset``; ``train/files_info.snippets.stride_6.json``, else
``files_info.all_train.json``, else ``files_info.snippets.stride_6.json``,
as tools/make_dataset.py and data/chiron.py write them); the snippet
cache goes to ``.cache`` beside the files-info. The model is the flagship
with the data type's input, on ``--weights`` (an npz of the JAX tree, or a
port checkpoint directory) or weights seeded from ``--seed``, trained with
TrainConfig's defaults (scheduled sampling at p = 0.5, whose draws differ
from jax.random's; ``run_profile(teacher_forcing=1.0)`` trains as the JAX
trainer does).
Runs on the first CUDA device unless ``--cpu`` or ``--device``. Prints a
line a data type and ONE JSON line last, ``{"device": ..., "results":
[...]}``; writes a file only where ``--out`` names one.

  python -m ravvent_tpu_torch.tools.train_profile --data-dir DS
      [--data-types raw,event,joint] [--steps 30] [--batch-size 128]
      [--weights w.npz | --seed 22] [--out PATH] [--cpu | --device DEV]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from timeit import default_timer as timer
from typing import Optional

import torch

from ravvent_tpu_torch.config import DataConfig, ModelConfig, RunConfig, TrainConfig
from ravvent_tpu_torch.data.generator import SnippetBatchGenerator
from ravvent_tpu_torch.evaluation.basecall import resolve_device
from ravvent_tpu_torch.tools import bench
from ravvent_tpu_torch.tools.common import add_bench_flags, load_params, tool_device
from ravvent_tpu_torch.training.loop import Trainer


def device_memory(device: torch.device) -> dict:
    """Live and peak bytes the caching allocator holds on the card; null
    on the CPU."""
    cuda = device.type == "cuda"
    return {str(device): {"bytes_in_use": torch.cuda.memory_allocated(device) if cuda else None,
                          "peak_bytes_in_use": (torch.cuda.max_memory_allocated(device)
                                                if cuda else None)}}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def find_files_info(data_dir) -> str:
    """The training files-info of a dataset directory (see the module's
    docstring)."""
    ds = Path(data_dir)
    for fi in (ds / "train" / "files_info.snippets.stride_6.json",
               ds / "files_info.all_train.json", ds / "files_info.snippets.stride_6.json"):
        if fi.exists():
            return str(fi)
    sys.exit(f"no files_info found under {ds}")


def profile_type(data_type: str, files_info: str, cache: str, steps: int, batch_size: int,
                 device: torch.device, model: ModelConfig, params=None, seed: int = 22,
                 learning_rate: float = TrainConfig.learning_rate,
                 teacher_forcing: float = TrainConfig.teacher_forcing) -> dict:
    """One warm-up step, ``steps`` timed steps and one validation batch of
    a data type (the module's docstring)."""
    cfg = RunConfig(
        data=DataConfig(batch_size=batch_size),
        model=dataclasses.replace(model, data_type=data_type),
        train=TrainConfig(batch_size=batch_size, steps_per_epoch=steps,
                          learning_rate=learning_rate, teacher_forcing=teacher_forcing,
                          random_seed=seed))
    gen = SnippetBatchGenerator.from_config(files_info, cfg.data, cache_dir=cache)
    trainer = Trainer(cfg, params=params, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    it = iter(gen.epoch())

    def next_batch():
        nonlocal it
        try:
            return next(it)
        except StopIteration:
            it = iter(gen.epoch())
            return next(it)

    t0 = timer()
    trainer.train_on_batch(next_batch())
    sync(device)
    t_first = timer() - t0

    losses = []
    t0 = timer()
    for _ in range(steps):
        losses.append(trainer.train_on_batch(next_batch())["loss"])
    sync(device)
    dt = timer() - t0

    batch = next_batch()
    t0 = timer()
    val = trainer.validate_on_batch(batch)
    sync(device)
    t_val = timer() - t0
    return {
        "data_type": data_type,
        "steps": steps,
        "batch_size": batch_size,
        "compile_plus_first_step_s": t_first,
        "train_time_s": dt,
        "steps_per_s": steps / dt,
        "examples_per_s": steps * batch_size / dt,
        "final_loss": float(losses[-1]),
        "validation_step_s": t_val,
        "validation_loss": float(val["loss"]),
        "device_memory": device_memory(device),
    }


def run_profile(files_info: str, cache: str, data_types, steps: int, batch_size: int,
                device=None, model: Optional[ModelConfig] = None, weights: Optional[str] = None,
                seed: int = 22, learning_rate: float = TrainConfig.learning_rate,
                teacher_forcing: float = TrainConfig.teacher_forcing) -> dict:
    """Every data type's profile (:func:`profile_type`)."""
    device = resolve_device(device)
    model = model or bench.FLAGSHIP
    params = load_params(weights) if weights else None
    results = []
    for data_type in data_types:
        r = profile_type(data_type, files_info, cache, steps, batch_size, device, model, params,
                         seed, learning_rate, teacher_forcing)
        results.append(r)
        print(f"{data_type}: {r['steps_per_s']:.2f} steps/s ({r['examples_per_s']:.0f} ex/s), "
              f"first step {r['compile_plus_first_step_s']:.1f}s, loss {r['final_loss']:.4f}",
              flush=True)
    return {"device": bench.device_line(device), "results": results}


def main(argv=None) -> dict:
    """Run the profile; returns the printed object."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--files-info", default=None, help="the training files-info (default: found "
                                                       "under --data-dir)")
    ap.add_argument("--data-types", default="raw,event,joint")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--out", default=None, help="also write the JSON there")
    add_bench_flags(ap, "datasets/sim_lambda")
    ap.add_argument("--dataset", dest="data_dir", help="the same as --data-dir")
    ap.set_defaults(seed=TrainConfig.random_seed)
    args = ap.parse_args(argv)
    files_info = args.files_info or find_files_info(args.data_dir)
    out = run_profile(files_info, str(Path(files_info).parent / ".cache"),
                      args.data_types.split(","), args.steps, args.batch_size,
                      tool_device(args), weights=args.weights, seed=args.seed)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=2))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
