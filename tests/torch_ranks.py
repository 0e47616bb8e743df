"""Rank functions the port's multi-process tests spawn
(ravvent_tpu_torch.parallel.distributed.spawn): importable without JAX, so
a spawned rank starts in about as long as torch takes to import. Each rank
joins a gloo group on the CPU (or an NCCL group, one card a rank, in
tests/test_torch_multigpu.py) and writes what it saw to ``out_dir``."""

import json
from pathlib import Path

import numpy as np
import torch

from ravvent_tpu_torch import weights
from ravvent_tpu_torch.parallel import distributed


def gather_rank(rank, world_size, init_method, out_dir, per_rank, backend="gloo"):
    """gather_read_results of this rank's list of ``per_rank``."""
    torch.set_num_threads(1)
    distributed.initialize(init_method, world_size, rank, backend)
    try:
        assert distributed.process_info() == (rank, world_size)
        got = distributed.gather_read_results(per_rank[rank])
        (Path(out_dir) / f"gather{rank}.json").write_text(json.dumps(got))
    finally:
        torch.distributed.destroy_process_group()


def dp_rank(rank, world_size, init_method, out_dir, cfg, params, batch, steps, fit_dir=None):
    """``steps`` data-parallel train steps on ``batch`` from ``params``
    (rank 0's; the other ranks start from other weights and another
    generator seed, which the trainer's broadcast replaces), then a
    validation; the metrics and the parameters to ``out_dir/rank{rank}.npz``.
    With ``fit_dir``, then a fit of one epoch of two steps writing its CSV
    log and checkpoints there."""
    from ravvent_tpu_torch.training.checkpoints import CheckpointManager
    from ravvent_tpu_torch.training.loop import Trainer

    torch.set_num_threads(1)
    distributed.initialize(init_method, world_size, rank, "gloo")
    try:
        start = weights.unflatten(params) if rank == 0 else None
        tr = Trainer(cfg, params=start, device="cpu", seed=None if rank == 0 else 100 + rank)
        ms = [tr.train_on_batch(batch) for _ in range(steps)]
        v = tr.validate_on_batch(batch)
        out = {"loss": [float(m["loss"]) for m in ms], "acc": [float(m["acc"]) for m in ms],
               "val": [float(v["loss"]), float(v["acc"])]}
        if fit_dir is not None:
            class Repeat:
                def steps(self, n):
                    return (batch for _ in range(n))

            hist = tr.fit(Repeat(), Repeat(), epochs=1, steps_per_epoch=2, validation_steps=1,
                          csv_log_path=str(Path(fit_dir) / f"log{rank}.csv"),
                          checkpoint_manager=CheckpointManager(str(Path(fit_dir) / "ckpt")),
                          verbose=False)
            out["fit"] = [hist[k][0] for k in ("loss", "acc", "val_loss", "val_acc")]
        np.savez(Path(out_dir) / f"rank{rank}.npz", **{k: np.asarray(v) for k, v in out.items()},
                 **{"param/" + k: v for k, v in weights.flatten(tr.params).items()})
    finally:
        torch.distributed.destroy_process_group()


def card_dp_rank(rank, world_size, init_method, out_dir, params, batch, model_shards=1):
    """A rank of the flagship at TrainConfig's defaults on card ``rank``
    (NCCL), data-parallel or, with ``model_shards > 1``, on a grid of
    ``world_size / model_shards`` data shards by ``model_shards`` model
    ranks: a validation, then one train step, on its rows of the global
    ``batch``, from rank 0's ``params`` (the other ranks start from other
    weights and another generator seed, which the trainer's broadcast
    replaces); the metrics, the all-reduced gradients and the updated
    parameters to ``out_dir/rank{rank}.npz``."""
    import dataclasses

    from ravvent_tpu_torch.config import RunConfig
    from ravvent_tpu_torch.training.loop import Trainer

    distributed.initialize(init_method, world_size, rank, "nccl")
    try:
        cfg = RunConfig()
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, num_data_shards=world_size // model_shards))
        start = weights.unflatten(params) if rank == 0 else None
        tr = Trainer(cfg, params=start, seed=None if rank == 0 else 100 + rank,
                     model_shards=model_shards)
        v = tr.validate_on_batch(batch)
        out, grads = tr.loss_and_grads(batch)
        tr.apply_gradients(grads)
        torch.cuda.synchronize()
        got = {"card": torch.cuda.current_device(), "loss": float(out.loss),
               "acc": float(out.acc), "val": [float(v["loss"]), float(v["acc"])]}
        got.update({"grad/" + k: g for k, g in weights.flatten(grads).items()})
        got.update({"param/" + k: p for k, p in weights.flatten(tr.params).items()})
        np.savez(Path(out_dir) / f"rank{rank}.npz", **got)
    finally:
        torch.distributed.destroy_process_group()


def attention_rank(rank, world_size, init_method, out_dir, cases):
    """The attention over a memory whose positions are sharded over the
    ``world_size`` ranks of one model row: for each (name, attention type,
    attention params, memory, mask, query, cotangent) of ``cases``, the
    context and this rank's alignments, and the gradients of ``(context *
    cotangent).sum()`` with respect to the query, the memory and the
    attention's parameters, to ``out_dir/attn{rank}.npz``."""
    from ravvent_tpu_torch.models import attention as attn
    from ravvent_tpu_torch.models.basecaller import shard_attention

    torch.set_num_threads(1)
    distributed.initialize(init_method, world_size, rank, "gloo")
    try:
        _, axis = distributed.grid_axes(1, world_size)
        out = {}
        for name, kind, params, memory, mask, query, cot in cases:
            params = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
            memory = torch.tensor(memory, requires_grad=True)
            query = torch.tensor(query, requires_grad=True)
            dec, mem, msk = shard_attention({"attention": params}, memory, torch.tensor(mask),
                                            axis)
            context, align = attn.attend_beams(dec["attention"], kind, query,
                                               attn.setup_memory(dec["attention"], mem, msk),
                                               axis)
            leaves = [query, memory] + list(params.values())
            grads = torch.autograd.grad((context * torch.tensor(cot)).sum(), leaves)
            out[name + "/context"] = context.detach().numpy()
            out[name + "/align"] = align.detach().numpy()
            for k, g in zip(["query", "memory"] + list(params), grads):
                out[f"{name}/grad/{k}"] = g.numpy()
        np.savez(Path(out_dir) / f"attn{rank}.npz", **out)
    finally:
        torch.distributed.destroy_process_group()


def grid_rank(rank, world_size, init_method, out_dir, cfgs, model_shards, params, batch):
    """A rank of a (num_data_shards x model_shards) grid, for each config
    ``i`` of ``cfgs``: a validation, then one train step, on ``batch`` from
    rank 0's ``params`` (the other ranks start from other weights and
    another generator seed, which the trainer's broadcast replaces); the
    metrics, the gradients and the updated parameters to
    ``out_dir/rank{rank}_{i}.npz``."""
    from ravvent_tpu_torch.training.loop import Trainer

    torch.set_num_threads(1)
    distributed.initialize(init_method, world_size, rank, "gloo")
    try:
        for i, cfg in enumerate(cfgs):
            start = weights.unflatten(params) if rank == 0 else None
            tr = Trainer(cfg, params=start, device="cpu", seed=None if rank == 0 else 100 + rank,
                         model_shards=model_shards)
            v = tr.validate_on_batch(batch)
            out, grads = tr.loss_and_grads(batch)
            tr.apply_gradients(grads)
            got = {"loss": float(out.loss.detach()), "acc": float(out.acc),
                   "val": [float(v["loss"]), float(v["acc"])]}
            got.update({"grad/" + k: g for k, g in weights.flatten(grads).items()})
            got.update({"param/" + k: p for k, p in weights.flatten(tr.params).items()})
            np.savez(Path(out_dir) / f"rank{rank}_{i}.npz", **got)
    finally:
        torch.distributed.destroy_process_group()
