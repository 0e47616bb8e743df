"""Entry points (counterpart of __graft_entry__.py).

- :func:`entry` -> (fn, example_args): the flagship model's train forward
  step (joint raw+event BiLSTM encoder, LSTM decoder with Luong attention,
  128 units, encoder depth 2, decoder depth 1), ``fn(params, raw, event,
  targets, gen, draws=None) -> (loss, acc)``, at B = 16 on the JAX entry's
  numpy-seeded inputs.
- :func:`dryrun_multichip` spawns n gloo ranks on tiny shapes (16 units on
  the CPU; on the card the flagship's 128, one of the widths the f32 BiLSTM
  kernel is built for, so that each rank's validation runs its encoder on
  that kernel rather than on the plain route other widths take). As the JAX
  dry run does, at n >= 4 and n even the ranks form a grid of n / 2 data
  shards by 2 model ranks (``model_shards=2``: the attention memory's
  positions sharded over each model row), else n data shards. Each rank
  runs one train step and one validation on that grid; then rank 0 decodes
  one simulated read with a :class:`ShardedBasecallEngine` over the same
  mesh (rows split over ``'data'``), on the i8dev wire (4-bit
  probabilities, packed result, pre-projected values) and on the
  signal-only wire, and requires both to equal a single-device engine bit
  for bit.

Usage: ``python -m ravvent_tpu_torch.entry [multichip N] [--cpu]``; the card
unless ``--cpu`` (a dry run's ranks then share the card's devices
round-robin, gloo between them).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ravvent_tpu_torch.config import RunConfig
from ravvent_tpu_torch.evaluation.basecall import resolve_device


def entry(device: Union[str, torch.device, None] = None):
    """The flagship's train forward step and its example arguments (params
    seeded by ``init_basecaller`` from generator seed 0, raw [16, 200, 1],
    event [16, 30, 5], targets [16, 48], a generator seeded 42 for the
    scheduled sampling at p = 0.5) on the card unless ``device`` says
    otherwise."""
    from ravvent_tpu_torch.models.basecaller import init_basecaller, train_forward

    dev = resolve_device(device)
    mcfg = RunConfig().model  # the flagship
    params = init_basecaller(mcfg, torch.Generator().manual_seed(0), device=dev)

    def fn(params, raw, event, targets, gen=None, draws=None):
        out = train_forward(params, raw, event, targets, mcfg, 0.5, gen, draws)
        return out.loss, out.acc

    B = 16
    raw = np.random.default_rng(0).normal(size=(B, 200, 1)).astype(np.float32)
    event = np.random.default_rng(1).normal(size=(B, 30, 5)).astype(np.float32)
    targets = np.random.default_rng(2).integers(3, 7, size=(B, 48)).astype(np.int64)
    targets[:, 0], targets[:, 40] = 2, 1
    gen = torch.Generator(device=dev).manual_seed(42)
    return fn, (params, torch.from_numpy(raw).to(dev), torch.from_numpy(event).to(dev),
                torch.from_numpy(targets).to(dev), gen)


def _rank_device(rank: int, device: Optional[str]) -> torch.device:
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", rank % torch.cuda.device_count())


def _simulated_read():
    """One simulated read (seeded): its raw samples and its compact form
    (data/snippets.py:load_read_compact_ex)."""
    from ravvent_tpu_torch.data import chiron, simulator
    from ravvent_tpu_torch.data.snippets import load_read_compact_ex

    rng = np.random.default_rng(5)
    genome = simulator.random_genome(1500, rng)
    sig, ranges = simulator.simulate_read(genome, rng, simulator.PoreModel())
    with tempfile.TemporaryDirectory() as td:
        d = Path(td)
        chiron.write_read(d / "r.signal", d / "r.label", sig, ranges, genome)
        return sig, load_read_compact_ex(d / "r.signal", d / "r.label", stride=6)


def _dryrun_rank(rank: int, world_size: int, init_method: str, device: Optional[str],
                 units: int) -> None:
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.parallel import distributed
    from ravvent_tpu_torch.parallel.inference import ShardedBasecallEngine
    from ravvent_tpu_torch.parallel.mesh import make_mesh
    from ravvent_tpu_torch.training.loop import Trainer

    if device == "cpu":  # each rank its share of the cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    distributed.initialize(init_method, world_size, rank, "gloo")
    try:
        dev = _rank_device(rank, device)
        cfg = RunConfig()  # the flagship: teacher forcing 0.5, lr 1e-4
        model_shards = 2 if world_size >= 4 and world_size % 2 == 0 else 1
        # narrow on the CPU for a fast step; the sharding structure is the same
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, enc_units=units, dec_units=units),
            train=dataclasses.replace(cfg.train, num_data_shards=world_size // model_shards))
        trainer = Trainer(cfg, device=dev, model_shards=model_shards)
        B = 2 * world_size
        rng = np.random.default_rng(0)
        batch = (rng.normal(size=(B, 40, 1)).astype(np.float32),
                 rng.normal(size=(B, 8, 5)).astype(np.float32),
                 np.concatenate([np.full((B, 1), 2), rng.integers(3, 7, size=(B, 8)),
                                 np.full((B, 1), 1)], axis=1).astype(np.int64))
        metrics = trainer.train_on_batch(batch)
        val = trainer.validate_on_batch(batch)
        if rank != 0:
            return

        # one read through the sharded engine's i8dev and signal-only wires,
        # bit-equal to one device: the shards split the rows, which the
        # program treats independently
        sig, (sigc, rr, ev, er, nuc, aux) = _simulated_read()
        devices = ([device] * world_size if device is not None else
                   [_rank_device(i, None) for i in range(world_size)])
        fast = dict(chunk_size=512, beam_impl="xla", memory_dtype=None, transport_dtype="i8dev",
                    pack_u8=True, prob_bits=4, project_values=True)
        engine = ShardedBasecallEngine(trainer.params, cfg.model,
                                       make_mesh(devices=devices, model_shards=model_shards),
                                       **fast)
        single = BasecallEngine(trainer.params, cfg.model, device=devices[0], **fast)
        max_len = int((nuc != 0).sum(axis=1).max())
        tokens, probs = engine.predict_beam_compact(sigc, rr, ev, er, max_len, 5, aux=aux)
        tokens_1, probs_1 = single.predict_beam_compact(sigc, rr, ev, er, max_len, 5, aux=aux)
        if not (tokens.shape[0] == rr.shape[0] and np.array_equal(tokens, tokens_1)
                and np.array_equal(probs, probs_1)):
            raise AssertionError("the sharded i8dev decode differs from one device's")
        sig_out = engine.predict_beam_signal(sig, max_output_len=max_len, beam_width=5)
        sig_out_1 = single.predict_beam_signal(sig, max_output_len=max_len, beam_width=5)
        if sig_out is None or sig_out_1 is None or not sig_out[0].shape[0]:
            raise AssertionError("the signal-only wire gave no snippets")
        if not all(np.array_equal(a, b) for a, b in zip(sig_out, sig_out_1)):
            raise AssertionError("the sharded sigdev decode differs from one device's")
        print(f"dryrun_multichip({world_size}), {units} units: train loss="
              f"{float(metrics['loss']):.4f} "
              f"val loss={float(val['loss']):.4f} mesh={engine.mesh.shape} on {devices}; "
              f"sharded decode bit-equal to one device ({tokens.shape[0]} snippets, beam 5, "
              f"i8dev wire; sigdev wire {sig_out[0].shape[0]} snippets)", flush=True)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device: Optional[str] = None, timeout: float = 600.0
                     ) -> None:
    """One train step and validation on ``n_devices`` gloo ranks (a grid of
    ``n_devices / 2`` x 2 at n >= 4 and n even), then the sharded decode
    checks (the module's docstring); ranks
    on the card's devices round-robin unless ``device`` (e.g. "cpu") is
    given. Raises when a rank fails."""
    from ravvent_tpu_torch.parallel.distributed import spawn

    if device is None:
        resolve_device(None)  # raises when there is no card
    units = 128 if device is None or torch.device(device).type == "cuda" else 16  # the flagship's
    spawn(_dryrun_rank, n_devices, (device, units), timeout=timeout)


def main(argv) -> int:
    device = "cpu" if "--cpu" in argv else None
    args = [a for a in argv if a != "--cpu"]
    if args and args[0] == "multichip":
        dryrun_multichip(int(args[1]) if len(args) > 1 else 2, device)
        return 0
    fn, example = entry(device)
    loss, acc = fn(*example)
    print(f"entry(): loss={float(loss):.4f} acc={float(acc):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
