"""What the port's user tools share: the model flags, weights from a
checkpoint or an npz file, and the engine of the evaluate-side tools.

The JAX package's evaluate-side tools (tools/evaluate.py, sweep_epochs.py,
train_curriculum.py) build ``BasecallEngine(params, cfg, chunk_size=1024)``
with that engine's defaults: f32 memory, f32 encoder stream, the plain beam
decode (ravvent_tpu/evaluation/basecall.py:250-256 there). The port's tools
keep those numerics, f32 memory and encoder with chunks of 1024 rows, and
decode with the beam-step kernels (``beam_impl="step"``) where the
configuration allows it (evaluation/basecall.py:kernels_serve, the rule
the engine enforces), else with the plain decode (``"xla"``):
:func:`default_beam_impl`.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Iterable, Optional, Union

import torch

from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine, kernels_serve, resolve_device
from ravvent_tpu_torch.training.checkpoints import PARAMS_FILE
from ravvent_tpu_torch.weights import load_npz

EVAL_CHUNK = 1024  # rows a chunk of the evaluate-side tools' engine


def add_model_flags(ap: argparse.ArgumentParser, rnn_type: bool = True,
                    attention: bool = False) -> None:
    """The model's flags, as the JAX tools name them: ``--data-type``, the
    widths and depths, and where the tool takes them ``--rnn-type`` and
    ``--attention``."""
    ap.add_argument("--data-type", default="joint", choices=["raw", "event", "joint"])
    if rnn_type:
        ap.add_argument("--rnn-type", default="bilstm", choices=["gru", "lstm", "bigru", "bilstm"])
    if attention:
        ap.add_argument("--attention", default="luong", choices=["luong", "bahdanau"])
    ap.add_argument("--enc-units", type=int, default=128)
    ap.add_argument("--dec-units", type=int, default=128)
    ap.add_argument("--encoder-depth", type=int, default=2)
    ap.add_argument("--decoder-depth", type=int, default=1)


def model_config(args: argparse.Namespace) -> ModelConfig:
    """The ``ModelConfig`` of :func:`add_model_flags`' flags."""
    return ModelConfig(
        enc_units=args.enc_units, dec_units=args.dec_units,
        encoder_depth=args.encoder_depth, decoder_depth=args.decoder_depth,
        rnn_type=getattr(args, "rnn_type", "bilstm"),
        attention_type=getattr(args, "attention", "luong"), data_type=args.data_type,
    )


def load_params(path) -> dict:
    """The parameters of a port checkpoint directory (its ``params.npz``,
    training/checkpoints.py) or of an npz file (``weights.save_npz``), as
    CPU tensors."""
    p = Path(path)
    if p.is_dir():
        p = p / PARAMS_FILE
    if not p.is_file():
        raise FileNotFoundError(f"no checkpoint or npz of weights at {path}")
    return load_npz(p)


def default_beam_impl(cfg: ModelConfig, beams: Iterable[int],
                      device: Union[str, torch.device, None] = None) -> str:
    """``"step"`` (the beam-step kernels) where ``kernels_serve(cfg, beams,
    device)``, ``"xla"`` (the plain beam decode) otherwise: for beam widths
    outside ``STEP_BEAMS`` and, on a CUDA device, for decoder widths past
    the widest of ``STEP_UNITS`` (ops/beam_step_cuda.py; the widths between
    them run zero-padded)."""
    return "step" if kernels_serve(cfg, beams, device) else "xla"


def eval_engine(params, cfg: ModelConfig, device: torch.device, beams: Iterable[int],
                n_beams: int = 1, beam_impl: Optional[str] = None) -> BasecallEngine:
    """The evaluate-side tools' engine: f32 memory and encoder, chunks of
    1024 rows, unpacked results, ``beam_impl`` or :func:`default_beam_impl`."""
    return BasecallEngine(params, cfg, chunk_size=EVAL_CHUNK, memory_dtype=None,
                          encoder_dtype=None, pack_u8=False, device=device,
                          beam_impl=beam_impl or default_beam_impl(cfg, beams, device),
                          n_beams=n_beams)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def add_bench_flags(ap: argparse.ArgumentParser, data_dir) -> None:
    """The bench-side tools' shared flags (tools/{sweep_pipeline,
    floor_probe, bench_scaling, train_profile}.py): ``--weights w.npz |
    --seed N``, ``--data-dir`` and :func:`add_device_flags`."""
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--weights", help="npz of the JAX parameter tree (ravvent_tpu_torch.weights)")
    src.add_argument("--seed", type=int, default=0, help="seeded random weights (no --weights)")
    ap.add_argument("--data-dir", default=str(data_dir), help="the reads, made there when missing")
    add_device_flags(ap)


def add_device_flags(ap: argparse.ArgumentParser) -> None:
    """``--cpu | --device DEV``: where a tool runs, the first card unless
    one of them is given (:func:`tool_device`)."""
    dev = ap.add_mutually_exclusive_group()
    dev.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    dev.add_argument("--device", default=None, help="a torch device, e.g. cuda:1")


def tool_device(args: argparse.Namespace) -> torch.device:
    """The device of :func:`add_device_flags`' flags: the first card unless
    ``--cpu`` or ``--device``; raises when a card is asked for and there is
    none."""
    return resolve_device("cpu" if args.cpu else args.device)


def stream_paths(files_info) -> list:
    """The signal paths of a files-info JSON, in its order."""
    return [v["signal_path"] for v in json.loads(Path(files_info).read_text())]


def add_study_flags(ap: argparse.ArgumentParser, reads: int) -> None:
    """The flags of the studies over a checkpoint (tools/{analyze_beam1_gap,
    exp_conf_gate}.py), with the JAX tools' defaults: the model's depths
    and types (at the flagship's widths), the reads, their snippet cache,
    and :func:`add_device_flags`."""
    ap.add_argument("--checkpoint", required=True, help="port checkpoint dir or npz of weights")
    ap.add_argument("--data-type", default="raw")
    ap.add_argument("--encoder-depth", type=int, default=3)
    ap.add_argument("--decoder-depth", type=int, default=1)
    ap.add_argument("--rnn-type", default="bilstm")
    ap.add_argument("--files-info", required=True)
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--reads", type=int, default=reads)
    add_device_flags(ap)


def study_engine(args: argparse.Namespace, beams):
    """The studies' engine: :func:`eval_engine` of ``--checkpoint`` and the
    flags' model, on the flags' device, for ``beams``."""
    device = tool_device(args)
    cfg = ModelConfig(encoder_depth=args.encoder_depth, decoder_depth=args.decoder_depth,
                      rnn_type=args.rnn_type, data_type=args.data_type)
    engine = eval_engine(load_params(args.checkpoint), cfg, device, beams)
    print(f"engine: beam_impl={engine.beam_impl} on {device} ({device_name(device)})",
          file=sys.stderr)
    return engine
