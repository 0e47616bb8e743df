"""Basecalling CLI: chiron signal in, FASTA/FASTQ out, on the GPU.

Counterpart of tools/basecall.py of the JAX package: basecalls every read of
a directory with chunked beam decode on the compact path, the confidence
gate and the overlap merge, and writes the assembled sequences. The reads
are the directory's ``*.fast5`` files (the whole read is the region), or,
when it has none, its chiron ``*.signal`` files (the region from the
``.label`` beside each, else the whole read). Weights come
from an npz file of the JAX parameter tree (``--weights``, see
ravvent_tpu_torch/weights.py) or are drawn from ``--seed`` at the configured
widths. Runs on the first CUDA device unless ``--cpu`` is given. The memory
is bf16 and pre-projected, as the JAX CLI sets it. ``--beam-impl step`` and
``loop`` run the beam kernels, which take the flagship's depth-1 decoder
(on the card at ``--dec-units`` up to 256, the widths other than 64, 128
and 256 on weights the engine zero-pads to the next of them, and ``--beam``
1 to 32; ``loop`` on its resident layout at 128 units and beams 1-5 or 8,
on its streamed one elsewhere; wider shapes raise); ``xla`` runs the plain
beam decode and serves any depth, e.g. the 3-layer encoder, 2-layer decoder
flagship32.

Usage:
  python -m ravvent_tpu_torch.tools.basecall --weights flagship.npz \
      --input datasets/sim_lambda/eval --out basecalls.fasta [--beam 5] \
      [--beam-impl step|loop|xla] [--encoder-depth 2] [--decoder-depth 1]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ravvent_tpu_torch.assembly.merger import (
    CONF_GATE_DEFAULT, Merger, confidence_keep_mask, expected_overlaps_from_ranges,
)
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.data import chiron
from ravvent_tpu_torch.data.snippets import prepare_compact
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine, resolve_device
from ravvent_tpu_torch.models.basecaller import init_basecaller
from ravvent_tpu_torch.weights import load_npz

MAX_OUTPUT_LEN = 40  # decode bound of the CLI: max_steps = 39


class ReadCall(NamedTuple):
    merged: object  # assembly.merger MergeResult (seq, logits)
    n_snippets: int
    seconds: Dict[str, float]  # wall time of prepare / decode / merge


def basecall_read(engine: BasecallEngine, merger: Merger, raw: np.ndarray, ranges: np.ndarray,
                  beam: int = 5, conf_gate: bool = True) -> Optional[ReadCall]:
    """One read through the CLI's path: snippet preparation, beam decode on
    the compact path, the confidence gate and the overlap merge. Returns
    None when the read yields no snippet."""
    t0 = time.perf_counter()
    sig, rr, ev, er, _syms, _aux = prepare_compact(
        raw, ranges, np.array(["a"] * len(ranges)), stride=6)
    if rr.shape[0] == 0:
        return None
    t1 = time.perf_counter()
    tokens, probs = engine.predict_beam_compact(sig, rr, ev, er, MAX_OUTPUT_LEN, beam)
    t2 = time.perf_counter()
    seqs = engine.tokens_to_sequences(tokens)
    probs = np.asarray(probs, dtype=np.float64)
    rows = [p[: len(s)] for s, p in zip(seqs, probs)]
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    keep = np.ones(len(seqs), bool)
    if conf_gate and len(seqs) > 1:
        offsets = np.concatenate([[0], np.cumsum(lens)])
        keep = confidence_keep_mask(np.concatenate(rows), offsets, *CONF_GATE_DEFAULT)
    seqs_k = [s for s, k in zip(seqs, keep) if k]
    rows_k = [r for r, k in zip(rows, keep) if k]
    eo = expected_overlaps_from_ranges(rr[keep], lens[keep]) if keep.sum() > 1 else None
    merged = merger.merge_arrays(seqs_k, rows_k, expected_overlaps=eo)
    t3 = time.perf_counter()
    return ReadCall(merged, int(rr.shape[0]),
                    {"prepare": t1 - t0, "decode": t2 - t1, "merge": t3 - t2})


def fastq_quality(probs) -> str:
    return "".join(chr(33 + min(40, int(-10 * np.log10(max(1e-4, 1 - p))))) for p in probs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--weights", help="npz of the JAX parameter tree (ravvent_tpu_torch.weights)")
    src.add_argument("--seed", type=int, default=0, help="seeded random weights (no --weights)")
    ap.add_argument("--input", required=True,
                    help="dir with .fast5 files, or with .signal (and .label) files")
    ap.add_argument("--out", default="basecalls.fasta")
    ap.add_argument("--format", choices=["fasta", "fastq"], default="fasta")
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--data-type", default="joint", choices=["raw", "event", "joint"])
    ap.add_argument("--enc-units", type=int, default=128)
    ap.add_argument("--dec-units", type=int, default=128)
    ap.add_argument("--encoder-depth", type=int, default=2)
    ap.add_argument("--decoder-depth", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--beam-impl", default="step", choices=["xla", "loop", "step"],
                    help="beam kernel: one launch per decode step, or one per chunk; or the "
                         "plain decode (any decoder depth)")
    ap.add_argument("--pack-u8", action=argparse.BooleanOptionalAction, default=True,
                    help="nibble-pack tokens + u8-quantize step probs in the result buffer")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    ap.add_argument("--no-conf-gate", action="store_true",
                    help="keep every decoded snippet in the merge fold")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    cfg = ModelConfig(enc_units=args.enc_units, dec_units=args.dec_units,
                      encoder_depth=args.encoder_depth, decoder_depth=args.decoder_depth,
                      data_type=args.data_type)
    if args.weights:
        params = load_npz(args.weights)
        print(f"loaded weights {args.weights}", file=sys.stderr)
    else:
        params = init_basecaller(cfg, torch.Generator().manual_seed(args.seed))
        print(f"WARNING: no --weights — using random weights from seed {args.seed}",
              file=sys.stderr)
    engine = BasecallEngine(params, cfg, chunk_size=args.chunk, pack_u8=args.pack_u8,
                            device=device, beam_impl=args.beam_impl, project_values=True)
    merger = Merger()

    in_dir = Path(args.input)
    fast5s = sorted(in_dir.glob("*.fast5"))
    if fast5s:
        from ravvent_tpu_torch.utils.io import read_fast5_signal

        reads = [(p.stem, read_fast5_signal(p), None) for p in fast5s]
    else:
        reads = []
        for sp in sorted(in_dir.glob("*.signal")):
            lp = sp.with_suffix(".label")
            reads.append((sp.stem, chiron.load_signal(sp), lp if lp.exists() else None))
    if not reads:
        sys.exit(f"no .fast5 or .signal files in {in_dir}")

    t0 = time.time()
    n_bases = 0
    with open(args.out, "wt") as out:
        for name, raw, lp in reads:
            # no labels: treat the whole read as the region of interest
            ranges = chiron.load_label(lp)[0] if lp is not None else np.array([[0, raw.size]])
            call = basecall_read(engine, merger, raw, ranges, args.beam,
                                 conf_gate=not args.no_conf_gate)
            if call is None:
                print(f"{name}: no snippets (read too short)", file=sys.stderr)
                continue
            seq = call.merged.seq
            n_bases += len(seq)
            if args.format == "fasta":
                out.write(f">{name}\n{seq}\n")
            else:
                out.write(f"@{name}\n{seq}\n+\n{fastq_quality(call.merged.logits)}\n")
            print(f"{name}: {len(seq)} bases", file=sys.stderr)
    dt = time.time() - t0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{len(reads)} reads, {n_bases} bases in {dt:.1f}s "
          f"({n_bases / max(dt, 1e-9):.0f} bases/s on {name})", file=sys.stderr)


if __name__ == "__main__":
    main()
