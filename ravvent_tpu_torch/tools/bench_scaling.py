"""Throughput against mesh size: bases/s of the sharded engine over a ladder
of meshes, on the GPU.

Counterpart of the repo root's tools/bench_scaling.py, which runs the JAX
package. Each chunk's snippet rows are split over a ``('data',)`` mesh
(parallel/inference.py:ShardedBasecallEngine over parallel/mesh.py:
make_mesh, built by tools/bench.py:bench_engine), every shard running the
one-device program with its kernels.
At each mesh size of ``--sizes`` the reference's throughput protocol runs
(PerformanceEvaluator.evaluate_files: beam prediction, postprocessing and
merge over ``total_processing``, each read the fastest of 3),
or with ``--pipelined`` the production number (``run_pipelined`` over the
reads three times over, the faster of 2 passes); each row gives bases/s,
its speedup over the first size and its efficiency (speedup / size).
``--compare-single`` also runs the plain one-device engine and reports the
mesh wrapper's cost at size 1 (``mesh1_vs_single``).

The mesh: N cards, sizes above the machine's count of cards left out, as
the reference does; ``--device D`` N shards of D (``--device cuda:0`` on a
machine of one card), ``--cpu`` N shards of the CPU. ``--virtual N`` runs
N shards on the CPU (sizes above N are left out), which exercises the same
sharded program and says nothing of a card. On the card the engine takes
the bench's settings (bf16 memory and encoder stream, i8dev, 4-bit
probabilities, ``beam_impl="step"``); on the CPU f32 memory and encoder, as
the reference runs off its accelerator. Chunks of ``--chunk`` rows (512).

The reads are the reference's, made with the port's simulator into
``--data-dir`` (by default ``.bench_scaling_torch/`` at the repo's root):
a 120 kb genome of 43 base 6-mers (seed 7), ``--reads`` reads of
``--read-len`` to ``--read-len`` + 2000 bases (seed 1234, noise 9), made
again when its ``scaling_meta.json`` names other reads. A ``--data-dir``
that holds a files-info and no such meta is read as it is, and nothing in
it is removed. Each row also
gives the merged reads' bases (``called_bases``) and their digest
(``called_sha1``), which every mesh size must equal. The model is the
flagship on ``--weights`` or weights seeded from ``--seed``.

Prints a table, then ONE JSON line last:
  {"metric": "scaling sweep (sharded inference)", "device": ...,
   "pipelined": bool, "rows": [{"mesh": N, "devices": [...], "bases_per_s": x,
   "bases_num": N, "called_bases": N, "called_sha1": "...", "speedup": x,
   "efficiency": x}, ...] [, "single_device_bases_per_s": x,
   "mesh1_vs_single": x]}

  python -m ravvent_tpu_torch.tools.bench_scaling [--sizes 1,2,4,8]
      [--virtual N | --cpu | --device DEV] [--pipelined] [--compare-single]
      [--reads 2] [--read-len 6000] [--chunk 512] [--beam 5]
      [--weights w.npz | --seed 0] [--data-dir DIR]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.data import chiron, simulator
from ravvent_tpu_torch.evaluation.basecall import resolve_device
from ravvent_tpu_torch.evaluation.performance import (
    PerformanceEvaluator, _max_output_len, flatten_calls, gate_snippets, merge_snippets,
)
from ravvent_tpu_torch.parallel.mesh import make_mesh
from ravvent_tpu_torch.tools import bench
from ravvent_tpu_torch.tools.common import add_bench_flags, stream_paths

REPO = Path(__file__).resolve().parents[2]
DATA_DIR = REPO / ".bench_scaling_torch"
METRIC = "scaling sweep (sharded inference)"
META = "scaling_meta.json"


def ensure_reads(data_dir, reads: int, read_len: int) -> Path:
    """The reads' files-info path in ``data_dir``. A directory with a
    files-info and no ``scaling_meta.json`` is the caller's dataset, used as
    it is, as the reference does; otherwise the reference's reads are made
    there. Only a directory that holds this tool's meta file, so one it
    made, is removed (when the meta names other reads), and the meta is
    written only into a directory that was missing or empty."""
    data_dir = Path(data_dir)
    fi = data_dir / "files_info.snippets.stride_6.json"
    meta = data_dir / META
    want = {"reads": reads, "read_len": read_len}
    if meta.exists():
        if fi.exists() and json.loads(meta.read_text()) == want:
            return fi
        shutil.rmtree(data_dir)  # made by this tool for other reads: made again
    elif fi.exists():
        return fi
    ours = not data_dir.exists() or not any(data_dir.iterdir())
    genome = simulator.generate_reduced_genome(43, 120_000, np.random.default_rng(7))
    simulator.generate_chiron_dataset(data_dir, genome, n_reads=reads,
                                      read_len_range=(read_len, read_len + 2000), seed=1234,
                                      noise_std=9.0)
    chiron.create_files_info(data_dir, stride=6, verbose=False)
    if ours:
        meta.write_text(json.dumps(want))
    return fi


def mesh_devices(n: int, device: Optional[torch.device]) -> List[str]:
    """The mesh's devices at size ``n``: n shards of ``device`` when given,
    else the first n cards."""
    if device is None:
        return [f"cuda:{i}" for i in range(n)]
    return [str(device)] * n


def called_reads(pe: PerformanceEvaluator, paths) -> List[str]:
    """Each read's merged sequence, as ``PerformanceEvaluator.run`` makes it
    (untimed)."""
    out = []
    for p in paths:
        sig, rr, ev, er, nuc, aux = pe._load(p)
        if not rr.shape[0]:
            out.append("")
            continue
        tokens, probs = pe.engine.predict_beam_compact(
            sig, rr, ev, er, _max_output_len(rr, nuc), pe.beam_width, aux=aux)
        calls = flatten_calls(tokens, probs)
        out.append(merge_snippets(pe.merger, *gate_snippets(pe.conf_gate, *calls, rr)).seq)
    return out


def measure(engine, fi: Path, data_dir: Path, beam_width: int, tag: str, pipelined: bool,
            repeats: int) -> dict:
    """bases/s of one engine by the reference's protocol, and the merged
    reads' bases and digest."""
    pe = PerformanceEvaluator(engine, beam_width=beam_width, cache_dir=str(data_dir / "cache"))
    paths = stream_paths(fi)
    if pipelined:
        rec = min((pe.run_pipelined(paths * 3) for _ in range(2)), key=lambda r: r["wall_s"])
        rate, bases = rec["bases_per_s"], rec["bases_num"]
    else:
        results = pe.evaluate_files(fi, data_dir / f"perf_{tag}.json", verbose=False,
                                    repeats=repeats)
        bases = sum(r["bases_num"] for r in results)
        rate = bases / sum(r["total_processing"] for r in results)
    called = called_reads(pe, paths)
    return {"bases_per_s": rate, "bases_num": bases,
            "called_bases": sum(len(s) for s in called),
            "called_sha1": hashlib.sha1("\n".join(called).encode()).hexdigest()}


def run_scaling(sizes: Sequence[int], virtual: Optional[int] = None, device=None,
                pipelined: bool = False, compare_single: bool = False, reads: int = 2,
                read_len: int = 6000, chunk_size: int = 512, beam_width: int = 5,
                repeats: int = 3, data_dir=DATA_DIR, weights: Optional[str] = None,
                seed: int = 0, cfg: Optional[ModelConfig] = None, params=None,
                settings: Optional[dict] = None) -> dict:
    """The ladder's rows (see the module's docstring). ``device``: every
    shard on it; ``virtual``: that many shards on the CPU at most.
    ``settings`` overrides the engine's settings (tools/bench.py:
    bench_engine's keywords); ``cfg`` and ``params`` the flagship and its
    weights."""
    if virtual is not None:
        device = torch.device("cpu")
        sizes = [s for s in sizes if s <= virtual]
    elif device is not None:
        device = resolve_device(device)
    else:
        resolve_device(None)  # refuses a machine without a card
        sizes = [s for s in sizes if s <= torch.cuda.device_count()]
    if not sizes:
        raise ValueError("no size of --sizes fits the devices")
    data_dir = Path(data_dir)
    fi = ensure_reads(data_dir, reads, read_len)
    cfg = cfg or bench.FLAGSHIP
    params, _ = bench.model_params(cfg, params, weights, seed)
    first = resolve_device(mesh_devices(1, device)[0])
    on_card = first.type == "cuda"
    settings = dict(dict(memory="bf16" if on_card else "f32", bf16_encoder=on_card),
                    **(settings or {}))
    rows, single = [], None
    if compare_single:
        engine = bench.bench_engine(params, cfg, first, chunk_size, **settings)
        single = measure(engine, fi, data_dir, beam_width, "single", pipelined, repeats)
        print(f"plain single-device engine: {single['bases_per_s']:.1f} bases/s", flush=True)
    for n in sizes:
        devices = mesh_devices(n, device)
        engine = bench.bench_engine(params, cfg, None, chunk_size,
                                    mesh=make_mesh(devices=devices), **settings)
        rows.append(dict(mesh=n, devices=devices,
                         **measure(engine, fi, data_dir, beam_width, f"mesh{n}", pipelined,
                                   repeats)))
    base = rows[0]["bases_per_s"]
    print(f"{'mesh':>5} {'bases/s':>12} {'speedup':>8} {'efficiency':>10}")
    for r in rows:
        r["speedup"] = round(r["bases_per_s"] / base, 4)
        r["efficiency"] = round(r["speedup"] / r["mesh"], 4)
        print(f"{r['mesh']:>5} {r['bases_per_s']:>12.1f} {r['speedup']:>8.2f} "
              f"{r['efficiency']:>10.3f}")
    out = {"metric": METRIC, "device": bench.device_line(first), "pipelined": pipelined,
           "rows": rows}
    if single is not None:
        out["single_device_bases_per_s"] = single["bases_per_s"]
        out["mesh1_vs_single"] = (round(rows[0]["bases_per_s"] / single["bases_per_s"], 4)
                                  if rows[0]["mesh"] == 1 else None)
    return out


def main(argv=None) -> dict:
    """Run the ladder; returns the last line's object."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="1,2,4,8", help="comma-separated mesh sizes")
    ap.add_argument("--virtual", type=int, default=None, metavar="N",
                    help="N shards on the CPU (no card needed)")
    ap.add_argument("--pipelined", action="store_true",
                    help="the pipelined read stream's bases/s instead of the per-read protocol")
    ap.add_argument("--compare-single", action="store_true",
                    help="also run the plain one-device engine (the mesh wrapper's cost at 1)")
    ap.add_argument("--reads", type=int, default=2)
    ap.add_argument("--read-len", type=int, default=6000)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--beam", type=int, default=5)
    add_bench_flags(ap, DATA_DIR)
    args = ap.parse_args(argv)
    # not common.tool_device: without --device (None) each shard takes a card of its own
    device = "cpu" if args.cpu else args.device
    out = run_scaling([int(s) for s in args.sizes.split(",")], args.virtual, device,
                      args.pipelined, args.compare_single, args.reads, args.read_len, args.chunk,
                      args.beam, data_dir=args.data_dir, weights=args.weights, seed=args.seed)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
